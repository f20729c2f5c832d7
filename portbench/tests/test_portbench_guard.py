"""The import guard compares whole top-level names."""

import subprocess
import sys
from pathlib import Path

import pytest

from portbench import guard

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, found", [
    (["plslam_tpu_torch", "plslam_tpu_torch.system", "numpy", "torch"], []),
    (["plslam_tpu", "plslam_tpu_torch"], ["plslam_tpu"]),
    (["plslam_tpu.ops.fast"], ["plslam_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "jax_random", "plslam_tpu_torch.utils.jax_random", "flaxen"], []),
])
def test_top_level_names_compared_whole(names, found):
    assert guard.loaded(names) == found
    if found:
        with pytest.raises(guard.Loaded, match=found[0]):
            guard.require_clean("after the window", names)
    else:
        guard.require_clean("after the window", names)


def test_harness_and_port_import_no_jax():
    """Importing the harness, its reference and the port's modules that the
    entries drive loads neither JAX nor the JAX package."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import harness, calibrate; "
            "from portbench.entries import system, batched; "
            "import plslam_tpu_torch.system, plslam_tpu_torch.parallel.batch; "
            "from portbench import guard; guard.require_clean('after imports'); print('clean')")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().endswith("clean")


def test_a_loaded_jax_package_fails_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "plslam_tpu", type(sys)("plslam_tpu"))
    with pytest.raises(guard.Loaded, match="plslam_tpu"):
        guard.require_clean("before the result")
