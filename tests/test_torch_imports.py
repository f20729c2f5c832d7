"""Import hygiene of the port: every module of plslam_tpu_torch and
chip_smoke.py import with `jax` and `plslam_tpu` blocked (the machine with
the card has no JAX), and chip_smoke.py refuses to run without CUDA."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "plslam_tpu"):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import plslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plslam_tpu_torch.__path__, "plslam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "plslam_tpu"))
assert not leaked, leaked
print("imported", len(names) + 2, "modules")
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[1]) > 20


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
