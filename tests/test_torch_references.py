"""Regeneration checks of the port's recorded reference runs
(tests/reference_runs.py): each generator under tests/data/ reruns the
JAX reference into a temporary file, and every array of it must equal
the committed recording's bit for bit (dtype, shape and bytes).

Marked slow: each reruns a reference compile (~45-90 s each on 8 cores,
244 s for the seven with -p xdist -n 3), and the tier-1 run deselects
them with -m 'not slow'. Run them after a change to a generator, to the
reference, or to the port's synthetic frames (then commit what the
generators write):

    python -m pytest -q -p no:cacheprovider -m slow tests/test_torch_references.py
"""

import subprocess
import sys

import pytest

import reference_runs

NAMES = ("pipelined", "mapping", "parallel", "system", "slice", "slice_lines", "loopclosing")


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_generator_reproduces_recording(name, tmp_path):
    out = tmp_path / f"{name}_reference.npz"
    subprocess.run([sys.executable, str(reference_runs.DATA / f"make_{name}_reference.py"), str(out)], check=True,
                   timeout=1200)
    want, got = reference_runs.read(reference_runs.path(name)), reference_runs.read(out)
    assert list(got) == list(want)
    for k, a in want.items():
        assert (got[k].dtype, got[k].shape) == (a.dtype, a.shape), k
        assert got[k].tobytes() == a.tobytes(), k
