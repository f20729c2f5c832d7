"""Write tests/data/parallel_reference.npz: the reference's batched step,
for tests/test_torch_parallel.py.

The reference's `BatchedTracker(mesh=None)` over the test's two sequences
(`_sequences()`, `_settings`, its caps), its FrameBuilder at capacity 128
and line capacity 16 on the port's gray and depth, the state carried as
numpy between steps (so the vmapped step compiles once), for the first
N_STEP frames. Keys: "out<i>.*", the StepOut of step i; "state.*" and
"frame.*", the state and the stacked FrameData before step 2 (bf16 fields
as float32). The test carries the last two across.

    python tests/data/make_parallel_reference.py [OUT]   # ~70 s on 8 CPU cores
"""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import reference_runs as rr  # noqa: E402

rr.cpu_jax_like_the_tests()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_parallel as t  # noqa: E402
from plslam_tpu.config import Settings as JSettings  # noqa: E402
from plslam_tpu.features.frame import FrameBuilder as JFrameBuilder  # noqa: E402
from plslam_tpu.parallel.batch import BatchedTracker as JBatchedTracker  # noqa: E402
from plslam_tpu.pipeline.tracking import Tracker as JTracker  # noqa: E402


def main(out=rr.path("parallel")):
    seqs = t._sequences()
    inputs = t._inputs(seqs)[:t.N_STEP]
    js = JSettings(**dataclasses.asdict(t._settings(seqs[0])))
    jb = JFrameBuilder(js, capacity=128, line_capacity=16)
    jbt = JBatchedTracker(JTracker(js, **t.CAPS), batch=len(t.SEEDS))
    jst = jax.tree.map(np.asarray, jbt.init_state())
    arrays = {}
    for i, row in enumerate(inputs):
        jf = jax.tree.map(lambda *xs: jnp.stack(xs), *[jb(jnp.asarray(g), jnp.asarray(d)) for g, d in row])
        if i == 2:
            arrays.update(rr.flat("state", jst))
            arrays.update(rr.flat("frame", jf))
        # numpy in, numpy out: every step sees the same (strong) types, so
        # the vmapped step compiles once
        jst, jo = jbt.step(jax.tree.map(jnp.asarray, jst), jf)
        jst = jax.tree.map(np.asarray, jst)
        arrays.update(rr.flat(f"out{i}", jo))
    rr.save(Path(out), rr.frames_sha256([gd for row in inputs for gd in row]), arrays)


if __name__ == "__main__":
    main(*sys.argv[1:])
