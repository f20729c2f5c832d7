"""Write tests/data/slice_reference.npz: the reference's FrameBuilder ->
Tracker.step slice, for tests/test_torch_slice.py.

The reference's FrameBuilder and Tracker (the test's caps) on
configs/TUM1.yaml scaled to 320x240, over the port's frames
(`_sequence()`), `status` weakly typed from the start (so the step
compiles once); then its step on frame MID from each state the test's
STEPS make of its state before frame MID. Keys: "out<i>.*", the StepOut
of frame i; "frame_ids" and "frame<i>.*", the FrameData the tests read
(bf16 fields as float32; frame 0 only its line fields); "mid_state.*" and
"state.*", the TrackState before frame MID and after the last; "step.<name>.*",
each step from STEPS[name] (`reference_runs.flat_call`).
tests/data/make_slice_lines_reference.py records the point+line slice
with `record` below.

    python tests/data/make_slice_reference.py [OUT]   # ~55 s on 8 CPU cores
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import reference_runs as rr  # noqa: E402

rr.cpu_jax_like_the_tests()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from plslam_tpu.config import load_settings as jload_settings  # noqa: E402
from plslam_tpu.features.frame import FrameBuilder as JFrameBuilder  # noqa: E402
from plslam_tpu.pipeline.tracking import ST_UNINIT  # noqa: E402
from plslam_tpu.pipeline.tracking import Tracker as JTracker  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def record(t, out, steps, full_frames, line_frames, final_state):
    """The reference's slice for test module t (its CFG, N_FRAMES, MID, CAPS,
    `_half` and `_sequence`): every frame's StepOut, the FrameData of
    `full_frames` whole and of `line_frames` their "ln_" fields, the state
    before frame MID (and after the last if `final_state`), and the step on
    frame MID from each steps[name](state before MID)."""
    seq = t._sequence()
    frames = [seq.frame(i) for i in range(t.N_FRAMES)]
    js = t._half(jload_settings(t.CFG))
    jb, jt = JFrameBuilder(js), JTracker(js, **t.CAPS)
    # the step makes `status` weakly typed; start it so, or jit compiles twice
    jst = jt.init_state()._replace(status=jnp.asarray(ST_UNINIT))
    kept = sorted(set(full_frames) | set(line_frames))
    arrays, jframes = {"frame_ids": np.array(kept)}, {}
    for i, (g, d, _) in enumerate(frames):
        jf = jb(jnp.asarray(g), jnp.asarray(d))
        if i == t.MID:
            mid_state = _np(jst)
            arrays.update(rr.flat("mid_state", mid_state))
        jframes[i] = _np(jf)
        if i in kept:
            arrays.update({k: v for k, v in rr.flat(f"frame{i}", jf).items()
                           if i in full_frames or k.split(".")[1].startswith("ln_")})
        jst, o = jt.step(jst, jf)
        arrays.update(rr.flat(f"out{i}", o))
    if final_state:
        arrays.update(rr.flat("state", jst))
    for name, mutate in steps.items():
        d, jf = mutate(mid_state), jframes[t.MID]
        s = jax.tree_util.tree_map(jnp.asarray, d)
        s = s._replace(status=jnp.asarray(int(d.status)))  # weakly typed, as the step leaves it
        s2, o = jt.step(s, jax.tree_util.tree_map(jnp.asarray, jf))
        arrays.update(rr.flat_call(f"step.{name}", dict(state=d, frame=jf), dict(state=_np(s2), out=_np(o))))
    rr.save(Path(out), rr.frames_sha256(frames), arrays)


def main(out=rr.path("slice")):
    import test_torch_slice as t

    record(t, out, t.STEPS, full_frames=(t.MID, t.N_FRAMES - 1), line_frames=(0,), final_state=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
