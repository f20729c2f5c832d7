"""Write tests/data/pipelined_reference.npz: the reference's pipelined
`System` for tests/test_torch_pipelined.py.

The reference's `System(pipeline_depth=K)` with every default and the
test's caps, its chunk program swapped for K calls of its per-frame
program (`_RefPipelined`, below), driven by the test's `_drive` over the
port's frames (`_sequence()`, the first N_FRAMES), then
`save_trajectory_tum` (which finalizes the last K frames) and `save_map`.
Keys: "rows.*", each finalized frame's call, timestamp, telemetry row and
returned pose; "tracked_flags", "n_keyframes"; "state.*", its TrackState
after the save; "kf_bow" and "kf_timestamps.*", its BoW rows and keyframe
timestamps; "snapshot.*", the arrays of the file `save_map` wrote.

    python tests/data/make_pipelined_reference.py [OUT]   # ~90 s on 8 CPU cores
"""

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import reference_runs as rr  # noqa: E402

rr.cpu_jax_like_the_tests()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_pipelined as t  # noqa: E402
from plslam_tpu.io.synthetic import SyntheticSequence as JSyntheticSequence  # noqa: E402
from plslam_tpu.system import System as JSystem  # noqa: E402


class _RefPipelined(JSystem):
    """The reference System with its chunk program as K calls of its
    per-frame program (see tests/test_torch_pipelined.py's docstring),
    recording each finalized frame's telemetry row."""

    @property
    def _fused_chunk(self):
        def chunk(state, grays, depths, ln_sp, ln_ep, ln_valid):
            tels = []
            for i in range(self.pipeline_depth):
                # one typing of `status` keeps the per-frame program to one
                # compile (the step leaves it weakly typed; the value is
                # unchanged)
                state = state._replace(status=jnp.asarray(int(state.status)))
                state, out, _ = self._fused_step(state, grays[i], depths[i], ln_sp, ln_ep, ln_valid)
                tels.append(out.telemetry)
            return state, jnp.stack(tels)

        return chunk

    def _finalize_one(self):
        telc, idx = self._inflight[0][:2]
        row = np.array(telc.row(idx))
        ret = super()._finalize_one()
        self.rows.append(dict(call=self.call, t=self._timestamps[-1], v=row, ret=ret))
        return ret


def main(out=rr.path("pipelined")):
    inputs = t._inputs(t._sequence())
    jseq = JSyntheticSequence(n_frames=t.N_FRAMES, height=240, width=320, seed=3)
    ref = _RefPipelined(jseq.settings, pipeline_depth=t.K, **t.CAPS)
    t._drive(ref, inputs)
    with tempfile.TemporaryDirectory() as tmp:
        ref.save_trajectory_tum(Path(tmp) / "traj.txt")
        ref.save_map(Path(tmp) / "map.npz")
        with np.load(Path(tmp) / "map.npz") as z:
            snapshot = {f"snapshot.{k}": z[k] for k in z.files}
    arrays = {
        **rr.flat_rows("rows", ref.rows),
        "tracked_flags": np.array(ref.tracked_flags),
        "n_keyframes": np.array(ref.n_keyframes),
        **rr.flat("state", ref.state),
        "kf_bow": np.array(ref._reloc.kf_bow),
        "kf_timestamps.slot": np.array(list(ref._kf_timestamps), np.int64),
        "kf_timestamps.t": np.array(list(ref._kf_timestamps.values()), np.float64),
        **snapshot,
    }
    rr.save(Path(out), rr.frames_sha256(inputs), arrays)


if __name__ == "__main__":
    main(*sys.argv[1:])
