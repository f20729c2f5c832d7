"""Write tests/data/system_reference.npz: the reference's mapper-less
synchronous `System`, for tests/test_torch_system.py.

The reference's `System(use_local_mapping=False, use_loop_closing=False)`
with lines off, the test's caps and a JSONL log, driven by the test's
`_drive` over the port's frames (`_inputs(_sequence())`: 8 frames, a
blackout, the first frames again), its state and bookkeeping snapshotted
before each call (its `status` typed once there, so the fused step
compiles once) and after the last; then both TUM files and `shutdown`.
Keys: "rows.*", what the tests read after each call; "snap_calls" and
"snap<i>.*", the snapshots before the calls the tests start from (the
first keyframe after frame 0, the relocalizing frame, the calls after
them, and the end; `reference_runs.flat_system`); "jsonl" (its host
times, "ms", written as 0 so that the file repeats itself), "traj", "kf".

    python tests/data/make_system_reference.py [OUT]   # ~70 s on 8 CPU cores
"""

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import reference_runs as rr  # noqa: E402

rr.cpu_jax_like_the_tests()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_system as t  # noqa: E402
from plslam_tpu.io.synthetic import SyntheticSequence as JSyntheticSequence  # noqa: E402
from plslam_tpu.system import System as JSystem  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def main(out=rr.path("system")):
    inputs = t._inputs(t._sequence())
    jseq = JSyntheticSequence(n_frames=t.STRIDE * t.N_BEFORE, height=240, width=320, seed=3, motion_scale=t.MOTION)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ref = JSystem(dataclasses.replace(jseq.settings, use_lines=False), use_local_mapping=False,
                      use_loop_closing=False, log_path=tmp / "ref.jsonl", **t.CAPS)
        snaps = {}

        def snapshot(i):  # the reference's state and bookkeeping before call i
            # the step leaves `status` weakly typed and a fresh or relocalized
            # state has it strongly typed; one typing keeps the reference's
            # fused step to one compile (the value is unchanged)
            ref.state = ref.state._replace(status=jnp.asarray(int(ref.state.status)))
            snaps[i] = dict(state=_np(ref.state), kf_bow=np.asarray(ref._reloc.kf_bow),
                            timestamps=list(ref._timestamps), rel_poses=list(ref._rel_poses),
                            ref_ids=list(ref._ref_ids), tracked=list(ref._tracked),
                            kf_timestamps=dict(ref._kf_timestamps), last_status=ref._last_status,
                            last_frame=None if ref._last_frame is None else _np(ref._last_frame[1]))

        rows = t._drive(ref, inputs, snapshot)
        snapshot(len(inputs))
        ref.save_trajectory_tum(tmp / "ref_traj.txt")
        ref.save_keyframe_trajectory_tum(tmp / "ref_kf.txt")
        ref.shutdown()
        log = [json.loads(x) for x in (tmp / "ref.jsonl").read_text().splitlines()]
        jsonl = "".join(json.dumps({**r, "ms": 0.0}) + "\n" for r in log)
        traj, kf = ((tmp / n).read_text() for n in ("ref_traj.txt", "ref_kf.txt"))

    reloc = next(i for i in range(t.N_BEFORE + t.N_BLACK, len(rows))
                 if rows[i]["Tcw"] is None and rows[i]["state"] == "OK")
    first_kf = next(i for i in range(1, t.N_BEFORE) if rows[i]["new_kf"])
    calls = sorted({first_kf, first_kf + 1, reloc, reloc + 1, len(inputs)})
    arrays = {"snap_calls": np.array(calls), **rr.flat_rows("rows", rows)}
    for i in calls:
        arrays.update(rr.flat_system(f"snap{i}", snaps[i]))
    arrays.update(jsonl=rr.text(jsonl), traj=rr.text(traj), kf=rr.text(kf))
    rr.save(Path(out), rr.frames_sha256(inputs), arrays)


if __name__ == "__main__":
    main(*sys.argv[1:])
