"""Write tests/data/loopclosing_reference.npz: the reference's loop
detection, closure and global-BA slice on the constructed map of
tests/test_torch_loopclosing.py.

With ESSENTIAL_GRAPH_ITERS at the test's EG_ITERS, the reference's
LoopCloser at the test's capacities on `_world_map()`: every keyframe's
BoW row, the jitted `_detect_gate_impl` over LOOP_KFS in turn (its groups
carried), `close_loop` of CLOSE_K onto the best candidate of the last
gate, and `LocalBA(global_mode=True).slice_runner(0, 2, True)` on the
closed map. Keys: "kf_bow"; "gate_kfs", "gate<j>.g_mask" and
"gate<j>.g_consist" (the groups going in) and "gate<j>.out<i>" (the
gate's five outputs); "state.*", the TrackState the closure starts from;
"closed" and "closed_state.*", its outcome and state; "loop.*", the loop
closer's state after it; "slice_m.*", the map after the slice.

    python tests/data/make_loopclosing_reference.py [OUT]   # ~45 s on 8 CPU cores
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

import plslam_tpu.constants as JC  # noqa: E402
import test_torch_loopclosing as t  # noqa: E402
from plslam_tpu.config import Settings as JSettings  # noqa: E402
from plslam_tpu.pipeline.loopclosing import LoopCloser as JLoopCloser  # noqa: E402
from plslam_tpu.pipeline.tracking import Tracker as JTracker  # noqa: E402
from plslam_tpu.solvers.local_ba import LocalBA as JLocalBA  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def main(out=rr.path("loopclosing")):
    JC.ESSENTIAL_GRAPH_ITERS = t.EG_ITERS
    m = t._world_map()
    jtr = JTracker(JSettings(**t.CAM), **t.CAPS)
    jloop = JLoopCloser(jtr)
    jm = jax.tree_util.tree_map(jnp.asarray, jtr.init_state().m._replace(**m))
    for k in range(t.N_KF):
        jloop.observe_keyframe(jm, k)
    kf_bow = np.array(jloop.kf_bow)
    arrays = {"kf_bow": kf_bow, "gate_kfs": np.array(t.LOOP_KFS)}
    gate = jax.jit(jloop._detect_gate_impl)
    g_mask, g_consist = jnp.zeros_like(jloop._g_mask), jnp.zeros_like(jloop._g_consist)
    for j, k in enumerate(t.LOOP_KFS):
        g = gate(jnp.asarray(kf_bow), jm, k, g_mask, g_consist)
        arrays.update({f"gate{j}.g_mask": np.array(g_mask), f"gate{j}.g_consist": np.array(g_consist)})
        arrays.update({f"gate{j}.out{i}": np.array(x) for i, x in enumerate(g)})
        g_mask, g_consist = g[3], g[4]
    enough, scores = arrays[f"gate{j}.out1"], arrays[f"gate{j}.out2"]
    cands = sorted(np.where(enough)[0].tolist(), key=lambda c: -scores[c])
    jstate = jtr.init_state()._replace(m=jm)
    closed_state, closed = jloop.close_loop(jstate, t.CLOSE_K, cands[0])
    slice_m = JLocalBA(jtr, global_mode=True).slice_runner(0, 2, True)(closed_state.m, jnp.int32(t.CLOSE_K))
    arrays.update(rr.flat("state", _np(jstate)))
    arrays["closed"] = np.array(bool(closed))
    arrays.update(rr.flat("closed_state", _np(closed_state)))
    arrays.update({"loop.n_loops_closed": np.array(jloop.n_loops_closed),
                   "loop.loop_edges": np.array(jloop._loop_edges, np.int64).reshape(-1, 2),
                   "loop.gba_queue": np.array(jloop.gba_queue, np.int64).reshape(-1, 3),
                   "loop.gba_k": np.array(jloop._gba_k), "loop.kf_counter": np.array(jloop._kf_counter),
                   "loop.last_loop_kfn": np.array(jloop.last_loop_kfn)})
    arrays.update(rr.flat("slice_m", _np(slice_m)))
    rr.save(Path(out), rr.inputs_sha256(*rr.flat("m", m).values()), arrays)


if __name__ == "__main__":
    main(*sys.argv[1:])
