"""Write tests/data/mapping_reference.npz: the reference's synchronous
`System` with the local mapper on, for tests/test_torch_mapping.py.

The reference's `System(use_loop_closing=False)` at the test's caps on the
port's frames (`_sequence()`), its `status` typed once before each frame
(so the fused step compiles once), its `_dispatch_kf_chain` wrapped to
record the state and host bookkeeping before and after each chain; then
`save_trajectory_tum`, and the same compiled chain on the test's
constructed pair of keyframes (`_pair_without_lines`), the rest of the
state as the run left it. Keys: "chain_kf_ids"; "chain<i>.pre.*" and
"chain<i>.post.*", the i-th chain's System before and after it
(`reference_runs.flat_system`); "rows.*", what the tests read after each
frame; "traj", the TUM file; "tracker.K" and "tracker.caps" (max_kf,
max_feat, max_lines, max_pts, max_maplines); "pair.*", the map the chain
made of the constructed pair, and the pair's hash
(`reference_runs.flat_call`).

    python tests/data/make_mapping_reference.py [OUT]   # ~85 s on 8 CPU cores
"""

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

import test_torch_mapping as t  # noqa: E402
from plslam_tpu.io.synthetic import SyntheticSequence as JSyntheticSequence  # noqa: E402
from plslam_tpu.system import System as JSystem  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def main(out=rr.path("mapping")):
    inputs = t._inputs(t._sequence())
    jseq = JSyntheticSequence(n_frames=t.N_FRAMES, height=240, width=320, seed=3)
    ref = JSystem(jseq.settings, use_loop_closing=False, **t.CAPS)
    chains = []
    dispatch = ref._dispatch_kf_chain

    def snapshot():
        """The state, the BoW rows and the host bookkeeping, as
        convert.system_from_numpy takes them."""
        return dict(state=_np(ref.state), kf_bow=np.array(ref._reloc.kf_bow), timestamps=list(ref._timestamps),
                    rel_poses=[r.copy() for r in ref._rel_poses], ref_ids=list(ref._ref_ids),
                    tracked=list(ref._tracked), kf_timestamps=dict(ref._kf_timestamps),
                    last_status=ref._last_status, recent_rebase=dict(ref._recent_rebase))

    def recorded(kf_id):
        pre = snapshot()
        dispatch(kf_id)
        ref._process_chain_results(block=True)  # what the synchronous System does next
        chains.append(dict(kf_id=int(kf_id), pre=pre, post=snapshot()))

    ref._dispatch_kf_chain = recorded
    rows = []
    for g, d, ts in inputs:
        # one typing of `status` keeps the fused step to one compile (the
        # step leaves it weakly typed; the value is unchanged)
        ref.state = ref.state._replace(status=jnp.asarray(int(ref.state.status)))
        rows.append(t._row(ref, ref.track_rgbd(g, d, ts)))
    with tempfile.TemporaryDirectory() as tmp:
        ref.save_trajectory_tum(Path(tmp) / "traj.txt")
        traj = (Path(tmp) / "traj.txt").read_text()

    tr = ref.tracker
    m, _ = t._pair_without_lines(tr)
    ref.state = ref.state._replace(m=jax.tree_util.tree_map(jnp.asarray, m))
    dispatch(1)
    ref._process_chain_results(block=True)

    arrays = {"chain_kf_ids": np.array([c["kf_id"] for c in chains])}
    for i, c in enumerate(chains):
        arrays.update(rr.flat_system(f"chain{i}.pre", c["pre"]))
        arrays.update(rr.flat_system(f"chain{i}.post", c["post"]))
    arrays.update(rr.flat_rows("rows", rows))
    arrays["traj"] = rr.text(traj)
    arrays["tracker.K"] = np.asarray(tr.K)
    arrays["tracker.caps"] = np.array([tr.max_kf, tr.max_feat, tr.max_lines, tr.max_pts, tr.max_maplines])
    arrays.update(rr.flat_call("pair", dict(m=m, k=1), _np(ref.state.m)))
    rr.save(Path(out), rr.frames_sha256(inputs), arrays)


if __name__ == "__main__":
    main(*sys.argv[1:])
