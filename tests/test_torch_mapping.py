"""Port parity, the keyframe chain: the reference's synchronous `System`
with the local mapper on (JAX, CPU) against the port's (PyTorch, CPU) on
one run, 320x240, `SyntheticSequence(seed=3)` with lines on, 3 frames
(each a keyframe: three chains, the second triangulating map lines), caps `max_kf=32,
max_pts=4096`, loop closing off. The reference's run is recorded:
tests/data/mapping_reference.npz, written by
tests/data/make_mapping_reference.py from these frames (the fixture
checks their SHA-256 first; the live run compiled the fused step and the
chain, ~165 s of every suite run). It records the state before and after
each chain by wrapping the instance's `_dispatch_kf_chain`, and the same
compiled chain's output on the constructed pair of keyframes below.

Tolerances, and what they rest on. Both systems get the port's frames
(`io/synthetic.py`: the reference's frames to 9.2e-5 gray levels). The
reference alone, on its own frames instead, reads per frame poses up to
3.34e-3 m and point / map-line counts 2 apart on the last frame, and a
different map after the last chain: the run is that sensitive to float32
rounding. It repeats itself bit for bit on 1, 6 and 8 cores and after a
cold compile. The port's differences are such rounding: local BA's
segment sums are exact sums rounded once (`_segsum`), the reference's
one-hot matmuls sum in float32, and the normal equations' products round
in other orders.
  * Each chain, from the reference's pre-chain state: every index, flag,
    counter, descriptor and slot the chain writes equal (validity,
    `kf_lm_idx` / `kf_ln_idx`, observation counts, the working set, the
    BoW row, the culled mask), and the floats no BA touches to 1e-5.
    Local BA's iterates agree closely through the robust phase; in the
    plain phase the LM accept test and the damping follow the rounding,
    and weakly constrained landmarks move with it. Measured here:
    keyframe poses within 5.7e-4, point positions a median of 0.15 mm and
    a 99th percentile of 1.09 mm apart, single far points up to 1.2 cm
    (1 and 4 threads read no more; the chains of a run on the reference's
    own frames up to 1.23e-3, 0.16 mm, 1.16 mm and 5 cm). Map-line endpoints are
    not compared by position: the synthetic baselines are ~2 cm, so each
    endpoint is nearly free along its back-projected plane and both BAs
    move endpoints by tens of cm there (tests/test_local_ba.py says the
    same of the reference). Held: poses to TOL_CHAIN_POSE, point positions
    median <= TOL_PT_MEDIAN and 99th percentile <= TOL_PT_P99, the
    reprojection cost of the point observations within 1%.
  * The whole run: per frame the tracking state, new-keyframe flag,
    reference keyframe and keyframe count equal; poses and landmark
    counts to TOL_RUN_POSE and TOL_RUN_COUNT. Measured here: poses within
    3.87e-3 m and counts 2 apart on the last frame (2.48e-3 m and 1 apart
    with 4 threads, 3.88e-3 m and 1 with 1), exact before it: the chains'
    rounding reaches tracking through the map lines in the joint pose
    solve, as in the reference's own reading above.
The chains triangulate map lines; no point of the run is depthless (the
synthetic depth covers every pixel) and no keyframe is culled, so the
file also holds, on constructed states: the triangulation functions on
rng inputs; LocalMapper's point triangulation on the reference's own
keyframe pair (tests/test_triangulate.py: created points, slots and rows
equal, positions and distance bands to 1e-3 relative, normals to 1e-4);
the whole chain with lines off on such a pair, against the run's own
compiled reference chain (recorded with the run); keyframe culling and capacity eviction on a map built
for their rules (every field equal); and `_rebase_aux` / `_apply_rebase`
on a map with a culled keyframe (equal; transforms to 1e-5). Local BA's
own properties are checked on the port's map as tests/test_local_ba.py
checks the reference's.

The file keeps more than 7 tests on purpose: pytest-xdist's loadfile
schedule orders files by test count, so it starts with the first six,
before tests/test_loop_e2e.py (7 tests); run after it, its port runs
would compete for the cores with that file, which alone sets the suite's
wall time."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reference_runs
from plslam_tpu.geometry import camera as jcamera
from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.slammap.state import empty_map as jempty_map
from plslam_tpu.solvers import triangulate as jtri
from plslam_tpu.system import System as JSystem
from plslam_tpu.system import _rebase_aux as j_rebase_aux
from plslam_tpu_torch import convert
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.solvers import triangulate as tri
from plslam_tpu_torch.solvers.local_ba import LocalBA
from plslam_tpu_torch.system import System, _rebase_aux

torch.set_num_threads(2)

N_FRAMES, N_CHAINS = 3, 3
TOL_CHAIN_POSE, TOL_PT_MEDIAN, TOL_PT_P99 = 2.5e-3, 5e-4, 5e-3
TOL_RUN_POSE, TOL_RUN_COUNT = 5e-3, 3
CAPS = dict(max_kf=32, max_pts=4096)
# written by the chain and compared exactly
EXACT = ("kf_valid", "kf_frame_id", "kf_seq", "kf_octave", "kf_desc", "kf_feat_valid", "kf_lm_idx", "kf_ln_idx",
         "kf_ln_valid", "kf_ln_desc", "pt_desc", "pt_valid", "pt_ref_kf", "pt_first_kf", "pt_first_seq", "pt_nobs",
         "pt_replaced", "ln_desc", "ln_valid", "ln_ref_kf", "ln_first_kf", "ln_first_seq", "ln_nobs", "n_kf",
         "n_pt", "n_ln", "next_kf_seq")
# what the point triangulation stage writes, compared exactly
STAGE_EXACT = ("kf_lm_idx", "pt_desc", "pt_valid", "pt_ref_kf", "pt_first_kf", "pt_first_seq", "pt_nobs",
               "pt_visible", "pt_found", "pt_replaced", "n_kf", "n_pt")
# the constructed map of the rebase checks: five keyframes, the one on
# frame 7 culled (its nearest survivor by frame id is frame 3's slot)
REBASE_CAPS = dict(max_kf=8, max_pts=64)
FRAME_IDS = (0, 3, 7, 12, 20)
CULLED = 2
# floats no BA touches
ROUNDING = ("kf_uv", "kf_angle", "kf_ln_obs", "kf_ln_sp", "kf_ln_ep", "pt_visible", "pt_found", "ln_visible",
            "ln_found")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _sequence():
    return SyntheticSequence(n_frames=N_FRAMES, height=240, width=320, seed=3)


def _inputs(seq):
    return [seq.frame(i) for i in range(N_FRAMES)]


def _row(slam, Tcw):
    """What the tests read of a System after one track_rgbd."""
    m = slam.state.m
    return dict(Tcw=Tcw, state=slam.get_tracking_state(), new_kf=slam.last_frame_was_kf, ref_kf=int(slam.state.ref_kf),
                n_kf=int(m.n_kf), n_pt=int(m.n_pt), n_ln=int(m.n_ln))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mapping")
    seq = _sequence()
    assert seq.settings.use_lines
    inputs = _inputs(seq)

    # the reference's run (tests/data/make_mapping_reference.py)
    z = reference_runs.load("mapping", reference_runs.frames_sha256(inputs))
    chains = [dict(kf_id=int(k), pre=reference_runs.system(z, f"chain{i}.pre"),
                   post=reference_runs.system(z, f"chain{i}.post")) for i, k in enumerate(z["chain_kf_ids"])]
    ref_rows = reference_runs.rows(z, "rows")
    (tmp / "ref_traj.txt").write_bytes(z["traj"].tobytes())
    caps = dict(zip(("max_kf", "max_feat", "max_lines", "max_pts", "max_maplines"), z["tracker.caps"].tolist()))
    # the reference tracker's constants, for the constructed pair
    ref_tracker = types.SimpleNamespace(K=z["tracker.K"], **caps,
                                        init_state=lambda: types.SimpleNamespace(m=jempty_map(**caps)))

    def ref_chain(m, k):
        """The run's compiled reference chain on map m (numpy leaves), the
        rest of the state as the run left it -> the map after it: recorded
        for the one map the tests give it."""
        return reference_runs.call(z, "pair", dict(m=m, k=k))

    got = System(seq.settings, use_loop_closing=False, device="cpu", **CAPS)
    got_rows = [_row(got, got.track_rgbd(g, d, t)) for g, d, t in inputs]
    got.save_trajectory_tum(tmp / "got_traj.txt")
    return dict(tmp=tmp, settings=seq.settings, ref=ref_rows, got=got_rows, chains=chains, got_sys=got,
                ref_tracker=ref_tracker, ref_chain=ref_chain)


def _numpy_map(m):
    return m._replace(**{f: getattr(m, f).numpy() for f in m._fields})


def _reproj_cost(m, K):
    """Sum of squared pixel residuals of every valid point observation of
    a map (numpy leaves)."""
    ok = (m.kf_lm_idx >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    k, f = np.nonzero(ok)
    X = m.pt_pos[m.kf_lm_idx[k, f]]
    T = m.kf_pose[k]
    pc = np.einsum("nij,nj->ni", T[:, :3, :3], X) + T[:, :3, 3]
    uv = pc[:, :2] / pc[:, 2:] * np.diag(K)[:2] + K[:2, 2]
    return float(np.sum((uv - m.kf_uv[k, f, :2]) ** 2))


@pytest.mark.parametrize("i", range(N_CHAINS))
def test_chain_reproduces_reference(run, i):
    """The port's keyframe chain on the reference's pre-chain state and BoW
    database gives the reference's post-chain state (tolerances above)."""
    c = run["chains"][i]
    slam = convert.system_from_numpy(System(run["settings"], use_loop_closing=False, device="cpu", **CAPS),
                                     **c["pre"])
    aux = slam._dispatch_kf_chain(c["kf_id"])
    slam._process_chain_results()
    ts, want = slam.state, c["post"]
    pre, post, got = c["pre"]["state"].m, want["state"].m, ts.m
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(post, name), err_msg=name)
    for name in ROUNDING:
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(post, name), atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(ts.local_set.numpy(), want["state"].local_set)
    np.testing.assert_array_equal(slam._reloc.kf_bow.numpy(), want["kf_bow"])
    K = slam.tracker.max_kf
    assert aux.shape == (1 + 20 * K,) and float(aux[0]) == 0.0  # the reference's layout; no loop gate here
    np.testing.assert_array_equal(aux[1:1 + K].numpy() > 0, pre.kf_valid & ~post.kf_valid)
    assert slam.aux_reads == 1
    assert slam._ref_ids == want["ref_ids"] and set(slam._recent_rebase) == set(want["recent_rebase"])
    np.testing.assert_allclose(np.array(slam._rel_poses), np.array(want["rel_poses"]), atol=1e-5)

    dp = np.linalg.norm(got.pt_pos.numpy() - post.pt_pos, axis=1)[post.pt_valid]
    Kcam = slam.tracker.K_host
    ref_cost, got_cost = _reproj_cost(post, Kcam), _reproj_cost(_numpy_map(got), Kcam)
    np.testing.assert_allclose(got.kf_pose.numpy(), post.kf_pose, atol=TOL_CHAIN_POSE)
    assert np.median(dp) <= TOL_PT_MEDIAN and np.percentile(dp, 99) <= TOL_PT_P99, (np.median(dp),
                                                                                    np.percentile(dp, 99))
    assert got_cost <= 1.01 * ref_cost + 1e-3, (got_cost, ref_cost)


def test_chains_triangulate_lines(run):
    """The run exercises line triangulation: map lines created by the
    reference's chains and bound in two keyframe rows, which the port's
    chains reproduce above. (The synthetic depth covers every pixel, so
    no point of this run is depthless and none is triangulated; the
    point path is held on constructed keyframes below.)"""
    lines = [_triangulated_lines(c["post"]["state"].m, c["kf_id"]) for c in run["chains"]]
    assert any(n > 0 for n in lines), lines


def _triangulated_lines(m, k):
    """Map lines created with keyframe k and already observed by another
    keyframe: only line triangulation binds two rows."""
    created = m.ln_valid & (m.ln_first_seq == m.kf_seq[k])
    rows = (m.kf_ln_idx >= 0) & m.kf_ln_valid & m.kf_valid[:, None]
    rows[k] = False
    seen = np.zeros_like(created)
    seen[m.kf_ln_idx[rows]] = True
    return int(np.sum(created & seen))


def test_system_run_per_frame(run):
    ref, got = run["ref"], run["got"]
    assert [r["new_kf"] for r in ref].count(True) == N_CHAINS == len(run["chains"])
    assert all(r["state"] == "OK" for r in ref)
    for i, (r, g) in enumerate(zip(ref, got)):
        for key in ("state", "new_kf", "ref_kf", "n_kf"):
            assert g[key] == r[key], (i, key, g[key], r[key])
        for key in ("n_pt", "n_ln"):
            assert abs(g[key] - r[key]) <= TOL_RUN_COUNT, (i, key, g[key], r[key])
        np.testing.assert_allclose(g["Tcw"], r["Tcw"], atol=TOL_RUN_POSE, err_msg=f"frame {i}")
    slam = run["got_sys"]
    assert slam.aux_reads == N_CHAINS and slam.telemetry_reads == N_FRAMES


def test_trajectory_files_match(run):
    def rows(who):
        return np.array([[float(v) for v in ln.split()]
                         for ln in (run["tmp"] / f"{who}_traj.txt").read_text().strip().splitlines()])

    ref, got = rows("ref"), rows("got")
    assert got.shape == ref.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], atol=TOL_RUN_POSE)


# ---------------------------------------------------- triangulation
def _two_views(rng, n, baseline):
    K = np.array([[520.0, 0, 320], [0, 520, 240], [0, 0, 1]], np.float32)
    pw = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(5, 12, n)].astype(np.float32)
    xi = np.array([baseline, 0.05, 0.01, 0.01, -0.02, 0.005], np.float32)
    T1, T2 = np.eye(4, dtype=np.float32), np.array(jse3.exp(jnp.asarray(xi)))
    uv = [np.array(jcamera.project(jnp.asarray(K), jse3.transform(jnp.asarray(T), jnp.asarray(pw))))
          for T in (T1, T2)]
    # the second view's observations off by up to a pixel: some pairs fail
    uv[1] = uv[1] + rng.uniform(-1.0, 1.0, uv[1].shape).astype(np.float32)
    return K, T1, T2, uv[0], uv[1]


def test_epipolar_gate_matches_reference(rng):
    K, T1, T2, uv1, uv2 = _two_views(rng, 40, 0.3)
    F_ref = np.array(jtri.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K)))
    F = tri.fundamental_from_poses(torch.from_numpy(T1), torch.from_numpy(T2), torch.from_numpy(K))
    np.testing.assert_allclose(F.numpy(), F_ref, rtol=1e-4, atol=1e-9)
    D_ref = np.asarray(jtri.epipolar_distance(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(F_ref)))
    D = tri.epipolar_distance(torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(F_ref)).numpy()
    np.testing.assert_allclose(D, D_ref, rtol=1e-4, atol=1e-3)
    assert np.abs(np.diag(D)).max() < 2.0


@pytest.mark.parametrize("baseline", [0.3, 0.003])  # a real baseline; ~zero parallax (all rejected)
def test_midpoint_and_checks_match_reference(rng, baseline):
    K, T1, T2, uv1, uv2 = _two_views(rng, 50, baseline)
    isig = np.linspace(0.3, 1.0, 50).astype(np.float32)
    j = [jnp.asarray(a) for a in (T1, T2, K, uv1, uv2)]
    pw_ref, par_ref = jtri.triangulate_midpoint(*j)
    ok_ref = np.asarray(jtri.triangulation_checks(*j, pw_ref, par_ref, jnp.asarray(isig), jnp.asarray(isig)))
    t = [torch.from_numpy(a) for a in (T1, T2, K, uv1, uv2)]
    pw, par = tri.triangulate_midpoint(*t)
    np.testing.assert_allclose(pw.numpy(), np.asarray(pw_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(par.numpy(), np.asarray(par_ref), atol=1e-6)
    ok = tri.triangulation_checks(*t, torch.from_numpy(np.array(pw_ref)), torch.from_numpy(np.array(par_ref)),
                                  torch.from_numpy(isig), torch.from_numpy(isig)).numpy()
    np.testing.assert_array_equal(ok, ok_ref)
    assert ok.any() == (baseline > 0.1)


def test_triangulation_stage_matches_reference(rng):
    """LocalMapper's point triangulation on the reference's own constructed
    pair (tests/test_triangulate.py: a 30 cm baseline, 120 depthless far
    points, 30 shared landmarks for covisibility), reference stage against
    the port's: the created points, their slots and both keyframe rows
    equal; positions and distance bands to 1e-3 relative (points 6-12 m
    away seen over 30 cm: the midpoint's 2x2 system cancels, and float32
    rounding reaches 2.8e-4 relative here), normals to 1e-4."""
    from plslam_tpu.config import Settings as JSettings
    from plslam_tpu.pipeline.mapping import LocalMapper as JLocalMapper
    from plslam_tpu.pipeline.tracking import Tracker as JTracker
    from plslam_tpu_torch.config import Settings
    from plslam_tpu_torch.pipeline.mapping import LocalMapper

    cam = dict(fx=520, fy=520, cx=320, cy=240, k1=0, k2=0, p1=0, p2=0, k3=0, width=640, height=480, bf=40.0,
               depth_map_factor=1.0)
    caps = dict(max_kf=8, max_pts=1024, max_feat=256)
    jtr = JTracker(JSettings(**cam), **caps)
    K = np.asarray(jtr.K)
    n = 120
    pw = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(6, 12, n)].astype(np.float32)
    desc = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    T = [np.eye(4, dtype=np.float32),
         np.asarray(jse3.exp(jnp.asarray([0.3, 0.0, 0.0, 0.0, -0.02, 0.0], dtype=jnp.float32)))]
    m = _np(jtr.init_state().m)
    pad = caps["max_feat"] - n
    for kf in (0, 1):
        uv = np.asarray(jcamera.project(jnp.asarray(K), jse3.transform(jnp.asarray(T[kf]), jnp.asarray(pw))))
        m.kf_pose[kf] = T[kf]
        m.kf_valid[kf] = True
        m.kf_uv[kf] = np.pad(np.concatenate([uv, -np.ones((n, 1), np.float32)], -1), ((0, pad), (0, 0)))  # no depth
        m.kf_desc[kf] = np.pad(desc, ((0, pad), (0, 0)))
        m.kf_feat_valid[kf, :n] = True
        m.kf_lm_idx[kf, :30] = np.arange(30)
    m.pt_valid[:30] = True
    m = m._replace(n_kf=np.int32(2), n_pt=np.int32(30))

    want = _np(JLocalMapper(jtr, enable_ba=False, enable_fuse=False, enable_kf_culling=False)._triangulate(
        jax.tree_util.tree_map(jnp.asarray, m), jnp.int32(1)))
    tr = tracking.Tracker(Settings(**cam), device="cpu", **caps)
    got = LocalMapper(tr, enable_ba=False, enable_fuse=False, enable_kf_culling=False)._triangulate_impl(
        convert.map_state_from_numpy(m, "cpu"), torch.tensor(1))
    assert int(want.n_pt) - 30 > 50  # the reference's own test's bar
    for name in STAGE_EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), err_msg=name)
    for name in ("pt_pos", "pt_dist"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(got.pt_normal.numpy(), want.pt_normal, atol=1e-4)


# ---------------------------------- point-only chain, culling, eviction
# the constructed pair of test_chain_without_lines_matches_reference: the
# landmarks both keyframes already share
PAIR_SHARED = 30


def _pair_without_lines(jtr):
    """Two constructed keyframes 30 cm apart for the reference tracker's
    caps (numpy leaves), and the second's pose as tracking left it."""
    K = np.asarray(jtr.K)
    rng = np.random.default_rng(11)
    n, shared = 120, PAIR_SHARED
    z = rng.uniform(6, 12, n)
    pw = np.c_[z * rng.uniform(-0.25, 0.25, n), z * rng.uniform(-0.18, 0.18, n), z].astype(np.float32)
    desc = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    T = [np.eye(4, dtype=np.float32),
         np.asarray(jse3.exp(jnp.asarray([0.3, 0.0, 0.0, 0.0, -0.02, 0.0], dtype=jnp.float32)))]
    # the second keyframe's pose as tracking left it: 1 cm and 0.1 degree off
    T_est = np.asarray(jse3.exp(jnp.asarray([0.31, 0.0, 0.0, 0.0, -0.0217, 0.0], dtype=jnp.float32)))
    m = _np(jtr.init_state().m)
    for kf in (0, 1):
        uv = np.asarray(jcamera.project(jnp.asarray(K), jse3.transform(jnp.asarray(T[kf]), jnp.asarray(pw))))
        m.kf_pose[kf], m.kf_valid[kf], m.kf_frame_id[kf], m.kf_seq[kf] = (T[kf], T_est)[kf], True, 5 * kf, kf
        m.kf_uv[kf, :n] = np.concatenate([uv, -np.ones((n, 1), np.float32)], -1)  # no depth
        m.kf_desc[kf, :n] = desc
        m.kf_feat_valid[kf, :n] = True
        m.kf_lm_idx[kf, :shared] = np.arange(shared)
    d = np.linalg.norm(pw[:shared], axis=1)
    m.pt_pos[:shared], m.pt_desc[:shared], m.pt_valid[:shared] = pw[:shared], desc[:shared], True
    m.pt_normal[:shared] = pw[:shared] / d[:, None]
    m.pt_dist[:shared] = np.stack([0.5 * d, 2.0 * d], -1)
    m.pt_nobs[:shared], m.pt_visible[:shared], m.pt_found[:shared] = 2, 2.0, 2.0
    m = m._replace(n_kf=np.int32(2), n_pt=np.int32(shared), next_kf_seq=np.int32(2))
    return m, T_est


def test_chain_without_lines_matches_reference(run):
    """`process` on the mapper of a System whose settings have lines off
    (the branch `System(load_settings("configs/TUM1.yaml"))` takes), on
    two constructed keyframes 30 cm apart, the second's pose 1 cm off: 30
    shared landmarks with their positions, normals and distance bands, and
    90 depthless far points seen by both, which the chain triangulates
    before local BA moves them and the second pose.
    The reference is the run's own compiled chain (lines on): on a map
    without lines its line stages change nothing. Every
    index, flag and count equal; poses and positions to the chain
    tolerances above (measured: 90 points created, the second pose moved
    9.3 mm; poses within 8.6e-6, positions within 0.13 mm)."""
    from plslam_tpu_torch.pipeline.mapping import LocalMapper

    jtr = run["ref_tracker"]
    shared = PAIR_SHARED
    m, T_est = _pair_without_lines(jtr)

    want = run["ref_chain"](m, 1)
    settings = dataclasses.replace(run["settings"], use_lines=False)
    tr = tracking.Tracker(settings, device="cpu", max_kf=jtr.max_kf, max_pts=jtr.max_pts, max_feat=jtr.max_feat,
                          max_lines=jtr.max_lines, max_maplines=jtr.max_maplines)
    mapper = LocalMapper(tr)
    assert not mapper._lines
    got = mapper.process(convert.map_state_from_numpy(m, "cpu"), 1)
    assert int(want.n_pt) - shared > 40 and not want.ln_valid.any()
    assert np.abs(want.kf_pose[1] - T_est).max() > 1e-3  # local BA moved the second keyframe
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), err_msg=name)
    dp = np.linalg.norm(got.pt_pos.numpy() - want.pt_pos, axis=1)[want.pt_valid]
    np.testing.assert_allclose(got.kf_pose.numpy(), want.kf_pose, atol=TOL_CHAIN_POSE)
    assert np.median(dp) <= TOL_PT_MEDIAN and np.percentile(dp, 99) <= TOL_PT_P99, (np.median(dp),
                                                                                    np.percentile(dp, 99))


# the constructed map of the culling and eviction checks: the points each
# keyframe slot observes; k = 5 is the fresh keyframe. Slots 1 and 3 are
# redundant (28 of their 30 points seen by >= 4 keyframes), slot 2 is not
# (20 of 30), slot 4 shares no point with k; 6 and 7 fill the ring.
CULL_CAPS = dict(max_kf=8, max_feat=32, max_lines=4, max_pts=128, max_maplines=8)
CULL_ROWS = {0: range(30), 1: range(30), 2: [*range(20), *range(60, 70)], 3: [*range(28), 70, 71],
             4: range(80, 110), 5: range(30), 6: range(110, 128), 7: [*range(15), *range(60, 75)]}
CULL_K = 5


def _ring(n_valid):
    """The culling map (numpy leaves) with slots [0, n_valid) valid; point
    and line references point into slots 1 and 3, some with a surviving
    observer, some without; every other observation stereo."""
    m = jax.tree_util.tree_map(np.array, jempty_map(**CULL_CAPS))
    for slot in range(n_valid):
        ids = np.asarray(CULL_ROWS[slot])
        m.kf_valid[slot], m.kf_frame_id[slot], m.kf_seq[slot] = True, 4 * slot, slot
        m.kf_lm_idx[slot, :len(ids)] = ids
        m.kf_feat_valid[slot, :len(ids)] = True
        m.kf_uv[slot, :len(ids), 2] = np.where(np.arange(len(ids)) % 2 == 0, 12.0, -1.0)
    m.pt_valid[:] = True
    m.pt_ref_kf[:] = 0
    m.pt_ref_kf[0:10], m.pt_ref_kf[60:65], m.pt_ref_kf[10:15], m.pt_ref_kf[70:72] = 1, 1, 3, 3
    m.pt_ref_kf[80:90] = 4
    for slot, lns in {1: (0, 2), 3: (1,), CULL_K: (0, 1, 3), 4: (3,)}.items():
        if slot < n_valid:
            m.kf_ln_idx[slot, :len(lns)] = lns
            m.kf_ln_valid[slot, :len(lns)] = True
    m.ln_valid[:4] = True
    m.ln_ref_kf[:4] = (1, 3, 1, 4)
    m.ln_nobs[:4] = 4
    return m._replace(n_kf=np.int32(n_valid), n_pt=np.int32(128), n_ln=np.int32(4), next_kf_seq=np.int32(n_valid))


def _mappers():
    """The reference's LocalMapper and the port's on the culling caps."""
    from plslam_tpu.config import Settings as JSettings
    from plslam_tpu.pipeline.mapping import LocalMapper as JLocalMapper
    from plslam_tpu.pipeline.tracking import Tracker as JTracker
    from plslam_tpu_torch.config import Settings
    from plslam_tpu_torch.pipeline.mapping import LocalMapper

    cam = dict(fx=520, fy=520, cx=320, cy=240, k1=0, k2=0, p1=0, p2=0, k3=0, width=640, height=480, bf=40.0,
               depth_map_factor=1.0)
    off = dict(enable_ba=False, enable_fuse=False, enable_kf_culling=False)
    return (JLocalMapper(JTracker(JSettings(**cam), **CULL_CAPS), **off),
            LocalMapper(tracking.Tracker(Settings(**cam), device="cpu", **CULL_CAPS), **off))


def _assert_maps_equal(got, want):
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), err_msg=name)


def test_kf_cull_stage_matches_reference():
    """KeyFrameCulling on the constructed map: slots 1 and 3 culled, their
    rows dropped, point and line references re-anchored to the first
    surviving observer (kept where none survives), counts re-derived;
    every field equal to the reference's."""
    jmapper, mapper = _mappers()
    m = _ring(CULL_K + 1)
    want = _np(jax.jit(jmapper._kf_cull_impl)(jax.tree_util.tree_map(jnp.asarray, m), jnp.int32(CULL_K)))
    got = mapper._kf_cull_impl(convert.map_state_from_numpy(m, "cpu"), torch.tensor(CULL_K))
    assert list(np.nonzero(m.kf_valid & ~want.kf_valid)[0]) == [1, 3]
    assert set(want.pt_ref_kf[[0, 60, 10, 70]]) == {0, 2, 3}  # re-anchored, re-anchored, re-anchored, kept
    _assert_maps_equal(got, want)


@pytest.mark.parametrize("full", [True, False])
def test_ensure_free_slot_matches_reference(full):
    """Capacity eviction: with the ring full, the keyframe sharing the
    fewest points with k goes (slots 4 and 6 tie at none: the lower, 4),
    its references re-anchored and counts re-derived; with a free slot
    nothing changes. Every field equal to the reference's."""
    jmapper, mapper = _mappers()
    m = _ring(8 if full else 7)
    want = _np(jax.jit(jmapper._ensure_free_slot_impl)(jax.tree_util.tree_map(jnp.asarray, m),
                                                          jnp.int32(CULL_K)))
    got = mapper._ensure_free_slot_impl(convert.map_state_from_numpy(m, "cpu"), torch.tensor(CULL_K))
    assert list(np.nonzero(m.kf_valid & ~want.kf_valid)[0]) == ([4] if full else [])
    _assert_maps_equal(got, want)


# ----------------------------------------------------------- rebase
def _culled_state():
    """A small map (numpy leaves) with CULLED invalidated after the fact,
    and the valid mask before."""
    rng = np.random.default_rng(4)
    m = jax.tree_util.tree_map(np.array, jempty_map(max_kf=REBASE_CAPS["max_kf"], max_feat=16, max_lines=4,
                                                    max_pts=REBASE_CAPS["max_pts"], max_maplines=8))
    for slot, fid in enumerate(FRAME_IDS):
        xi = rng.normal(0, [0.5, 0.5, 0.5, 0.2, 0.2, 0.2]).astype(np.float32)
        m.kf_pose[slot] = np.array(jse3.exp(jnp.asarray(xi)))
        m.kf_frame_id[slot] = fid
        m.kf_valid[slot] = True
    prev = m.kf_valid.copy()
    m.kf_valid[CULLED] = False
    return m, prev


def test_rebase_aux_matches_reference():
    m, prev = _culled_state()
    culled_r, p_of_r, M_r = j_rebase_aux(jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(prev))
    culled, p_of, M = _rebase_aux(convert.map_state_from_numpy(m, "cpu"), torch.from_numpy(prev))
    np.testing.assert_array_equal(culled.numpy(), np.asarray(culled_r))
    assert culled.numpy().sum() == 1 and culled.numpy()[CULLED]
    np.testing.assert_array_equal(p_of.numpy(), np.asarray(p_of_r))
    assert int(p_of[CULLED]) == 1
    np.testing.assert_allclose(M.numpy(), np.asarray(M_r), atol=1e-5)


def test_apply_rebase_matches_reference():
    """_apply_rebase re-anchors the rows of the culled slot as the
    reference's does; a later row that references it is rebased by
    _finalize_row through _recent_rebase, and reset() forgets it."""
    m, prev = _culled_state()
    culled, p_of, M = (np.asarray(a) for a in j_rebase_aux(jax.tree_util.tree_map(jnp.asarray, m),
                                                             jnp.asarray(prev)))
    rng = np.random.default_rng(5)
    ref_ids = [int(r) for r in rng.choice(np.nonzero(prev)[0], 12)] + [CULLED]
    rel = [np.eye(4) + 0.01 * rng.normal(size=(4, 4)) for _ in ref_ids]

    def book():
        return types.SimpleNamespace(_ref_ids=list(ref_ids), _rel_poses=[r.copy() for r in rel], _recent_rebase={})

    want, got = book(), book()
    JSystem._apply_rebase(want, culled, p_of.astype(np.int64), M.reshape(-1, 4, 4).astype(np.float64))
    System._apply_rebase(got, culled, p_of.astype(np.int64), M.reshape(-1, 4, 4).astype(np.float64))
    assert got._ref_ids == want._ref_ids and CULLED not in got._ref_ids
    for a, b in zip(got._rel_poses, want._rel_poses):
        np.testing.assert_array_equal(a, b)
    assert set(got._recent_rebase) == set(want._recent_rebase) == {CULLED}

    seq = SyntheticSequence(n_frames=1, height=240, width=320, seed=3)
    slam = System(seq.settings, use_loop_closing=False, device="cpu", **REBASE_CAPS)
    slam._recent_rebase = dict(got._recent_rebase)
    v = np.zeros(tracking.TEL_KF_VALID + REBASE_CAPS["max_kf"], np.float32)
    v[tracking.TEL_TRACKED], v[tracking.TEL_STATUS], v[tracking.TEL_REF_KF] = 1, tracking.ST_OK, CULLED
    v[tracking.TEL_REL_POSE] = np.eye(4, dtype=np.float32).reshape(-1)
    v[tracking.TEL_TCW] = np.eye(4, dtype=np.float32).reshape(-1)
    slam._finalize_row(v, None, 1.0, 0.0)
    p, Mj = got._recent_rebase[CULLED]
    assert slam._ref_ids == [p]
    np.testing.assert_array_equal(slam._rel_poses[0], Mj)
    slam.reset()
    assert slam._recent_rebase == {}


# -------------------------------------------- local BA, port only
@pytest.fixture(scope="module")
def tracked_map(run):
    """The port System's map at the end of the run (mapper and BA on)."""
    slam = run["got_sys"]
    return slam.tracker, slam.state.m


def _mean_sq_reproj(tr, m):
    K = tr.K_host
    mm = m._replace(**{f: getattr(m, f).numpy() for f in m._fields})
    n = int(np.sum((mm.kf_lm_idx >= 0) & mm.kf_feat_valid & mm.kf_valid[:, None]))
    return _reproj_cost(mm, K) / max(n, 1)


def test_local_ba_reduces_reprojection_error(tracked_map):
    tr, m = tracked_map
    rng = np.random.default_rng(0)
    n_kf = int(m.n_kf)
    poses = m.kf_pose.clone()
    poses[1:n_kf, :3, 3] += torch.from_numpy(rng.normal(0, 0.01, (n_kf - 1, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(0, 0.01, tuple(m.pt_pos.shape)).astype(np.float32))
    pts = m.pt_pos + noise * m.pt_valid[:, None]
    m_pert = m._replace(kf_pose=poses, pt_pos=pts)
    m_opt = LocalBA(tr, window=8, fixed=8, local_pts=2048).run(m_pert, n_kf - 1)
    before, after = _mean_sq_reproj(tr, m_pert), _mean_sq_reproj(tr, m_opt)
    assert after < 0.2 * before, (before, after)


def test_local_ba_noop_on_converged_map_and_gauge_fixed(tracked_map):
    tr, m = tracked_map
    m_opt = LocalBA(tr, window=8, fixed=8, local_pts=2048).run(m, int(m.n_kf) - 1)
    assert torch.isfinite(m_opt.pt_pos).all()
    assert float((m_opt.kf_pose - m.kf_pose).abs().max()) < 0.05  # poses move a few cm at most
    assert torch.equal(m_opt.kf_pose[0], m.kf_pose[0])  # keyframe 0 is the gauge


def _with_lines(tr, m, rng, n_lines=6):
    """Ground-truth 3D lines and their 2D observations in every keyframe,
    in place of the tracker's own lines (tests/test_local_ba.py)."""
    K = tr.K_host
    n_kf = int(m.n_kf)
    kf_ln_obs = m.kf_ln_obs.clone()
    kf_ln_idx = torch.full_like(m.kf_ln_idx, -1)
    kf_ln_valid = torch.zeros_like(m.kf_ln_valid)
    sw = rng.normal(0, 0.4, (n_lines, 3)) + np.array([0.0, 0.0, 3.0])
    ew = sw + rng.normal(0, 0.6, (n_lines, 3))
    for i in range(n_kf):
        T = m.kf_pose[i].numpy().astype(np.float64)
        for q in range(n_lines):
            ps, pe = T[:3, :3] @ sw[q] + T[:3, 3], T[:3, :3] @ ew[q] + T[:3, 3]
            if ps[2] < 0.1 or pe[2] < 0.1:
                continue
            ln = np.cross(K @ (ps / ps[2]), K @ (pe / pe[2]))
            kf_ln_obs[i, q] = torch.from_numpy((ln / np.linalg.norm(ln[:2])).astype(np.float32))
            kf_ln_idx[i, q] = q
            kf_ln_valid[i, q] = True
    ln_valid = torch.zeros_like(m.ln_valid)
    ln_valid[:n_lines] = True
    ln_sw, ln_ew = m.ln_sw.clone(), m.ln_ew.clone()
    ln_sw[:n_lines] = torch.from_numpy(sw.astype(np.float32))
    ln_ew[:n_lines] = torch.from_numpy(ew.astype(np.float32))
    return m._replace(kf_ln_obs=kf_ln_obs, kf_ln_idx=kf_ln_idx, kf_ln_valid=kf_ln_valid, ln_sw=ln_sw, ln_ew=ln_ew,
                      ln_valid=ln_valid, n_ln=torch.tensor(n_lines, dtype=torch.int32))


def test_local_ba_perturbed_line_converges(tracked_map):
    """The point-to-2D-line pixel residual of perturbed endpoints collapses
    (the reference's own test: 50x); the point map stays finite."""
    tr, m = tracked_map
    rng = np.random.default_rng(7)
    m = _with_lines(tr, m, rng)
    pert = torch.from_numpy(rng.normal(0, 0.05, (6, 3)).astype(np.float32))
    ln_sw, ln_ew = m.ln_sw.clone(), m.ln_ew.clone()
    ln_sw[:6] += pert
    ln_ew[:6] -= pert
    m_pert = m._replace(ln_sw=ln_sw, ln_ew=ln_ew)
    m_opt = LocalBA(tr, window=8, fixed=8, local_pts=2048, local_lines=16).run(m_pert, int(m.n_kf) - 1)
    K = tr.K_host

    def px_resid(mm):
        tot, cnt = 0.0, 0
        for i in range(int(mm.n_kf)):
            T = mm.kf_pose[i].numpy()
            for q in range(6):
                if int(mm.kf_ln_idx[i, q]) < 0:
                    continue
                ln = mm.kf_ln_obs[i, q].numpy()
                for X in (mm.ln_sw[q].numpy(), mm.ln_ew[q].numpy()):
                    P = T[:3, :3] @ X + T[:3, 3]
                    tot += abs(ln @ (K @ (P / P[2])))
                    cnt += 1
        return tot / max(cnt, 1)

    before, after = px_resid(m_pert), px_resid(m_opt)
    assert before > 5.0
    assert after < before / 50.0, (before, after)
    assert torch.isfinite(m_opt.pt_pos).all()
