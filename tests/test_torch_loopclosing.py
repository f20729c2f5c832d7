"""Port parity, loop closing: the JAX reference (CPU) against the port's
plain path (PyTorch, CPU) for `geometry/sim3.py`, `solvers/sim3_solver.py`
(RANSAC and OptimizeSim3), `solvers/pose_graph.py`, `solvers/local_ba.py` in
global mode and `pipeline/loopclosing.py::LoopCloser`, plus a few frames of
the port's `System` with loop closing on.

The reference pieces run jitted at small capacities on one constructed map
(no reference `System`, step or chain): sixteen keyframe slots, thirteen of
them valid. Keyframes 0-9 walk along a wall of 420 textured points at
their true poses; keyframes 10-12 revisit the start, but their map holds
drifted copies (a 2 degree, 13 cm world transform) of the points they see,
with the original descriptors, and poses consistent with those copies. So
loop detection finds the start group on three consecutive keyframes and
closing keyframe 12 onto it must undo the drift and fuse the copies away.
The essential graph runs ESSENTIAL_GRAPH_ITERS = 1 iteration in both
packages here (each unrolled reference iteration costs ~7 s of compile on
one core); the drift it removes is asserted all the same.

Tolerances: Sim3 exp/log/compose/inverse within 2e-6 (float32 rounding of
the same formulas), the essential graph's Jacobians at xi = 0 within 1e-6
and finite; RANSAC: the same `ok`, inlier set and count, R and t within
1e-5; OptimizeSim3: the same inliers, R within 1e-5, t within 1e-4 (LM
steps solved by another LAPACK call); essential graph and landmark
correction within 1e-4 (dense 7K solves in another summation order); the
detect gate's flags, candidate masks, groups and consistency counts equal,
scores within 1e-6; a whole closure: the same outcome, loop edge, queue and
every index and flag of the map (`kf_lm_idx`, `pt_valid`, `pt_replaced`,
counts), poses and points within 1e-4 (the port's supporter count, which
the reference does not keep, above the gate); one
global-BA slice from the closed map (the chi2 gate, the plain phase and
the erase sweep): indices equal, poses within 1e-4, points within 1e-3 (LM on
a 420-point map in float32, sums in another order).

The reference's gate over keyframes 10-12, its closure of keyframe 12 and
its global-BA slice are recorded: tests/data/loopclosing_reference.npz,
written by tests/data/make_loopclosing_reference.py from the constructed
map (the fixture checks its SHA-256 first; compiling them took ~45 s of
every suite run). The reference's solvers (RANSAC, OptimizeSim3, the
essential graph) and the Sim3 group run live, each jitted once at the
closure's shapes."""

import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import plslam_tpu.constants as JC
import reference_runs
from plslam_tpu.config import Settings as JSettings
from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.geometry import sim3 as jsim3
from plslam_tpu.pipeline.loopclosing import LoopCloser as JLoopCloser
from plslam_tpu.pipeline.tracking import Tracker as JTracker
from plslam_tpu.slammap.state import empty_map as jempty_map
from plslam_tpu.solvers import pose_graph as jpg
import plslam_tpu_torch.constants as PC
from plslam_tpu_torch import convert
from plslam_tpu_torch.config import Settings
from plslam_tpu_torch.geometry import sim3
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.pipeline.loopclosing import LoopCloser
from plslam_tpu_torch.pipeline.tracking import Tracker
from plslam_tpu_torch.solvers import pose_graph, sim3_solver
from plslam_tpu_torch.solvers.local_ba import LocalBA
from plslam_tpu_torch.system import System

torch.set_num_threads(2)

CAPS = dict(max_kf=16, max_pts=512, max_feat=256, max_lines=8, max_maplines=64)
CAM = dict(fx=520.0, fy=520.0, cx=159.5, cy=119.5, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=320,
           height=240, bf=40.0, depth_map_factor=1.0, fps=10.0)
EG_ITERS = 1
N_KF, LOOP_KFS, CLOSE_K = 13, (10, 11, 12), 12
MAP_EXACT = ("kf_valid", "kf_lm_idx", "kf_ln_idx", "pt_valid", "pt_replaced", "pt_nobs", "pt_ref_kf", "ln_valid",
             "n_kf", "n_pt", "n_ln")
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (a writable copy)


@functools.cache
def _ref_loop():
    """The reference's LoopCloser at the fixture's capacities, for its
    solvers."""
    return JLoopCloser(JTracker(JSettings(**CAM), **CAPS))


@functools.cache
def _ref_sim3_ops():
    """The reference's exp, log of exp, compose and inverse, one program."""
    def f(xi, xi2):
        a, b = jsim3.exp(xi), jsim3.exp(xi2)
        return a, jsim3.log(a), jsim3.compose(a, b), jsim3.inverse(a), jsim3.to_se3(a)
    return jax.jit(f)


@functools.cache
def _ref_res_and_jac():
    """The reference's residual and its jacfwd at xi = 0, over a batch of pairs."""
    z = jnp.zeros(7)
    one = lambda *a: (jpg._residual(z, z, a[0:3], a[3:6], a[6:9]),  # noqa: E731
                      *jax.jacfwd(jpg._residual, argnums=(0, 1))(z, z, a[0:3], a[3:6], a[6:9]))
    return jax.jit(jax.vmap(one))


def _twc(c, yaw=0.0):
    """Camera-to-world pose: centre c, a yaw about y."""
    T_ = np.eye(4)
    cy, sy = np.cos(yaw), np.sin(yaw)
    T_[:3, :3] = [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]
    T_[:3, 3] = c
    return T_


def _build_map(rng):
    """The constructed map (numpy, the reference's field names); see the
    module docstring."""
    m = {k: np.array(v) for k, v in jempty_map(CAPS["max_kf"], CAPS["max_feat"], CAPS["max_lines"], CAPS["max_pts"],
                                               CAPS["max_maplines"])._asdict().items()}
    K = np.array([[CAM["fx"], 0, CAM["cx"]], [0, CAM["fy"], CAM["cy"]], [0, 0, 1]])
    n_wall = 420
    pts = np.stack([rng.uniform(-1.4, 4.6, n_wall), rng.uniform(-0.9, 0.9, n_wall), rng.uniform(2.0, 3.4, n_wall)], -1)
    desc = rng.integers(0, 256, (n_wall, 32), dtype=np.uint8)
    true_wc = [_twc((0.05 * i, 0.01 * (i % 2), 0.0), 0.004 * i) for i in range(4)]
    true_wc += [_twc((0.2 + 0.42 * (i - 3), 0.0, 0.0), 0.01) for i in range(4, 10)]
    true_wc += [_twc((0.03, 0.0, 0.0)), _twc((0.09, 0.01, 0.0)), _twc((0.05, -0.01, 0.0))]
    ang = np.deg2rad(2.0)
    D = np.eye(4)  # the drift of the revisit's copies: a world transform
    D[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    D[:3, 3] = (0.12, -0.05, 0.04)
    copy_of = {}  # wall point -> its drifted copy's slot
    n_pt = n_wall
    obs_count = np.zeros(CAPS["max_pts"], np.int64)
    pos = np.zeros((CAPS["max_pts"], 3))
    pos[:n_wall] = pts
    pdesc = np.zeros((CAPS["max_pts"], 32), np.uint8)
    pdesc[:n_wall] = desc
    first = np.full(CAPS["max_pts"], -1)
    for k, Twc in enumerate(true_wc):
        Tcw = np.linalg.inv(Twc)
        pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
        uv = pc[:, :2] / pc[:, 2:] * [CAM["fx"], CAM["fy"]] + [CAM["cx"], CAM["cy"]]
        seen = np.where((pc[:, 2] > 0.5) & (uv[:, 0] > 8) & (uv[:, 0] < 312) & (uv[:, 1] > 8) & (uv[:, 1] < 232))[0]
        if k in (10, 11):  # the revisit's neighbours see part of it: their BoW scores stay below the start's
            seen = seen[rng.uniform(size=len(seen)) < 0.55]
        elif k < 4:
            seen = seen[rng.uniform(size=len(seen)) < 0.9]
        seen = seen[: CAPS["max_feat"]]
        ids = seen
        if k >= 10:  # the revisit's map holds drifted copies
            ids = []
            for p in seen:
                if p not in copy_of:
                    copy_of[p] = n_pt
                    pos[n_pt] = D[:3, :3] @ pts[p] + D[:3, 3]
                    pdesc[n_pt] = desc[p]
                    n_pt += 1
                ids.append(copy_of[p])
            ids = np.array(ids)
            Tcw = Tcw @ np.linalg.inv(D)  # consistent with the copies
        n = len(ids)
        u = uv[seen] + rng.normal(0, 0.3, (n, 2))
        m["kf_uv"][k, :n] = np.c_[u, u[:, 0] - CAM["bf"] / pc[seen, 2]]
        m["kf_desc"][k, :n] = desc[seen]
        m["kf_feat_valid"][k, :n] = True
        m["kf_lm_idx"][k, :n] = ids
        m["kf_pose"][k] = Tcw
        m["kf_valid"][k] = True
        m["kf_frame_id"][k] = 10 * k
        m["kf_seq"][k] = k
        obs_count[ids] += 1
        first[ids] = np.where(first[ids] < 0, k, first[ids])
        if k < 2:  # map lines along the wall's start, seen by keyframes 0 and 1
            L = 6
            sw = np.stack([np.linspace(-0.6, 0.5, L), np.full(L, -0.4), np.full(L, 2.6)], -1)
            ew = sw + [0.05, 0.6, 0.1]
            sp = (sw @ Tcw[:3, :3].T + Tcw[:3, 3])
            ep = (ew @ Tcw[:3, :3].T + Tcw[:3, 3])
            sp = sp[:, :2] / sp[:, 2:] * [CAM["fx"], CAM["fy"]] + [CAM["cx"], CAM["cy"]]
            ep = ep[:, :2] / ep[:, 2:] * [CAM["fx"], CAM["fy"]] + [CAM["cx"], CAM["cy"]]
            l2 = np.cross(np.c_[sp, np.ones(L)], np.c_[ep, np.ones(L)])
            m["kf_ln_obs"][k, :L] = l2 / np.linalg.norm(l2[:, :2], axis=1, keepdims=True)
            m["kf_ln_sp"][k, :L], m["kf_ln_ep"][k, :L] = sp, ep
            m["kf_ln_idx"][k, :L] = np.arange(L)
            m["kf_ln_valid"][k, :L] = True
            m["ln_sw"][:L], m["ln_ew"][:L] = sw, ew
            m["ln_valid"][:L] = True
            m["ln_nobs"][:L] = 2 * (k + 1)
            m["ln_normal"][:L] = [0, 0, 1]
            m["ln_dist"][:L] = [0.3, 4.0]
    valid = obs_count > 0
    cen = np.array([Twc[:3, 3] for Twc in true_wc])[np.clip(first, 0, None)]
    d = np.linalg.norm(pos - cen, axis=1)
    m["pt_pos"] = pos
    m["pt_desc"] = pdesc
    m["pt_normal"] = (pos - cen) / np.maximum(d, 1e-6)[:, None]
    m["pt_dist"] = np.stack([1.1 * d / 1.2**7, 1.1 * d], -1)
    m["pt_valid"] = valid
    m["pt_ref_kf"] = np.clip(first, 0, None)
    m["pt_first_kf"] = np.clip(first, 0, None)
    m["pt_first_seq"] = np.clip(first, 0, None)
    m["pt_nobs"] = 2 * obs_count
    m["pt_visible"] = m["pt_found"] = np.maximum(obs_count, 1).astype(np.float32)
    m["n_kf"], m["n_pt"], m["n_ln"], m["next_kf_seq"] = N_KF, int(valid.sum()), int(m["ln_valid"].sum()), N_KF
    dtypes = {k: np.asarray(v).dtype for k, v in jempty_map(1, 1, 1, 1, 1)._asdict().items()}
    return {k: np.asarray(v, dtypes[k]) for k, v in m.items()}


def _world_map():
    return _build_map(np.random.default_rng(7))


@pytest.fixture(scope="module")
def world():
    """Both packages' loop closers on the constructed map; the reference's
    gate over keyframes 10-12, its closure of 12, and one global-BA slice
    from the closed map (recorded: tests/data/make_loopclosing_reference.py)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JC, "ESSENTIAL_GRAPH_ITERS", EG_ITERS)
    mp.setattr(PC, "ESSENTIAL_GRAPH_ITERS", EG_ITERS)
    m = _world_map()
    z = reference_runs.load("loopclosing", reference_runs.inputs_sha256(*reference_runs.flat("m", m).values()))
    tr = Tracker(Settings(**CAM), device="cpu", **CAPS)
    loop = LoopCloser(tr)
    kf_bow = z["kf_bow"]
    gates = [dict(k=int(k), g_in=(z[f"gate{j}.g_mask"], z[f"gate{j}.g_consist"]),
                  out=[z[f"gate{j}.out{i}"] for i in range(5)]) for j, k in enumerate(z["gate_kfs"])]
    enough, scores = gates[-1]["out"][1], gates[-1]["out"][2]
    cands = sorted(np.where(enough)[0].tolist(), key=lambda c: -scores[c])
    jclosed_state = reference_runs.tree(z, "closed_state")
    jloop = types.SimpleNamespace(  # the reference's LoopCloser after the closure
        n_loops_closed=int(z["loop.n_loops_closed"]), _loop_edges=[tuple(e) for e in z["loop.loop_edges"].tolist()],
        gba_queue=[(int(a), int(b), bool(e)) for a, b, e in z["loop.gba_queue"].tolist()],
        _gba_k=int(z["loop.gba_k"]), _kf_counter=int(z["loop.kf_counter"]), last_loop_kfn=int(z["loop.last_loop_kfn"]))
    yield dict(m=m, kf_bow=kf_bow, gates=gates, cands=cands, jloop=jloop, tr=tr, loop=loop,
               jstate=reference_runs.tree(z, "state"), jclosed=bool(z["closed"]), jclosed_state=jclosed_state,
               jmc=jclosed_state.m._asdict(), slice_m=reference_runs.tree(z, "slice_m")._asdict())
    mp.undo()


# ------------------------------------------------------------------ sim3
@pytest.mark.parametrize("scale", [0.4, 1e-3, 0.0], ids=["general", "small", "zero"])
def test_sim3_group_ops_match_reference(scale):
    rng = np.random.default_rng(1)
    xi = (rng.normal(0, 1, (8, 7)) * scale).astype(np.float32)
    xi[:, 6] *= 0.5
    xi2 = np.roll(xi, 1, 0)
    ja, jlog, jcomp, jinv, jse = _ref_sim3_ops()(xi, xi2)
    a, b = sim3.exp(T(xi)), sim3.exp(T(xi2))
    for want, got in ((ja, a), (jcomp, sim3.compose(a, b)), (jinv, sim3.inverse(a))):
        for x, y in zip(want, got):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=2e-6)
    np.testing.assert_allclose(sim3.log(a).numpy(), np.asarray(jlog), atol=2e-6)
    np.testing.assert_allclose(sim3.log(a).numpy(), xi, atol=2e-5)  # log inverts exp
    np.testing.assert_allclose(sim3.to_se3(a).numpy(), np.asarray(jse), atol=2e-6)
    p = rng.normal(size=(8, 5, 3)).astype(np.float32)
    R, t, sc = (np.asarray(x) for x in ja)
    want = sc[:, None, None] * np.einsum("hij,hnj->hni", R, p) + t[:, None]
    np.testing.assert_allclose(sim3.apply(a, T(p)).numpy(), want, atol=5e-6)


@pytest.mark.parametrize("scale", [0.3, 1e-3, 0.0], ids=["general", "small", "identity"])
def test_essential_graph_jacobians_at_zero_match_reference(scale):
    """The pose graph linearises at xi = 0, exp's small-angle branch; both
    branches of every guarded expression are finite there."""
    rng = np.random.default_rng(2)

    def sims(n):
        Tm = np.asarray(jse3.exp(jnp.asarray((rng.normal(0, 1, (n, 6)) * scale).astype(np.float32))))
        return Tm[:, :3, :3].copy(), Tm[:, :3, 3].copy(), np.exp(rng.normal(0, 0.1, n) * scale).astype(np.float32)

    S = [sims(12) for _ in range(3)]
    got = pose_graph._res_and_jac(*[tuple(T(x) for x in s) for s in S])
    ref = _ref_res_and_jac()(*[jnp.asarray(x) for s in S for x in s])
    for g, w in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# --------------------------------------------------------------- solvers
def _rigid_problem(tr, n=256, n_used=80):
    """tests/test_loopclosing.py's rigid problem (20% gross outliers),
    padded with invalid pairs to the closure's pair count."""
    rng = np.random.default_rng(42)
    x2 = rng.uniform([-2, -2, 1.5], [2, 2, 5], (n_used, 3)).astype(np.float32)
    T12 = np.asarray(jse3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.1, -0.15, 0.08], dtype=jnp.float32)))
    p1 = (T12[:3, :3] @ x2.T).T + T12[:3, 3]
    x1 = (p1 + rng.normal(0, 0.002, (n_used, 3))).astype(np.float32)
    out = rng.choice(n_used, n_used // 5, replace=False)
    x1[out] += rng.uniform(0.5, 1.0, (len(out), 3)).astype(np.float32)
    pad = lambda a: np.concatenate([a, np.zeros((n - n_used,) + a.shape[1:], a.dtype)])  # noqa: E731
    valid = np.arange(n) < n_used
    Kf = tr.K_host.astype(np.float32)
    uv = lambda p: (p @ Kf.T)[:, :2] / p[:, 2:]  # noqa: E731
    obs1 = (uv(p1) + rng.normal(0, 0.5, (n_used, 2))).astype(np.float32)
    obs2 = (uv(x2) + rng.normal(0, 0.5, (n_used, 2))).astype(np.float32)
    isig = rng.uniform(0.4, 1.0, n).astype(np.float32)
    return dict(x1=pad(x1), x2=pad(x2), valid=valid, uv1=pad(obs1), uv2=pad(obs2), isig=isig, T12=T12, out=out)


def test_solve_sim3_ransac_matches_reference(world):
    jloop, tr = _ref_loop(), world["tr"]
    pb = _rigid_problem(tr)
    I4 = np.eye(4, dtype=np.float32)
    ref = jloop._sim3(jnp.asarray(pb["x1"]), jnp.asarray(pb["x2"]), jnp.asarray(pb["valid"]), jnp.asarray(I4),
                      jnp.asarray(I4))
    got = sim3_solver.solve_sim3_ransac(T(pb["x1"]), T(pb["x2"]), T(pb["valid"]), tr.K, T(I4), T(I4),
                                        min_inliers=PC.LOOP_SIM3_MIN_INLIERS)
    assert bool(got.ok) == bool(ref.ok) is True
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert not got.inliers.numpy()[pb["out"]].any()
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-5)
    np.testing.assert_allclose(got.R.numpy(), pb["T12"][:3, :3], atol=1e-2)


def test_optimize_sim3_matches_reference(world):
    jloop, tr = _ref_loop(), world["tr"]
    pb = _rigid_problem(tr)
    R0 = pb["T12"][:3, :3].astype(np.float32)
    t0 = (pb["T12"][:3, 3] + 0.02).astype(np.float32)  # a start the LM has to correct
    args = (pb["x1"], pb["x2"], pb["uv1"], pb["uv2"], pb["isig"], pb["isig"], pb["valid"])
    ref = jloop._sim3_opt(*map(jnp.asarray, args), jnp.asarray(tr.K_host), jnp.asarray(R0), jnp.asarray(t0),
                          jnp.float32(1.0))
    got = sim3_solver.optimize_sim3(*map(T, args), tr.K, T(R0), T(t0), torch.tensor(1.0))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) >= 50
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4)
    assert float(got[2]) == float(ref[2]) == 1.0
    assert np.abs(got[1].numpy() - pb["T12"][:3, 3]).max() < 0.01  # the 2 cm start error is gone


def test_essential_graph_and_landmarks_match_reference(world):
    """tests/test_loopclosing.py's drift problem (a 12-keyframe chain, a true
    loop edge from the last to the first), padded to the map's 16 slots
    with invalid nodes; then the landmarks follow their keyframes."""
    jloop = _ref_loop()
    K, Kv = CAPS["max_kf"], 12
    true_step = np.asarray(jse3.exp(jnp.asarray([0.1, 0, 0, 0, 0.02, 0], dtype=jnp.float32)))
    drift_step = np.asarray(jse3.exp(jnp.asarray([0.105, 0.004, 0.002, 0, 0.023, 0.001], dtype=jnp.float32)))
    tp, dp = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(Kv - 1):
        tp.append(true_step @ tp[-1])
        dp.append(drift_step @ dp[-1])
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:Kv] = np.stack(dp)
    edge = np.zeros((K, K), bool)
    Sm_R = np.tile(np.eye(3, dtype=np.float32), (K, K, 1, 1))
    Sm_t = np.zeros((K, K, 3), np.float32)
    Sm_s = np.ones((K, K), np.float32)
    pairs = [(i, i + 1, dp[i] @ np.linalg.inv(dp[i + 1])) for i in range(Kv - 1)]
    pairs.append((0, Kv - 1, tp[0] @ np.linalg.inv(tp[Kv - 1])))
    for i, j, M in pairs:
        edge[i, j] = True
        Sm_R[i, j], Sm_t[i, j] = M[:3, :3], M[:3, 3]
    valid = np.arange(K) < Kv
    fixed = np.arange(K) == 0
    args = (poses, valid, fixed, np.triu(edge | edge.T, 1), Sm_R, Sm_t, Sm_s)
    ref = np.asarray(jloop._essential(*map(jnp.asarray, args), n_iters=EG_ITERS))
    got = pose_graph.optimize_essential_graph(*map(T, args), n_iters=EG_ITERS).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got[Kv:], poses[Kv:])  # invalid nodes keep their poses
    err = lambda P: np.linalg.norm(P[Kv - 1][:3, 3] - tp[-1][:3, 3])  # noqa: E731
    assert err(got) < 0.35 * err(poses)

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    pv = rng.uniform(size=40) < 0.8
    ref_kf = rng.integers(-1, K, 40).astype(np.int32)
    args = (pts, pv, ref_kf, poses, got)
    want = np.asarray(jpg.correct_landmarks(*map(jnp.asarray, args)))
    np.testing.assert_allclose(pose_graph.correct_landmarks(*map(T, args)).numpy(), want, atol=1e-4)


# ---------------------------------------------------------------- closing
def test_detect_gate_matches_reference_over_three_keyframes(world):
    """The gate on keyframes 10, 11, 12 in turn, its groups carried: the
    start group grows consistent and fires on the third."""
    loop = world["loop"]
    m = convert.map_state_from_numpy(world["m"], "cpu")
    for g in world["gates"]:
        out = loop._detect_gate_impl(T(world["kf_bow"]), m, g["k"], T(g["g_in"][0]), T(g["g_in"][1]))
        want = g["out"]
        assert bool(out[0]) == bool(want[0])
        for i in (1, 3, 4):
            np.testing.assert_array_equal(out[i].numpy(), want[i])
        np.testing.assert_allclose(out[2].numpy(), want[2], atol=1e-6)
    fired = [bool(g["out"][0]) for g in world["gates"]]
    assert fired == [False, False, True]
    assert set(world["cands"]) <= {0, 1, 2, 3} and world["cands"]


def test_close_loop_matches_reference(world):
    """Sim3 solve, OptimizeSim3, the guided top-up, the essential graph,
    landmark correction and SearchAndFuse on the constructed map."""
    loop, tr, jloop = world["loop"], world["tr"], world["jloop"]
    state = convert.track_state_from_numpy(world["jstate"], "cpu")
    got_state, closed = loop.close_loop(state, CLOSE_K, world["cands"][0])
    assert closed and world["jclosed"]
    got, want = got_state.m, world["jmc"]
    for name in MAP_EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    np.testing.assert_allclose(got.kf_pose.numpy(), want["kf_pose"], atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), want["pt_pos"], atol=1e-4)
    np.testing.assert_allclose(got.ln_sw.numpy(), want["ln_sw"], atol=1e-4)
    np.testing.assert_allclose(got_state.last.Tcw.numpy(), world["jclosed_state"].last.Tcw, atol=1e-4)
    assert not bool(got_state.vel_ok)
    assert loop.n_loops_closed == jloop.n_loops_closed == 1
    assert loop._loop_edges == jloop._loop_edges == [(CLOSE_K, world["cands"][0])]
    assert loop.gba_queue == jloop.gba_queue and loop._gba_k == jloop._gba_k == CLOSE_K
    assert loop.last_supporters >= PC.LOOP_TOTAL_MIN_MATCHES
    # the drifted copies were fused into the start's landmarks
    pre = world["m"]
    copies = np.where(pre["pt_valid"] & (pre["pt_first_kf"] >= 10))[0]
    replaced = got.pt_replaced.numpy()[copies]
    assert (replaced >= 0).mean() > 0.8 and (replaced[replaced >= 0] < 420).all()
    # the revisit's poses moved back by the drift (13 cm)
    moved = np.linalg.norm(got.kf_pose.numpy()[CLOSE_K, :3, 3] - pre["kf_pose"][CLOSE_K, :3, 3])
    assert moved > 0.08


def test_global_ba_slice_matches_reference(world):
    """One time-sliced global-BA slice from the reference's closed map: the
    queue's last kind, the chi2 gate, 2 plain iterations and the erase
    sweep (the robust phase is local mode's code, held in
    tests/test_torch_mapping.py)."""
    m = convert.map_state_from_numpy(world["jmc"], "cpu")
    gba = LocalBA(world["tr"], global_mode=True)
    assert (gba.W, gba.X, gba.Pl, gba.Ql) == (16, 1, 512, 64)
    got, want = gba.slice_runner(0, 2, True)(m, CLOSE_K), world["slice_m"]
    for name in ("kf_lm_idx", "kf_ln_idx", "pt_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    np.testing.assert_allclose(got.kf_pose.numpy(), want["kf_pose"], atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), want["pt_pos"], atol=1e-3)
    np.testing.assert_allclose(got.ln_ew.numpy(), want["ln_ew"], atol=1e-3)
    assert np.abs(got.kf_pose.numpy() - world["jmc"]["kf_pose"]).max() > 0  # the slice moved poses
    np.testing.assert_array_equal(got.kf_pose.numpy()[0], world["jmc"]["kf_pose"][0])  # slot 0 is the gauge
    # a slice without the sweep leaves the observations alone
    kept = gba.slice_runner(1, 0, False)(m, CLOSE_K)
    np.testing.assert_array_equal(kept.kf_lm_idx.numpy(), world["jmc"]["kf_lm_idx"])


# ------------------------------------------------------------ System, port only
def test_system_with_loop_closing_runs_on_cpu(tmp_path):
    """A few frames of System with every default but the capacities: the
    chain carries the loop gate (aux of 1 + 20 K), the JSONL the closure
    fields, and a queued global-BA slice runs one per frame."""
    seq = SyntheticSequence(n_frames=6, height=240, width=320, seed=3)
    s = dataclasses.replace(seq.settings, use_lines=False)
    slam = System(s, device="cpu", log_path=tmp_path / "log.jsonl", max_kf=8, max_pts=512)
    assert slam.use_loop_closing and isinstance(slam._reloc, LoopCloser) and slam._reloc is slam._loop
    assert not slam.tracker.in_step_local_refresh
    auxes = []
    dispatch = slam._dispatch_kf_chain
    slam._dispatch_kf_chain = lambda k: auxes.append(dispatch(k)) or auxes[-1]
    for i in range(0, 6, 2):
        g, d, t = seq.frame(i)
        assert slam.track_rgbd(g, d, t) is not None
        if i == 0:  # a pending slice runs after each later frame
            slam._loop.gba_queue = [(1, 0, False), (0, 1, True)]
    K = slam.tracker.max_kf
    assert auxes and all(a.shape == (1 + 20 * K,) for a in auxes)
    assert all(float(a[0]) == 0.0 for a in auxes)  # no gate fired
    assert slam._loop._kf_counter == len(auxes) == slam.aux_reads
    recs = [json.loads(ln) for ln in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert len(recs) == 3 and all({"closure_ms", "gba_pending", "loops_closed"} <= set(r) for r in recs)
    assert [r["gba_pending"] for r in recs] == [0, 1, 0]
    assert slam._loop.gba_queue == [] and slam.n_loops_closed == 0


def test_loop_closer_state_crosses_over(world):
    """convert.loop_closer_from_numpy / system_from_numpy(loop=...) carry the
    reference loop closer's state after its closure (groups from the gate,
    loop edges, counters, the pending global-BA queue) into the port's,
    which then continues from it."""
    jloop = world["jloop"]
    g = world["gates"][-1]["out"]
    fields = dict(g_mask=g[3], g_consist=g[4], loop_edges=jloop._loop_edges, kf_counter=jloop._kf_counter,
                  last_loop_kfn=jloop.last_loop_kfn, n_loops_closed=jloop.n_loops_closed,
                  gba_queue=jloop.gba_queue, gba_k=jloop._gba_k)
    loop = convert.loop_closer_from_numpy(LoopCloser(world["tr"]), **fields)
    np.testing.assert_array_equal(loop._g_mask.numpy(), g[3])
    np.testing.assert_array_equal(loop._g_consist.numpy(), g[4])
    assert loop._g_mask.dtype == torch.bool and loop._g_consist.dtype == torch.int32
    assert loop._loop_edges == [(CLOSE_K, world["cands"][0])] and loop.gba_queue == jloop.gba_queue
    assert (loop._kf_counter, loop.last_loop_kfn, loop._gba_k) == (jloop._kf_counter, jloop.last_loop_kfn, CLOSE_K)
    assert loop.n_loops_closed == 1
    # the pending global-BA slices run on the reference's closed state
    state = loop.flush_gba(convert.track_state_from_numpy(world["jclosed_state"], "cpu"))
    assert loop.gba_queue == [] and bool(torch.isfinite(state.m.kf_pose).all())
    # and through a System
    slam = System(Settings(**CAM), device="cpu", max_kf=CAPS["max_kf"], max_pts=CAPS["max_pts"])
    st = slam.tracker.init_state()
    st = st._replace(m=st.m._replace(**{f: t.numpy() for f, t in st.m._asdict().items()}),
                     last=st.last._replace(**{f: t.numpy() for f, t in st.last._asdict().items()}),
                     **{f: getattr(st, f).numpy() for f in st._fields if f not in ("m", "last")})
    slam = convert.system_from_numpy(slam, state=st, kf_bow=world["kf_bow"], timestamps=[], rel_poses=[],
                                     ref_ids=[], tracked=[], kf_timestamps={}, last_status=1, loop=fields)
    assert slam._loop.gba_queue == jloop.gba_queue and slam.n_loops_closed == 1
    np.testing.assert_array_equal(slam._loop._g_mask.numpy(), g[3])
