"""Port parity, the slice: FrameBuilder -> Tracker.step on a synthetic
TUM1 sequence (configs/TUM1.yaml scaled to 320x240, lens distortion as
shipped), reference (JAX, CPU) against the port (PyTorch, CPU), plus the
mechanisms the port replaces: drop-mode scatters, stable argsorts, the
nonzero compaction, and both branches of the reference's lax.conds.

Tolerances: the two front ends agree to float32 rounding (a descriptor bit
on a near-tie may flip), so statuses and keyframe decisions must be equal,
poses within 1e-3 m and the ATE within 1e-3 m; from one shared state and
frame the step must agree to 1e-4."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.config import load_settings as jload_settings
from plslam_tpu.features.frame import FrameBuilder as JFrameBuilder
from plslam_tpu.pipeline.tracking import Tracker as JTracker
from plslam_tpu.slammap import state as jstate
from plslam_tpu_torch import convert, load_settings
from plslam_tpu_torch.eval.ate import ate_rmse
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.slammap import state

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM1.yaml"
N_FRAMES, MID = 6, 3
CAPS = dict(max_kf=32, max_pts=4096)


def _half(s):
    return dataclasses.replace(s, width=320, height=240, fx=s.fx / 2, fy=s.fy / 2, cx=s.cx / 2, cy=s.cy / 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    s, js = _half(load_settings(CFG)), _half(jload_settings(CFG))
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=0, settings=s)
    frames = [seq.frame(i) for i in range(N_FRAMES)]

    jb, jt = JFrameBuilder(js), JTracker(js, **CAPS)
    # the step makes `status` weakly typed; start it so, or jit compiles twice
    jst = jt.init_state()._replace(status=jnp.asarray(tracking.ST_UNINIT))
    ref, jframes, mid_state = [], [], None
    for i, (g, d, _) in enumerate(frames):
        jf = jb(jnp.asarray(g), jnp.asarray(d))
        if i == MID:
            mid_state = _np(jst)
        jframes.append(_np(jf))
        jst, out = jt.step(jst, jf)
        ref.append(_np(out))

    b, t = FrameBuilder(s, device="cpu"), tracking.Tracker(s, device="cpu", **CAPS)
    st, got = t.init_state(), []
    for g, d, _ in frames:
        st, out = t.step(st, b(g, d))
        got.append(out)
    return dict(seq=seq, ref=ref, got=got, jt=jt, jst=jst, t=t, st=st,
                jframes=jframes, mid_state=mid_state)


def test_status_and_keyframes_per_frame(run):
    for r, g in zip(run["ref"], run["got"]):
        assert bool(g.tracked) == bool(r.tracked)
        assert bool(g.new_kf) == bool(r.new_kf)
        assert int(g.telemetry[tracking.TEL_STATUS]) == int(r.telemetry[tracking.TEL_STATUS])
        assert abs(int(g.n_inliers) - int(r.n_inliers)) <= max(2, 0.01 * int(r.n_inliers))
    assert all(bool(r.tracked) for r in run["ref"])


def test_poses_and_ate(run):
    seq = run["seq"]
    est_r = [(seq.timestamp(i), np.linalg.inv(r.Tcw.astype(np.float64))) for i, r in enumerate(run["ref"])]
    est_g = [(seq.timestamp(i), np.linalg.inv(g.Tcw.numpy().astype(np.float64))) for i, g in enumerate(run["got"])]
    for (_, a), (_, b) in zip(est_r, est_g):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < 1e-3
        assert np.abs(a[:3, :3] - b[:3, :3]).max() < 1e-3
    ate_r, _ = ate_rmse(est_r, seq.gt_trajectory())
    ate_g, _ = ate_rmse(est_g, seq.gt_trajectory())
    assert abs(ate_r - ate_g) < 1e-3
    assert ate_g < 0.02


def _one_step(run, mutate=lambda d: d):
    """Both trackers, one step from the same converted state and frame."""
    d = mutate(run["mid_state"])
    jf = run["jframes"][MID]
    jst = jax.tree_util.tree_map(jnp.asarray, d)
    jst = jst._replace(status=jnp.asarray(int(d.status)))  # weakly typed, as the step leaves it
    jst2, jout = run["jt"].step(jst, jax.tree_util.tree_map(jnp.asarray, jf))
    st2, out = run["t"].step(convert.track_state_from_numpy(d, "cpu"), convert.frame_from_numpy(jf, "cpu"))
    return _np(jst2), _np(jout), st2, out


def _check_step(jst2, jout, st2, out):
    np.testing.assert_allclose(out.Tcw.numpy(), jout.Tcw, atol=1e-4)
    for name in ("tracked", "new_kf", "kf_id", "ref_kf", "n_inliers", "n_matches"):
        assert int(getattr(out, name)) == int(getattr(jout, name)), name
    for name in ("pt_valid", "kf_valid", "kf_lm_idx", "pt_nobs", "pt_found", "pt_visible", "n_pt", "n_kf"):
        np.testing.assert_array_equal(getattr(st2.m, name).numpy(), getattr(jst2.m, name), err_msg=name)
    np.testing.assert_array_equal(st2.local_set.numpy(), jst2.local_set)
    np.testing.assert_array_equal(st2.last.lm_idx.numpy(), jst2.last.lm_idx)


def test_single_step_from_shared_state(run):
    _check_step(*_one_step(run))


def test_ref_kf_fallback_branch(run):
    """No last-frame targets: the motion model fails and the reference-KF
    fallback (the reference's lax.cond at tracking.py:700) carries the step."""
    def no_last(d):
        return d._replace(last=d.last._replace(valid=np.zeros_like(d.last.valid)))

    jst2, jout, st2, out = _one_step(run, no_last)
    assert bool(jout.tracked)
    _check_step(jst2, jout, st2, out)


def test_drop_scatters_match_reference():
    rng = np.random.default_rng(0)
    dst = rng.normal(size=(10, 3)).astype(np.float32)
    idx = np.array([3, 3, -1, 10, 12, 0, 3, 9, 9], np.int32)  # duplicates + out of range
    val = rng.normal(size=(9, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tracking.set_drop(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(val)).numpy(),
        np.asarray(jnp.asarray(dst).at[jnp.asarray(np.where(idx < 0, 10, idx))].set(jnp.asarray(val), mode="drop")))
    cnt = np.zeros(10, np.int32)
    np.testing.assert_array_equal(
        tracking.add_drop(torch.from_numpy(cnt), torch.from_numpy(idx), 2).numpy(),
        np.asarray(jnp.asarray(cnt).at[jnp.asarray(np.where(idx < 0, 10, idx))].add(2, mode="drop")))


def test_stable_argsort_and_compaction_match_reference():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 4, 300).astype(np.float32)  # many ties
    np.testing.assert_array_equal(torch.argsort(torch.from_numpy(v), stable=True).numpy(), np.asarray(jnp.argsort(v)))
    b = rng.uniform(size=300) < 0.5
    np.testing.assert_array_equal(torch.argsort(torch.from_numpy(b).to(torch.int8), stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(b))))


def test_local_set_and_covisibility_match_reference(run):
    jm = run["jst"].m
    m = convert.map_state_from_numpy(_np(jm), "cpu")
    np.testing.assert_array_equal(state.observation_matrix(m).numpy(), np.asarray(jstate.observation_matrix(jm)))
    np.testing.assert_array_equal(state.covisibility(m).numpy(), np.asarray(jstate.covisibility(jm)))
    ref_local_set = jax.jit(run["jt"]._compute_local_set)
    for k in range(3):
        got = run["t"]._compute_local_set(m, torch.tensor(k, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_local_set(jm, jnp.int32(k))))


def test_entry_points_default_to_the_card():
    s = _half(load_settings(CFG))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.Tracker(s, **CAPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameBuilder(s)


def test_solve_pose_matches_reference(run):
    """Tracker._solve_pose: the last frame's own bindings re-solved from the
    previous pose."""
    jf, jm = run["jframes"][-1], _np(run["jst"].m)
    lm, T0 = _np(run["jst"].last.lm_idx), run["ref"][-2].Tcw
    Tj, inl_j = run["jt"]._solve_pose(jax.tree_util.tree_map(jnp.asarray, jf), jnp.asarray(lm),
                                      jnp.asarray(jm.pt_pos), jnp.asarray(T0))
    Tt, inl_t = run["t"]._solve_pose(convert.frame_from_numpy(jf, "cpu"), torch.from_numpy(lm),
                                     torch.from_numpy(jm.pt_pos), torch.from_numpy(T0))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    assert (inl_t.numpy() != np.asarray(inl_j)).sum() <= 2
    assert inl_t.sum() > 100


def test_point_only_line_fields_match_reference(run):
    """Point-only settings: every keyline slot invalid, with the same
    stand-in fields as the reference's (computed once by the builder), and
    the line half of the map as the reference leaves it."""
    s = _half(load_settings(CFG))
    assert not s.use_lines
    g, d, _ = SyntheticSequence(n_frames=1, seed=0, settings=s).frame(0)
    f, jf = FrameBuilder(s, device="cpu")(g, d), run["jframes"][0]
    assert not f.ln_valid.any()
    # the stand-ins pass through the lens undistortion: float32 rounding
    for name in ("ln_sp", "ln_ep", "ln_line2d", "ln_angle"):
        np.testing.assert_allclose(getattr(f, name).numpy(), getattr(jf, name), atol=1e-3, err_msg=name)
    for name in ("ln_depth_sp", "ln_depth_ep", "ln_desc"):
        np.testing.assert_array_equal(getattr(f, name).numpy(), getattr(jf, name), err_msg=name)
    jm = _np(run["jst"].m)
    for name in ("kf_ln_obs", "kf_ln_sp", "kf_ln_ep"):
        np.testing.assert_allclose(getattr(run["st"].m, name).numpy(), getattr(jm, name), atol=1e-3, err_msg=name)
    for name in ("kf_ln_idx", "kf_ln_valid", "kf_ln_desc", "ln_valid", "ln_visible", "ln_found", "ln_nobs", "n_ln"):
        np.testing.assert_array_equal(getattr(run["st"].m, name).numpy(), getattr(jm, name), err_msg=name)
