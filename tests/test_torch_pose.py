"""Port parity, kernel B3 and the geometry under it: the plain PyTorch pose
LM against the reference's jnp solve (solvers/pose.py), SE(3) and camera
helpers against geometry/, all on the CPU from the same numpy inputs. The
CUDA kernel is held against the twin on the card in test_torch_cuda.py.

Tolerance: the two solves run the same float32 arithmetic but sum the
normal equations in another order, so poses agree to 1e-4 and at most two
observations sitting on a chi2 boundary may be classified differently."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.geometry import camera as jcam
from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.solvers import pose as jpose
from plslam_tpu_torch.geometry import camera, se3
from plslam_tpu_torch.io.synthetic import pose_problem
from plslam_tpu_torch.solvers import pose

torch.set_num_threads(2)

K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32)
DIST = np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314], np.float32)
BF = 40.0


def _scene(seed, n=1024, n_lines=128, noise_px=0.5, outlier_frac=0.1, stereo_frac=0.8,
           line_frac=0.6, pad_frac=0.1):
    """Points/lines seen from a known pose; padded rows carry NaN coords."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.1, -0.08, 0.05, 0.04, -0.03, 0.02], np.float32)
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(1.5, 6.0, n)], -1).astype(np.float32)
    obs = np.array(jcam.project_stereo(jnp.asarray(K), BF, jse3.transform(jnp.asarray(T), jnp.asarray(xw))))
    obs[:, :2] += rng.normal(0, noise_px, (n, 2))
    out = rng.choice(n, int(n * outlier_frac), replace=False)
    obs[out, :2] += rng.uniform(20, 80, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    valid = rng.uniform(size=n) >= pad_frac
    obs[~valid] = np.nan
    sw = np.stack([rng.uniform(-2, 2, n_lines), rng.uniform(-1.5, 1.5, n_lines), rng.uniform(2, 5, n_lines)], -1)
    ew = sw + rng.uniform(-0.8, 0.8, (n_lines, 3))
    ew[:, 2] = np.clip(ew[:, 2], 1.5, None)
    sw, ew = sw.astype(np.float32), ew.astype(np.float32)
    sp = np.asarray(jcam.project(jnp.asarray(K), jse3.transform(jnp.asarray(T), jnp.asarray(sw))))
    ep = np.asarray(jcam.project(jnp.asarray(K), jse3.transform(jnp.asarray(T), jnp.asarray(ew))))
    l2d = np.cross(np.c_[sp, np.ones(n_lines)], np.c_[ep, np.ones(n_lines)])
    l2d = (l2d / (np.linalg.norm(l2d[:, :2], axis=1, keepdims=True) + 1e-9)).astype(np.float32)
    inv_sig = (1.0 / 1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    pts = (xw, obs.astype(np.float32), inv_sig, rng.uniform(size=n) < stereo_frac, valid)
    lines = (sw, ew, l2d, np.ones(n_lines, np.float32), rng.uniform(size=n_lines) < line_frac)
    return pts, lines, T


def _solve_both(pts, lines, T0=None):
    T0 = np.eye(4, dtype=np.float32) if T0 is None else T0
    jl = None if lines is None else jpose.LineObs(*map(jnp.asarray, lines))
    Tj, pj, lj = jpose.pose_optimization(jnp.asarray(T0), jpose.PointObs(*map(jnp.asarray, pts)),
                                         jnp.asarray(K), BF, lines=jl)
    tl = None if lines is None else pose.LineObs(*map(torch.from_numpy, lines))
    Tt, pt, lt = pose.pose_optimization(torch.from_numpy(T0), pose.PointObs(*map(torch.from_numpy, pts)),
                                        K, BF, lines=tl)
    return (np.asarray(Tj), np.asarray(pj), None if lj is None else np.asarray(lj)), \
        (Tt.numpy(), pt.numpy(), None if lt is None else lt.numpy())


@pytest.mark.parametrize("case", ["points", "points+lines", "mono_only", "few_points+lines", "clean"])
def test_pose_lm_matches_reference(case):
    kw = dict(
        points=dict(),
        mono_only=dict(stereo_frac=0.0),
        clean=dict(outlier_frac=0.0, pad_frac=0.0),
    ).get(case, {})
    if case == "few_points+lines":
        kw = dict(n=1024, pad_frac=0.97)
    pts, lines, T_gt = _scene(3, **kw)
    use_lines = lines if "lines" in case else None
    (Tj, pj, lj), (Tt, pt, lt) = _solve_both(pts, use_lines)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert (pt != pj).sum() <= 2
    if use_lines is not None:
        assert (lt != lj).sum() <= 2
    assert np.abs(Tt - T_gt).max() < 0.05  # and both actually solved the problem


@pytest.mark.parametrize("with_lines", [False, True])
def test_kernel_check_problem_matches_reference(with_lines):
    """The problem the card checks of B3 are made from: same solve, and it
    recovers the pose it was made from."""
    pb = pose_problem(np.random.default_rng(7), with_lines=with_lines)
    assert pb["bf"] == BF and np.array_equal(pb["K"], K)
    (Tj, pj, lj), (Tt, pt, lt) = _solve_both(pb["pts"], pb["lines"])
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert (pt != pj).sum() + (lt != lj).sum() <= 2
    assert not (pt & ~pb["pts"][4]).any() and lt.any() == with_lines
    assert np.abs(Tt[:3, 3] - [0.1, -0.08, 0.05]).max() < 0.02


def test_all_rows_padded_keeps_the_init():
    pts, _, _ = _scene(4, n=256, pad_frac=1.0)
    T0 = np.asarray(jse3.exp(jnp.asarray(np.array([0.01, 0, 0, 0, 0.02, 0], np.float32))))
    (Tj, pj, _), (Tt, pt, _) = _solve_both(pts, None, T0)
    np.testing.assert_array_equal(Tt, T0)
    np.testing.assert_array_equal(Tj, T0)
    assert not pt.any() and not pj.any()


def test_jacobians_match_reference():
    pts, lines, T = _scene(5, n=64, n_lines=16, pad_frac=0.0)
    cam = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    r, J, ok = pose._point_residual_jac(torch.from_numpy(T), pose.PointObs(*map(torch.from_numpy, pts)), cam, BF)
    rj, Jj, okj = jpose._point_residual_jac(jnp.asarray(T), jpose.PointObs(*map(jnp.asarray, pts)), jnp.asarray(K), BF)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    r, J, ok = pose._line_residual_jac(torch.from_numpy(T), pose.LineObs(*map(torch.from_numpy, lines)), cam)
    rj, Jj, okj = jpose._line_residual_jac(jnp.asarray(T), jpose.LineObs(*map(jnp.asarray, lines)), jnp.asarray(K))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=1e-5, atol=1e-3)


def test_se3_and_camera_match_reference():
    rng = np.random.default_rng(6)
    xi = np.concatenate([rng.normal(0, 0.5, (64, 3)), rng.normal(0, 0.7, (64, 3))], -1).astype(np.float32)
    xi[:8, 3:] *= 1e-3  # the Taylor branch
    T = se3.exp(torch.from_numpy(xi))
    Tj = jse3.exp(jnp.asarray(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=2e-6)
    np.testing.assert_allclose(se3.log(T).numpy(), np.asarray(jse3.log(Tj)), atol=5e-5)
    np.testing.assert_allclose(se3.inverse(T).numpy(), np.asarray(jse3.inverse(Tj)), atol=2e-6)
    p = rng.normal(0, 2, (64, 100, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.transform(T, torch.from_numpy(p)).numpy(),
                               np.asarray(jse3.transform(Tj, jnp.asarray(p))), atol=1e-5)
    uv = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 480, 500)], -1).astype(np.float32)
    np.testing.assert_allclose(
        camera.undistort_pixels(torch.from_numpy(K), torch.from_numpy(DIST), torch.from_numpy(uv)).numpy(),
        np.asarray(jcam.undistort_pixels(jnp.asarray(K), jnp.asarray(DIST), jnp.asarray(uv))), atol=2e-3)
    pc = np.abs(p[0]) + 0.5
    np.testing.assert_allclose(camera.project_stereo(torch.from_numpy(K), BF, torch.from_numpy(pc)).numpy(),
                               np.asarray(jcam.project_stereo(jnp.asarray(K), BF, jnp.asarray(pc))), rtol=1e-6, atol=1e-3)
