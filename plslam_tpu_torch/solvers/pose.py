"""Motion-only pose optimization: LM over point and line reprojection
errors, and kernel B3 that runs the whole solve in one launch.

Port of plslam_tpu/solvers/pose.py. `pose_optimization_plain` is the
reference's jnp path in PyTorch (4 rounds on the (4, 2, 2, 2) iteration
schedule, chi2 re-classification between rounds, Huber off in the last
round, additive damping lam0 = 1e-5 * max diag H, accept/reject lam/3 |
lam * nu). `pose_lm` is kernel B3 (csrc/pose_lm.cu), which replaces
`_kernel` in plslam_tpu/solvers/pose_pallas.py:67 (launched by
`_pose_pallas` / `pose_optimization_pallas`, dispatched at
plslam_tpu/solvers/pose.py:168-179). `pose_optimization` dispatches on the
device of the observations.

Padded rows may carry non-finite coordinates: their residuals are zeroed
before any reduction, because a zero weight does not save b = (J w)^T r
from 0 * NaN.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.geometry import se3

_TAU = 1e-5  # g2o OptimizationAlgorithmLevenberg initial lambda factor


class PointObs(NamedTuple):
    """Fixed-capacity point observations for a pose solve. [N] leading dim."""

    xw: torch.Tensor  # f32[N, 3] landmark world position
    obs: torch.Tensor  # f32[N, 3] (u, v, u_r); u_r only used when is_stereo
    inv_sigma2: torch.Tensor  # f32[N]
    is_stereo: torch.Tensor  # bool[N]
    valid: torch.Tensor  # bool[N]


class LineObs(NamedTuple):
    """Fixed-capacity line observations. [L] leading dim."""

    sw: torch.Tensor  # f32[L, 3] start-point world position
    ew: torch.Tensor  # f32[L, 3] end-point world position
    line2d: torch.Tensor  # f32[L, 3] observed 2D line (a, b, c), a^2+b^2 = 1
    inv_sigma2: torch.Tensor  # f32[L]
    valid: torch.Tensor  # bool[L]


def _intrinsics(K):
    """(fx, fy, cx, cy) as Python floats from a host-side 3x3 K."""
    K = np.asarray(K.cpu() if torch.is_tensor(K) else K, np.float32)
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def _rot_cols(A, X, Y, Z):
    """Elementwise A @ hat(P) for rows A [N, 3] of d(pred)/dP."""
    return torch.stack(
        [A[..., 1] * Z - A[..., 2] * Y, -A[..., 0] * Z + A[..., 2] * X, A[..., 0] * Y - A[..., 1] * X], -1
    )


def _point_residual_jac(Tcw, pts: PointObs, cam, bf):
    """-> r f32[N, 3], J f32[N, 3, 6], depth_ok bool[N]; J is d r / d xi for
    the left update exp(xi) * Tcw, twist order (rho, phi)."""
    fx, fy, cx, cy = cam
    P = se3.transform(Tcw, pts.xw)
    X, Y, Z = P[..., 0], P[..., 1], P[..., 2]
    depth_ok = Z > 1e-3
    iz = 1.0 / torch.where(depth_ok, Z, 1.0)
    iz2 = iz * iz
    u = fx * X * iz + cx
    v = fy * Y * iz + cy
    ur = u - bf * iz
    r = pts.obs - torch.stack([u, v, ur], -1)
    r = torch.cat([r[..., :2], torch.where(pts.is_stereo, r[..., 2], 0.0)[..., None]], -1)
    zero = torch.zeros_like(X)
    du_dP = torch.stack([fx * iz, zero, -fx * X * iz2], -1)
    dv_dP = torch.stack([zero, fy * iz, -fy * Y * iz2], -1)
    dur_dP = du_dP + torch.stack([zero, zero, bf * iz2], -1)
    J = torch.stack(
        [
            torch.cat([-du_dP, _rot_cols(du_dP, X, Y, Z)], -1),
            torch.cat([-dv_dP, _rot_cols(dv_dP, X, Y, Z)], -1),
            torch.cat([-dur_dP, _rot_cols(dur_dP, X, Y, Z)], -1),
        ],
        -2,
    )
    J = torch.cat([J[..., :2, :], torch.where(pts.is_stereo[..., None], J[..., 2, :], 0.0)[..., None, :]], -2)
    return r, J, depth_ok


def _line_residual_jac(Tcw, lines: LineObs, cam):
    """-> r f32[L, 2], J f32[L, 2, 6], depth_ok bool[L]."""
    fx, fy, cx, cy = cam
    l = lines.line2d

    def endpoint(Xw):
        P = se3.transform(Tcw, Xw)
        X, Y, Z = P[..., 0], P[..., 1], P[..., 2]
        ok = Z > 1e-3
        iz = 1.0 / torch.where(ok, Z, 1.0)
        iz2 = iz * iz
        u = fx * X * iz + cx
        v = fy * Y * iz + cy
        res = l[..., 0] * u + l[..., 1] * v + l[..., 2]
        zero = torch.zeros_like(X)
        du_dP = torch.stack([fx * iz, zero, -fx * X * iz2], -1)
        dv_dP = torch.stack([zero, fy * iz, -fy * Y * iz2], -1)
        dres_dP = l[..., 0:1] * du_dP + l[..., 1:2] * dv_dP
        return res, torch.cat([dres_dP, -_rot_cols(dres_dP, X, Y, Z)], -1), ok

    r_s, J_s, ok_s = endpoint(lines.sw)
    r_e, J_e, ok_e = endpoint(lines.ew)
    return -torch.stack([r_s, r_e], -1), -torch.stack([J_s, J_e], -2), ok_s & ok_e


def _huber_weight(chi2, delta2, robust: bool):
    """g2o RobustKernelHuber weight: 1 inside, delta/sqrt(chi2) outside."""
    if not robust:
        return torch.ones_like(chi2)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _huber_rho(chi2, delta2, robust: bool):
    if not robust:
        return chi2
    return torch.where(chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0)) - delta2)


def _chi2_threshold_pts(is_stereo):
    return torch.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO).to(torch.float32)


def pose_optimization_plain(Tcw0, pts: PointObs, K, bf, lines: LineObs | None = None):
    """Plain PyTorch twin of B3 -> (Tcw f32[4,4], pt_inlier bool[N],
    line_inlier bool[L] | None). No host synchronisation."""
    cam = _intrinsics(K)
    bf = float(bf)
    has_lines = lines is not None
    eye6 = torch.eye(6, dtype=torch.float32, device=pts.xw.device)

    def chi2_all(Tcw):
        r, _, ok = _point_residual_jac(Tcw, pts, cam, bf)
        chi2_p = torch.where(ok, torch.sum(r * r, -1) * pts.inv_sigma2, torch.inf)
        if not has_lines:
            return chi2_p, None
        rl, _, okl = _line_residual_jac(Tcw, lines, cam)
        return chi2_p, torch.where(okl, torch.sum(rl * rl, -1) * lines.inv_sigma2, torch.inf)

    def build_system(Tcw, active_pts, active_lines, robust):
        r, J, ok = _point_residual_jac(Tcw, pts, cam, bf)
        r = torch.where((pts.valid & ok)[:, None], r, 0.0)
        chi2 = torch.sum(r * r, -1) * pts.inv_sigma2
        delta2 = _chi2_threshold_pts(pts.is_stereo)
        sel = active_pts & pts.valid & ok
        w = torch.where(sel, _huber_weight(chi2, delta2, robust) * pts.inv_sigma2, 0.0)
        Jf = J.reshape(-1, 6)
        Jw = Jf * w[:, None].expand(-1, 3).reshape(-1)[:, None]
        H = Jw.t() @ Jf
        b = -(Jw.t() @ r.reshape(-1, 1))[:, 0]
        cost = torch.sum(torch.where(sel, _huber_rho(chi2, delta2, robust), 0.0))
        cost = cost + 1e7 * torch.sum(active_pts & pts.valid & ~ok)
        if has_lines:
            rl, Jl, okl = _line_residual_jac(Tcw, lines, cam)
            rl = torch.where((lines.valid & okl)[:, None], rl, 0.0)
            chi2l = torch.sum(rl * rl, -1) * lines.inv_sigma2
            sell = active_lines & lines.valid & okl
            wl = torch.where(sell, _huber_weight(chi2l, C.CHI2_LINE, robust) * lines.inv_sigma2, 0.0)
            Jlf = Jl.reshape(-1, 6)
            Jlw = Jlf * wl[:, None].expand(-1, 2).reshape(-1)[:, None]
            H = H + Jlw.t() @ Jlf
            b = b - (Jlw.t() @ rl.reshape(-1, 1))[:, 0]
            cost = cost + torch.sum(torch.where(sell, _huber_rho(chi2l, C.CHI2_LINE, robust), 0.0))
            cost = cost + 1e7 * torch.sum(active_lines & lines.valid & ~okl)
        return H, b, cost

    def lm_round(Tcw, active_pts, active_lines, robust, n_iters):
        # (H, b, cost) at the current linearisation point are carried: the
        # candidate's system becomes the next one on accept.
        H, b, cost = build_system(Tcw, active_pts, active_lines, robust)
        lam = _TAU * torch.max(torch.abs(torch.diagonal(H)))
        nu = torch.full((), 2.0, device=H.device)
        for _ in range(n_iters):
            delta = torch.linalg.solve_ex(H + (lam + 1e-9) * eye6, b)[0]  # no info check: a singular system gives
            # non-finite delta, rejected below (as jnp.linalg.solve)
            T_new = se3.compose(se3.exp(delta), Tcw)
            H_new, b_new, new_cost = build_system(T_new, active_pts, active_lines, robust)
            accept = (new_cost < cost) & torch.all(torch.isfinite(delta))
            Tcw = torch.where(accept, T_new, Tcw)
            H = torch.where(accept, H_new, H)
            b = torch.where(accept, b_new, b)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, lam / 3.0, lam * nu)
            nu = torch.where(accept, 2.0, nu * 2.0)
        return Tcw

    active_pts = pts.valid
    active_lines = lines.valid if has_lines else None
    Tcw = Tcw0
    for rnd in range(C.POSE_OPT_ROUNDS):
        robust = rnd < C.POSE_OPT_ROUNDS - 1  # Huber off in the last round
        Tcw = lm_round(Tcw, active_pts, active_lines, robust, C.POSE_OPT_SCHEDULE[rnd])
        chi2_p, chi2_l = chi2_all(Tcw)
        active_pts = pts.valid & (chi2_p <= _chi2_threshold_pts(pts.is_stereo))
        if has_lines:
            active_lines = lines.valid & (chi2_l <= C.CHI2_LINE)
    return Tcw, active_pts, active_lines


def _f32(t, shape, dev):
    if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"pose_lm wants f32{list(shape)} on {dev}, got {t.dtype}{list(t.shape)} on {t.device}")
    return t.contiguous()


def _u8(t, n, dev):
    if t.dtype != torch.bool or tuple(t.shape) != (n,) or t.device != dev:
        raise ValueError(f"pose_lm wants bool[{n}] on {dev}, got {t.dtype}{list(t.shape)} on {t.device}")
    return t.contiguous().view(torch.uint8)


def pose_lm(Tcw0, pts: PointObs, K, bf, lines: LineObs | None = None):
    """Kernel B3: the whole solve in one single-block launch on the card.
    Same contract as pose_optimization_plain; CUDA tensors only."""
    from plslam_tpu_torch import _build

    dev = pts.xw.device
    if dev.type != "cuda":
        raise ValueError(f"pose_lm wants CUDA tensors, got {dev}")
    N = pts.xw.shape[0]
    L = lines.sw.shape[0] if lines is not None else 0
    if not (0 < N <= 4096 and L <= 4096):
        raise ValueError(f"pose_lm supports N in 1..4096 and L <= 4096 (got {N}, {L})")
    keep = [
        _f32(Tcw0, (4, 4), dev), _f32(pts.xw, (N, 3), dev), _f32(pts.obs, (N, 3), dev),
        _f32(pts.inv_sigma2, (N,), dev), _u8(pts.is_stereo, N, dev), _u8(pts.valid, N, dev),
    ]
    if lines is not None:
        keep += [_f32(lines.sw, (L, 3), dev), _f32(lines.ew, (L, 3), dev), _f32(lines.line2d, (L, 3), dev),
                 _f32(lines.inv_sigma2, (L,), dev), _u8(lines.valid, L, dev)]
    else:
        keep += [None] * 5
    Tcw = torch.empty((4, 4), dtype=torch.float32, device=dev)
    pin = torch.empty(N, dtype=torch.uint8, device=dev)
    lin = torch.empty(max(L, 1), dtype=torch.uint8, device=dev)
    fx, fy, cx, cy = _intrinsics(K)
    sched = (ctypes.c_int * C.POSE_OPT_ROUNDS)(*C.POSE_OPT_SCHEDULE)
    ptr = [0 if t is None else t.data_ptr() for t in keep]
    rc = _build.library().plslam_pose_lm(
        *ptr[:6], N, *ptr[6:], L, fx, fy, cx, cy, float(bf), C.POSE_OPT_ROUNDS, sched,
        Tcw.data_ptr(), pin.data_ptr(), lin.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "pose_lm")
    pose_lm.launches += 1
    if lines is None:
        return Tcw, pin.view(torch.bool), None
    lin = lin[:L].view(torch.bool)
    if pose_lm.count_lines:
        # launches fed at least one valid line row, and the line inliers
        # they returned, counted on the card (reading them is the caller's
        # host sync, not the step's); off by default: three small device
        # ops per launch
        pose_lm.line_launches = pose_lm.line_launches + lines.valid.any().to(torch.int32)
        pose_lm.line_inliers = pose_lm.line_inliers + torch.sum(lin & lines.valid).to(torch.int32)
    return Tcw, pin.view(torch.bool), lin


pose_lm.launches = 0
pose_lm.count_lines = False
pose_lm.line_launches = 0
pose_lm.line_inliers = 0


def pose_optimization(Tcw0, pts: PointObs, K, bf, lines: LineObs | None = None):
    """-> (Tcw f32[4,4], pt_inlier bool[N], line_inlier bool[L] | None).

    B3 on CUDA tensors, the plain twin on CPU tensors. K is the host-side
    3x3 intrinsics (numpy or CPU tensor): the kernel takes them as
    launch arguments."""
    if pts.xw.device.type == "cpu":
        return pose_optimization_plain(Tcw0, pts, K, bf, lines)
    return pose_lm(Tcw0, pts, K, bf, lines)
