"""Frozen copy of the plain pose solve of plslam_tpu_torch/solvers/pose.py
(`pose_optimization_plain` and what it calls): LM over point and line
reprojection errors, 4 rounds on the (4, 2, 2, 2) iteration schedule,
chi2 re-classification between rounds, Huber off in the last round. The
benchmark's reference imports nothing of the port."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import constants as C
from portbench.reference import se3

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
    line_inlier bool[L] | None), or the same with a leading problem axis
    for stacked problems. No host synchronisation."""
    if Tcw0.ndim == 3:
        outs = [_solve_plain(Tcw0[p], PointObs(*(f[p] for f in pts)), K, bf,
                             None if lines is None else LineObs(*(f[p] for f in lines)))
                for p in range(Tcw0.shape[0])]
        return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                None if lines is None else torch.stack([o[2] for o in outs]))
    return _solve_plain(Tcw0, pts, K, bf, lines)


def _solve_plain(Tcw0, pts: PointObs, K, bf, lines: LineObs | None):
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
