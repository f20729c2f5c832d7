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

Every entry also takes P independent problems stacked on a leading axis
(Tcw0 f32[P, 4, 4], PointObs fields [P, N, ...], LineObs fields [P, L, ...]);
B3 solves them in one launch, one block each, and the plain twin one after
the other, each exactly as alone.

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


MAX_PROBLEMS = 8  # problems per launch (csrc/pose_lm.cu)


def smem_limit() -> int:
    """The most row bytes (30 N + 41 L) one problem may stage: the card's
    shared memory per block less the kernel's own, as the C entry checks
    it (asked of the card once)."""
    from plslam_tpu_torch import _build

    if smem_limit.bytes is None:
        out = ctypes.c_int()
        _build.check(_build.library().plslam_pose_lm_smem_limit(ctypes.byref(out)), "pose_lm_smem_limit")
        smem_limit.bytes = out.value
    return smem_limit.bytes


smem_limit.bytes = None


def _staged(t, dtype, shape, dev):
    """-> (problem 0's contiguous data, problem stride in elements): a field
    expanded along the problem axis (stride 0, e.g. the observations both
    of the tracker's problems share) is passed once, with stride 0."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"pose_lm wants {dtype}{list(shape)} on {dev}, got {t.dtype}{list(t.shape)} on {t.device}")
    if t.stride(0) == 0 and t[0].is_contiguous():
        t, stride = t[0], 0
    else:
        t = t.contiguous()
        stride = t.stride(0)
    return (t.view(torch.uint8) if dtype == torch.bool else t), stride


def pose_lm(Tcw0, pts: PointObs, K, bf, lines: LineObs | None = None):
    """Kernel B3: the whole solve of one problem, or of P <= 8 stacked
    problems, in one launch on the card (one block per problem). Same
    contract as pose_optimization_plain; CUDA tensors only.

    The kernel stages each problem's rows into shared memory with bulk
    async copies, so N and L must be multiples of 16, every input 16-byte
    aligned and one problem's rows (30 N + 41 L bytes) within
    `smem_limit()`, about 219 KB on the H100. A field expanded along the
    problem axis is read once for all problems."""
    from plslam_tpu_torch import _build

    dev = pts.xw.device
    if dev.type != "cuda":
        raise ValueError(f"pose_lm wants CUDA tensors, got {dev}")
    batched = Tcw0.ndim == 3
    if not batched:
        Tcw0, pts = Tcw0[None], PointObs(*(f[None] for f in pts))
        lines = None if lines is None else LineObs(*(f[None] for f in lines))
    P, N = pts.xw.shape[:2]
    L = lines.sw.shape[1] if lines is not None else 0
    if not (1 <= P <= MAX_PROBLEMS):
        raise ValueError(f"pose_lm solves 1..{MAX_PROBLEMS} problems per launch, got {P}")
    if not (16 <= N <= 4096 and N % 16 == 0 and L <= 4096 and L % 16 == 0):
        raise ValueError(f"pose_lm wants N in 16..4096 and L <= 4096, both multiples of 16 (got {N}, {L})")
    if 30 * N + 41 * L > smem_limit():
        raise ValueError(f"pose_lm: {30 * N + 41 * L} bytes of rows per problem exceed {smem_limit()}")
    f32, b8 = torch.float32, torch.bool
    keep = [
        _staged(Tcw0, f32, (P, 4, 4), dev), _staged(pts.xw, f32, (P, N, 3), dev),
        _staged(pts.obs, f32, (P, N, 3), dev), _staged(pts.inv_sigma2, f32, (P, N), dev),
        _staged(pts.is_stereo, b8, (P, N), dev), _staged(pts.valid, b8, (P, N), dev),
    ]
    if lines is not None:
        keep += [_staged(lines.sw, f32, (P, L, 3), dev), _staged(lines.ew, f32, (P, L, 3), dev),
                 _staged(lines.line2d, f32, (P, L, 3), dev), _staged(lines.inv_sigma2, f32, (P, L), dev),
                 _staged(lines.valid, b8, (P, L), dev)]
    misaligned = [i for i, (t, _) in enumerate(keep[1:]) if t.data_ptr() % 16]
    if misaligned:
        raise ValueError(f"pose_lm: inputs {misaligned} (PointObs fields, then LineObs fields) are not "
                         "16-byte aligned, which the bulk copies into shared memory need")
    keep += [(None, 0)] * (11 - len(keep))
    Tcw = torch.empty((P, 4, 4), dtype=torch.float32, device=dev)
    pin = torch.empty((P, N), dtype=torch.uint8, device=dev)
    lin = torch.empty((P, max(L, 1)), dtype=torch.uint8, device=dev)
    fx, fy, cx, cy = _intrinsics(K)
    sched = (ctypes.c_int * C.POSE_OPT_ROUNDS)(*C.POSE_OPT_SCHEDULE)
    ptr = [0 if t is None else t.data_ptr() for t, _ in keep]
    strides = (ctypes.c_longlong * 11)(*[st for _, st in keep])
    rc = _build.library().plslam_pose_lm(
        *ptr[:6], N, *ptr[6:], L, P, strides, fx, fy, cx, cy, float(bf), C.POSE_OPT_ROUNDS, sched,
        Tcw.data_ptr(), pin.data_ptr(), lin.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "pose_lm")
    pose_lm.launches += 1
    pin = pin.view(torch.bool)
    lin = None if lines is None else lin[:, :L].view(torch.bool)
    if lines is not None and pose_lm.count_lines:
        # launches fed at least one valid line row, and the line inliers
        # they returned, counted on the card (reading them is the caller's
        # host sync, not the step's); off by default: three small device
        # ops per launch
        pose_lm.line_launches = pose_lm.line_launches + lines.valid.any().to(torch.int32)
        pose_lm.line_inliers = pose_lm.line_inliers + torch.sum(lin & lines.valid).to(torch.int32)
    if not batched:
        return Tcw[0], pin[0], None if lin is None else lin[0]
    return Tcw, pin, lin


pose_lm.launches = 0
pose_lm.count_lines = False
pose_lm.line_launches = 0
pose_lm.line_inliers = 0


def pose_optimization(Tcw0, pts: PointObs, K, bf, lines: LineObs | None = None):
    """-> (Tcw f32[4,4], pt_inlier bool[N], line_inlier bool[L] | None), or
    the same with a leading problem axis for stacked problems.

    B3 on CUDA tensors, the plain twin on CPU tensors. K is the host-side
    3x3 intrinsics (numpy or CPU tensor): the kernel takes them as
    launch arguments."""
    if pts.xw.device.type == "cpu":
        return pose_optimization_plain(Tcw0, pts, K, bf, lines)
    return pose_lm(Tcw0, pts, K, bf, lines)
