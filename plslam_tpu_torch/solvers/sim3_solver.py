"""Sim3 (fixed scale for RGB-D) estimation: batched Horn + RANSAC, then LM.

Port of plslam_tpu/solvers/sim3_solver.py (Sim3Solver, OptimizeSim3):
  * `_horn`: the weighted closed form inside Sim3Solver::ComputeSim3, also
    used by the PnP RANSAC of relocalization. The 4x4 symmetric
    eigenproblem goes to `torch.linalg.eigh`, batched. The eigenvector's
    sign is free and does not matter (R is quadratic in q); where the two
    largest eigenvalues (nearly) coincide, the vector picked may differ
    from LAPACK's in the reference, as it may between any two solvers.
  * `solve_sim3_ransac`: every hypothesis scored at once by bidirectional
    reprojection; its hypotheses are the reference's bit for bit
    (`utils/jax_random.py`), sampled over the valid pairs in a stable
    order, and the first of equally good hypotheses wins (`jnp.argmax`).
  * `optimize_sim3`: 7-parameter LM on bidirectional reprojection edges,
    the reference's schedule (an LM phase, a chi2 prune, another phase);
    the Jacobians by `torch.func.jacfwd` as the reference's `jax.jacfwd`,
    the `fori_loop` a Python loop of fixed count with accept/reject kept
    on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.geometry import camera, se3
from plslam_tpu_torch.utils import jax_random
from plslam_tpu_torch.utils.precision import mm


class Sim3Result(NamedTuple):
    R: torch.Tensor  # f32[3, 3] rotation 1 <- 2
    t: torch.Tensor  # f32[3]
    s: torch.Tensor  # f32[] (1 with a fixed scale)
    n_inliers: torch.Tensor  # i64[]
    inliers: torch.Tensor  # bool[N]
    ok: torch.Tensor  # bool[]


def _horn(p1, p2, w, fix_scale: bool = True):
    """Weighted Horn alignment: (R, t, s) with p1 ~= s R p2 + t.

    p1, p2: [..., N, 3]; w: [..., N] weights."""
    wsum = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-6)
    c1 = torch.sum(p1 * w[..., None], -2) / wsum
    c2 = torch.sum(p2 * w[..., None], -2) / wsum
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = torch.einsum("...ni,...n,...nj->...ij", q1, w, q2)  # [..., 3, 3]
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        -2,
    )  # [..., 4, 4] symmetric
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]  # largest eigenvalue -> quaternion (w, x, y, z)
    # conjugate: this N convention gives the 1 -> 2 rotation; we want 2 -> 1
    quat_xyzw = torch.stack([-q[..., 1], -q[..., 2], -q[..., 3], q[..., 0]], -1)
    R = se3.from_quat_xyzw(quat_xyzw, torch.zeros_like(c1))[..., :3, :3]
    if fix_scale:
        s = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    else:
        rot_q2 = torch.einsum("...ij,...nj->...ni", R, q2)
        s = torch.sum(q1 * rot_q2 * w[..., None], (-2, -1)) / torch.clamp(
            torch.sum(q2 * q2 * w[..., None], (-2, -1)), min=1e-9)
    t = c1 - s[..., None] * torch.einsum("...ij,...j->...i", R, c2)
    return R, t, s


def solve_sim3_ransac(x1, x2, valid, K, Tcw1, Tcw2, n_hyp: int = 256, chi2_th: float = 9.21,
                      min_inliers: int = 20, fix_scale: bool = True, seed: int = 0):
    """x1 / x2 f32[N, 3]: world positions of matched landmarks from the maps
    of keyframes 1 / 2; valid bool[N]; Tcw1 / Tcw2 the two keyframe poses
    (for the bidirectional reprojection inlier test). -> Sim3Result with
    (R, t, s) mapping camera-2 coordinates to camera 1: p_c1 = s R p_c2 + t."""
    p1 = se3.transform(Tcw1, x1)
    p2 = se3.transform(Tcw2, x2)
    idx = jax_random.randint(seed, (n_hyp, 3), torch.clamp(torch.sum(valid), min=1))
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid pairs first
    samp = order[idx]  # [H, 3]
    R, t, s = _horn(p1[samp], p2[samp], torch.ones((n_hyp, 3), dtype=x1.dtype, device=x1.device), fix_scale)

    # every hypothesis against every pair: p2 through (R, t, s) into camera
    # 1 against p1's projection, and p1 back into camera 2
    uv1_obs = camera.project(K, p1)
    uv2_obs = camera.project(K, p2)
    p2_in_1 = s[:, None, None] * torch.einsum("hij,nj->hni", R, p2) + t[:, None, :]
    Rt = R.transpose(-1, -2)
    p1_in_2 = torch.einsum("hij,hnj->hni", Rt, (p1[None] - t[:, None, :]) / s[:, None, None])
    e1 = torch.sum((camera.project(K, p2_in_1) - uv1_obs[None]) ** 2, -1)
    e2 = torch.sum((camera.project(K, p1_in_2) - uv2_obs[None]) ** 2, -1)
    inl = (e1 < chi2_th) & (e2 < chi2_th) & valid[None] & (p2_in_1[..., 2] > 0) & (p1_in_2[..., 2] > 0)
    best_inl = inl[torch.argmax(torch.sum(inl, -1))]  # the first maximum, as jnp.argmax

    # refine on the winning inliers (weighted Horn) and recount
    Rr, tr, sr = _horn(p1, p2, best_inl.to(x1.dtype), fix_scale)
    p2_in_1r = sr * mm(p2, Rr.t()) + tr
    p1_in_2r = mm((p1 - tr) / sr, Rr)
    e1r = torch.sum((camera.project(K, p2_in_1r) - uv1_obs) ** 2, -1)
    e2r = torch.sum((camera.project(K, p1_in_2r) - uv2_obs) ** 2, -1)
    inl_r = (e1r < chi2_th) & (e2r < chi2_th) & valid & (p2_in_1r[:, 2] > 0) & (p1_in_2r[:, 2] > 0)
    n = torch.sum(inl_r)
    return Sim3Result(R=Rr, t=tr, s=sr, n_inliers=n, inliers=inl_r, ok=n >= min_inliers)


def optimize_sim3(p1, p2, uv1, uv2, inv_s2_1, inv_s2_2, valid, K, R0, t0, s0, fix_scale: bool = True,
                  chi2_th: float = C.CHI2_SIM3, iters: int = C.SIM3_OPT_ITERS):
    """LM refinement of a Sim3 on bidirectional reprojection edges
    (Optimizer::OptimizeSim3):

      e1_i = uv1_i - pi(K, s R p2_i + t)          (seen in keyframe 1)
      e2_i = uv2_i - pi(K, (1/s) R^T (p1_i - t))  (seen in keyframe 2)

    p1 / p2 f32[N, 3] camera-frame positions of the matched pair; uv1 /
    uv2 f32[N, 2] the matched keypoints; inv_s2_* their octave weights. A
    left-composed update (rotation, translation, log-scale; the scale
    frozen with fix_scale), `iters` LM steps, a chi2 prune on both
    directions, `iters` more on the inliers.
    -> (R, t, s, inliers bool[N], n_inliers)."""
    dev, f32 = p1.device, torch.float32
    n_par = 7
    zero = torch.zeros(n_par, dtype=f32, device=dev)
    eye = torch.eye(n_par, dtype=f32, device=dev)

    def apply_delta(d, R, t, s):
        dR = se3.exp(torch.cat([torch.zeros(3, dtype=d.dtype, device=dev), d[:3]])[None])[0][:3, :3]
        return mm(dR, R), t + d[3:6], (s if fix_scale else s * torch.exp(d[6]))

    def residuals(d, R, t, s):
        R_, t_, s_ = apply_delta(d, R, t, s)
        q1 = s_ * mm(p2, R_.t()) + t_  # p2 -> camera 1
        q2 = mm(p1 - t_, R_) / s_  # p1 -> camera 2
        return uv1 - camera.project(K, q1), uv2 - camera.project(K, q2), (q1[:, 2] > 1e-3) & (q2[:, 2] > 1e-3)

    def chi2_pair(R, t, s):
        r1, r2, okz = residuals(zero, R, t, s)
        return torch.sum(r1 * r1, -1) * inv_s2_1, torch.sum(r2 * r2, -1) * inv_s2_2, ~okz

    def rho(c):  # Huber on one directed edge (deltaHuber = sqrt(th2))
        return torch.where(c <= chi2_th, c, 2.0 * torch.sqrt(chi2_th * torch.clamp(c, min=0.0)) - chi2_th)

    def cost_fn(R, t, s, active):
        c1, c2, bad_z = chi2_pair(R, t, s)
        w = active & valid
        return torch.sum(torch.where(w, rho(c1) + rho(c2), 0.0)) + 1e7 * torch.sum(w & bad_z)

    def system(R, t, s, active):
        def rvec(d):
            r1, r2, _ = residuals(d, R, t, s)
            return torch.cat([r1, r2], 0)  # [2N, 2]

        J = torch.func.jacfwd(rvec)(zero)  # [2N, 2, 7]
        r0 = rvec(zero)
        c1, c2, bad_z = chi2_pair(R, t, s)
        cc = torch.cat([c1, c2])
        hub = torch.where(cc <= chi2_th, 1.0, torch.sqrt(chi2_th / torch.clamp(cc, min=1e-12)))
        act = torch.cat([active & valid & ~bad_z] * 2)
        w = torch.where(act, torch.cat([inv_s2_1, inv_s2_2]) * hub, 0.0)
        return torch.einsum("eai,e,eaj->ij", J, w, J), -torch.einsum("eai,e,ea->i", J, w, r0)

    def lm_phase(R, t, s, active, n_iters):
        cost = cost_fn(R, t, s, active)
        H, _ = system(R, t, s, active)
        lam = 1e-5 * torch.max(torch.abs(torch.diagonal(H)))
        nu = torch.full((), 2.0, dtype=f32, device=dev)
        for _ in range(n_iters):
            H, g = system(R, t, s, active)
            Hd = H + lam * eye
            if fix_scale:  # freeze the scale row and column
                Hd = torch.cat([torch.cat([Hd[:6, :6], torch.zeros((6, 1), dtype=f32, device=dev)], 1),
                                eye[6:]], 0)
                g = torch.cat([g[:6], zero[:1]])
            d = torch.linalg.solve_ex(Hd, g).result
            R_n, t_n, s_n = apply_delta(d, R, t, s)
            new_cost = cost_fn(R_n, t_n, s_n, active)
            accept = (new_cost < cost) & torch.all(torch.isfinite(d))
            R = torch.where(accept, R_n, R)
            t = torch.where(accept, t_n, t)
            s = torch.where(accept, s_n, s)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, lam / 3.0, lam * nu)
            nu = torch.where(accept, 2.0, nu * 2.0)
        return R, t, s

    active = torch.ones_like(valid)
    R, t, s = lm_phase(R0, t0, s0, active, iters)
    # prune a pair if either directed edge fails the chi2 gate
    c1, c2, bad_z = chi2_pair(R, t, s)
    active = valid & (c1 <= chi2_th) & (c2 <= chi2_th) & ~bad_z
    R, t, s = lm_phase(R, t, s, active, iters)
    c1, c2, bad_z = chi2_pair(R, t, s)
    inl = valid & (c1 <= chi2_th) & (c2 <= chi2_th) & ~bad_z
    return R, t, s, inl, torch.sum(inl)
