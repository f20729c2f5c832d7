"""Init-free camera pose from 2D-3D matches: batched RANSAC for
relocalization.

Port of plslam_tpu/solvers/pnp.py (the reference's stand-in for
PnPsolver inside Tracking::Relocalization): 3-point hypotheses aligned by
Horn from the frame's own depth, every hypothesis scored against every
match by reprojection chi2, the best refined by a weighted Horn on its
depth-valid inliers and kept only if it does not lose support.

The hypotheses are the reference's own: `utils/jax_random.randint` draws
exactly what `jax.random.randint(PRNGKey(seed), ...)` draws (its random
words made on the host, mapped into range on the device: no readback),
and the seedable matches come first by a stable sort, as `jnp.argsort`
orders them. The winner is the first
hypothesis with the most inliers, as `jnp.argmax` picks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.geometry import camera
from plslam_tpu_torch.solvers.sim3_solver import _horn
from plslam_tpu_torch.utils import jax_random


class PnPResult(NamedTuple):
    Tcw: torch.Tensor  # f32[4, 4]
    n_inliers: torch.Tensor  # i64[]
    inliers: torch.Tensor  # bool[N]
    ok: torch.Tensor  # bool[]


def solve_pnp_ransac(
    xw,
    uv,
    depth,
    inv_sigma2,
    valid,
    K,
    n_hyp: int = 256,
    chi2_th: float = C.CHI2_MONO,
    min_inliers: int = 10,
    seed: int = 0,
):
    """xw f32[N, 3] matched landmark world positions; uv f32[N, 2] observed
    undistorted keypoints; depth f32[N] measured frame depth (<= 0: no
    depth, the match still votes by reprojection but cannot seed a
    hypothesis); inv_sigma2 f32[N] octave weights; K f32[3, 3] on the same
    device. -> PnPResult with Tcw such that p_cam = R p_w + t."""
    p_cam = camera.backproject(K, uv, torch.clamp(depth, min=1e-3))  # [N, 3]
    can_seed = valid & (depth > 0)

    idx = jax_random.randint(seed, (n_hyp, 3), torch.clamp(torch.sum(can_seed), min=1))
    order = torch.argsort((~can_seed).to(torch.int8), stable=True)  # seedable matches first
    samp = order[idx]  # [H, 3]
    R, t, _ = _horn(p_cam[samp], xw[samp], torch.ones((n_hyp, 3), dtype=xw.dtype, device=xw.device))

    # reprojection scoring of all hypotheses against all matches
    pc = torch.einsum("hij,nj->hni", R, xw) + t[:, None, :]  # [H, N, 3]
    chi2 = torch.sum((camera.project(K, pc) - uv[None]) ** 2, -1) * inv_sigma2[None]
    inl = (chi2 < chi2_th) & valid[None] & (pc[..., 2] > 0.05)
    counts = torch.sum(inl, -1)
    best = torch.argmax(counts)  # the first maximum, as jnp.argmax
    best_inl = inl[best]

    # refine with a weighted Horn on the depth-valid winning inliers, recount
    w = (best_inl & can_seed).to(xw.dtype)
    Rr, tr, _ = _horn(p_cam, xw, w)
    pc_r = torch.einsum("ij,nj->ni", Rr, xw) + tr
    chi2_r = torch.sum((camera.project(K, pc_r) - uv) ** 2, -1) * inv_sigma2
    inl_r = (chi2_r < chi2_th) & valid & (pc_r[:, 2] > 0.05)
    # keep the refined transform only if it did not lose support
    better = torch.sum(inl_r) >= counts[best]
    Rf = torch.where(better, Rr, R[best])
    tf = torch.where(better, tr, t[best])
    inl_f = torch.where(better, inl_r, best_inl)
    Tcw = torch.eye(4, dtype=xw.dtype, device=xw.device)
    Tcw[:3, :3] = Rf
    Tcw[:3, 3] = tf
    n = torch.sum(inl_f)
    return PnPResult(Tcw=Tcw, n_inliers=n, inliers=inl_f, ok=n >= min_inliers)
