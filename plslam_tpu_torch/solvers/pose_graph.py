"""Essential-graph (pose-graph) optimisation over Sim3 nodes.

Port of plslam_tpu/solvers/pose_graph.py (Optimizer::OptimizeEssentialGraph,
20 LM iterations): after a loop closure every keyframe pose is
redistributed so that the loop edge and the odometry / covisibility edges
agree; landmarks then follow their reference keyframe.

Edges are a dense [K, K] mask over all K(K-1)/2 pairs (spanning tree,
strong covisibility and loop edges), the residual
r_ij = log(S_meas_ij * S_j * S_i^-1) is evaluated for every pair at once and
its 7x7 Jacobians by forward-mode autodiff at xi = 0 (`torch.func.jacfwd`
under `vmap`, as the reference's `jax.jacfwd`), then Gauss-Newton with
additive damping on the dense [7K, 7K] system (`linalg.solve_ex`). RGB-D
fixes the scale: the sigma part of every update is dropped.

Difference in mechanism: the reference scatters the per-pair blocks into
H with `.at[].add`. The pairs are dense and each appears once, so here
each pair's blocks are written to its own cell of a [K, K, 7, 7] tensor
and the diagonal blocks are row and column sums of it: no float atomics,
so the card gives the same poses on every run (the SearchAndFuse that
follows is discrete). Sums run in another order than the reference's.
"""

from __future__ import annotations

import torch

from plslam_tpu_torch.geometry import se3, sim3


def _residual(xi_i, xi_j, Si, Sj, Smeas):
    """r = log(Smeas * (exp(xi_j) Sj) * (exp(xi_i) Si)^-1) -> [7]."""
    Sj_p = sim3.compose(sim3.exp(xi_j), Sj)
    Si_p = sim3.compose(sim3.exp(xi_i), Si)
    return sim3.log(sim3.compose(Smeas, sim3.compose(Sj_p, sim3.inverse(Si_p))))


def _res_and_jac(Si, Sj, Sm):
    """Residual and its Jacobians in xi_i, xi_j at xi = 0 for a batch of
    pairs: -> r [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]."""
    def one(*S9):
        # each pair as a batch of one: forward-mode tangents of a 0-dim
        # tensor divided by a Python float come out float64
        z = torch.zeros((1, 7), dtype=S9[0].dtype, device=S9[0].device)
        Si_, Sj_, Sm_ = (tuple(a[None] for a in S9[i:i + 3]) for i in (0, 3, 6))
        r = _residual(z, z, Si_, Sj_, Sm_)
        Ji_, Jj_ = torch.func.jacfwd(_residual, argnums=(0, 1))(z, z, Si_, Sj_, Sm_)
        return r[0], Ji_[0, :, 0], Jj_[0, :, 0]

    return torch.func.vmap(one)(*Si, *Sj, *Sm)


def optimize_essential_graph(poses, node_valid, fixed, edge_mask, meas_R, meas_t, meas_s, n_iters: int = 20,
                             fix_scale: bool = True, damping: float = 1e-6):
    """poses f32[K, 4, 4] initial Tcw (corrected window applied);
    node_valid, fixed bool[K] (invalid nodes are fixed too); edge_mask
    bool[K, K] (upper triangle read); meas_* the Sim3 measurements
    S_meas[i, j] = S_i * S_j^-1. -> corrected poses f32[K, 4, 4]."""
    K = poses.shape[0]
    dev = poses.device
    S = sim3.from_se3(poses)
    iu, ju = torch.triu_indices(K, K, 1, device=dev)
    e_mask = (edge_mask | edge_mask.t())[iu, ju] & node_valid[iu] & node_valid[ju]
    Sm = (meas_R[iu, ju], meas_t[iu, ju], meas_s[iu, ju])
    w = e_mask.to(torch.float32)
    free = node_valid & ~fixed
    fmask = torch.repeat_interleave(free.to(torch.float32), 7)
    eye7k = torch.eye(7 * K, dtype=torch.float32, device=dev)

    def pair_cells(v):
        """v [E, ...] per pair -> [K, K, ...], pair (i, j) at [i, j], 0 elsewhere."""
        out = torch.zeros((K, K) + v.shape[1:], dtype=v.dtype, device=dev)
        out[iu, ju] = v  # each cell written once
        return out

    for _ in range(n_iters):
        R, t, s = S
        r, Ji, Jj = _res_and_jac((R[iu], t[iu], s[iu]), (R[ju], t[ju], s[ju]), Sm)
        Hii = pair_cells(torch.einsum("eai,e,eaj->eij", Ji, w, Ji))
        Hjj = pair_cells(torch.einsum("eai,e,eaj->eij", Jj, w, Jj))
        Hij = pair_cells(torch.einsum("eai,e,eaj->eij", Ji, w, Jj))
        bi = pair_cells(-torch.einsum("eai,e,ea->ei", Ji, w, r))
        bj = pair_cells(-torch.einsum("eai,e,ea->ei", Jj, w, r))
        # node i is the first end of its pairs in row i, the second in column i
        H = Hij + Hij.permute(1, 0, 3, 2)
        diag = torch.arange(K, device=dev)
        H[diag, diag] = torch.sum(Hii, 1) + torch.sum(Hjj, 0)
        Hf = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        bf = (torch.sum(bi, 1) + torch.sum(bj, 0)).reshape(7 * K)
        # fixed and invalid nodes: identity rows
        Hf = Hf * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
        bf = bf * fmask
        lam = damping * torch.max(torch.abs(torch.diagonal(Hf)))
        delta = torch.linalg.solve_ex(Hf + lam * eye7k, bf).result.reshape(K, 7)
        if fix_scale:
            delta = torch.cat([delta[:, :6], torch.zeros_like(delta[:, 6:])], 1)
        delta = torch.where(free[:, None], delta, 0.0)
        S = sim3.compose(sim3.exp(delta), S)
    out = sim3.to_se3(S)
    return torch.where(node_valid[:, None, None], out, poses)


def correct_landmarks(pt_pos, pt_valid, pt_ref_kf, poses_old, poses_new):
    """Move landmarks with their reference keyframe: P' = Twc_new Tcw_old P."""
    ref = torch.clamp(pt_ref_kf, min=0).long()
    T_old = poses_old[ref]  # [P, 4, 4]
    T_new_wc = se3.inverse(poses_new)[ref]
    p_cam = torch.einsum("pij,pj->pi", T_old[:, :3, :3], pt_pos) + T_old[:, :3, 3]
    p_new = torch.einsum("pij,pj->pi", T_new_wc[:, :3, :3], p_cam) + T_new_wc[:, :3, 3]
    return torch.where(pt_valid[:, None], p_new, pt_pos)
