"""Rigid / similarity alignment by Horn's quaternion method.

Port of `_horn` from plslam_tpu/solvers/sim3_solver.py:37-75 (the closed
form inside Sim3Solver::ComputeSim3), used by the PnP RANSAC of
relocalization. The rest of the reference module (`solve_sim3_ransac`,
`optimize_sim3`) belongs to loop closing and is not ported yet.

The 4x4 symmetric eigenproblem goes to `torch.linalg.eigh`, batched. The
eigenvector's sign is free and does not matter (R is quadratic in q);
where the two largest eigenvalues (nearly) coincide, the vector picked may
differ from LAPACK's in the reference, as it may between any two solvers.
"""

from __future__ import annotations

import torch

from plslam_tpu_torch.geometry import se3


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
