"""Two-view triangulation and epipolar gating (CreateNewMapPoints).

Port of plslam_tpu/solvers/triangulate.py: depthless features of a new
keyframe are matched against a covisible keyframe under the epipolar
constraint (|x2^T F21 x1| as a point-to-epiline distance), triangulated by
the closed-form ray midpoint, and accepted by the reference's checks:
positive depth in both views, reprojection chi2 within CHI2_MONO / invSigma2,
and at least ~1 degree of parallax.

Matrix inverses use `linalg.inv_ex`: `linalg.inv` checks its result on
the host, which is a device synchronisation.
"""

from __future__ import annotations

import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.geometry import camera, se3
from plslam_tpu_torch.utils.precision import mm


def _inv(A):
    return torch.linalg.inv_ex(A).inverse


def fundamental_from_poses(Tcw1, Tcw2, K):
    """F21 such that x2^T F21 x1 = 0 for projections x of one world point."""
    T12 = se3.compose(Tcw1, se3.inverse(Tcw2))  # cam1 <- cam2
    T21 = se3.inverse(T12)  # cam2 <- cam1
    E21 = mm(se3.hat(T21[:3, 3]), T21[:3, :3])
    Kinv = _inv(K)
    return mm(Kinv.t(), mm(E21, Kinv))


def epipolar_distance(uv1, uv2, F21):
    """[N1, 2] x [N2, 2] -> |distance of x2 to the epiline F21 x1| [N1, N2]."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], -1)
    lines = mm(x1, F21.t())  # [N1, 3] epilines in image 2
    norm = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2) + 1e-9
    x2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], -1)
    return torch.abs(mm(lines, x2.t())) / norm[:, None]


def triangulate_midpoint(Tcw1, Tcw2, K, uv1, uv2):
    """Batched two-view midpoint triangulation -> (world points [N, 3],
    cosine of the parallax angle [N])."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    def ray(Tcw, uv):
        Twc = se3.inverse(Tcw)
        d_cam = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, torch.ones_like(uv[:, 0])], -1)
        d = se3.transform(se3.from_rt(Twc[:3, :3], torch.zeros_like(Twc[:3, 3])), d_cam)
        return Twc[:3, 3], d / torch.linalg.norm(d, dim=-1, keepdim=True)

    c1, d1 = ray(Tcw1, uv1)
    c2, d2 = ray(Tcw2, uv2)
    b = c2 - c1
    d11 = torch.sum(d1 * d1, -1)
    d22 = torch.sum(d2 * d2, -1)
    d12 = torch.sum(d1 * d2, -1)
    denom = d11 * d22 - d12 * d12
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t1 = (torch.sum(b * d1, -1) * d22 - torch.sum(b * d2, -1) * d12) / denom
    t2 = (torch.sum(b * d1, -1) * d12 - torch.sum(b * d2, -1) * d11) / denom
    p1 = c1 + t1[:, None] * d1
    p2 = c2 + t2[:, None] * d2
    parallax_cos = torch.clamp(d12 / torch.sqrt(d11 * d22), -1.0, 1.0)
    return 0.5 * (p1 + p2), parallax_cos


def triangulation_checks(Tcw1, Tcw2, K, uv1, uv2, pw, parallax_cos, inv_sigma2_1, inv_sigma2_2):
    """The reference's acceptance tests: positive depth in both views,
    reprojection chi2 below CHI2_MONO, real parallax. -> bool[N]."""
    ok = parallax_cos < 0.9998  # ~1 degree of parallax at least
    for Tcw, uv, is2 in ((Tcw1, uv1, inv_sigma2_1), (Tcw2, uv2, inv_sigma2_2)):
        pc = se3.transform(Tcw, pw)
        ok = ok & (pc[:, 2] > 0.05)
        chi2 = torch.sum((camera.project(K, pc) - uv) ** 2, -1) * is2
        ok = ok & (chi2 < C.CHI2_MONO)
    return ok
