"""Frozen copy of plslam_tpu_torch/geometry/se3.py: the benchmark's reference imports nothing of the port.

SE(3) on 4x4 homogeneous float32 matrices + se(3) exp/log.

Port of plslam_tpu/geometry/se3.py (the functions the tracking step uses).
Poses are [..., 4, 4] `Tcw` (world->camera); twists are [..., 6] =
(rho, phi) = (translation part, rotation part), g2o's SE3Quat order.
Formulas, Taylor cut-offs and operation order follow the reference so the
two packages agree to float32 rounding.
"""

from __future__ import annotations

import torch


_EPS = 1e-8
_SMALL_THETA2 = 1e-3  # f32: below theta ~ 0.03, 1-cos / t-sin cancel


def hat(phi):
    """so(3) hat: [..., 3] -> [..., 3, 3] skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def _so3_coeffs(theta2):
    """Taylor-safe (A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    small = theta2 < _SMALL_THETA2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0, (1.0 - torch.cos(theta)) / t2)
    C = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (theta - torch.sin(theta)) / (t2 * theta),
    )
    return A, B, C


def _eye3_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi):
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    A, B, _ = _so3_coeffs(torch.sum(phi * phi, -1))
    K = hat(phi)
    return _eye3_like(K) + A[..., None, None] * K + B[..., None, None] * torch.matmul(K, K)


def so3_log(R):
    """[..., 3, 3] -> [..., 3] through the canonical (w >= 0) quaternion."""
    q = to_quat_xyzw(R)
    xyz, w = q[..., :3], q[..., 3]
    n = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(n > 1e-7, theta / (n + _EPS), 2.0 / torch.clamp(w, min=0.5))
    return xyz * scale[..., None]


def exp(xi):
    """se(3) exp: twist [..., 6] = (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    A, B, Cc = _so3_coeffs(torch.sum(phi * phi, -1))
    K = hat(phi)
    I = _eye3_like(K)
    K2 = torch.matmul(K, K)
    R = I + A[..., None, None] * K + B[..., None, None] * K2
    V = I + B[..., None, None] * K + Cc[..., None, None] * K2
    t = torch.matmul(V, rho[..., None])[..., 0]
    return from_rt(R, t)


def log(T):
    """[..., 4, 4] -> twist [..., 6] = (rho, phi)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, -1)
    A, B, _ = _so3_coeffs(theta2)
    K = hat(phi)
    small = theta2 < _SMALL_THETA2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B + _EPS)) / torch.where(small, torch.ones_like(theta2), theta2),
    )
    Vinv = _eye3_like(K) - 0.5 * K + coef[..., None, None] * torch.matmul(K, K)
    rho = torch.matmul(Vinv, t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def from_rt(R, t):
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)  # a fill kernel: assigning a Python number copies it from the host
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def identity(batch=(), dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch) + (4, 4)).clone()


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -torch.matmul(Rt, t[..., None])[..., 0])


def compose(A, B):
    return torch.matmul(A, B)


def transform(T, p):
    """Apply [..., 4, 4] to points [..., N, 3] (or [..., 3]), elementwise
    like the reference (nine multiplies, no matmul)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if p.ndim >= 2 and p.shape[-1] == 3 and p.ndim - 1 >= T.ndim - 2:
        R_ = R[..., None, :, :]
        t_ = t[..., None, :]
    else:
        R_, t_ = R, t
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [
            R_[..., 0, 0] * x + R_[..., 0, 1] * y + R_[..., 0, 2] * z + t_[..., 0],
            R_[..., 1, 0] * x + R_[..., 1, 1] * y + R_[..., 1, 2] * z + t_[..., 1],
            R_[..., 2, 0] * x + R_[..., 2, 1] * y + R_[..., 2, 2] * z + t_[..., 2],
        ],
        -1,
    )


def translation(T):
    return T[..., :3, 3]


def to_quat_xyzw(R):
    """Rotation matrix -> quaternion (x, y, z, w), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], -1) / (4.0 * qw0[..., None])
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1) / (4.0 * qx1[..., None])
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], -1) / (4.0 * qy2[..., None])
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], -1) / (4.0 * qz3[..., None])
    cands = torch.stack([q0, q1, q2, q3], -2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    k = torch.argmax(scores, -1)
    q = torch.gather(cands, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def from_quat_xyzw(q, t):
    """Quaternion (x, y, z, w) + translation -> [..., 4, 4]."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
    return from_rt(R, t)
