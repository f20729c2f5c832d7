"""Sim(3) similarity transforms for loop closing.

Port of plslam_tpu/geometry/sim3.py (g2o::Sim3): a Sim3 is a tuple
(R [..., 3, 3], t [..., 3], s [...]); twists are [..., 7] =
(rho, phi, sigma). Action: S(p) = s * R @ p + t.

exp uses W = integral_0^1 e^{sigma u} R(u theta) du = C I + A K + B K^2 in
closed form, with Taylor series in the small-theta / small-sigma corners.
Both branches of every `torch.where` are kept finite (the guarded
argument, not the result, is switched), so forward-mode derivatives at
xi = 0, where the essential graph linearises, are finite and the
reference's.
"""

from __future__ import annotations

import torch

from plslam_tpu_torch.geometry import se3
from plslam_tpu_torch.utils.precision import mm


def identity(batch=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch) + (3, 3))
    t = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
    s = torch.ones(tuple(batch), dtype=dtype, device=device)
    return R, t, s


def from_se3(T, s=None):
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return T[..., :3, :3], T[..., :3, 3], s


def to_se3(S):
    """Fold the scale into the translation: SE3 (R, t / s)."""
    R, t, s = S
    return se3.from_rt(R, t / s[..., None])


def apply(S, p):
    R, t, s = S
    if p.ndim >= 2 and p.shape[-1] == 3 and p.ndim - 1 >= R.ndim - 2:
        return s[..., None, None] * mm(p, R.transpose(-1, -2)) + t[..., None, :]
    return s[..., None] * mm(R, p[..., None])[..., 0] + t


def compose(A, B):
    """A after B: S_A(S_B(x))."""
    RA, tA, sA = A
    RB, tB, sB = B
    return mm(RA, RB), sA[..., None] * mm(RA, tB[..., None])[..., 0] + tA, sA * sB


def inverse(S):
    R, t, s = S
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return Rt, -sinv[..., None] * mm(Rt, t[..., None])[..., 0], sinv


def _W_coeffs(theta2, sigma, s):
    """Coefficients (C, A, B) of W = C I + A K + B K^2; series below
    theta^2 < 1e-3 and |sigma| < 0.25 (float32 cancellation), as the
    reference."""
    small_t = theta2 < 1e-3
    small_s = torch.abs(sigma) < 0.25
    sig = torch.where(small_s, torch.ones_like(sigma), sigma)
    th = torch.where(small_t, torch.ones_like(theta2),
                     torch.sqrt(torch.where(small_t, torch.ones_like(theta2), theta2)))
    # C = (s - 1) / sigma = int_0^1 e^{sigma u} du
    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma**2 / 6.0 + sigma**3 / 24.0, (s - 1.0) / sig)
    # theta not small: smooth in sigma, sigma = 0 included
    a = s * torch.sin(th)
    b = s * torch.cos(th)
    c2 = th * th + sigma * sigma
    A_gen = (a * sigma + (1.0 - b) * th) / (th * c2)
    B_gen = (C - ((b - 1.0) * sigma + a * th) / c2) / (th * th)
    # theta -> 0: A = int u e^{su}, B = (1/2) int u^2 e^{su}
    A_t0 = torch.where(small_s, 0.5 + sigma / 3.0 + sigma**2 / 8.0 + sigma**3 / 30.0,
                       (s * (sig - 1.0) + 1.0) / (sig * sig))
    B_t0 = torch.where(small_s, 1.0 / 6.0 + sigma / 8.0 + sigma**2 / 20.0 + sigma**3 / 72.0,
                       (s * (sig * sig - 2.0 * sig + 2.0) - 2.0) / (2.0 * sig * sig * sig))
    return C, torch.where(small_t, A_t0, A_gen), torch.where(small_t, B_t0, B_gen)


def _W(phi, sigma, s):
    theta2 = torch.sum(phi * phi, -1)
    K = se3.hat(phi)
    C, A, B = _W_coeffs(theta2, sigma, s)
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return C[..., None, None] * I + A[..., None, None] * K + B[..., None, None] * mm(K, K)


def exp(xi):
    """[..., 7] = (rho, phi, sigma) -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    return se3.so3_exp(phi), mm(_W(phi, sigma, s), rho[..., None])[..., 0], s


def _solve3(A, b):
    """A [..., 3, 3] x = b [..., 3] by Cramer's rule. `linalg.solve`'s
    forward-mode derivative under `vmap` reads the wrong batch element
    (torch 2.13), and the essential graph needs exactly that."""
    c0 = torch.linalg.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c1 = torch.linalg.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c2 = torch.linalg.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = torch.sum(A[..., 0, :] * c0, -1)
    adj_b = c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]  # adj(A) b
    return adj_b / det[..., None]


def log(S):
    """Sim3 -> [..., 7]: invert exp by solving W rho = t."""
    R, t, s = S
    phi = se3.so3_log(R)
    sigma = torch.log(s)
    return torch.cat([_solve3(_W(phi, sigma, s), t), phi, sigma[..., None]], -1)


def stack(Ss):
    Rs, ts, ss = zip(*Ss)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ss)
