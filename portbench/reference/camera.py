"""Frozen copy of plslam_tpu_torch/geometry/camera.py: the benchmark's reference imports nothing of the port.

Pinhole camera: projection, undistortion, depth backprojection.

Port of plslam_tpu/geometry/camera.py. OpenCV radial-tangential model
(k1, k2, p1, p2, k3); undistortion is the reference's 8-iteration fixed
point. Batched over leading dims.
"""

from __future__ import annotations

import torch


def project(K, p_cam):
    """Camera-frame points [..., 3] -> undistorted pixels [..., 2]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    z = p_cam[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * p_cam[..., 0] * zi + cx
    v = fy * p_cam[..., 1] * zi + cy
    return torch.stack([u, v], -1)


def project_stereo(K, bf, p_cam):
    """-> [..., 3] = (u, v, u_r) with u_r = u - bf/z."""
    uv = project(K, p_cam)
    z = p_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.cat([uv, (uv[..., 0] - bf / z)[..., None]], -1)


def distort_normalized(dist, xn):
    """Radial-tangential distortion of normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3], dist[..., 4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_pixels(K, dist, uv, iters: int = 8):
    """Distorted pixels -> undistorted pixels (same K), fixed point."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    x = xd
    for _ in range(iters):
        x = xd - (distort_normalized(dist, x) - x)
    return torch.stack([fx * x[..., 0] + cx, fy * x[..., 1] + cy], -1)


def backproject(K, uv, depth):
    """(u, v) [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], -1)


def in_image(uv, width, height, margin=0.0):
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < height - margin)
    )
