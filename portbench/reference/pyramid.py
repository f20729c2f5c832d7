"""Frozen copy of plslam_tpu_torch/ops/pyramid.py: the benchmark's reference imports nothing of the port.

Image pyramid stack + 7x7 sigma=2 Gaussian blur.

Port of plslam_tpu/ops/pyramid.py. The numpy matrix builders are copied
verbatim so the interpolation and blur weights are bit-equal to the
reference's; they are applied with float32 `torch.matmul` (a plain product
that the reference also leaves outside any kernel). Every level lives on
one [L, H, W] plane; the area beyond a level's true extent is
edge-replicated (encoded in the matrices).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static per-level (H, W) like the reference (round(W / s^l))."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / scale_factor**l
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def _interp_1d(n_out: int, n_in: int):
    """1D resize matrix f64[n_out, n_in] matching jax.image.resize
    'bilinear': half-pixel-center sampling with the triangle kernel SCALED
    by the downsample factor (antialiasing), edge-clamped and re-normalized
    — the exact weights the per-level resize chain used."""
    M = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    s = max(scale, 1.0)  # kernel width scaling (downsample only)
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        j_lo = int(np.floor(src - s)) - 1
        j_hi = int(np.ceil(src + s)) + 1
        for j in range(j_lo, j_hi + 1):
            w = max(0.0, 1.0 - abs(j - src) / s)
            if w > 0.0 and 0 <= j < n_in:  # out-of-bounds taps dropped,
                M[i, j] += w  # then renormalized (jax.image.resize edge rule)
        M[i] /= M[i].sum()
    return M


@functools.lru_cache(maxsize=8)
def pyramid_matrices(height: int, width: int, n_levels: int, scale_factor: float):
    """-> (AH f32[L, H, H], AW f32[L, W, W]) composed per-level interp
    matrices. Rows/cols beyond a level's true (h_l, w_l) replicate the last
    real row/col (edge extension for halo reads)."""
    shapes = level_shapes(height, width, n_levels, scale_factor)
    AH = np.zeros((n_levels, height, height), np.float64)
    AW = np.zeros((n_levels, width, width), np.float64)
    Ch = np.eye(height)
    Cw = np.eye(width)
    prev_h, prev_w = height, width
    for l, (h, w) in enumerate(shapes):
        if l > 0:
            Ch = _interp_1d(h, prev_h) @ Ch  # [h_l, H]
            Cw = _interp_1d(w, prev_w) @ Cw
            prev_h, prev_w = h, w
        AH[l, :h] = Ch
        AH[l, h:] = Ch[h - 1]  # edge replication
        AW[l, :w] = Cw
        AW[l, w:] = Cw[w - 1]
    return AH.astype(np.float32), AW.astype(np.float32)


@functools.lru_cache(maxsize=8)
def blur_matrices(height: int, width: int, ksize: int = 7, sigma: float = 2.0):
    """-> (BH f32[H, H], BW f32[W, W]) banded separable Gaussian with edge
    clamping, shared by every level (the blur is pixel-grid-local)."""
    k = _gauss_kernel(ksize, sigma).astype(np.float64)
    r = ksize // 2

    def band(n):
        B = np.zeros((n, n), np.float64)
        for i in range(n):
            for d in range(-r, r + 1):
                B[i, min(max(i + d, 0), n - 1)] += k[d + r]
        return B.astype(np.float32)

    return band(height), band(width)


@functools.lru_cache(maxsize=8)
def _gauss_kernel(ksize: int, sigma: float):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


# The matrices as float32 tensors on a device, uploaded once per process
# (a frame must not re-upload ~20 MB of weights); right factors transposed.
@functools.lru_cache(maxsize=4)
def _pyramid_on(height: int, width: int, n_levels: int, scale_factor: float, device: str):
    AH, AW = pyramid_matrices(height, width, n_levels, scale_factor)
    return torch.from_numpy(AH).to(device), torch.from_numpy(AW).transpose(1, 2).contiguous().to(device)


@functools.lru_cache(maxsize=4)
def _blur_on(height: int, width: int, device: str):
    BH, BW = blur_matrices(height, width)
    return torch.from_numpy(BH).to(device), torch.from_numpy(BW).t().contiguous().to(device)


def build_pyramid_stack(img, n_levels: int, scale_factor: float):
    """img f32[H, W] -> f32[L, H, W]: AH_l @ img @ AW_l^T per level."""
    AH, AWt = _pyramid_on(*img.shape, n_levels, scale_factor, str(img.device))
    return torch.matmul(torch.matmul(AH, img), AWt)


def blur_stack(stack):
    """f32[L, H, W] -> per-level 7x7 sigma=2 blur as two batched matmuls
    (edge clamping at the plane border)."""
    BH, BWt = _blur_on(*stack.shape[1:], str(stack.device))
    return torch.matmul(torch.matmul(BH[None], stack), BWt[None])
