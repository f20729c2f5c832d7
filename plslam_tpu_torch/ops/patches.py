"""Kernel B2: one 39x39 window per keypoint from the blurred stack.

Replaces `gather_patches_pallas` (plslam_tpu/ops/patches.py:44, its inner
`kernel`, used at plslam_tpu/features/orb.py:168-176). CUDA source:
csrc/patches.cu. The TPU kernel DMA'd tile-aligned bf16 [48, 256] windows
and rotated them in registers to satisfy (8, 128) tiling; here one block
per keypoint does coalesced row loads and writes f32[K, 39, 39], equal to
the plain `dynamic_slice` gather (plslam_tpu/ops/patches.py:29-40), start
rules included. It is
bound by memory traffic: K x 39 x 39 floats read and written, ~12 MB at
K = 1000, ~4 us at 3.35 TB/s.
"""

from __future__ import annotations

import torch


def _starts(yx, H, W, size):
    """Window top-left as lax.dynamic_slice takes it: a negative start is
    first wrapped once by the dimension (Python-style), then the start is
    clamped into [0, dim - size]. Only padded slots reach either rule."""
    r = size // 2

    def one(v, dim):
        v = v.long() - r
        return torch.clamp(torch.where(v < 0, v + dim, v), 0, dim - size)

    return one(yx[:, 0], H), one(yx[:, 1], W)


def gather_patches_plain(img, yx, size: int):
    """img f32[H, W], centres yx i32[K, 2] -> f32[K, size, size]."""
    H, W = img.shape
    ys, xs = _starts(yx, H, W, size)
    ar = torch.arange(size, device=img.device)
    return img[(ys[:, None] + ar)[:, :, None], (xs[:, None] + ar)[:, None, :]]


def gather_patches(img, yx, size: int):
    """B2 on CUDA tensors; the plain twin for CPU tensors."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, yx, size)
    from plslam_tpu_torch import _build

    H, W = img.shape
    if (img.device.type != "cuda" or img.dtype != torch.float32 or yx.device != img.device
            or yx.ndim != 2 or yx.shape[1] != 2 or not (0 < size <= min(H, W))):
        raise ValueError("gather_patches wants CUDA f32[H, W] and i32[K, 2] on one device")
    img = img.contiguous()
    yx = yx.to(torch.int32).contiguous()
    K = yx.shape[0]
    out = torch.empty((K, size, size), dtype=torch.float32, device=img.device)
    rc = _build.library().plslam_gather_patches(
        img.data_ptr(), yx.data_ptr(), out.data_ptr(), H, W, K, size,
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    _build.check(rc, "gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
