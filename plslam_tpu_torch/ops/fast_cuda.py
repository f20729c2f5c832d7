"""Kernel B1: FAST-9/16 scores at two thresholds + 7x7 Gaussian blur of
the whole pyramid stack, from one read of each pixel.

Replaces `_band_kernel_stack` (plslam_tpu/ops/fast_pallas.py:145, launched
by `fast_scores_pallas_stack`, used at plslam_tpu/features/orb.py:106-116).
CUDA source: csrc/fast_blur.cu. On the card the kernel is bound by memory
traffic: one read of the f32[L, H, W] stack and three writes (s_hi, s_lo,
blur), ~39 MB at 8 x 480 x 640, ~12 us at 3.35 TB/s. It reads each 32x8
tile once into shared memory with a 3-px halo and computes the 16 ring
differences, both arc tests, both scores and the separable blur from it.

Tiles that lie beyond a level's live extent are written as zeros without
compute. The live extent is the level's true (h, w) from `level_shapes`
rounded up to the FAST fallback cell (32 px): every cell that holds a real
pixel is computed in full, so the per-cell fallback downstream sees exactly
what it sees on the full plane, and the zeroed region holds no pixel that
survives the border mask.
"""

from __future__ import annotations

import ctypes

import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops import fast, pyramid


def live_extents(level_hw, height: int, width: int, cell: int = C.FAST_CELL):
    """Per-level (h, w) rounded up to the FAST cell, clipped to the plane."""
    return [
        (min(-(-h // cell) * cell, height), min(-(-w // cell) * cell, width))
        for h, w in level_hw
    ]


def _live_mask(level_hw, L, H, W, device):
    ext = live_extents(level_hw, H, W)
    hs = torch.tensor([h for h, _ in ext], device=device)[:, None, None]
    ws = torch.tensor([w for _, w in ext], device=device)[:, None, None]
    ys = torch.arange(H, device=device)[None, :, None]
    xs = torch.arange(W, device=device)[None, None, :]
    return (ys < hs) & (xs < ws)


def fast_blur_stack_plain(stack, level_hw, ini_th: float, min_th: float):
    """Plain PyTorch twin of B1: (s_hi, s_lo, blur), each f32[L, H, W]."""
    L, H, W = stack.shape
    live = _live_mask(level_hw, L, H, W, stack.device)
    outs = (
        fast.fast_scores(stack, ini_th),
        fast.fast_scores(stack, min_th),
        pyramid.blur_stack(stack),
    )
    return tuple(torch.where(live, o, 0.0) for o in outs)


def fast_blur_stack(stack, level_hw, ini_th: float, min_th: float):
    """B1 on a CUDA stack; the plain twin for a CPU stack."""
    if stack.device.type == "cpu":
        return fast_blur_stack_plain(stack, level_hw, ini_th, min_th)
    from plslam_tpu_torch import _build

    if stack.device.type != "cuda" or stack.dtype != torch.float32 or stack.ndim != 3:
        raise ValueError(f"fast_blur_stack wants a CUDA f32[L, H, W], got {stack.dtype} "
                         f"{tuple(stack.shape)} on {stack.device}")
    L, H, W = stack.shape
    if len(level_hw) != L or L > 16:
        raise ValueError(f"need 1..16 levels with one extent each, got {L} / {len(level_hw)}")
    stack = stack.contiguous()
    hi, lo, blur = (torch.empty_like(stack) for _ in range(3))
    ext = live_extents(level_hw, H, W)
    hs = (ctypes.c_int * L)(*[h for h, _ in ext])
    ws = (ctypes.c_int * L)(*[w for _, w in ext])
    g = (ctypes.c_float * 7)(*[float(v) for v in pyramid._gauss_kernel(7, 2.0)])
    rc = _build.library().plslam_fast_blur_stack(
        stack.data_ptr(), hi.data_ptr(), lo.data_ptr(), blur.data_ptr(),
        L, H, W, float(ini_th), float(min_th), hs, ws, g,
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    _build.check(rc, "fast_blur_stack")
    fast_blur_stack.launches += 1
    return hi, lo, blur


fast_blur_stack.launches = 0
