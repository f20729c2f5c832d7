"""Kernel B1: FAST-9/16 scores at two thresholds + 7x7 Gaussian blur of
the whole pyramid stack, from one read of each pixel; and kernel B4, its
single-image form without the blur.

Replaces `_band_kernel_stack` (plslam_tpu/ops/fast_pallas.py:145, launched
by `fast_scores_pallas_stack`, used at plslam_tpu/features/orb.py:106-116).
CUDA source: csrc/fast_blur.cu. Its bytes bound on the card is one read
of the f32[L, H, W] stack and three writes (s_hi, s_lo, blur), ~34 MB at
8 x 480 x 640, ~10 us at 3.35 TB/s; the per-pixel work is what it has to
keep under that. Each block loads a 64x16 tile with its 3-px halo by one
TMA copy and each thread walks 4 pixels down a column with a 7x7 window
in registers; ring bits come from sign bits, and the relu sums run only
in warps that found a 9-arc.

Tiles that lie beyond a level's live extent are written as zeros without
compute. The live extent is the level's true (h, w) from `level_shapes`
rounded up to the FAST fallback cell (32 px): every cell that holds a real
pixel is computed in full, so the per-cell fallback downstream sees exactly
what it sees on the full plane, and the zeroed region holds no pixel that
survives the border mask.

B4 (`fast_scores`) replaces `_band_kernel` (plslam_tpu/ops/fast_pallas.py:48,
launched by `fast_scores_pallas` at :87): the same CUDA kernel instantiated
without the blur, on one f32[H, W] image with every tile live. Bound by one
read and two writes, 3.7 MB at 480 x 640, ~1.1 us at 3.35 TB/s.
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


def fast_scores_plain(img, ini_th: float, min_th: float):
    """Plain PyTorch twin of B4: (s_hi, s_lo), each f32[H, W]."""
    return fast.fast_scores(img, ini_th), fast.fast_scores(img, min_th)


def fast_scores(img, ini_th: float, min_th: float):
    """B4 on a CUDA image; the plain twin for a CPU image."""
    if img.device.type == "cpu":
        return fast_scores_plain(img, ini_th, min_th)
    from plslam_tpu_torch import _build

    if img.device.type != "cuda" or img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError(f"fast_scores wants a CUDA f32[H, W], got {img.dtype} "
                         f"{tuple(img.shape)} on {img.device}")
    img = img.contiguous()
    hi, lo = torch.empty_like(img), torch.empty_like(img)
    H, W = img.shape
    rc = _build.library().plslam_fast_scores(
        img.data_ptr(), hi.data_ptr(), lo.data_ptr(), H, W, float(ini_th), float(min_th),
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    _build.check(rc, "fast_scores")
    fast_scores.launches += 1
    return hi, lo


fast_scores.launches = 0
