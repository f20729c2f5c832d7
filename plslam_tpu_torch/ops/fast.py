"""FAST-9/16 scores, 3x3 NMS and the per-cell fallback / border tail.

Port of plslam_tpu/ops/fast.py. `fast_scores` is the plain twin of the
scoring half of kernels B1 and B4 (ops/fast_cuda.py); the NMS / fallback /
border tail stays PyTorch code, as it stayed XLA code beside the TPU
kernel. `fast_with_fallback` is the single-image entry: B4 on a CUDA
image, the plain scores on a CPU one, then the same tail.

Corner test: 16-pixel Bresenham ring of radius 3; a corner has >= 9
contiguous ring pixels all brighter than p + t or all darker than p - t.
Score: max over polarity of the sum of (|I_i - I_p| - t) over qualifying
ring pixels (SAD proxy), 0 where not a corner.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# (dy, dx), clockwise from 12 o'clock: the standard FAST-16 ring.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # contiguous run length for FAST-9


def _shifted(img, dy, dx):
    """img[..., clamp(y+dy), clamp(x+dx)]: edge-replicated neighbour plane."""
    H, W = img.shape[-2:]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def arc_any(bits):
    """int32 ring words (bit i = ring mask i) -> bool: any run of ARC
    contiguous set bits on the circular 16-ring (ring doubled to 32 bits,
    then ARC-1 shift-ANDs — the same boolean function as the reference's
    AND-of-rolls)."""
    ww = bits | (bits << 16)
    r = ww
    for k in range(1, ARC):
        r = r & (ww >> k)
    return (r & 0xFFFF) != 0


def fast_scores(img, threshold: float):
    """Dense FAST response, f32[..., H, W] (0..255) -> f32[..., H, W]."""
    th = float(threshold)
    score_b = torch.zeros_like(img)
    score_d = torch.zeros_like(img)
    bits_b = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    bits_d = torch.zeros_like(bits_b)
    for i, (dy, dx) in enumerate(CIRCLE):
        d = _shifted(img, dy, dx) - img
        bright = d > th
        dark = d < -th
        score_b += torch.where(bright, d - th, 0.0)
        score_d += torch.where(dark, -d - th, 0.0)
        bits_b |= bright.to(torch.int32) << i
        bits_d |= dark.to(torch.int32) << i
    is_corner = arc_any(bits_b) | arc_any(bits_d)
    return torch.where(is_corner, torch.maximum(score_b, score_d), 0.0)


def nms3(score):
    """3x3 non-max suppression over [..., H, W]: keep strict local maxima."""
    H, W = score.shape[-2:]
    p = F.pad(score, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack(
        [
            p[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        0,
    )
    return torch.where(score > neigh.amax(0), score, 0.0)


@functools.lru_cache(maxsize=4)
def _inside_mask(level_hw, H: int, W: int, border: int, device: str):
    """bool[L, H, W]: pixels at least `border` inside their level's extent."""
    m = torch.zeros((len(level_hw), H, W), dtype=torch.bool)
    for l, (h, w) in enumerate(level_hw):
        m[l, border : h - border, border : w - border] = True
    return m.to(device)


def _cell_fallback(s_hi, s_lo, cell: int):
    """Cells of s_hi [..., H, W] with no corner take s_lo's scores."""
    H, W = s_hi.shape[-2:]
    ch, cw = -(-H // cell), -(-W // cell)
    hi_p = F.pad(s_hi, (0, cw * cell - W, 0, ch * cell - H))
    cell_has = hi_p.unflatten(-2, (ch, cell)).unflatten(-1, (cw, cell)).amax(dim=(-3, -1)) > 0.0
    full = cell_has.repeat_interleave(cell, -2).repeat_interleave(cell, -1)[..., :H, :W]
    return torch.where(full, s_hi, s_lo)


def fast_with_fallback(img, ini_th: float, min_th: float, cell: int, border: int):
    """Dense score map of one image f32[H, W]: dual-threshold scores (kernel
    B4 on the card), per-cell fallback, 3x3 NMS, border masking."""
    from plslam_tpu_torch.ops import fast_cuda  # it imports this module

    s_hi, s_lo = fast_cuda.fast_scores(img, ini_th, min_th)
    score = nms3(_cell_fallback(s_hi, s_lo, cell))
    H, W = img.shape
    inside = _inside_mask(((H, W),), H, W, border, str(img.device))[0]
    return torch.where(inside, score, 0.0)


def fallback_nms_border_stack(s_hi, s_lo, level_hw, cell: int, border: int):
    """Per-cell threshold fallback (cells without a corner at the high
    threshold use the low one), 3x3 NMS, and per-level border masking on a
    [L, H, W] pyramid stack (level l's true extent is level_hw[l])."""
    H, W = s_hi.shape[-2:]
    score = nms3(_cell_fallback(s_hi, s_lo, cell))
    inside = _inside_mask(tuple(map(tuple, level_hw)), H, W, border, str(s_hi.device))
    return torch.where(inside, score, 0.0)
