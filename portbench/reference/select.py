"""Frozen copy of plslam_tpu_torch/ops/select.py: the benchmark's reference imports nothing of the port.

Grid-cell top-1 + top-k keypoint selection and subpixel refinement.

Port of plslam_tpu/ops/select.py, batched over pyramid levels (the
reference vmaps the single-level function). Tie rules follow the
reference: `argmax` keeps the first maximum within a cell, and the top-k
over cells is a stable descending sort, so equal responses come out lower
cell index first exactly as `jax.lax.top_k` orders them (`torch.topk`
promises no order among ties).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def topk_lower_index_first(x, k: int):
    """(values, indices) of the k largest along the last dim; ties keep
    the lower index first (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_grid(score, k: int, cell: int = 16):
    """score f32[L, H, W] -> (yx i32[L, k, 2], resp f32[L, k], valid bool[L, k]).

    Top-1 per cell x cell grid cell, then the top-k cells by response.
    Slots beyond the non-zero cells have resp 0 and valid False."""
    L, H, W = score.shape
    ch, cw = -(-H // cell), -(-W // cell)
    sp = F.pad(score, (0, cw * cell - W, 0, ch * cell - H))
    blocks = sp.reshape(L, ch, cell, cw, cell).permute(0, 1, 3, 2, 4).reshape(L, ch * cw, cell * cell)
    cell_best = blocks.amax(-1)
    cell_arg = torch.argmax(blocks, -1)
    if cell_best.shape[1] < k:  # tiny top levels: fewer cells than k
        cell_best = F.pad(cell_best, (0, k - cell_best.shape[1]))
    resp, idx = topk_lower_index_first(cell_best, k)
    idx = torch.clamp(idx, max=ch * cw - 1)
    cy, cx = idx // cw, idx % cw
    within = torch.gather(cell_arg, 1, idx)
    y = cy * cell + within // cell
    x = cx * cell + within % cell
    yx = torch.stack([torch.clamp(y, max=H - 1), torch.clamp(x, max=W - 1)], -1)
    return yx.to(torch.int32), resp, resp > 0.0


def subpixel_refine(score, yx):
    """Parabolic subpixel offsets on a response map: score f32[H, W],
    integer yx [k, 2] -> f32[k, 2] offsets in [-0.5, 0.5] per axis."""
    H, W = score.shape
    y = torch.clamp(yx[:, 0].long(), 1, H - 2)
    x = torch.clamp(yx[:, 1].long(), 1, W - 2)
    flat = score.reshape(-1)
    base = y * W + x

    def at(off):
        return flat[base + off]

    def axis_offset(sm, s0, sp):
        denom = 2.0 * s0 - sm - sp
        flat_ = torch.abs(denom) < 1e-6
        off = 0.5 * (sp - sm) / torch.where(flat_, torch.ones_like(denom), denom)
        return torch.clamp(torch.where(flat_, 0.0, off), -0.5, 0.5)

    s0 = at(0)
    return torch.stack([axis_offset(at(-W), s0, at(W)), axis_offset(at(-1), s0, at(1))], -1)
