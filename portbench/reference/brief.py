"""Frozen copy of plslam_tpu_torch/ops/brief.py: the benchmark's reference imports nothing of the port.

Steered BRIEF-256 descriptors.

Port of plslam_tpu/ops/brief.py. The pattern is the reference's seeded
table (RandomState(0x5151)), so descriptors are bit-compatible with it.

Sampling is a direct gather. The reference samples with hi + lo bf16
one-hot matmuls (a TPU workaround, plslam_tpu/ops/brief.py:58-67), which
reads each pixel as bf16(p) + bf16(p - bf16(p)). The gathered samples are
rounded the same way before they are compared, so every bit equals the
reference's, near ties included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import constants as C

N_BITS = 256
_PATTERN_SEED = 0x5151
_MAX_OFF = 13  # offsets clipped so rotated points stay within radius 19
PATCH_R = 19
PATCH_D = 2 * PATCH_R + 1


@functools.lru_cache(maxsize=1)
def pattern():
    """(a i8[256, 2], b i8[256, 2]) pattern point pairs, (x, y) order."""
    rs = np.random.RandomState(_PATTERN_SEED)
    sigma = C.PATCH_SIZE / 5.0
    pts = rs.normal(0.0, sigma, size=(2, N_BITS, 2))
    pts = np.clip(np.round(pts), -_MAX_OFF, _MAX_OFF).astype(np.int8)
    return pts[0], pts[1]


@functools.lru_cache(maxsize=4)
def _pattern_xy(device: str):
    """Both pattern halves stacked, as f32 (x [1, 512], y [1, 512])."""
    p = torch.from_numpy(np.concatenate(pattern(), 0)).to(torch.float32).to(device)
    return p[None, :, 0].contiguous(), p[None, :, 1].contiguous()


def _as_hi_plus_lo(v):
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi + (v - hi).to(torch.bfloat16).to(torch.float32)


def steered_brief(patches, angles):
    """Centred patches f32[K, D, D], angles f32[K] -> desc u8[K, 32].

    Rotated sample positions are rounded to the nearest pixel (half to
    even, as the reference)."""
    K, Dr, Dc = patches.shape
    x, y = _pattern_xy(str(patches.device))
    ca, sa = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    c = Dr // 2
    rows = torch.round(x * sa + y * ca).long() + c
    cols = torch.round(x * ca - y * sa).long() + c
    vals = _as_hi_plus_lo(torch.gather(patches.reshape(K, -1), 1, rows * Dc + cols))
    bits = (vals[:, :N_BITS] < vals[:, N_BITS:]).to(torch.int32).reshape(K, 32, 8)
    pow2 = (1 << torch.arange(8, device=patches.device, dtype=torch.int32))
    return torch.sum(bits * pow2, -1).to(torch.uint8)


def unpack_bits_pm1(desc):
    """u8[..., 32] -> +-1 float32 [..., 256]: dot(a, b) = 256 - 2 hamming.
    float32 products of +-1 sum exactly (integers below 2^24)."""
    shifts = torch.arange(8, device=desc.device, dtype=torch.uint8)
    # not `>>`: DTensor's __rshift__ drops the broadcast of a size-1 axis
    bits = torch.bitwise_right_shift(desc[..., :, None], shifts) & 1
    return (bits.to(torch.float32) * 2 - 1).reshape(desc.shape[:-1] + (N_BITS,))
