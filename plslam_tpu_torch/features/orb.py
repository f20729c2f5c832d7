"""ORB keypoints + descriptors over the whole pyramid stack.

Port of plslam_tpu/features/orb.py (`ORBExtractor._extract`): pyramid
stack -> B1 (FAST at two thresholds + blur, ops/fast_cuda.py) -> per-cell
fallback / NMS / border -> grid top-k per level -> subpixel -> B2 (39x39
blurred patches, ops/patches.py) -> IC angle -> steered BRIEF -> level-0
coordinates. On CPU tensors B1 and B2 run their plain twins.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops import brief, fast, orientation, patches, pyramid, select
from plslam_tpu_torch.ops.fast_cuda import fast_blur_stack


class FeatureSet(NamedTuple):
    """Fixed-capacity per-frame keypoints (padded to `capacity`)."""

    uv: torch.Tensor  # f32[N, 2] (x, y) level-0 pixel coords
    response: torch.Tensor  # f32[N]
    angle: torch.Tensor  # f32[N] radians
    octave: torch.Tensor  # i32[N]
    desc: torch.Tensor  # u8[N, 32]
    valid: torch.Tensor  # bool[N]


def features_per_level(n_features: int, scale_factor: float, n_levels: int):
    """Geometric split of the feature budget over levels (last level
    absorbs the rounding remainder)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor**n_levels)
    out, acc = [], 0
    for l in range(n_levels - 1):
        k = int(round(n_first * factor**l))
        out.append(k)
        acc += k
    out.append(max(n_features - acc, 0))
    return out


class ORBExtractor:
    """Callable extractor; all shape-determining config is static."""

    def __init__(
        self,
        height: int,
        width: int,
        n_features: int = C.N_FEATURES,
        scale_factor: float = C.SCALE_FACTOR,
        n_levels: int = C.N_LEVELS,
        ini_th_fast: float = C.INI_TH_FAST,
        min_th_fast: float = C.MIN_TH_FAST,
        capacity: int = C.MAX_FEAT,
    ):
        self.height, self.width = height, width
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th, self.min_th = float(ini_th_fast), float(min_th_fast)
        self.capacity = capacity
        self.per_level = features_per_level(n_features, scale_factor, n_levels)
        # levels too small for a descriptor patch give their budget to the
        # last usable level (only reachable for tiny images)
        self.shapes = pyramid.level_shapes(height, width, n_levels, scale_factor)
        usable = [min(s) > 2 * C.EDGE_THRESHOLD + 1 for s in self.shapes]
        last_ok = max(i for i, u in enumerate(usable) if u)
        for l in range(n_levels):
            if not usable[l]:
                self.per_level[last_ok] += self.per_level[l]
                self.per_level[l] = 0
        if sum(self.per_level) > capacity:
            raise ValueError(f"feature budget {sum(self.per_level)} exceeds capacity {capacity}")
        self.scales = [scale_factor**l for l in range(n_levels)]

    def _device_consts(self, device):
        """(octave per slot i32[N], level scales f32[L]) on `device`."""
        return _consts_on(tuple(self.per_level), tuple(self.scales), str(device))

    def __call__(self, gray) -> FeatureSet:
        """gray f32[H, W] (0..255) on the target device -> FeatureSet."""
        Lv = self.n_levels
        stack = pyramid.build_pyramid_stack(gray, Lv, self.scale_factor)
        s_hi, s_lo, blurred = fast_blur_stack(stack, self.shapes, self.ini_th, self.min_th)
        score = fast.fallback_nms_border_stack(s_hi, s_lo, self.shapes, C.FAST_CELL, C.EDGE_THRESHOLD)

        yx, resp, valid = select.select_topk_grid(score, max(self.per_level), cell=16)
        # level l owns slots [off_l, off_l + k_l): the first k_l of its top-k
        keep = [l for l in range(Lv) if self.per_level[l]]
        yx_f = torch.cat([yx[l, : self.per_level[l]] for l in keep], 0)
        resp_f = torch.cat([resp[l, : self.per_level[l]] for l in keep], 0)
        val_f = torch.cat([valid[l, : self.per_level[l]] for l in keep], 0)
        oct_f, scales = self._device_consts(gray.device)

        H = stack.shape[1]
        # flat-stack rows = level * H + y (the border mask keeps every patch
        # inside its own level plane)
        yx_flat = torch.stack([oct_f * H + yx_f[:, 0], yx_f[:, 1]], -1)
        sub = select.subpixel_refine(score.reshape(Lv * H, -1), yx_flat)
        blur_patch = patches.gather_patches(blurred.reshape(Lv * H, -1), yx_flat, brief.PATCH_D)
        ang = orientation.ic_angle(blur_patch)
        desc = brief.steered_brief(blur_patch, ang)
        uv0 = (yx_f.flip(-1).to(torch.float32) + sub.flip(-1)) * scales[oct_f.long()][:, None]

        pad = self.capacity - uv0.shape[0]

        def padded(x):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0)

        return FeatureSet(
            uv=padded(uv0),
            response=padded(resp_f),
            angle=padded(ang),
            octave=padded(oct_f),
            desc=padded(desc),
            valid=padded(val_f),
        )


@functools.lru_cache(maxsize=8)
def _consts_on(per_level: tuple, scales: tuple, device: str):
    """ORBExtractor's constants on `device`, uploaded once per process (a
    copy from host memory in a frame's build would block the host)."""
    oct_ = np.concatenate([np.full(k, l, np.int32) for l, k in enumerate(per_level) if k])
    return torch.from_numpy(oct_).to(device), torch.tensor(scales, dtype=torch.float32).to(device)


@functools.lru_cache(maxsize=2)
def inv_sigma2_table(n_levels: int = C.N_LEVELS, scale: float = C.SCALE_FACTOR):
    """Per-octave information weights 1/1.2^(2*octave)."""
    return np.asarray([1.0 / scale ** (2 * l) for l in range(n_levels)], np.float32)
