"""Frozen copy of plslam_tpu_torch/ops/orientation.py: the benchmark's reference imports nothing of the port.

IC (intensity-centroid) keypoint orientation.

Port of plslam_tpu/ops/orientation.py: moments m01, m10 over the circular
31-diameter patch around each keypoint; theta = atan2(m01, m10).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import constants as C


@functools.lru_cache(maxsize=4)
def _moment_masks(radius: int):
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    circ = (ys * ys + xs * xs) <= radius * radius
    return (xs * circ).astype(np.float32), (ys * circ).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _moment_masks_on(radius: int, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _moment_masks(radius))


def ic_angle(patches, radius: int = C.HALF_PATCH_SIZE):
    """Centred square patches f32[K, D, D] -> angle f32[K] radians."""
    c = patches.shape[-2] // 2
    p = patches[:, c - radius : c + radius + 1, c - radius : c + radius + 1]
    mx, my = _moment_masks_on(radius, str(patches.device))
    m10 = torch.sum(p * mx, dim=(-2, -1))
    m01 = torch.sum(p * my, dim=(-2, -1))
    return torch.atan2(m01, m10)
