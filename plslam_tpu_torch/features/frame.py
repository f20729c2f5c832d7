"""Per-frame observation container + builder (point half).

Port of plslam_tpu/features/frame.py for point-only configurations
(`UseLines: 0`, as configs/TUM1.yaml): ORB extraction, keypoint undistortion, depth
lookup and the virtual right coordinate u_r = u - bf/d. The line fields
keep their fixed capacity and are all invalid; line detection and LBD are
a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.config import Settings
from plslam_tpu_torch.features.orb import ORBExtractor
from plslam_tpu_torch.geometry import camera
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.utils.device import resolve_device


class FrameData(NamedTuple):
    """Fixed-capacity per-frame observations (tensors on one device)."""

    uvr: torch.Tensor  # f32[N, 3] undistorted (u, v, u_r); u_r = -1 if no depth
    uv_raw: torch.Tensor  # f32[N, 2] raw (distorted) pixel coords
    depth: torch.Tensor  # f32[N] depth (m), 0 where invalid
    octave: torch.Tensor  # i32[N]
    angle: torch.Tensor  # f32[N]
    desc: torch.Tensor  # u8[N, 32]
    pm1: torch.Tensor  # f32[N, 256] +-1 unpacked bits
    valid: torch.Tensor  # bool[N]
    ln_sp: torch.Tensor  # f32[L, 2]
    ln_ep: torch.Tensor  # f32[L, 2]
    ln_line2d: torch.Tensor  # f32[L, 3]
    ln_angle: torch.Tensor  # f32[L]
    ln_depth_sp: torch.Tensor  # f32[L]
    ln_depth_ep: torch.Tensor  # f32[L]
    ln_desc: torch.Tensor  # u8[L, 32]
    ln_pm1: torch.Tensor  # f32[L, 256]
    ln_valid: torch.Tensor  # bool[L]


class FrameBuilder:
    """gray / depth images -> FrameData on `device` (default: the card)."""

    def __init__(
        self,
        settings: Settings,
        capacity: int = C.MAX_FEAT,
        line_capacity: int = C.MAX_LINES,
        device="cuda",
    ):
        if settings.use_lines:
            raise NotImplementedError("the port covers point-only settings (UseLines: 0) so far")
        self.s = settings
        self.device = resolve_device(device)
        self.extractor = ORBExtractor(
            settings.height,
            settings.width,
            n_features=settings.n_features,
            scale_factor=settings.scale_factor,
            n_levels=settings.n_levels,
            ini_th_fast=settings.ini_th_fast,
            min_th_fast=settings.min_th_fast,
            capacity=capacity,
        )
        K, dist = settings.intrinsics()
        self.K = torch.from_numpy(K).to(self.device)
        self.dist = torch.from_numpy(dist).to(self.device)
        self.has_dist = bool((dist != 0).any())
        self.bf = float(settings.bf)
        self.line_capacity = line_capacity

    def _undistort(self, uv):
        return camera.undistort_pixels(self.K, self.dist, uv) if self.has_dist else uv

    def _depth_at(self, depth, uv, valid):
        Hd, Wd = depth.shape
        xi = torch.clamp(torch.round(uv[..., 0]).long(), 0, Wd - 1)
        yi = torch.clamp(torch.round(uv[..., 1]).long(), 0, Hd - 1)
        d = depth.reshape(-1)[yi * Wd + xi]
        return torch.where(valid & (d > 0) & torch.isfinite(d), d, 0.0)

    def _as_tensor(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return a.to(self.device, torch.float32)

    def __call__(self, gray, depth) -> FrameData:
        """gray f32[H, W] (0..255), depth f32[H, W] metres (numpy or tensor)."""
        gray, depth = self._as_tensor(gray), self._as_tensor(depth)
        fs = self.extractor(gray)
        uv_raw = fs.uv
        # undistort a zeroed stand-in for padded slots: the fixed point
        # diverges on far-out coordinates and a NaN row would poison every
        # masked 0 * NaN reduction downstream
        uv_und = self._undistort(torch.where(fs.valid[:, None], uv_raw, 0.0))
        # depth at the raw (pre-undistortion) position, as the reference
        d = self._depth_at(depth, uv_raw, fs.valid)
        ur = torch.where(d > 0, uv_und[:, 0] - self.bf / torch.where(d > 0, d, 1.0), -1.0)
        L = self.line_capacity
        f32 = dict(dtype=torch.float32, device=self.device)
        return FrameData(
            uvr=torch.cat([uv_und, ur[:, None]], -1),
            uv_raw=uv_raw,
            depth=d,
            octave=fs.octave,
            angle=fs.angle,
            desc=fs.desc,
            pm1=brief.unpack_bits_pm1(fs.desc),
            valid=fs.valid,
            ln_sp=torch.zeros((L, 2), **f32),
            ln_ep=torch.zeros((L, 2), **f32),
            ln_line2d=torch.zeros((L, 3), **f32),
            ln_angle=torch.zeros(L, **f32),
            ln_depth_sp=torch.zeros(L, **f32),
            ln_depth_ep=torch.zeros(L, **f32),
            ln_desc=torch.zeros((L, 32), dtype=torch.uint8, device=self.device),
            ln_pm1=torch.zeros((L, brief.N_BITS), **f32),
            ln_valid=torch.zeros(L, dtype=torch.bool, device=self.device),
        )
