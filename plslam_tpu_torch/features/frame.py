"""Per-frame observation container + builder (points and lines).

Port of plslam_tpu/features/frame.py: ORB extraction, keypoint
undistortion, depth lookup and the virtual right coordinate u_r = u - bf/d;
with lines on (`UseLines`, default 1, `line_backend: "device"`), dense LSD
on the image (ops/lsd_device.py), LBD on the full-resolution gradients
(ops/lbd.py), endpoint undistortion, the normalised 2-D line, the segment
angle and endpoint depths. With lines off, every line slot is invalid
and the line fields are the same each frame: the builder computes them
once, as the reference computes them from empty lines.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.config import Settings
from plslam_tpu_torch.features.orb import ORBExtractor
from plslam_tpu_torch.geometry import camera
from plslam_tpu_torch.ops import brief, lbd, lsd_device
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
        if settings.use_lines and settings.line_backend != "device":
            raise NotImplementedError(
                f"line_backend {settings.line_backend!r}: the port detects lines on the device only; "
                "the host LSD (native/lsd.cpp) is not ported yet (ROADMAP A21)")
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
        if not settings.use_lines:
            # every keyline invalid: the line fields are the same each frame
            L = line_capacity
            z = torch.zeros((L, 2), dtype=torch.float32, device=self.device)
            plane = torch.zeros((settings.height, settings.width), dtype=torch.float32, device=self.device)
            self._no_lines = self._lines(plane, plane, z, z, torch.zeros(L, dtype=torch.bool, device=self.device))

    def _undistort(self, uv):
        return camera.undistort_pixels(self.K, self.dist, uv) if self.has_dist else uv

    def _depth_at(self, depth, uv, valid):
        Hd, Wd = depth.shape
        xi = torch.clamp(torch.round(uv[..., 0]).long(), 0, Wd - 1)
        yi = torch.clamp(torch.round(uv[..., 1]).long(), 0, Hd - 1)
        d = depth.reshape(-1)[yi * Wd + xi]
        return torch.where(valid & (d > 0) & torch.isfinite(d), d, 0.0)

    def _lines(self, gray, depth, sp_raw, ep_raw, ln_valid) -> dict:
        """The line fields of FrameData from raw keyline endpoints: LBD on
        the full-resolution gradients, endpoint undistortion (padded rows
        take the stand-ins 0 and 1, which keep the segment non-degenerate),
        the normalised 2-D line, the segment angle and endpoint depths."""
        gx, gy = lbd.image_gradients(gray)
        ln_desc = lbd.lbd_descriptor(gx, gy, sp_raw, ep_raw, ln_valid)
        sp_und = self._undistort(torch.where(ln_valid[:, None], sp_raw, 0.0))
        ep_und = self._undistort(torch.where(ln_valid[:, None], ep_raw, 1.0))
        seg = ep_und - sp_und
        # cross((sp, 1), (ep, 1)), normalised so that a^2 + b^2 = 1
        line2d = torch.stack([sp_und[:, 1] - ep_und[:, 1], ep_und[:, 0] - sp_und[:, 0],
                              sp_und[:, 0] * ep_und[:, 1] - sp_und[:, 1] * ep_und[:, 0]], -1)
        nrm = torch.sqrt(torch.sum(line2d[:, :2] * line2d[:, :2], -1, keepdim=True))
        return dict(
            ln_sp=sp_und,
            ln_ep=ep_und,
            ln_line2d=line2d / torch.clamp(nrm, min=1e-6),
            ln_angle=torch.atan2(seg[:, 1], seg[:, 0]),
            ln_depth_sp=self._depth_at(depth, sp_raw, ln_valid),
            ln_depth_ep=self._depth_at(depth, ep_raw, ln_valid),
            ln_desc=ln_desc,
            ln_pm1=brief.unpack_bits_pm1(ln_desc),
            ln_valid=ln_valid,
        )

    def _as_tensor(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return a.to(self.device, torch.float32)

    def __call__(self, gray, depth) -> FrameData:
        """gray f32[H, W] (0..255), depth f32[H, W] metres (numpy or tensor),
        uploaded to the builder's device (a blocking copy from host memory)."""
        return self.build(self._as_tensor(gray), self._as_tensor(depth))

    def build(self, gray, depth) -> FrameData:
        """The frame from gray and depth f32[H, W] tensors already on the
        builder's device: no upload and, once the first frame has copied the
        builder's constant tables, no host synchronisation."""
        if gray.device.type != self.device.type or depth.device.type != self.device.type:
            raise ValueError(f"FrameBuilder.build wants tensors on {self.device}, got {gray.device} / {depth.device}")
        fs = self.extractor(gray)
        uv_raw = fs.uv
        # undistort a zeroed stand-in for padded slots: the fixed point
        # diverges on far-out coordinates and a NaN row would poison every
        # masked 0 * NaN reduction downstream
        uv_und = self._undistort(torch.where(fs.valid[:, None], uv_raw, 0.0))
        # depth at the raw (pre-undistortion) position, as the reference
        d = self._depth_at(depth, uv_raw, fs.valid)
        ur = torch.where(d > 0, uv_und[:, 0] - self.bf / torch.where(d > 0, d, 1.0), -1.0)

        if self.s.use_lines:
            lines = self._lines(gray, depth, *lsd_device.detect_lines_device(gray, self.line_capacity))
        else:
            lines = self._no_lines
        return FrameData(
            uvr=torch.cat([uv_und, ur[:, None]], -1),
            uv_raw=uv_raw,
            depth=d,
            octave=fs.octave,
            angle=fs.angle,
            desc=fs.desc,
            pm1=brief.unpack_bits_pm1(fs.desc),
            valid=fs.valid,
            **lines,
        )
