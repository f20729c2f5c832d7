"""Host line segment detection, behind `line_backend: "host"`.

Port of plslam_tpu/ops/lsd.py: the native C++ LSD (`native/lsd.cpp`,
gradient region growing with an aligned-point density check) on the
host, built with g++ at first use (`_build.lsd_library`) and called through
ctypes. It feeds fixed-capacity endpoint arrays to the frame builder,
which runs LBD and the rest of the line front end on the device.

Output contract: fixed-capacity numpy arrays (sp f32[L, 2], ep f32[L, 2],
valid bool[L]), endpoints in raw pixel coordinates, segments sorted by
length (longest first), segments shorter than `min_length_frac` of the
image diagonal dropped.

Unlike the reference, there is no fallback: where the library cannot be
built or loaded this raises. The reference falls back to OpenCV's LSD and
then to an empty set; the card's machine has no OpenCV, and an empty set
would quietly turn the point+line system into a point-only one.
"""

from __future__ import annotations

import ctypes

import numpy as np

from plslam_tpu_torch import _build
from plslam_tpu_torch import constants as C


def detect_lines_native(
    gray: np.ndarray,
    capacity: int = C.MAX_LINES,
    min_length_frac: float = C.MIN_LINE_LENGTH_FRAC,
    angle_tol_deg: float = 22.5,
    density_th: float = 0.5,
    grad_th: float = 5.0,
):
    """gray [H, W] (0..255) -> (sp f32[L, 2], ep f32[L, 2], valid bool[L])
    from native/lsd.cpp; raises if the library cannot be built."""
    gray = np.asarray(gray)
    if gray.ndim != 2:
        raise ValueError(f"detect_lines_native takes a [H, W] image, got shape {gray.shape}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    lib = _build.lsd_library()
    h, w = gray.shape
    img = np.ascontiguousarray(gray, np.float32)
    out = np.zeros((capacity, 4), np.float32)
    min_len = min_length_frac * float(np.hypot(h, w))
    fp = ctypes.POINTER(ctypes.c_float)
    n = lib.lsd_detect(
        img.ctypes.data_as(fp), h, w, out.ctypes.data_as(fp), capacity,
        ctypes.c_float(min_len), ctypes.c_float(angle_tol_deg),
        ctypes.c_float(density_th), ctypes.c_float(grad_th),
    )
    sp = np.zeros((capacity, 2), np.float32)
    ep = np.zeros((capacity, 2), np.float32)
    valid = np.zeros(capacity, bool)
    sp[:n] = out[:n, :2]
    ep[:n] = out[:n, 2:]
    valid[:n] = True
    return sp, ep, valid


def detect_lines_host(gray: np.ndarray, capacity: int = C.MAX_LINES,
                      min_length_frac: float = C.MIN_LINE_LENGTH_FRAC):
    """The frame builder's host detector: `detect_lines_native` at its
    default thresholds (the reference's `prefer_native` path; its OpenCV
    fallback is not ported)."""
    return detect_lines_native(gray, capacity, min_length_frac)
