"""Headless visualisation: the reference's FrameDrawer / MapDrawer as
image dumps.

Port of plslam_tpu/io/viewer.py without OpenCV (the card's machine has
none): numpy images, drawn with io/raster.py's copies of cv2.circle and
cv2.line (LINE_8), so every circle and line lands on the pixels cv2 draws.

  * draw_frame: the frame with its keypoints (green: bound to a landmark,
    blue: unbound) and the state banner.
  * draw_map: a top-down (x-z) view of the map points, map lines, keyframe
    centres and the current camera.

One part is not copied: the reference writes the banner with cv2.putText
in the Hershey "plain" font, anti-aliased (LINE_AA). The port draws the
same string (`banner_text`) at the same origin, (10, H - 12), in a 5 x 7
stroke font of its own with 1-px LINE_8 strokes, which stays inside the
box cv2.getTextSize gives for that string; the pixels inside the box
differ from cv2's.

Both read the state back from the device with one copy per call and
return BGR u8 images (`io/png.py write_png` writes them as cv2.imwrite
would). `System.dump_debug_images(dir)` wires them up.
"""

from __future__ import annotations

import numpy as np
import torch

from plslam_tpu_torch.io import raster

STATES = {0: "NOT INITIALIZED", 1: "OK", 2: "LOST"}

# 5 x 7 stroke glyphs (x 0..4 left to right, y 0..6 top to bottom) for the
# characters a banner can hold: polylines, and the advance to the next glyph
_GLYPHS = {
    "N": ([[(0, 6), (0, 0), (4, 6), (4, 0)]], 7),
    "O": ([[(1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6), (0, 5), (0, 1), (1, 0)]], 7),
    "T": ([[(0, 0), (4, 0)], [(2, 0), (2, 6)]], 7),
    "I": ([[(0, 0), (2, 0)], [(1, 0), (1, 6)], [(0, 6), (2, 6)]], 4),
    "A": ([[(0, 6), (0, 2), (2, 0), (4, 2), (4, 6)], [(0, 4), (4, 4)]], 7),
    "L": ([[(0, 0), (0, 6), (4, 6)]], 7),
    "Z": ([[(0, 0), (4, 0), (0, 6), (4, 6)]], 7),
    "E": ([[(4, 0), (0, 0), (0, 6), (4, 6)], [(0, 3), (3, 3)]], 7),
    "D": ([[(0, 0), (0, 6), (3, 6), (4, 5), (4, 1), (3, 0), (0, 0)]], 7),
    "K": ([[(0, 0), (0, 6)], [(4, 0), (0, 4)], [(1, 3), (4, 6)]], 7),
    "S": ([[(4, 1), (3, 0), (1, 0), (0, 1), (0, 2), (1, 3), (3, 3), (4, 4), (4, 5), (3, 6), (1, 6), (0, 5)]], 7),
    "?": ([[(0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (2, 4)], [(2, 6), (2, 6)]], 7),
    "m": ([[(0, 6), (0, 2)], [(0, 3), (1, 2), (2, 3), (2, 6)], [(2, 3), (3, 2), (4, 3), (4, 6)]], 7),
    "a": ([[(1, 2), (3, 2), (4, 3), (4, 6)], [(4, 4), (1, 4), (0, 5), (1, 6), (4, 6)]], 7),
    "t": ([[(1, 0), (1, 5), (2, 6), (3, 6)], [(0, 2), (3, 2)]], 7),
    "c": ([[(4, 2), (1, 2), (0, 3), (0, 5), (1, 6), (4, 6)]], 7),
    "h": ([[(0, 0), (0, 6)], [(0, 3), (1, 2), (3, 2), (4, 3), (4, 6)]], 7),
    "e": ([[(0, 4), (4, 4), (4, 3), (3, 2), (1, 2), (0, 3), (0, 5), (1, 6), (4, 6)]], 7),
    "s": ([[(4, 2), (1, 2), (0, 3), (1, 4), (3, 4), (4, 5), (3, 6), (0, 6)]], 7),
    ":": ([[(1, 2), (1, 2)], [(1, 5), (1, 5)]], 4),
    " ": ([], 4),
    "0": ([[(1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6), (0, 5), (0, 1), (1, 0)], [(4, 1), (0, 5)]], 7),
    "1": ([[(1, 1), (2, 0), (2, 6)], [(1, 6), (3, 6)]], 7),
    "2": ([[(0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (0, 6), (4, 6)]], 7),
    "3": ([[(0, 0), (4, 0), (2, 2), (3, 2), (4, 3), (4, 5), (3, 6), (1, 6), (0, 5)]], 7),
    "4": ([[(3, 6), (3, 0), (0, 4), (4, 4)]], 7),
    "5": ([[(4, 0), (0, 0), (0, 2), (3, 2), (4, 3), (4, 5), (3, 6), (0, 6)]], 7),
    "6": ([[(3, 0), (1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5), (4, 4), (3, 3), (0, 3)]], 7),
    "7": ([[(0, 0), (4, 0), (1, 6)]], 7),
    "8": ([[(1, 0), (3, 0), (4, 1), (4, 2), (3, 3), (1, 3), (0, 4), (0, 5), (1, 6), (3, 6), (4, 5), (4, 4), (3, 3)],
           [(1, 3), (0, 2), (0, 1), (1, 0)]], 7),
    "9": ([[(4, 3), (1, 3), (0, 2), (0, 1), (1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6)]], 7),
}


def banner_text(status: int, n_tracked: int) -> str:
    """The banner's string, as the reference's FrameDrawer writes it."""
    return f"{STATES.get(int(status), '?')}  matches: {n_tracked}"


def _put_text(img, text, org, color):
    """Draw text with its baseline at org (x, y): each glyph's bottom row on
    y, glyphs left to right from x. Characters without a glyph advance
    only."""
    x, y = org
    for ch in text:
        strokes, advance = _GLYPHS.get(ch, ([], 4))
        for poly in strokes:
            for (ax, ay), (bx, by) in zip(poly, poly[1:]):
                raster.line(img, (x + ax, y - 6 + ay), (x + bx, y - 6 + by), color)
        x += advance


def _host(*tensors):
    """The tensors as numpy arrays of their own dtypes, read back with one
    device->host copy (float64 holds every float32, int32 and bool value
    exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(tuple(t.shape)).astype(torch.empty(0, dtype=t.dtype).numpy().dtype))
        i += n
    return out


def draw_frame(gray: np.ndarray, state) -> np.ndarray:
    """gray [H, W] (0..255) + TrackState -> BGR u8[H, W, 3] overlay."""
    img = np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, -1)
    uvr, valid, lm, status = _host(state.last.uvr, state.last.valid, state.last.lm_idx, state.status)
    uv = uvr[:, :2]
    for i in np.where(valid)[0]:
        x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
            color = (0, 200, 0) if lm[i] >= 0 else (200, 120, 0)
            raster.circle(img, x, y, 2, color, fill=True)
    _put_text(img, banner_text(int(status), int((lm >= 0).sum())), (10, img.shape[0] - 12), (255, 255, 255))
    return img


def draw_map(state, size: int = 640) -> np.ndarray:
    """Top-down x-z map view -> BGR u8[size, size, 3]."""
    img = np.full((size, size, 3), 30, np.uint8)
    m = state.m
    pt_pos, pt_valid, kf_pose, kf_valid, ln_valid, ln_sw, ln_ew, Tcw = _host(
        m.pt_pos, m.pt_valid, m.kf_pose, m.kf_valid, m.ln_valid, m.ln_sw, m.ln_ew, state.last.Tcw)
    pts = pt_pos[pt_valid]
    centers = [np.linalg.inv(kf_pose[i])[:3, 3] for i in np.where(kf_valid)[0]]
    centers = np.asarray(centers) if centers else np.zeros((0, 3))
    all_xz = np.concatenate([pts[:, [0, 2]], centers[:, [0, 2]]]) if len(pts) else centers[:, [0, 2]]
    if len(all_xz) == 0:
        return img
    lo, hi = all_xz.min(0) - 0.5, all_xz.max(0) + 0.5
    scale = (size - 40) / max(float((hi - lo).max()), 1e-6)

    def to_px(xz):
        p = (xz - lo) * scale + 20
        return int(p[0]), size - int(p[1])

    for p in pts:
        raster.circle(img, *to_px(p[[0, 2]]), 1, (140, 140, 140), fill=True)
    for a, b in zip(ln_sw[ln_valid], ln_ew[ln_valid]):
        raster.line(img, to_px(a[[0, 2]]), to_px(b[[0, 2]]), (60, 60, 200))
    for c in centers:
        raster.circle(img, *to_px(c[[0, 2]]), 4, (0, 200, 255), fill=False)
    Twc = np.linalg.inv(Tcw)
    raster.circle(img, *to_px(Twc[[0, 2], 3]), 5, (0, 255, 0), fill=True)
    return img
