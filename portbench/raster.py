"""Frozen copy of plslam_tpu_torch/io/raster.py: the benchmark's reference imports nothing of the port.

cv2's rasterisation of circles and lines, copied from OpenCV's drawing
code (modules/imgproc/src/drawing.cpp) in numpy, pixel for pixel, for the
synthetic frames (io/synthetic.py) and the debug images (io/viewer.py) on
a machine without OpenCV.

- `circle`: cv2.circle with LINE_8, filled (thickness -1) or 1 px wide:
  OpenCV's integer Circle routine, not EllipseEx (which cv2.circle uses
  only for thicker, anti-aliased or sub-pixel circles).
- `line`: cv2.line with LINE_8 and thickness 1: the endpoints clipped to
  the image (clipLine), then the 8-connected LineIterator from the
  left endpoint.
- `thick_line`: cv2.line with LINE_8 and thickness 2-4: coordinates in
  16-bit fixed point, the segment clipped to the image grown by the
  thickness, the offset quad filled as a convex polygon (its edges drawn
  too), a filled disc at each end.

Integer endpoints and centres only (shift 0). Images are [H, W] or
[H, W, C], drawn in place; `value` is a scalar or one value per channel.
"""

from __future__ import annotations

import numpy as np

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
_HALF = _XY_ONE >> 1


def _tdiv(a, b):
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w, h, x1, y1, x2, y2):
    """OpenCV's clipLine(Size2l) on int64 coordinates -> (visible, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_fixed(img, p1, p2, value):
    """OpenCV's Line2: a one-pixel line between fixed-point points."""
    H, W = img.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(W << _XY_SHIFT, H << _XY_SHIFT, *p1, *p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    k_along_x = abs(dx) > abs(dy)
    if (dx if k_along_x else dy) < 0:
        x1, x2, y1, y2 = x2, x1, y2, y1
        dx, dy = -dx, -dy
    if 0 <= (x2 + _HALF) >> _XY_SHIFT < W and 0 <= (y2 + _HALF) >> _XY_SHIFT < H:
        img[(y2 + _HALF) >> _XY_SHIFT, (x2 + _HALF) >> _XY_SHIFT] = value
    x1 += _HALF
    y1 += _HALF
    if k_along_x:
        k = np.arange(((x2 - x1 + _HALF) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = (x1 >> _XY_SHIFT) + k
        ys = (y1 + k * _tdiv(dy << _XY_SHIFT, dx | 1)) >> _XY_SHIFT
    else:
        k = np.arange(((y2 - y1 + _HALF) >> _XY_SHIFT) + 1, dtype=np.int64)
        ys = (y1 >> _XY_SHIFT) + k
        xs = (x1 + k * _tdiv(dx << _XY_SHIFT, dy | 1)) >> _XY_SHIFT
    m = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[m], xs[m]] = value


def _fill_convex_poly(img, v, value):
    """OpenCV's FillConvexPoly for LINE_8 and fixed-point vertices."""
    H, W = img.shape[:2]
    n = len(v)
    for p0, p in zip(v[-1:] + v[:-1], v):
        _line_fixed(img, p0, p, value)
    ys_ = [p[1] for p in v]
    imin = ys_.index(min(ys_))
    xmin = (min(p[0] for p in v) + _HALF) >> _XY_SHIFT
    xmax = (max(p[0] for p in v) + _HALF) >> _XY_SHIFT
    y = (min(ys_) + _HALF) >> _XY_SHIFT
    ymax = (max(ys_) + _HALF) >> _XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= W or y >= H:
        return
    ymax = min(ymax, H - 1)
    # two edges walk down from the top vertex, one each way round
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=y), dict(idx=imin, di=n - 1, x=-_XY_ONE, dx=0, ye=y)]
    edges = n
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + _HALF) >> _XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, dx=_tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), x=xs, idx=idx)
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            xl, xr = sorted((edge[0]["x"], edge[1]["x"]))
            x1, x2 = (xl + _HALF) >> _XY_SHIFT, (xr + _HALF) >> _XY_SHIFT
            if x2 >= 0 and x1 < W:
                img[y, max(x1, 0) : min(x2, W - 1) + 1] = value
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def circle(img, cx, cy, radius, value, fill):
    """OpenCV's Circle (cv2.circle with LINE_8 and thickness 1 or filled):
    the midpoint circle, each step one span (filled) or the ends of the
    span (outline) on four rows, clipped to the image."""
    H, W = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, xa, xb):
        if not 0 <= y < H:
            return
        if fill:
            img[y, max(xa, 0) : min(xb, W - 1) + 1] = value
            return
        if xa >= 0:
            img[y, xa] = value
        if xb < W:
            img[y, xb] = value

    while dx >= dy:
        if cx - dx < W and cx + dx >= 0 and cy - dx < H and cy + dx >= 0:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            if cx - dy < W and cx + dy >= 0:
                span(cy - dx, cx - dy, cx + dy)
                span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img, p0, p1, value, thickness):
    """What cv2.line(img, p0, p1, value, thickness) draws for integer
    endpoints and thickness 2-4 (LINE_8), in place."""
    H, W = img.shape[:2]
    t = thickness
    ok, x0, y0, x1, y1 = _clip_line(W + 2 * t, H + 2 * t, p0[0] + t, p0[1] + t, p1[0] + t, p1[1] + t)
    if not ok:
        return
    q0 = ((x0 - t) << _XY_SHIFT, (y0 - t) << _XY_SHIFT)
    q1 = ((x1 - t) << _XY_SHIFT, (y1 - t) << _XY_SHIFT)
    dx = (q0[0] - q1[0]) / _XY_ONE
    dy = (q1[1] - q0[1]) / _XY_ONE
    r2 = dx * dx + dy * dy
    half = t << (_XY_SHIFT - 1)
    if r2 > np.finfo(np.float64).eps:
        r = (half + (t & 1) * _XY_ONE * 0.5) / np.sqrt(r2)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))  # cvRound: half to even
        quad = [(q0[0] + ox, q0[1] + oy), (q0[0] - ox, q0[1] - oy), (q1[0] - ox, q1[1] - oy), (q1[0] + ox, q1[1] + oy)]
        _fill_convex_poly(img, quad, value)
    for q in (q0, q1):
        circle(img, (q[0] + _HALF) >> _XY_SHIFT, (q[1] + _HALF) >> _XY_SHIFT, (half + _HALF) >> _XY_SHIFT, value, True)


def line(img, p0, p1, value):
    """What cv2.line(img, p0, p1, value, 1) draws (LINE_8), in place."""
    H, W = img.shape[:2]
    (x0, y0), (x1, y1) = p0, p1
    if not (0 <= x0 < W and 0 <= x1 < W and 0 <= y0 < H and 0 <= y1 < H):
        ok, x0, y0, x1, y1 = _clip_line(W, H, x0, y0, x1, y1)
        if not ok:
            return
    if x1 < x0:  # left to right
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # err starts at major - 2 minor; each step moves one pixel along the
    # major axis, and along the minor one where err was negative
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        img[y, x] = value
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0
