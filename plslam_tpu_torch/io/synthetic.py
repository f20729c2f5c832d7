"""Synthetic RGB-D sequence with exact ground truth (numpy only).

Copy of plslam_tpu/io/synthetic.py (a textured background plane plus
floating foreground patches, rendered by ray-plane intersection along a
smooth fr1_xyz-style trajectory, or the loop-closure circuits "loop" and
"rect", optionally with a per-frame depth-noise field) that needs no
OpenCV. Three
OpenCV calls of the reference are written out in numpy: GaussianBlur
(reflect-101 border, float64 taps here, so texels differ from OpenCV's by
float32 rounding only), line (the thick-line path exactly: clipping,
16-bit fixed point, the filled offset quad and the end discs, so the
stripes hit the same pixels) and undistortPoints (5 fixed-point
iterations). The random stream is consumed in the reference's order, so a
seed gives the reference's trajectory, patch layout, stripes and frames
(tests/test_torch_synthetic.py).

`pose_problem` makes a full-capacity motion-only pose problem (the inputs
of solvers/pose.py) for the pose kernel's checks.
"""

from __future__ import annotations

import numpy as np

from plslam_tpu_torch.config import Settings


def _gaussian_blur(img, sigma):
    """Separable Gaussian with OpenCV's automatic size for float images
    (ksize = round(8 sigma + 1) | 1) and reflect-101 borders."""
    ksize = int(round(sigma * 8 + 1)) | 1
    r = ksize // 2
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    out = np.pad(img.astype(np.float64), r, mode="reflect")
    out = sum(k[i] * out[i : i + img.shape[0], :] for i in range(ksize))
    out = sum(k[i] * out[:, i : i + img.shape[1]] for i in range(ksize))
    return out.astype(np.float32)


# cv2.line's thick-line path (LINE_8, integer endpoints, thickness > 1),
# copied from OpenCV's drawing code: coordinates in 16-bit fixed point, the
# segment clipped to the image grown by the thickness, the offset quad filled
# as a convex polygon (its edges drawn too), a filled disc at each end.
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
    H, W = img.shape
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
    H, W = img.shape
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


def _fill_circle(img, cx, cy, radius, value):
    """OpenCV's Circle with fill: midpoint circle, one span per octant pair."""
    H, W = img.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, xa, xb, span_ok in (
            (cy - dy, cx - dx, cx + dx, True), (cy + dy, cx - dx, cx + dx, True),
            (cy - dx, cx - dy, cx + dy, cx - dy < W and cx + dy >= 0),
            (cy + dx, cx - dy, cx + dy, cx - dy < W and cx + dy >= 0),
        ):
            if span_ok and cx - dx < W and cx + dx >= 0 and 0 <= y < H:
                img[y, max(xa, 0) : min(xb, W - 1) + 1] = value
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _draw_line(img, p0, p1, value, thickness):
    """What cv2.line(img, p0, p1, value, thickness) draws for integer
    endpoints and thickness 2-4 (LINE_8), on a float image in place."""
    H, W = img.shape
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
        _fill_circle(img, (q[0] + _HALF) >> _XY_SHIFT, (q[1] + _HALF) >> _XY_SHIFT, (half + _HALF) >> _XY_SHIFT, value)


def _texture(rng, size=2048, n_lines=40):
    tex = _gaussian_blur(rng.uniform(0, 255, (size, size)).astype(np.float32), 2.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    tex = (40 + tex * 170).astype(np.float32)
    # straight dark/bright stripes
    for _ in range(n_lines):
        x0, y0 = rng.uniform(0, size, 2)
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(0.2, 0.8) * size
        x1, y1 = x0 + np.cos(ang) * length, y0 + np.sin(ang) * length
        value = float(rng.choice([20.0, 235.0]))
        thickness = int(rng.integers(2, 5))
        _draw_line(tex, (int(x0), int(y0)), (int(x1), int(y1)), value, thickness)
    return tex


def _undistort_normalized(uv, K, dist, iters=5):
    """Distorted pixels [..., 2] -> normalized undistorted coords, OpenCV's
    undistortPoints fixed point (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    x0 = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y0 = (uv[..., 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return np.stack([x, y], -1)


class SyntheticSequence:
    """Deterministic RGB-D sequence. frame(i) -> (gray f32[H,W] 0..255,
    depth f32[H,W] metres, timestamp float); gt_pose_wc(i) -> Twc f64[4,4]."""

    def __init__(
        self,
        n_frames: int = 100,
        height: int = 480,
        width: int = 640,
        seed: int = 0,
        motion_scale: float = 1.0,
        fps: float = 30.0,
        settings: Settings | None = None,
        trajectory: str = "xyz",
        depth_noise: float = 0.0,
    ):
        """settings: render through this calibration (intrinsics and lens
        distortion), so the pipeline's undistortion inverts the lens.
        trajectory: "xyz" (fr1_xyz-style), "loop" (a circle facing the
        wall) or "rect" (a corridor circuit). depth_noise: sigma of a
        per-frame low-frequency multiplicative depth error field, which
        gives the odometry a random-walk drift for loop closure to remove."""
        if trajectory not in ("xyz", "loop", "rect"):
            raise ValueError(f"unknown trajectory {trajectory!r}")
        self.n_frames = n_frames
        self.trajectory = trajectory
        self.depth_noise = depth_noise
        if settings is not None:
            width, height = settings.width, settings.height
            fps = settings.fps
        self.height, self.width = height, width
        self.fps = fps
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.settings = settings if settings is not None else Settings(
            fx=520.0, fy=520.0, cx=width / 2 - 0.5, cy=height / 2 - 0.5,
            k1=0, k2=0, p1=0, p2=0, k3=0, width=width, height=height,
            bf=40.0, depth_map_factor=1.0, fps=fps,
        )
        self.tex = _texture(rng)
        self.tex_scale = 220.0  # pixels per world metre on the planes
        self.z_bg = 3.4
        # foreground square patches (x, y, half-size, z, texture offset x,
        # y), each sampling its own texture region; along the circuits they
        # cover the whole swept ring (the "rect" ones on a jittered grid)
        if trajectory == "loop":
            self.patches = [
                (rng.uniform(-2.4, 2.4), rng.uniform(-0.8, 4.0),
                 rng.uniform(0.2, 0.5), rng.uniform(1.5, 3.0),
                 rng.uniform(4.0, 8.0), rng.uniform(4.0, 8.0))
                for _ in range(34)
            ]
        elif trajectory == "rect":
            self.patches = []
            for gx in range(8):
                for gy in range(6):
                    px = -1.2 + (gx + rng.uniform(0.2, 0.8)) * 5.6 / 8
                    py = -1.0 + (gy + rng.uniform(0.2, 0.8)) * 4.6 / 6
                    self.patches.append((px, py, rng.uniform(0.25, 0.5), rng.uniform(1.5, 2.8),
                                         rng.uniform(4.0, 8.0), rng.uniform(4.0, 8.0)))
        else:
            self.patches = [
                (rng.uniform(-1.4, 1.4), rng.uniform(-1.0, 1.0),
                 rng.uniform(0.2, 0.5), rng.uniform(1.5, 3.0),
                 rng.uniform(4.0, 8.0), rng.uniform(4.0, 8.0))
                for _ in range(14)
            ]
        self.motion_scale = motion_scale
        K, dist = self.settings.intrinsics()
        self.K = K
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        if np.any(np.asarray(dist) != 0):
            norm = _undistort_normalized(
                np.stack([u, v], -1).astype(np.float64), np.asarray(K, np.float64), np.asarray(dist, np.float64)
            )
            self.ray = np.concatenate([norm, np.ones((height, width, 1), np.float64)], -1)
        else:
            self.ray = np.stack(
                [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, np.float64)], -1
            )

    def gt_pose_wc(self, i: int) -> np.ndarray:
        """Twc (camera->world), float64."""
        t = i / self.fps
        s = self.motion_scale
        if self.trajectory == "loop":
            # a circle in the wall-parallel plane, facing the wall; the ring
            # it views is wider than the field of view, so the return to the
            # start is abrupt; the last ~25% of frames dwell at the start
            period = max(int(0.75 * self.n_frames), 2)
            ph = 2.0 * np.pi * min(i, period) / period
            R_loop = 1.6 * s
            T = np.eye(4)
            T[:3, 3] = [R_loop * np.sin(ph), R_loop * (1.0 - np.cos(ph)), 0.05 * s * np.sin(3.0 * ph)]
            return T
        if self.trajectory == "rect":
            # out-and-back corridor circuit: straight legs (+x, +y, -x, -y),
            # eased corners, the return leg outside the outbound leg's view;
            # the last ~10% of frames dwell at the start
            Lx, Ly = 3.2 * s, 2.4 * s
            legs = [0.30, 0.15, 0.30, 0.15]
            period = max(int(0.9 * self.n_frames), 4)
            u = min(i, period) / period
            pts = [(0.0, 0.0), (Lx, 0.0), (Lx, Ly), (0.0, Ly), (0.0, 0.0)]
            tx, ty = pts[-1]
            acc = 0.0
            for leg, (p0, p1) in zip(legs, zip(pts[:-1], pts[1:])):
                if u <= acc + leg or leg == legs[-1]:
                    a = np.clip((u - acc) / leg, 0.0, 1.0)
                    a = a * a * (3 - 2 * a)  # smoothstep
                    tx = p0[0] + a * (p1[0] - p0[0])
                    ty = p0[1] + a * (p1[1] - p0[1])
                    break
                acc += leg
            T = np.eye(4)
            T[:3, 3] = [tx, ty, 0.03 * s * np.sin(7.0 * u)]
            return T
        tx = 0.25 * s * np.sin(0.9 * t)
        ty = 0.18 * s * np.sin(0.7 * t + 0.5)
        tz = 0.12 * s * np.sin(0.5 * t + 1.1)
        yaw = 0.04 * s * np.sin(0.6 * t)
        pitch = 0.03 * s * np.sin(0.45 * t + 0.7)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = [tx, ty, tz]
        return T

    def timestamp(self, i: int) -> float:
        return i / self.fps

    def frame(self, i: int):
        Twc = self.gt_pose_wc(i)
        R, c = Twc[:3, :3], Twc[:3, 3]
        d_world = self.ray @ R.T  # [H, W, 3]
        t_bg = (self.z_bg - c[2]) / d_world[..., 2]
        depth = t_bg.copy()
        wx = c[0] + t_bg * d_world[..., 0]
        wy = c[1] + t_bg * d_world[..., 1]
        for px, py, half, pz, ox, oy in self.patches:
            t_p = (pz - c[2]) / d_world[..., 2]
            x = c[0] + t_p * d_world[..., 0]
            y = c[1] + t_p * d_world[..., 1]
            hit = (np.abs(x - px) < half) & (np.abs(y - py) < half) & (t_p > 0.1) & (t_p < depth)
            depth = np.where(hit, t_p, depth)
            wx = np.where(hit, x + ox, wx)
            wy = np.where(hit, y + oy, wy)
        size = self.tex.shape[0]
        fx_ = (wx * self.tex_scale) % (size - 1)
        fy_ = (wy * self.tex_scale) % (size - 1)
        x0 = fx_.astype(np.int64)
        y0 = fy_.astype(np.int64)
        ax, ay = (fx_ - x0).astype(np.float32), (fy_ - y0).astype(np.float32)
        t00 = self.tex[y0, x0]
        t01 = self.tex[y0, x0 + 1]
        t10 = self.tex[y0 + 1, x0]
        t11 = self.tex[y0 + 1, x0 + 1]
        gray = (1 - ay) * ((1 - ax) * t00 + ax * t01) + ay * ((1 - ax) * t10 + ax * t11)
        if self.depth_noise > 0:
            # a deterministic per-frame field, constant over 40 x 40 cells
            nrng = np.random.default_rng((self.seed + 1) * 100003 + i)
            cell = 40
            H, W = depth.shape
            field = nrng.normal(0.0, self.depth_noise, (H // cell + 1, W // cell + 1))
            depth = depth * (1.0 + np.kron(field, np.ones((cell, cell)))[:H, :W])
        return gray.astype(np.float32), depth.astype(np.float32), self.timestamp(i)

    def gt_trajectory(self):
        """[(t, Twc)] for the evaluator."""
        return [(self.timestamp(i), self.gt_pose_wc(i)) for i in range(self.n_frames)]


def pose_problem(rng, n=1024, n_lines=128, with_lines=True):
    """A full-capacity pose problem (N points, L lines) from a numpy
    Generator: points in front of a TUM1 camera seen from a known pose
    (t = (0.1, -0.08, 0.05)), 0.5 px noise, 10% gross outliers, 80% stereo,
    10% padded rows carrying NaN coordinates; 60% valid lines unless
    `with_lines` is False. Returns dict(K, bf, pts, lines) with `pts` and
    `lines` the numpy fields of PointObs and LineObs."""
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32)
    bf = 40.0
    ang = np.array([0.04, -0.03, 0.02])
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0.1, -0.08, 0.05])

    def project(P):
        Pc = P @ R.T + t
        u = K[0, 0] * Pc[:, 0] / Pc[:, 2] + K[0, 2]
        v = K[1, 1] * Pc[:, 1] / Pc[:, 2] + K[1, 2]
        return np.stack([u, v, u - bf / Pc[:, 2]], -1)

    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(1.5, 6.0, n)], -1)
    obs = project(xw)
    obs[:, :2] += rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, n // 10, replace=False)
    obs[out, :2] += rng.uniform(20, 80, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    valid = rng.uniform(size=n) > 0.1
    obs[~valid] = np.nan
    sw = np.stack([rng.uniform(-2, 2, n_lines), rng.uniform(-1.5, 1.5, n_lines), rng.uniform(2, 5, n_lines)], -1)
    ew = sw + rng.uniform(-0.8, 0.8, (n_lines, 3))
    ew[:, 2] = np.clip(ew[:, 2], 1.5, None)
    sp, ep = project(sw)[:, :2], project(ew)[:, :2]
    l2d = np.cross(np.c_[sp, np.ones(n_lines)], np.c_[ep, np.ones(n_lines)])
    l2d /= np.linalg.norm(l2d[:, :2], axis=1, keepdims=True) + 1e-9
    lvalid = (rng.uniform(size=n_lines) < 0.6) & with_lines
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return dict(
        K=K, bf=bf,
        pts=(f(xw), f(obs), np.ones(n, np.float32), rng.uniform(size=n) < 0.8, valid),
        lines=(f(sw), f(ew), f(l2d), np.ones(n_lines, np.float32), lvalid),
    )


def pose_problem_pair(rng, n=1024):
    """Two point-only problems as the tracker stacks its motion-model and
    reference-keyframe fallback solves: the same keypoints (obs, inverse
    sigma2, stereo flags, shared once) against two landmark sets. Problem
    0 is `pose_problem`'s; problem 1 moves its landmarks by 1 cm noise and
    drops a fifth of its valid rows. Returns dict(K, bf, xw f32[2, N, 3],
    valid bool[2, N], obs f32[N, 3], isig f32[N], stereo bool[N])."""
    pb = pose_problem(rng, n=n, with_lines=False)
    xw, obs, isig, stereo, valid = pb["pts"]
    xw1 = (xw + rng.normal(0, 0.01, xw.shape)).astype(np.float32)
    valid1 = valid & (rng.uniform(size=n) > 0.2)
    return dict(K=pb["K"], bf=pb["bf"], xw=np.stack([xw, xw1]), valid=np.stack([valid, valid1]),
                obs=obs, isig=isig, stereo=stereo)


def patch_centres(rng, shapes, H, n=1000, size=39):
    """n keypoint centres on the flattened 8-level stack, as kernel B2 takes
    them (row = level * H + y): a uniform level, then a centre at least
    size // 2 from that level's edges. shapes: [(h, w)] per level.
    -> i32[n, 2]."""
    r = size // 2
    lv = rng.integers(0, len(shapes), n)
    hw = np.array(shapes)[lv]
    return np.stack([lv * H + rng.integers(r, hw[:, 0] - r), rng.integers(r, hw[:, 1] - r)], -1).astype(np.int32)
