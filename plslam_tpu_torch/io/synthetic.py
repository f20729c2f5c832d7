"""Synthetic RGB-D sequence with exact ground truth (numpy only).

Copy of plslam_tpu/io/synthetic.py's "xyz" sequence (a textured background
plane plus floating foreground patches, rendered by ray-plane intersection
along a smooth fr1_xyz-style trajectory) that needs no OpenCV: the texture
blur, the stripe rasterisation and the lens undistortion of the pixel rays
are written in numpy after OpenCV's GaussianBlur (reflect-101 border),
line (thick segment) and undistortPoints (5 fixed-point iterations). The
random stream is consumed in the reference's order, so a seed gives the
same trajectory, patch layout and stripe placement.

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


def _draw_segment(img, p0, p1, value, thickness):
    """Paint pixels within thickness/2 of the segment p0-p1 (round caps)."""
    H, W = img.shape
    half = thickness / 2.0
    (x0, y0), (x1, y1) = p0, p1
    xa, xb = int(max(np.floor(min(x0, x1) - half), 0)), int(min(np.ceil(max(x0, x1) + half), W - 1))
    ya, yb = int(max(np.floor(min(y0, y1) - half), 0)), int(min(np.ceil(max(y0, y1) + half), H - 1))
    if xa > xb or ya > yb:
        return
    yy, xx = np.mgrid[ya : yb + 1, xa : xb + 1].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    L2 = max(dx * dx + dy * dy, 1e-12)
    t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / L2, 0.0, 1.0)
    d2 = (xx - (x0 + t * dx)) ** 2 + (yy - (y0 + t * dy)) ** 2
    img[ya : yb + 1, xa : xb + 1][d2 <= half * half] = value


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
        _draw_segment(tex, (int(x0), int(y0)), (int(x1), int(y1)), value, thickness)
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
    ):
        """settings: render through this calibration (intrinsics and lens
        distortion), so the pipeline's undistortion inverts the lens."""
        self.n_frames = n_frames
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
        # foreground square patches (x, y, half-size, z, texture offset x, y)
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
