"""The benchmark's synthetic RGB-D scene, rendered on the card.

Frozen copy of plslam_tpu_torch/io/synthetic.py (a textured background
plane plus floating foreground patches, seen along a smooth fr1_xyz-style
trajectory; the original's other trajectories, its low-texture blur, its
depth-noise field and its lens model are left out, since no traffic mix
uses them); the port's package is not imported. The texture, the
patch layout and the ground-truth poses come from numpy exactly as there,
so a seed gives the same scene; `frame(i)` is the copied numpy renderer,
and `render(indices, device)` is the same ray-plane rendering in torch on
the card, many frames per call (float64 geometry, float32 texels), so
that a few thousand 640x480 frames take seconds.

The camera is a pinhole calibration given as a dict (fx, fy, cx, cy,
width, height, fps, and k1, k2, p1, p2, k3, which must be zero): the
benchmark's configuration files hold it.
"""

from __future__ import annotations

import numpy as np

from portbench.raster import thick_line as _draw_line


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


class SyntheticSequence:
    """Deterministic RGB-D sequence. frame(i) -> (gray f32[H,W] 0..255,
    depth f32[H,W] metres, timestamp float); gt_pose_wc(i) -> Twc f64[4,4]."""

    def __init__(
        self,
        height: int = 480,
        width: int = 640,
        seed: int = 0,
        motion_scale: float = 1.0,
        fps: float = 30.0,
        noise_seed: int = 0,
        gray_noise: float = 0.0,
        calib: dict | None = None,
    ):
        """calib: render through this pinhole calibration (fx, fy, cx, cy,
        width, height, fps; lens distortion must be zero). gray_noise: sigma
        (gray levels) of per-pixel Gaussian sensor noise that `render` adds,
        drawn on the device from noise_seed and each frame's noise key (0:
        none; `frame` adds none)."""
        self.noise_seed, self.gray_noise = int(noise_seed), float(gray_noise)
        if calib is not None:
            if any(float(calib.get(k, 0.0)) != 0.0 for k in ("k1", "k2", "p1", "p2", "k3")):
                raise ValueError("the scene renders through a pinhole: lens distortion must be zero")
            width, height = int(calib["width"]), int(calib["height"])
            fps = float(calib["fps"])
        self.height, self.width = height, width
        self.fps = fps
        self.seed = seed
        rng = np.random.default_rng(seed)
        c = calib if calib is not None else dict(fx=520.0, fy=520.0, cx=width / 2 - 0.5, cy=height / 2 - 0.5)
        self.tex = _texture(rng)
        self.tex_scale = 220.0  # pixels per world metre on the planes
        self.z_bg = 3.4
        # foreground square patches (x, y, half-size, z, texture offset x,
        # y), each sampling its own texture region
        self.patches = [
            (rng.uniform(-1.4, 1.4), rng.uniform(-1.0, 1.0),
             rng.uniform(0.2, 0.5), rng.uniform(1.5, 3.0),
             rng.uniform(4.0, 8.0), rng.uniform(4.0, 8.0))
            for _ in range(14)
        ]
        self.motion_scale = motion_scale
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]], np.float32)
        self.K = K
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        self.ray = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, np.float64)], -1)

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

    def render(self, indices, device, chunk: int = 16, noise_keys=None):
        """The frames `indices` rendered in torch on `device`, `chunk` frames
        per pass -> (gray f32[n, H, W], depth f32[n, H, W]) on the device:
        `frame`'s arithmetic (float64 rays and plane hits, float32 texels).
        Frame j's sensor noise is drawn from noise_keys[j] (default: its
        index), so a frame shown twice can carry fresh noise."""
        import torch

        keys = list(indices) if noise_keys is None else list(noise_keys)

        ray = torch.as_tensor(self.ray, device=device)
        tex = torch.as_tensor(self.tex, device=device)
        size = tex.shape[0]
        grays, depths = [], []
        for s in range(0, len(indices), chunk):
            idx = list(indices[s:s + chunk])
            T = torch.as_tensor(np.stack([self.gt_pose_wc(i) for i in idx]), device=device)
            R, c = T[:, None, None, :3, :3], T[:, :3, 3]
            # ray @ R.T, per frame
            d = (ray[None, :, :, None, :] * R).sum(-1)
            dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
            cx, cy, cz = (c[:, k, None, None] for k in range(3))
            t_bg = (self.z_bg - cz) / dz
            depth = t_bg.clone()
            wx = cx + t_bg * dx
            wy = cy + t_bg * dy
            for px, py, half, pz, ox, oy in self.patches:
                t_p = (pz - cz) / dz
                x = cx + t_p * dx
                y = cy + t_p * dy
                hit = (torch.abs(x - px) < half) & (torch.abs(y - py) < half) & (t_p > 0.1) & (t_p < depth)
                depth = torch.where(hit, t_p, depth)
                wx = torch.where(hit, x + ox, wx)
                wy = torch.where(hit, y + oy, wy)
            fx_ = torch.remainder(wx * self.tex_scale, size - 1)
            fy_ = torch.remainder(wy * self.tex_scale, size - 1)
            x0, y0 = fx_.long(), fy_.long()
            ax, ay = (fx_ - x0).float(), (fy_ - y0).float()
            t00, t01 = tex[y0, x0], tex[y0, x0 + 1]
            t10, t11 = tex[y0 + 1, x0], tex[y0 + 1, x0 + 1]
            gray = (1 - ay) * ((1 - ax) * t00 + ax * t01) + ay * ((1 - ax) * t10 + ax * t11)
            if self.gray_noise > 0:
                noise = torch.empty_like(gray)
                for j, key in enumerate(keys[s:s + chunk]):
                    gen = torch.Generator(device=device).manual_seed((self.noise_seed * 1_000_003 + key) % 2**63)
                    noise[j].normal_(0.0, self.gray_noise, generator=gen)
                gray = gray + noise
            grays.append(gray)
            depths.append(depth.float())
        return torch.cat(grays), torch.cat(depths)
