"""TUM RGB-D dataset loading: association files, DepthMapFactor scaling,
ground truth.

Port of plslam_tpu/io/tum.py (Examples/RGB-D/rgbd_tum.cc LoadImages):
association file lines are `t_rgb rgb/xxx.png t_depth depth/xxx.png`. The
reference decodes with cv2.imread; the port with io/png.py, which gives
the same arrays (gray as IMREAD_GRAYSCALE, depth as IMREAD_UNCHANGED).
Decoding is host work, as in the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from plslam_tpu_torch.io.png import read_png, to_gray


def load_associations(assoc_file: str | Path):
    """-> list of (t_rgb: float, rgb_rel: str, t_depth: float, depth_rel: str)."""
    out = []
    for line in Path(assoc_file).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 4:
            continue
        out.append((float(parts[0]), parts[1], float(parts[2]), parts[3]))
    return out


class TumSequence:
    """frame(i) -> (gray f32[H,W] 0..255, depth f32[H,W] metres, timestamp)."""

    def __init__(self, seq_dir: str | Path, assoc_file: str | Path, depth_map_factor: float = 5000.0):
        self.seq_dir = Path(seq_dir)
        self.assoc = load_associations(assoc_file)
        self.inv_factor = 1.0 / depth_map_factor
        self.n_frames = len(self.assoc)

    def timestamp(self, i: int) -> float:
        return self.assoc[i][0]

    def frame(self, i: int):
        t_rgb, rgb_rel, _, depth_rel = self.assoc[i]
        rgb_path, depth_path = self.seq_dir / rgb_rel, self.seq_dir / depth_rel
        if not (rgb_path.exists() and depth_path.exists()):
            raise FileNotFoundError(f"frame {i}: {rgb_rel} / {depth_rel}")
        gray = to_gray(read_png(rgb_path))
        depth_raw = read_png(depth_path)
        if depth_raw.ndim != 2:
            raise ValueError(f"frame {i}: depth {depth_rel} is not a one-channel image")
        depth = depth_raw.astype(np.float32) * self.inv_factor
        return gray.astype(np.float32), depth, t_rgb


def load_groundtruth(gt_file: str | Path):
    """TUM groundtruth.txt -> [(t, Twc 4x4)] (tx ty tz qx qy qz qw)."""
    out = []
    for line in Path(gt_file).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        if len(v) != 8:
            continue
        t, tx, ty, tz, qx, qy, qz, qw = v
        n = (qx * qx + qy * qy + qz * qz + qw * qw) ** 0.5
        qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
        R = np.array(
            [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ]
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [tx, ty, tz]
        out.append((t, T))
    return out
