"""TUM-format trajectory writing (byte-compatible with TUM eval tooling).

Port of plslam_tpu/io/trajectory.py (numpy + scipy, as the reference):
each frame's pose is kept as T_rel = Tcw * Twr(refKF) at track time and
composed with the reference keyframe's (possibly corrected) pose at save
time (System::SaveTrajectoryTUM). Lines: `timestamp tx ty tz qx qy qz qw`
of Twc.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pose_line(t: float, Twc: np.ndarray) -> str:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(Twc[:3, :3]).as_quat()  # xyzw
    tx, ty, tz = Twc[:3, 3]
    return (
        f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
    )


def save_trajectory_tum(path: str | Path, timestamps, rel_poses, ref_kf_ids, kf_poses, tracked_mask=None):
    """Write the frame trajectory.

    timestamps: [N] float; rel_poses: [N, 4, 4] Tcr (current <- ref KF);
    ref_kf_ids: [N] int; kf_poses: [K, 4, 4] final KF Tcw; tracked_mask:
    [N] bool (untracked frames are skipped, like the reference's empty-pose
    check)."""
    lines = []
    kf_poses = np.asarray(kf_poses, np.float64)
    for i, (t, Tcr, ref) in enumerate(zip(timestamps, rel_poses, ref_kf_ids)):
        if tracked_mask is not None and not tracked_mask[i]:
            continue
        Tcw = np.asarray(Tcr, np.float64) @ kf_poses[int(ref)]
        lines.append(_pose_line(float(t), np.linalg.inv(Tcw)))
    Path(path).write_text("\n".join(lines) + "\n")


def save_keyframe_trajectory_tum(path: str | Path, kf_timestamps, kf_poses, kf_valid):
    """System::SaveKeyFrameTrajectoryTUM: Twc of each valid keyframe."""
    lines = []
    for t, Tcw, ok in zip(kf_timestamps, np.asarray(kf_poses, np.float64), kf_valid):
        if not ok:
            continue
        lines.append(_pose_line(float(t), np.linalg.inv(Tcw)))
    Path(path).write_text("\n".join(lines) + "\n")


def load_trajectory_tum(path: str | Path):
    """A TUM trajectory file -> [(t, Twc f64[4, 4])] (for tests and ATE)."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        if len(v) != 8:
            continue
        t, tx, ty, tz, qx, qy, qz, qw = v
        n = (qx * qx + qy * qy + qz * qz + qw * qw) ** 0.5
        qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
        T = np.eye(4)
        T[:3, :3] = [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
        T[:3, 3] = [tx, ty, tz]
        out.append((t, T))
    return out
