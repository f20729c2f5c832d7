"""Frozen copy of plslam_tpu_torch/eval/ate.py: the benchmark's reference imports nothing of the port.

ATE / RPE evaluation, TUM-tooling-compatible (numpy copy of
plslam_tpu/eval/ate.py, so the port scores trajectories without JAX).

Vendored equivalent of TUM's evaluate_ate.py / evaluate_rpe.py (the
reference's de-facto validation, SURVEY.md §5.2): timestamp association,
Horn/Umeyama SE3 alignment (no scale for RGB-D), translational RMSE.
"""

from __future__ import annotations

import numpy as np


def associate(traj_a, traj_b, max_dt: float = 0.02):
    """Greedy timestamp association of [(t, Twc)] lists -> paired arrays."""
    ta = np.array([t for t, _ in traj_a])
    tb = np.array([t for t, _ in traj_b])
    pairs = []
    used = set()
    for i, t in enumerate(ta):
        j = int(np.argmin(np.abs(tb - t)))
        if abs(tb[j] - t) <= max_dt and j not in used:
            pairs.append((i, j))
            used.add(j)
    A = np.stack([traj_a[i][1][:3, 3] for i, _ in pairs])
    B = np.stack([traj_b[j][1][:3, 3] for _, j in pairs])
    return A, B, pairs


def horn_align(A, B):
    """Rigid SE3 (no scale) aligning A onto B: returns R, t with
    B ~= A @ R.T + t (Horn's closed form via SVD)."""
    ca, cb = A.mean(0), B.mean(0)
    H = (A - ca).T @ (B - cb)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = cb - R @ ca
    return R, t


def ate_rmse(traj_est, traj_gt, max_dt: float = 0.02):
    """Absolute trajectory error RMSE (meters) after SE3 alignment."""
    A, B, pairs = associate(traj_est, traj_gt, max_dt)
    if len(pairs) < 2:
        return float("inf"), 0
    R, t = horn_align(A, B)
    err = (A @ R.T + t) - B
    return float(np.sqrt((err**2).sum(-1).mean())), len(pairs)


def rpe_rmse(traj_est, traj_gt, delta: int = 1, max_dt: float = 0.02):
    """Relative pose error RMSE (translational drift per `delta` frames)."""
    _, _, pairs = associate(traj_est, traj_gt, max_dt)
    errs = []
    for k in range(len(pairs) - delta):
        i0, j0 = pairs[k]
        i1, j1 = pairs[k + delta]
        dE = np.linalg.inv(traj_est[i0][1]) @ traj_est[i1][1]
        dG = np.linalg.inv(traj_gt[j0][1]) @ traj_gt[j1][1]
        E = np.linalg.inv(dG) @ dE
        errs.append(np.linalg.norm(E[:3, 3]))
    if not errs:
        return float("inf"), 0
    errs = np.asarray(errs)
    return float(np.sqrt((errs**2).mean())), len(errs)


def load_trajectory_tum(path):
    """A TUM trajectory file -> [(t, Twc f64[4, 4])] (copy of
    plslam_tpu_torch/io/trajectory.py's reader)."""
    from pathlib import Path

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
