"""The control comes out not correct: the reference computed with TF32 on,
put in the program's place. Through the harness for each cell, on a short
window at the cell's own size: the window's own frames, pose problems and
local BA problems, the control's numbers judged where the program's go.
And on three seeds of synthetic frames and pose problems alone. Needs the
card (TF32 exists only there); skips without one. The readings the
limits were set from are portbench/calibrate.py's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference.pose import LineObs, PointObs
from portbench.scene import SyntheticSequence

ROOT = Path(__file__).resolve().parents[2]
LIMITS = json.loads((ROOT / "portbench/limits/fr3_pl_system.xyz.json").read_text())
SETTINGS = json.loads((ROOT / "portbench/configs/fr3_pl_system.json").read_text())["settings"]


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(card, cell):
    r = harness.run_cell(harness.Cell(cell), 2**31 + 11, 6.0, False, "cuda", control=True, log=lambda m: None)
    assert r["correct"] is True, r["checks"]
    assert r["control_correct"] is False, r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 2**31 + 5, 77])
def test_tf32_front_end_fails(card, seed):
    from portbench import generator

    sc = generator.scene({}, SETTINGS, seed)
    g, _ = sc.render([4], card)
    ref = check.reference_frame(g[0], SETTINGS)
    ctl = check.reference_frame(g[0], SETTINGS, tf32=True)
    (b1, t1), (b2, t2) = check.orb_bits(ctl, ref), check.line_bits(ctl, ref)
    assert (b1 + b2) / (t1 + t2) > LIMITS["frontend_bits"]["limit"]


def _tracking_problem(sc, K, rng, frame: int, device):
    """A 640x480 tracking problem of the scene: landmarks back-projected from
    frame 0's depth, observed in `frame` with 0.7 px noise (four fifths of
    them with a right-image coordinate), solved from frame 0's pose."""
    _, d0, _ = sc.frame(0)
    n = 1024
    u, v = rng.uniform(40, 600, n), rng.uniform(40, 440, n)
    z = d0[v.astype(int), u.astype(int)]
    Xc = np.stack([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z, z], -1)
    T0, Tf = sc.gt_pose_wc(0), sc.gt_pose_wc(frame)
    Xw = Xc @ T0[:3, :3].T + T0[:3, 3]
    Tcw = np.linalg.inv(Tf)
    P = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
    obs = np.stack([K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2], K[1, 1] * P[:, 1] / P[:, 2] + K[1, 2],
                    K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2] - 40.0 / P[:, 2]], -1)
    obs[:, :2] += rng.normal(0, 0.7, (n, 2))
    f = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    pts = PointObs(f(Xw), f(obs), f(np.ones(n)), f(rng.uniform(size=n) < 0.8, torch.bool), f(np.ones(n, bool), torch.bool))
    L = 128
    lines = LineObs(f(np.zeros((L, 3))), f(np.ones((L, 3))), f(np.tile([0.0, 1.0, -10.0], (L, 1))), f(np.ones(L)),
                    f(np.zeros(L, bool), torch.bool))
    return dict(Tcw0=f(np.linalg.inv(T0)), pts=pts, lines=lines, K=K, bf=40.0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2**31 + 7, 404])
def test_tf32_pose_solve_fails(card, seed):
    """As check.py compares B3: per problem the largest element of
    |Tcw - Tcw_ref|, and the 90th percentile over the problems (frame 0
    against frames 1-9 of the scene)."""
    sc = SyntheticSequence(seed=seed, calib=SETTINGS)
    K = np.array([[SETTINGS["fx"], 0, SETTINGS["cx"]], [0, SETTINGS["fy"], SETTINGS["cy"]], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(seed)
    gaps = []
    for frame in range(1, 10):
        prob = _tracking_problem(sc, K, rng, frame, card)
        gaps.append(float((check.reference_pose(prob, tf32=True)[0] - check.reference_pose(prob)[0]).abs().max()))
    assert float(np.quantile(gaps, 0.9)) > LIMITS["pose_gap_p90"]["limit"], gaps
