"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the reference tests.)
Tolerances as in chip_smoke.py: B1 to 1e-2 with equal corner masks, B2
exact, B3 poses to 1e-4 with at most 2 inlier flips."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from plslam_tpu_torch import load_settings
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence, pose_problem
from plslam_tpu_torch.ops import brief, fast_cuda, patches, pyramid
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.solvers import pose

pytestmark = pytest.mark.cuda

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM1.yaml"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_b1_fast_blur_stack(dev):
    s = load_settings(CFG)
    gray, _, _ = SyntheticSequence(n_frames=1, seed=0, settings=s).frame(0)
    shapes = pyramid.level_shapes(s.height, s.width, s.n_levels, s.scale_factor)
    stack = pyramid.build_pyramid_stack(torch.from_numpy(gray).to(dev), s.n_levels, s.scale_factor)
    n0 = fast_cuda.fast_blur_stack.launches
    got = fast_cuda.fast_blur_stack(stack, shapes, 20.0, 7.0)
    ref = fast_cuda.fast_blur_stack_plain(stack, shapes, 20.0, 7.0)
    assert fast_cuda.fast_blur_stack.launches == n0 + 1
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-2
    for g, r in zip(got[:2], ref[:2]):
        assert torch.equal(g > 0, r > 0)
        assert int((g > 0).sum()) > 1000


def test_b2_gather_patches(dev):
    rng = np.random.default_rng(3)
    rows, cols = 8 * 480, 640
    img = torch.from_numpy(rng.uniform(0, 255, (rows, cols)).astype(np.float32)).to(dev)
    yx = np.stack([rng.integers(-5, rows + 5, 1000), rng.integers(-5, cols + 5, 1000)], -1).astype(np.int32)
    yx = torch.from_numpy(yx).to(dev)
    n0 = patches.gather_patches.launches
    got = patches.gather_patches(img, yx, brief.PATCH_D)
    assert patches.gather_patches.launches == n0 + 1
    assert torch.equal(got, patches.gather_patches_plain(img, yx, brief.PATCH_D))
    with pytest.raises(ValueError):
        patches.gather_patches(img.double(), yx, brief.PATCH_D)


@pytest.mark.parametrize("with_lines", [False, True])
def test_b3_pose_lm(dev, with_lines):
    pb = pose_problem(np.random.default_rng(7), with_lines=with_lines)
    P = pose.PointObs(*(torch.from_numpy(a).to(dev) for a in pb["pts"]))
    L = pose.LineObs(*(torch.from_numpy(a).to(dev) for a in pb["lines"]))
    T0 = torch.eye(4, device=dev)
    n0 = pose.pose_lm.launches
    Tk, pk, lk = pose.pose_optimization(T0, P, pb["K"], pb["bf"], lines=L)
    assert pose.pose_lm.launches == n0 + 1
    Tp, pp, lp = pose.pose_optimization_plain(T0, P, pb["K"], pb["bf"], lines=L)
    assert float((Tk - Tp).abs().max()) <= 1e-4
    assert int((pk != pp).sum()) + int((lk != lp).sum()) <= 2
    assert float(Tk[:3, 3].sub(torch.tensor([0.1, -0.08, 0.05], device=dev)).abs().max()) < 0.02


def test_slice_on_card_matches_cpu_path(dev):
    s = load_settings(CFG)
    s = dataclasses.replace(s, width=320, height=240, fx=s.fx / 2, fy=s.fy / 2, cx=s.cx / 2, cy=s.cy / 2)
    seq = SyntheticSequence(n_frames=4, seed=0, settings=s)
    runs = {}
    for d in ("cpu", "cuda"):
        b, t = FrameBuilder(s, device=d), tracking.Tracker(s, max_kf=32, max_pts=4096, device=d)
        st, outs = t.init_state(), []
        for i in range(seq.n_frames):
            st, out = t.step(st, b(*seq.frame(i)[:2]))
            outs.append((int(out.telemetry[tracking.TEL_STATUS]), out.Tcw.cpu().numpy()))
        runs[d] = outs
    for (s_cpu, T_cpu), (s_gpu, T_gpu) in zip(runs["cpu"], runs["cuda"]):
        assert s_cpu == s_gpu == tracking.ST_OK
        assert np.abs(T_cpu - T_gpu).max() < 1e-3
