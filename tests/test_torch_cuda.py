"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the reference tests.)
Tolerances as in chip_smoke.py: B1 and B4 to 1e-2 with equal corner
masks, B2 exact, B3 poses to 1e-4 with at most 2 inlier flips per
problem."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from plslam_tpu_torch import load_settings
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence, pose_problem, pose_problem_pair
from plslam_tpu_torch.ops import brief, fast, fast_cuda, patches, pyramid
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.solvers import pose

pytestmark = pytest.mark.cuda

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM1.yaml"
CFG_LINES = Path(__file__).resolve().parents[1] / "configs" / "TUM3.yaml"


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


@pytest.mark.parametrize("LHW, level_hw", [
    # TMA path (rows of 16-byte multiples): the plane's last tiles cut at
    # W = 328 and H = 200; live extents 96 and 160 wide cut tiles inside
    ((3, 200, 328), [(200, 328), (150, 90), (75, 150)]),
    # plain-load path (W = 131): ragged on both edges
    ((2, 101, 131), [(101, 131), (60, 70)]),
])
def test_b1_ragged_live_extents(dev, LHW, level_hw):
    rng = np.random.default_rng(sum(LHW))
    stack = torch.from_numpy(rng.uniform(0, 255, LHW).astype(np.float32)).to(dev)
    got = fast_cuda.fast_blur_stack(stack, level_hw, 20.0, 7.0)
    ref = fast_cuda.fast_blur_stack_plain(stack, level_hw, 20.0, 7.0)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-2
    for g, r in zip(got[:2], ref[:2]):
        assert torch.equal(g > 0, r > 0)
        assert int((g > 0).sum()) > 100
    # zeros past each level's live extent
    for lvl, (h, w) in enumerate(fast_cuda.live_extents(level_hw, *LHW[1:])):
        assert not got[2][lvl, h:].any() and not got[2][lvl, :, w:].any()


@pytest.mark.parametrize("shape", [(480, 640), (97, 131)])
def test_b4_fast_scores(dev, shape):
    """B4 against its twin; the odd shape leaves ragged tiles at both edges."""
    rng = np.random.default_rng(shape[0])
    img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
    n0 = fast_cuda.fast_scores.launches
    got = fast_cuda.fast_scores(img, 20.0, 7.0)
    assert fast_cuda.fast_scores.launches == n0 + 1
    ref = fast_cuda.fast_scores_plain(img, 20.0, 7.0)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-2
        assert torch.equal(g > 0, r > 0)
        assert int((g > 0).sum()) > 100
    card = fast.fast_with_fallback(img, 20.0, 7.0, 32, 19)
    assert fast_cuda.fast_scores.launches == n0 + 2
    assert torch.equal(card.cpu() > 0, fast.fast_with_fallback(img.cpu(), 20.0, 7.0, 32, 19) > 0)


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


@pytest.mark.parametrize("K", [1, 31, 1000, 1024])
def test_b2_ragged_counts_and_edges(dev, K):
    """Counts whose K * 39 * 39 floats end inside a float4 group (1, 31,
    1000, 1024: remainders 1, 3, 0, 0), windows at the clamp edges of the
    flattened stack, and padded slots whose start is negative (it wraps
    once by the dimension, then clamps)."""
    rng = np.random.default_rng(K)
    rows, cols, r = 8 * 480, 640, brief.PATCH_D // 2
    img = torch.from_numpy(rng.uniform(0, 255, (rows, cols)).astype(np.float32)).to(dev)
    yx = np.stack([rng.integers(r, rows - r, K), rng.integers(r, cols - r, K)], -1)
    edges = np.array([[r, r], [rows - r - 1, cols - r - 1], [r, cols - r - 1], [rows - r - 1, r],
                      [0, 0], [-7, 3], [5, -40], [rows + 3, cols + 9]])
    yx[: min(K, len(edges))] = edges[:K]
    if K > len(edges):
        yx[-1] = [0, 0]  # a padded slot last
    yx = torch.from_numpy(yx.astype(np.int32)).to(dev)
    n0 = patches.gather_patches.launches
    got = patches.gather_patches(img, yx, brief.PATCH_D)
    torch.cuda.synchronize()
    assert patches.gather_patches.launches == n0 + 1
    assert got.shape == (K, brief.PATCH_D, brief.PATCH_D)
    assert torch.equal(got, patches.gather_patches_plain(img, yx, brief.PATCH_D))
    # a view whose data pointer is not 8-byte aligned takes a copy first
    pair = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), yx.reshape(-1)])[1:].reshape(K, 2)
    assert torch.equal(patches.gather_patches(img, pair, brief.PATCH_D), got)
    with pytest.raises(ValueError):  # the kernel is built for 39x39 windows only
        patches.gather_patches(img, yx, 15)


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


def _stacked_problems(dev, P):
    """P problems at the tracker's capacity (N = 1024, L = 128): one with
    valid lines, one whose lines are all padded, one with every row
    padded."""
    a = pose_problem(np.random.default_rng(7), with_lines=True)
    b = pose_problem(np.random.default_rng(8), with_lines=False)
    c = dict(pts=a["pts"][:4] + (np.zeros_like(a["pts"][4]),), lines=a["lines"][:4] + (np.zeros_like(a["lines"][4]),))
    probs = [a, b, c][:P]
    T = lambda k, i: torch.from_numpy(np.stack([pr[k][i] for pr in probs])).to(dev)  # noqa: E731
    return (pose.PointObs(*(T("pts", i) for i in range(5))), pose.LineObs(*(T("lines", i) for i in range(5))),
            a["K"], a["bf"])


@pytest.mark.parametrize("P", [1, 2, 3, "tracker"])
def test_b3_stacked_problems(dev, P):
    """P stacked copies, or ("tracker") two problems laid out as the
    tracker's call gives them: start pose, obs, inverse sigma2 and stereo
    flags expanded along the problem axis (stride 0), landmarks and valid
    flags per problem, no lines."""
    if P == "tracker":
        pr = pose_problem_pair(np.random.default_rng(7))
        T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        P, lines, K, bf = 2, None, pr["K"], pr["bf"]
        pts = pose.PointObs(T(pr["xw"]), T(pr["obs"]).expand(2, -1, -1), T(pr["isig"]).expand(2, -1),
                            T(pr["stereo"]).expand(2, -1), T(pr["valid"]))
        T0 = torch.eye(4, device=dev).expand(P, 4, 4)
    else:
        pts, lines, K, bf = _stacked_problems(dev, P)
        T0 = torch.eye(4, device=dev).expand(P, 4, 4).contiguous()
    n0 = pose.pose_lm.launches
    Tk, pk, lk = pose.pose_optimization(T0, pts, K, bf, lines=lines)
    assert pose.pose_lm.launches == n0 + 1  # one launch for all P problems
    Tp, pp, lp = pose.pose_optimization_plain(T0, pts, K, bf, lines=lines)
    assert Tk.shape == (P, 4, 4) and pk.shape == (P, 1024)
    for p in range(P):
        assert float((Tk[p] - Tp[p]).abs().max()) <= 1e-4
        flips = int((pk[p] != pp[p]).sum()) + (0 if lines is None else int((lk[p] != lp[p]).sum()))
        assert flips <= 2
        if p < 2:  # problem 2 has no valid row
            assert float(Tk[p, :3, 3].sub(torch.tensor([0.1, -0.08, 0.05], device=dev)).abs().max()) < 0.02
    if lines is not None:
        assert lk.shape == (P, 128)
    if P == 3:
        assert torch.equal(Tk[2], T0[2]) and not pk[2].any() and not lk[2].any()


def test_b3_wrapper_rejects_what_the_bulk_copy_cannot_take(dev):
    pts, lines, K, bf = _stacked_problems(dev, 1)
    T0 = torch.eye(4, device=dev)[None]
    # a view 4 bytes into its storage: not 16-byte aligned
    shifted = torch.empty(1, 1024 * 3 + 1, device=dev)[:, 1:].view(1, 1024, 3)
    shifted.copy_(pts.xw)
    with pytest.raises(ValueError, match="aligned"):
        pose.pose_lm(T0, pts._replace(xw=shifted), K, bf, lines)
    # the most rows one block's shared memory takes (30 N + 41 L bytes, N =
    # 4096, L as large as fits) launch and, padded past the problem's own
    # rows, give its result exactly; 16 more lines raise in the wrapper
    n_big = 4096
    l_fit = (pose.smem_limit() - 30 * n_big) // 41 // 16 * 16

    def padded(obs, rows, n):
        return type(obs)(*(torch.cat([f, torch.zeros((1, n - rows, *f.shape[2:]), dtype=f.dtype, device=dev)], 1)
                           for f in obs))

    T_ref, p_ref, l_ref = pose.pose_lm(T0, pts, K, bf, lines)
    Tb, pb, lb = pose.pose_lm(T0, padded(pts, 1024, n_big), K, bf, padded(lines, 128, l_fit))
    assert torch.equal(Tb, T_ref) and torch.equal(pb[:, :1024], p_ref) and torch.equal(lb[:, :128], l_ref)
    assert not pb[:, 1024:].any() and not lb[:, 128:].any()
    with pytest.raises(ValueError, match="exceed"):
        pose.pose_lm(T0, padded(pts, 1024, n_big), K, bf, padded(lines, 128, l_fit + 16))
    # N not a multiple of 16: byte counts the bulk copy cannot move
    with pytest.raises(ValueError, match="multiples of 16"):
        pose.pose_lm(T0, pose.PointObs(*(f[:, :1000] for f in pts)), K, bf, lines)


def test_slice_on_card_matches_cpu_path(dev):
    _card_vs_cpu(CFG)


def test_lines_slice_on_card_matches_cpu_path(dev):
    _card_vs_cpu(CFG_LINES)


def _card_vs_cpu(cfg):
    s = load_settings(cfg)
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
