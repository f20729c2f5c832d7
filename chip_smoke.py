#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each timed and printed:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the one nvcc call over plslam_tpu_torch/csrc/*.cu;
  3. kernels  each CUDA kernel at its main-path shapes against its plain
              PyTorch twin on the card (max abs error vs the stated
              tolerance), with CUDA-event times and the least time the card
              could take for the same work;
  4. slice    the point-only FrameBuilder -> Tracker step (configs/TUM1.yaml,
              640x480) over 30 synthetic frames on the card: status per
              frame, ATE against ground truth, ms/frame, kernel launches
              counted during exactly this run, and the first frames held
              against the port's plain CPU path.
Then one JSON line with the kernels, and as the last line
{"ok": true, "device": {...}} -- printed only if every phase passed. Any
failure exits non-zero; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BUDGET_S = 300.0  # whole run, build included
N_FRAMES = 30
N_TIMED = 20
SLEEP_CYCLES = 2_000_000  # ~1 ms of GPU clock ahead of each timed call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

# Tolerances, kernel vs plain twin on the card, and why:
#  B1: scores are sums of 16 terms and the blur a 7+7-tap stencil; the twin
#      sums in another order (the blur as cuBLAS float32 products), so values
#      agree to a few float32 ulps of their magnitude (scores < 4096). The
#      corner masks themselves must agree exactly (same differences).
#  B2: a copy: exact.
#  B3: the same arithmetic reduced in another order (block tree vs matrix
#      product) and solved by unpivoted vs pivoted LU: poses to 1e-4,
#      at most 2 inlier flips at the chi2 boundary.
TOL_B1 = 1e-2
TOL_B2 = 0.0
TOL_B3_POSE = 1e-4
TOL_B3_FLIPS = 2


class Failed(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise Failed(msg)


def log(msg=""):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s{' (FAILED)' if exc[0] else ''}")
        return False


def cuda_ms(torch, fn, n=N_TIMED):
    """Median over n runs of one call's device time (CUDA events), after a
    warm-up call. Before each run the card spins for ~1 ms
    (torch.cuda._sleep) while the host enqueues the call, so a call whose
    host side is shorter than that is timed without its launch overhead;
    a longer one (the plain twins) includes its host time."""
    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    from plslam_tpu_torch import _build, load_settings
    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.io.synthetic import SyntheticSequence, pose_problem
    from plslam_tpu_torch.ops import brief, fast_cuda, patches, pyramid
    from plslam_tpu_torch.pipeline.tracking import ST_OK, TEL_STATUS, TEL_TRACKED, Tracker
    from plslam_tpu_torch.solvers import pose as pose_mod

    dev = torch.device("cuda")
    kernels = {}

    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
        log(smi.stdout.strip().splitlines()[0])  # "<name>, <power limit>", as nvidia-smi gives them
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    with Phase("build"):
        _build.library()
        log(f"nvcc: {_build.last_build['seconds']:.2f} s -> {Path(_build.last_build['path']).name}")
        for line in _build.last_build.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    settings = load_settings(ROOT / "configs" / "TUM1.yaml")
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=0, settings=settings)
    frames = [seq.frame(i) for i in range(N_FRAMES)]

    with Phase("kernels"):
        L, H, W = settings.n_levels, settings.height, settings.width
        shapes = pyramid.level_shapes(H, W, L, settings.scale_factor)
        gray = torch.from_numpy(frames[0][0]).to(dev)
        stack = pyramid.build_pyramid_stack(gray, L, settings.scale_factor)
        ini, mn = float(settings.ini_th_fast), float(settings.min_th_fast)

        # B1 at the pyramid of a real 640x480 frame
        got = fast_cuda.fast_blur_stack(stack, shapes, ini, mn)
        ref = fast_cuda.fast_blur_stack_plain(stack, shapes, ini, mn)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        masks_equal = all(bool(torch.equal(a > 0, b > 0)) for a, b in zip(got[:2], ref[:2]))
        ms = cuda_ms(torch, lambda: fast_cuda.fast_blur_stack(stack, shapes, ini, mn))
        plain = cuda_ms(torch, lambda: fast_cuda.fast_blur_stack_plain(stack, shapes, ini, mn))
        ext = fast_cuda.live_extents(shapes, H, W)
        live = sum(h * w for h, w in ext)
        # reads: each level's live extent and the 3-px halo past its right
        # and bottom edges (clipped to the plane); the outputs depend on no
        # other pixel. Writes: the three full f32[L, H, W] outputs.
        read = sum(min(h + 3, H) * min(w + 3, W) for h, w in ext)
        # per live pixel: 16 ring differences; per threshold 16 x (2 sub,
        # 2 max, 2 add, 2 compare); 4 for the final selects; 28 blur MACs
        # -> 16 + 256 + 4 + 28 x 2 = 332 float32 operations
        b_ms, b_by = bound_ms(4 * read + 3 * 4 * stack.numel(), 332 * live)
        log(f"B1 fast_blur_stack: max_abs_err {err:.3e} (tol {TOL_B1}), corner masks equal {masks_equal}, "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        require(err <= TOL_B1 and masks_equal, "B1 disagrees with its plain twin")
        kernels["fast_blur_stack"] = dict(
            name="fast_blur_stack", route="cuda", source="plslam_tpu_torch/csrc/fast_blur.cu",
            replaces="plslam_tpu/ops/fast_pallas.py:145", max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )

        # B2 at K = 1000 centres on the blurred stack
        blur_flat = got[2].reshape(L * H, W).contiguous()
        rng = np.random.default_rng(0)
        lv = rng.integers(0, L, 1000)
        hw = np.array(shapes)[lv]
        yx = np.stack([lv * H + rng.integers(19, hw[:, 0] - 19), rng.integers(19, hw[:, 1] - 19)], -1)
        yx_t = torch.from_numpy(yx.astype(np.int32)).to(dev)
        D = brief.PATCH_D
        got2 = patches.gather_patches(blur_flat, yx_t, D)
        ref2 = patches.gather_patches_plain(blur_flat, yx_t, D)
        ys, xs = patches._starts(yx_t, L * H, W, D)
        view = blur_flat.unfold(0, D, 1).unfold(1, D, 1)
        lib2 = view[ys, xs]
        torch.cuda.synchronize()
        err2 = float((got2 - ref2).abs().max())
        require(torch.equal(lib2, ref2), "unfold yardstick disagrees with the plain gather")
        ms2 = cuda_ms(torch, lambda: patches.gather_patches(blur_flat, yx_t, D))
        plain2 = cuda_ms(torch, lambda: patches.gather_patches_plain(blur_flat, yx_t, D))
        lib_ms2 = cuda_ms(torch, lambda: view[ys, xs])
        b_ms2, b_by2 = bound_ms(2 * got2.numel() * 4 + yx_t.numel() * 4, 0)
        log(f"B2 gather_patches: max_abs_err {err2:.3e} (tol {TOL_B2}), {ms2:.4f} ms, plain {plain2:.4f} ms, "
            f"unfold-index {lib_ms2:.4f} ms, bound {b_ms2:.4f} ms ({b_by2})")
        require(err2 <= TOL_B2, "B2 disagrees with its plain twin")
        kernels["gather_patches"] = dict(
            name="gather_patches", route="cuda", source="plslam_tpu_torch/csrc/patches.cu",
            replaces="plslam_tpu/ops/patches.py:44", max_abs_err=err2, ms=ms2, plain_ms=plain2,
            bound_ms=b_ms2, bound_by=b_by2, library_ms=lib_ms2,
        )

        # B3 at N = 1024 points, L = 128 lines, without and with valid lines
        err3, times3 = 0.0, {}
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        T0 = torch.eye(4, device=dev)
        for with_lines in (False, True):
            pb = pose_problem(np.random.default_rng(1), with_lines=with_lines)
            pts = pose_mod.PointObs(*map(T, pb["pts"]))
            lines = pose_mod.LineObs(*map(T, pb["lines"]))
            Tk, pk, lk = pose_mod.pose_lm(T0, pts, pb["K"], pb["bf"], lines)
            Tp, pp, lp = pose_mod.pose_optimization_plain(T0, pts, pb["K"], pb["bf"], lines)
            torch.cuda.synchronize()
            e = float((Tk - Tp).abs().max())
            flips = int((pk != pp).sum()) + int((lk != lp).sum())
            log(f"B3 pose_lm (lines {'valid' if with_lines else 'all invalid'}): |dT| {e:.3e} "
                f"(tol {TOL_B3_POSE}), inlier flips {flips} (tol {TOL_B3_FLIPS}), "
                f"inliers {int(pk.sum())}/{int(pts.valid.sum())} points, {int(lk.sum())}/{int(lines.valid.sum())} lines")
            require(bool(torch.isfinite(Tk).all()) and e <= TOL_B3_POSE and flips <= TOL_B3_FLIPS,
                    "B3 disagrees with its plain twin")
            err3 = max(err3, e)
            times3[with_lines] = (
                cuda_ms(torch, lambda: pose_mod.pose_lm(T0, pts, pb["K"], pb["bf"], lines)),
                cuda_ms(torch, lambda: pose_mod.pose_optimization_plain(T0, pts, pb["K"], pb["bf"], lines), n=5),
            )
        ms3, plain3 = times3[True]
        # latency floor: the same launch and schedule with no valid row, so
        # only the 14 block reductions and thread 0's serial solves remain
        empty = pose_mod.PointObs(*(T(a) for a in pb["pts"][:4]), torch.zeros_like(pts.valid))
        no_lines = pose_mod.LineObs(*(T(a) for a in pb["lines"][:4]), torch.zeros_like(lines.valid))
        floor3 = cuda_ms(torch, lambda: pose_mod.pose_lm(T0, empty, pb["K"], pb["bf"], no_lines))
        log(f"B3 pose_lm: {ms3:.4f} ms (lines valid), {times3[False][0]:.4f} ms (no valid line), "
            f"{floor3:.4f} ms (no valid row: latency floor); plain {plain3:.4f} ms")
        # float32 operations, counted from pose_lm.cu's bodies. One build
        # (point_terms / line_terms over the active rows): a mono point row
        # 180 (point_residual 28, chi2 6, Huber 7, Jacobian 17, two add_row
        # 120, cost 2), a stereo one 250 (+3 for its third residual, +7 for
        # its Jacobian row, +60 for a third add_row), a line row 238 (two
        # line_endpoint 104, chi2 4, Huber 10, two add_row 120). Round r of
        # the (4, 2, 2, 2) schedule builds 1 + iters[r] times: round 0 over
        # the valid rows, later rounds over the re-classified ones, counted
        # here as the final inliers (the per-round sets stay on the card).
        # Each round's re-classification: 35 per valid mono point, 38 per
        # stereo one, 109 per valid line. Thread 0: solve6 209 + exp_compose
        # 215 per iteration, 10 iterations.
        st = pts.is_stereo

        def build_ops(p_act, l_act):
            return int(180 * (p_act & ~st).sum() + 250 * (p_act & st).sum() + 238 * l_act.sum())

        n_ops3 = (5 * build_ops(pts.valid, lines.valid) + 9 * build_ops(pk, lk)
                  + 4 * int(35 * (pts.valid & ~st).sum() + 38 * (pts.valid & st).sum() + 109 * lines.valid.sum())
                  + 10 * (209 + 215))
        # each input row read once; the pose and the two masks written once
        n_bytes3 = 1024 * (7 * 4 + 2) + 128 * (10 * 4 + 1) + 64 + 64 + 1024 + 128
        b_ms3, b_by3 = bound_ms(n_bytes3, n_ops3)
        log(f"B3 bound: {n_ops3} float32 operations, {n_bytes3} bytes -> {b_ms3:.6f} ms ({b_by3}); "
            f"latency floor {floor3:.4f} ms (measured)")
        kernels["pose_lm"] = dict(
            name="pose_lm", route="cuda", source="plslam_tpu_torch/csrc/pose_lm.cu",
            replaces="plslam_tpu/solvers/pose_pallas.py:67", max_abs_err=err3, ms=ms3, plain_ms=plain3,
            bound_ms=b_ms3, bound_by=b_by3, library_ms=None,
        )

    with Phase("slice"):
        # warm-up on a throwaway tracker (cuBLAS handles, module loading)
        builder = FrameBuilder(settings)
        warm = Tracker(settings)
        ws = warm.init_state()
        for g, d, _ in frames[:2]:
            ws, _ = warm.step(ws, builder(g, d))
        del warm, ws
        torch.cuda.synchronize()

        tracker = Tracker(settings)
        state = tracker.init_state()
        wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
        for w in wrappers:
            w.launches = 0
        ms_frame, tel, poses = [], [], []
        for i, (g, d, _) in enumerate(frames):
            t0 = time.perf_counter()
            state, out = tracker.step(state, builder(g, d))
            torch.cuda.synchronize()
            ms_frame.append((time.perf_counter() - t0) * 1e3)
            tel.append(out.telemetry.cpu().numpy())
            poses.append(out.Tcw.cpu().numpy().astype(np.float64))
        launches = {w.__name__: w.launches for w in wrappers}

        status = [int(t[TEL_STATUS]) for t in tel]
        tracked = [bool(t[TEL_TRACKED]) for t in tel]
        log("status per frame: " + " ".join(str(s) for s in status))
        n_tracked = sum(tracked)
        require(all(np.isfinite(T).all() and T.shape == (4, 4) for T in poses), "non-finite pose")
        est = [(seq.timestamp(i), np.linalg.inv(T)) for i, T in enumerate(poses)]
        ate, n_pairs = ate_rmse(est, seq.gt_trajectory())
        log(f"tracked {n_tracked}/{N_FRAMES}; ATE RMSE {ate * 100:.4f} cm over {n_pairs} frames; "
            f"median {statistics.median(ms_frame):.3f} ms/frame (first {ms_frame[0]:.3f} ms)")
        log(f"launches during the slice: {launches}")
        require(n_tracked == N_FRAMES and all(s == ST_OK for s in status), "a frame was not tracked")
        require(ate <= 0.02, f"ATE {ate:.4f} m above 2 cm")
        require(launches["fast_blur_stack"] == N_FRAMES and launches["gather_patches"] == N_FRAMES,
                "B1/B2 not launched once per frame")
        require(launches["pose_lm"] >= N_FRAMES - 1, "B3 not launched on every tracked frame")

        # the first frames against the port's plain CPU path
        n_ref = 3
        cb, ct = FrameBuilder(settings, device="cpu"), Tracker(settings, device="cpu")
        cs = ct.init_state()
        for i, (g, d, _) in enumerate(frames[:n_ref]):
            cf = cb(g, d)
            cs, cout = ct.step(cs, cf)
            dt = float(np.abs(cout.Tcw.numpy() - poses[i]).max())
            same = int(cout.telemetry[TEL_STATUS]) == status[i]
            log(f"frame {i} vs CPU path: status equal {same}, |dTcw| {dt:.2e}")
            require(same and dt < 1e-3, "card and CPU paths disagree")
        for w in wrappers:
            kernels[w.__name__]["launches"] = launches[w.__name__]

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {BUDGET_S:.0f} s)")
    require(total <= BUDGET_S, "over the wall-clock budget")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in order} for n in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
