#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each timed and printed:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    one nvcc per plslam_tpu_torch/csrc/*.cu, all at once, with
              ptxas's report for every kernel (fails if B3 spills);
  3. kernels  each CUDA kernel at its main-path shapes against its plain
              PyTorch twin on the card (max abs error vs the stated
              tolerance), with CUDA-event times and the least time the card
              could take for the same work; B3 also at its latency floor
              (no valid row) and with P = 2 stacked problems, as the
              tracker's motion-model + fallback call gives it;
  4. fast     the single-image FAST entry (ops/fast.py fast_with_fallback,
              kernel B4) on 30 synthetic 640x480 frames, B4's launches
              counted during exactly this run, held against the CPU path;
  5. slice    the point-only FrameBuilder -> Tracker step (configs/TUM1.yaml,
              640x480) over 30 synthetic frames on the card: status per
              frame, ATE against ground truth, ms/frame, kernel launches
              counted during exactly this run (B3: two per tracked frame),
              and the first frames held against the port's plain CPU path;
  6. slice-lines  the same for the point+line step (configs/TUM3.yaml, lines
              on, device LSD, 640x480): also map lines and line inliers per
              frame, and B3 fed valid line rows on every tracked frame.
  7. system   the port's mapper-less System.track_rgbd on configs/TUM3.yaml
              at 640x480: 20 frames of SyntheticSequence(seed=0,
              motion_scale=6) three apart (~1.4 m of travel), 5 black
              frames (LOST), then the camera back at the start for 10
              frames (BoW + PnP relocalization onto the first keyframe,
              then tracking; nearer the start, the step's own
              reference-keyframe fallback recovers first):
              states, ATE over tracked frames, one trajectory row per
              tracked frame, one telemetry copy per frame, kernel launches
              counted during exactly this run (B1 and B2 once per frame, B3
              on the relocalization frame too), ms per frame, and the first
              frames held against the port's CPU path.
Then one JSON line with the kernels (launches: B1-B3 from system, the
public entry; B4 from fast), and as the last line
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
# the system phase: frames SYS_STRIDE apart at SYS_MOTION times the
# sequence's motion, a blackout, then the first frames again (on the CPU
# path at 640x480 the relocalizer recovers on the first of them)
SYS_BEFORE, SYS_BLACK, SYS_AFTER, SYS_STRIDE, SYS_MOTION = 20, 5, 10, 3, 6.0
SLEEP_CYCLES = 2_000_000  # ~1 ms of GPU clock ahead of each timed call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

# Tolerances, kernel vs plain twin on the card, and why:
#  B1: scores are sums of 16 terms and the blur a 7+7-tap stencil; the twin
#      sums in another order (the blur as cuBLAS float32 products), so values
#      agree to a few float32 ulps of their magnitude (scores < 4096). The
#      corner masks themselves must agree exactly (same differences).
#  B4: B1's scores without the blur: the same tolerance and reason.
#  B2: a copy: exact.
#  B3: the same arithmetic reduced in another order (block tree vs matrix
#      product) and solved by unpivoted vs pivoted LU: poses to 1e-4,
#      at most 2 inlier flips at the chi2 boundary.
TOL_B1 = 1e-2
TOL_B4 = 1e-2
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


def run_slice(name, settings, seq, frames, lines: bool):
    """FrameBuilder -> Tracker.step over `frames` on the card, checked and
    printed; -> the kernel launches counted during exactly this run."""
    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.pipeline.tracking import ST_OK, TEL_N_LN, TEL_STATUS, TEL_TRACKED, Tracker
    from plslam_tpu_torch.solvers import pose as pose_mod

    with Phase(name):
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
        b3 = pose_mod.pose_lm
        wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, b3)
        for w in wrappers:
            w.launches = 0
        b3.line_launches = b3.line_inliers = 0
        b3.count_lines = lines
        ms_frame, tel, poses, line_launches, line_inliers = [], [], [], [0], [0]
        for g, d, _ in frames:
            t0 = time.perf_counter()
            state, out = tracker.step(state, builder(g, d))
            torch.cuda.synchronize()
            ms_frame.append((time.perf_counter() - t0) * 1e3)
            tel.append(out.telemetry.cpu().numpy())
            poses.append(out.Tcw.cpu().numpy().astype(np.float64))
            line_launches.append(int(b3.line_launches))
            line_inliers.append(int(b3.line_inliers))
        launches = {w.__name__: w.launches for w in wrappers}
        b3.count_lines = False

        n = len(frames)
        status = [int(t[TEL_STATUS]) for t in tel]
        tracked = [bool(t[TEL_TRACKED]) for t in tel]
        log("status per frame: " + " ".join(str(s) for s in status))
        n_tracked = sum(tracked)
        require(all(np.isfinite(T).all() and T.shape == (4, 4) for T in poses), "non-finite pose")
        est = [(seq.timestamp(i), np.linalg.inv(T)) for i, T in enumerate(poses)]
        ate, n_pairs = ate_rmse(est, seq.gt_trajectory())
        log(f"tracked {n_tracked}/{n}; ATE RMSE {ate * 100:.4f} cm over {n_pairs} frames; "
            f"median {statistics.median(ms_frame):.3f} ms/frame (first {ms_frame[0]:.3f} ms)")
        log(f"launches during the run: {launches}")
        require(n_tracked == n and all(s == ST_OK for s in status), "a frame was not tracked")
        require(ate <= 0.02, f"ATE {ate:.4f} m above 2 cm")
        require(launches["fast_blur_stack"] == n and launches["gather_patches"] == n,
                "B1/B2 not launched once per frame")
        # every frame after the first: the stacked motion-model + fallback
        # solve and the joint refinement, one launch each
        require(launches["pose_lm"] == 2 * (n - 1), f"B3 launched {launches['pose_lm']} times, not 2 per tracked frame")
        if lines:
            fed = np.diff(line_launches)
            inl = np.diff(line_inliers)
            n_ln = [int(t[TEL_N_LN]) for t in tel]
            log("map lines per frame: " + " ".join(map(str, n_ln)))
            log("line inliers per frame: " + " ".join(map(str, inl)))
            log("B3 launches with valid line rows per frame: " + " ".join(map(str, fed)))
            require(n_ln[-1] > 0, "no map line at the end")
            require(all(f >= 1 for f, t in zip(fed[1:], tracked[1:]) if t),
                    "B3 not fed a valid line row on a tracked frame")

        # the first frames against the port's plain CPU path
        cb, ct = FrameBuilder(settings, device="cpu"), Tracker(settings, device="cpu")
        cs = ct.init_state()
        for i, (g, d, _) in enumerate(frames[:3]):
            cs, cout = ct.step(cs, cb(g, d))
            dt = float(np.abs(cout.Tcw.numpy() - poses[i]).max())
            same = int(cout.telemetry[TEL_STATUS]) == status[i]
            log(f"frame {i} vs CPU path: status equal {same}, |dTcw| {dt:.2e}")
            require(same and dt < 1e-3, "card and CPU paths disagree")
    return launches


def run_system(settings):
    """System.track_rgbd over a blackout and a return to the start, on the
    card; checked and printed. -> the kernel launches counted during
    exactly this run."""
    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.io.trajectory import load_trajectory_tum
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose as pose_mod
    from plslam_tpu_torch.system import System

    with Phase("system"):
        seq = SyntheticSequence(n_frames=SYS_STRIDE * SYS_BEFORE, seed=0, settings=settings,
                                motion_scale=SYS_MOTION)
        before = [SYS_STRIDE * i for i in range(SYS_BEFORE)]
        after = [SYS_STRIDE * i for i in range(SYS_AFTER)]
        inputs = [seq.frame(i) for i in before]
        g, d, t = inputs[-1]
        inputs += [(np.zeros_like(g), d, t + 0.03 * (j + 1)) for j in range(SYS_BLACK)]
        inputs += [(g, d, t + 2.0) for g, d, t in (seq.frame(i) for i in after)]
        gt_index = before + [None] * SYS_BLACK + after
        n = len(inputs)

        slam = System(settings, use_local_mapping=False, use_loop_closing=False)
        wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
        for w in wrappers:
            w.launches = 0
        rows, ms_frame, b3 = [], [], []
        for g, d, t in inputs:
            b3_0 = pose_mod.pose_lm.launches
            t0 = time.perf_counter()
            Tcw = slam.track_rgbd(g, d, t)
            torch.cuda.synchronize()
            ms_frame.append((time.perf_counter() - t0) * 1e3)
            b3.append(pose_mod.pose_lm.launches - b3_0)
            rows.append((Tcw, slam.get_tracking_state()))
        launches = {w.__name__: w.launches for w in wrappers}
        reads = slam.telemetry_reads
        traj = ROOT / ".torch_build" / "chip_smoke_trajectory.txt"
        traj.parent.mkdir(parents=True, exist_ok=True)
        slam.save_trajectory_tum(traj)
        saved = load_trajectory_tum(traj)
        slam.shutdown()

        states = [st for _, st in rows]
        log("state per call: " + " ".join(st[0] for st in states) + "  (O = OK, L = LOST)")
        log("B3 launches per call: " + " ".join(map(str, b3)))
        first_after = SYS_BEFORE + SYS_BLACK
        reloc = next((k for k in range(first_after, n) if rows[k][0] is None and states[k] == "OK"), None)
        tracked = [k for k in range(n) if rows[k][0] is not None]
        est = [(float(k), np.linalg.inv(rows[k][0])) for k in tracked]
        gt = [(float(k), seq.gt_pose_wc(gt_index[k])) for k in tracked]
        ate, n_pairs = ate_rmse(est, gt)
        ms_track = [ms_frame[k] for k in tracked]
        log(f"relocalized on call {reloc} (first real frame after the blackout: {first_after}); "
            f"tracked {len(tracked)}/{n}; ATE RMSE {ate * 100:.4f} cm over {n_pairs} tracked frames")
        log(f"median {statistics.median(ms_track):.3f} ms per tracked frame; relocalization call "
            f"{ms_frame[reloc] if reloc is not None else float('nan'):.3f} ms; blackout calls "
            f"{statistics.median(ms_frame[SYS_BEFORE:first_after]):.3f} ms median")
        log(f"launches during the run: {launches}; telemetry reads {reads} for {n} calls; "
            f"{len(saved)} trajectory rows")
        require(all(rows[k][0] is not None for k in range(SYS_BEFORE)), "a frame before the blackout was not tracked")
        require(states[SYS_BEFORE:first_after] == ["LOST"] * SYS_BLACK, "not LOST through the blackout")
        require(reloc is not None and reloc < first_after + 3, "not relocalized within 3 real frames")
        require(all(rows[k][0] is not None for k in range(reloc + 1, n)), "a frame after relocalization was lost")
        require(ate <= 0.02, f"ATE {ate:.4f} m above 2 cm")
        require(len(saved) == len(tracked), "not one trajectory row per tracked frame")
        require(launches["fast_blur_stack"] == n and launches["gather_patches"] == n,
                "B1/B2 not launched once per frame")
        require(b3[reloc] > 2, "B3 not launched by the relocalization")
        require(reads == n, f"{reads} telemetry reads for {n} frames")

        # the first frames against the port's CPU path
        cpu = System(settings, use_local_mapping=False, use_loop_closing=False, device="cpu")
        for k in range(3):
            T_cpu = cpu.track_rgbd(*inputs[k])
            dt = float(np.abs(T_cpu - rows[k][0]).max())
            same = cpu.get_tracking_state() == states[k]
            log(f"call {k} vs CPU path: state equal {same}, |dTcw| {dt:.2e}")
            require(same and dt < 1e-3, "card and CPU paths disagree")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    from plslam_tpu_torch import _build, load_settings
    from plslam_tpu_torch import constants as C
    from plslam_tpu_torch.io.synthetic import SyntheticSequence, patch_centres, pose_problem, pose_problem_pair
    from plslam_tpu_torch.ops import brief, fast, fast_cuda, patches, pyramid
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
        cached = " (cached build; its ptxas report as kept beside it)" if _build.last_build["cached"] else ""
        log(f"nvcc: {_build.last_build['seconds']:.2f} s -> {Path(_build.last_build['path']).name}{cached}")
        ptxas = [ln.strip() for ln in _build.last_build["log"].splitlines()
                 if any(k in ln for k in ("registers", "spill", "Compiling entry", "Function properties"))]
        for line in ptxas:
            log(f"  ptxas: {line}")
        # B3 must not spill: its per-row state and the 29 sums stay in registers
        spills = [b for a, b in zip(ptxas, ptxas[1:]) if "Function properties" in a and "pose_lm_kernel" in a]
        require(bool(spills), "no ptxas report for the pose kernel")
        require(all("0 bytes spill stores, 0 bytes spill loads" in b for b in spills),
                f"the pose kernel spills: {spills}")
        log(f"pose_lm: at most {pose_mod.smem_limit()} bytes of rows per problem in shared memory")

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

        # B4 on a real 640x480 frame and on an odd crop (ragged tiles at
        # both edges); the single-image entry on the card against the CPU
        err4, masks4 = 0.0, True
        for img in (gray, gray[100:197, 200:331].contiguous()):
            got4 = fast_cuda.fast_scores(img, ini, mn)
            ref4 = fast_cuda.fast_scores_plain(img, ini, mn)
            card = fast.fast_with_fallback(img, ini, mn, C.FAST_CELL, C.EDGE_THRESHOLD)
            cpu = fast.fast_with_fallback(img.cpu(), ini, mn, C.FAST_CELL, C.EDGE_THRESHOLD)
            torch.cuda.synchronize()
            e = max(float((a - b).abs().max()) for a, b in zip(got4, ref4))
            eq = all(bool(torch.equal(a > 0, b > 0)) for a, b in zip(got4, ref4))
            eq_entry = bool(torch.equal(card.cpu() > 0, cpu > 0))
            log(f"B4 fast_scores {tuple(img.shape)}: max_abs_err {e:.3e} (tol {TOL_B4}), corner masks equal {eq}, "
                f"fast_with_fallback card vs CPU masks equal {eq_entry} ({int((cpu > 0).sum())} corners)")
            err4, masks4 = max(err4, e), masks4 and eq and eq_entry
        require(err4 <= TOL_B4 and masks4, "B4 disagrees with its plain twin")
        ms4 = cuda_ms(torch, lambda: fast_cuda.fast_scores(gray, ini, mn))
        plain4 = cuda_ms(torch, lambda: fast_cuda.fast_scores_plain(gray, ini, mn))
        # one read of the image, two writes; per pixel 16 ring differences,
        # per threshold 16 x (2 sub, 2 max, 2 add, 2 compare), 4 selects
        b_ms4, b_by4 = bound_ms(3 * 4 * gray.numel(), 276 * gray.numel())
        log(f"B4 fast_scores: {ms4:.4f} ms, plain {plain4:.4f} ms, bound {b_ms4:.4f} ms ({b_by4}), "
            f"library call: none")
        kernels["fast_scores"] = dict(
            name="fast_scores", route="cuda", source="plslam_tpu_torch/csrc/fast_blur.cu",
            replaces="plslam_tpu/ops/fast_pallas.py:48", max_abs_err=err4, ms=ms4, plain_ms=plain4,
            bound_ms=b_ms4, bound_by=b_by4, library_ms=None,
        )

        # B2 at K = 1000 centres on the blurred stack
        blur_flat = got[2].reshape(L * H, W).contiguous()
        yx_t = torch.from_numpy(patch_centres(np.random.default_rng(0), shapes, H)).to(dev)
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
        # what one launch costs as timed here: B2 on a single window
        one2 = cuda_ms(torch, lambda: patches.gather_patches(blur_flat, yx_t[:1], D))
        # each window read once and written once (the bound kept from the first kernel) ...
        b_ms2, b_by2 = bound_ms(2 * got2.numel() * 4 + yx_t.numel() * 4, 0)
        # ... and the least: the patches written plus each stack pixel that
        # some window covers, read once (windows of one level overlap)
        ar = torch.arange(D, device=dev)
        touched = torch.zeros(L * H, W, dtype=torch.bool, device=dev)
        touched[(ys[:, None] + ar)[:, :, None], (xs[:, None] + ar)[:, None, :]] = True
        n_touched = int(touched.sum())
        b_ms2_lo, _ = bound_ms(got2.numel() * 4 + n_touched * 4 + yx_t.numel() * 4, 0)
        log(f"B2 gather_patches: max_abs_err {err2:.3e} (tol {TOL_B2}), {ms2:.4f} ms, plain {plain2:.4f} ms, "
            f"unfold-index {lib_ms2:.4f} ms, bound {b_ms2:.4f} ms ({b_by2}: windows read and written); "
            f"{n_touched} distinct stack pixels -> bound {b_ms2_lo:.4f} ms (patches written, distinct pixels read); "
            f"share of bound {b_ms2 / ms2:.0%} / {b_ms2_lo / ms2:.0%}; one window {one2:.4f} ms")
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
        # only the 14 block reductions and the per-warp solves remain
        empty = pose_mod.PointObs(*(T(a) for a in pb["pts"][:4]), torch.zeros_like(pts.valid))
        no_lines = pose_mod.LineObs(*(T(a) for a in pb["lines"][:4]), torch.zeros_like(lines.valid))
        floor3 = cuda_ms(torch, lambda: pose_mod.pose_lm(T0, empty, pb["K"], pb["bf"], no_lines))
        # P = 2 laid out as the tracker's stacked call gives them: the
        # motion-model and the ref-KF fallback problems, points only, one
        # launch; the start pose, obs, inverse sigma2 and stereo flags
        # expanded along the problem axis (stride 0, staged from one copy),
        # landmarks and valid flags per problem
        pr = pose_problem_pair(np.random.default_rng(1))
        pts2 = pose_mod.PointObs(T(pr["xw"]), T(pr["obs"]).expand(2, -1, -1), T(pr["isig"]).expand(2, -1),
                                 T(pr["stereo"]).expand(2, -1), T(pr["valid"]))
        pts1 = pose_mod.PointObs(*(f[0] for f in pts2))
        T02 = T0.expand(2, 4, 4)
        Tk2, pk2, _ = pose_mod.pose_lm(T02, pts2, pr["K"], pr["bf"])
        Tp2, pp2, _ = pose_mod.pose_optimization_plain(T02, pts2, pr["K"], pr["bf"])
        torch.cuda.synchronize()
        e2 = float((Tk2 - Tp2).abs().max())
        flips2 = [int((pk2[i] != pp2[i]).sum()) for i in range(2)]
        log(f"B3 pose_lm P = 2 (points only, tracker layout): |dT| {e2:.3e} (tol {TOL_B3_POSE}), "
            f"inlier flips {flips2} (tol {TOL_B3_FLIPS} each), inliers {[int(k.sum()) for k in pk2]}")
        require(bool(torch.isfinite(Tk2).all()) and e2 <= TOL_B3_POSE and max(flips2) <= TOL_B3_FLIPS,
                "B3 (P = 2) disagrees with its plain twin")
        err3 = max(err3, e2)
        ms3_p2 = cuda_ms(torch, lambda: pose_mod.pose_lm(T02, pts2, pr["K"], pr["bf"]))
        ms3_p1 = cuda_ms(torch, lambda: pose_mod.pose_lm(T0, pts1, pr["K"], pr["bf"]))
        log(f"B3 pose_lm: {ms3:.4f} ms (lines valid), {times3[False][0]:.4f} ms (no valid line), "
            f"{floor3:.4f} ms (no valid row: latency floor), {ms3_p2:.4f} ms (P = 2, points only) "
            f"against {ms3_p1:.4f} ms (P = 1, points only); plain {plain3:.4f} ms")
        # float32 operations, counted from pose_lm.cu's bodies. One build
        # (point_terms / line_terms over the active rows): a mono point row
        # 180 (point_residual 28, chi2 6, Huber 7, Jacobian 17, two add_row
        # 120, cost 2), a stereo one 250 (+3 for its third residual, +7 for
        # its Jacobian row, +60 for a third add_row), a line row 238 (two
        # line_endpoint 104, chi2 4, Huber 10, two add_row 120). Round r of
        # the (4, 2, 2, 2) schedule builds 1 + iters[r] times: round 0 over
        # the valid rows, later rounds over the re-classified ones, counted
        # here as the final inliers (the per-round sets stay on the card).
        # Each round's re-classification (fused into the next round's first
        # build in the kernel; the last one its own pass): 35 per valid mono
        # point, 38 per stereo one, 109 per valid line. The solve, counted
        # once though every warp repeats it: solve6 209 + exp_compose 215
        # per iteration, 10 iterations.
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

    with Phase("fast"):
        # the single-image FAST entry on every frame: B4 and the tail
        fast_cuda.fast_scores.launches = 0
        maps = [fast.fast_with_fallback(torch.from_numpy(g).to(dev), ini, mn, C.FAST_CELL, C.EDGE_THRESHOLD)
                for g, _, _ in frames]
        torch.cuda.synchronize()
        n4 = fast_cuda.fast_scores.launches
        n_corners = [int((m > 0).sum()) for m in maps]
        log(f"B4 launches during the run: {n4} for {N_FRAMES} frames; corners per frame "
            f"{min(n_corners)}..{max(n_corners)}")
        require(n4 == N_FRAMES, "B4 not launched once per frame")
        require(all(m.shape == (H, W) and bool(torch.isfinite(m).all()) for m in maps) and min(n_corners) > 100,
                "bad FAST score maps")
        cpu0 = fast.fast_with_fallback(torch.from_numpy(frames[0][0]), ini, mn, C.FAST_CELL, C.EDGE_THRESHOLD)
        require(torch.equal(maps[0].cpu() > 0, cpu0 > 0), "FAST entry: card and CPU maps disagree")
        kernels["fast_scores"]["launches"] = n4

    run_slice("slice", settings, seq, frames, lines=False)
    lines_settings = load_settings(ROOT / "configs" / "TUM3.yaml")
    require(lines_settings.use_lines and lines_settings.line_backend == "device", "TUM3 should run device lines")
    lseq = SyntheticSequence(n_frames=N_FRAMES, seed=0, settings=lines_settings)
    run_slice("slice-lines", lines_settings, lseq, [lseq.frame(i) for i in range(N_FRAMES)], lines=True)
    for name, n in run_system(lines_settings).items():
        kernels[name]["launches"] = n

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {BUDGET_S:.0f} s)")
    require(total <= BUDGET_S, "over the wall-clock budget")
    names = ["fast_blur_stack", "gather_patches", "pose_lm", "fast_scores"]  # B1-B4
    require(sorted(names) == sorted(kernels), "a kernel is missing from the run")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in order} for n in names]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
