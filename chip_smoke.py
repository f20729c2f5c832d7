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
              (no valid row), with P = 2 stacked problems, as the
              tracker's motion-model + fallback call gives it, and under
              torch.func.vmap with 4 sequences of such a pair: the custom
              op's vmap rule makes it one launch of 8 problems;
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
  8. mapping  System with the local mapper, 30 frames of
              SyntheticSequence(seed=0) at 640x480 and full capacities:
              configs/TUM1.yaml with every default (depth beyond 3 m cut,
              so the chains triangulate points) and configs/TUM3.yaml with
              loop closing off (map lines): every frame tracked, ATE, one
              keyframe chain per keyframe run under CUDA's sync debug mode
              "error", one telemetry read per call and one aux read per
              chain, landmarks triangulated and a window pose moved by
              local BA, B1-B3 launched; ms per call and per chain; one
              chain replayed under torch.profiler (launches, device-busy
              time, launches by stage) and held bit for bit to the run's
              own; the first triangulating chain held against the CPU path.
  9. low_texture  BASELINE.json config 3: System(settings) with every default
              capacity on SyntheticSequence(30 frames, 640x480, seed 5,
              low_texture=True) and its settings (lines on, device LSD,
              mapper and loop closing on), held to the reference test's four
              assertions (tests/test_lines.py:188-207): every frame tracked,
              more than 10 map lines, more than 5 observed more than twice,
              ATE < 2 cm; every chain under CUDA's sync debug mode "error";
              ms per call and per chain.
 10. host_lines  System(configs/TUM3.yaml with line_backend: "host") with every
              default on 30 frames of SyntheticSequence(seed=0), 640x480, at
              pipeline_depth=0 and 4: the host LSD (native/lsd.cpp, built
              by g++ into .torch_build/) on each frame, its endpoints
              uploaded with the images; every frame tracked, ATE <= 2 cm,
              map lines, the pipelined run's flags equal to the
              synchronous run's, B1-B3 launched, every dispatch and chain
              under CUDA's sync debug mode "error"; the first frames' line
              fields in the System against the port's CPU path (raw
              endpoints equal, geometry to 1e-3, LBD bits equal on >=
              99.5%); host LSD ms per frame, ms per call and per chain.
              Then dump_debug_images on the synchronous System: frame.png
              and map.png decode (io/png.py) to draw_frame / draw_map of
              its state.
 11. vocab    the port's vocabulary harvest (loopclosing/train_vocab.py) on
              the card at the reference's defaults (16 scenes x 8 frames,
              320x240, ORB with B1 and B2), then train_tree: the descriptor
              count equal to the reference's corpus (46,385, committed in
              tests/data/vocab_corpus_ref.npz; the shipped codebook is its
              tree), the descriptor bits equal on >= 99.5% (ORB's
              documented near-tie flips); the descriptors and words that
              differ from the reference's printed, and the first frame
              that differs held against the port's CPU path (keypoints
              equal, angles to 1e-3, bits on >= 99.5%).
 12. batched  BASELINE.json config 5: BatchedTracker + BatchedMapper
              (parallel/batch.py, torch.func.vmap) on 4 sequences (seeds 1,
              12, 23, 34; 640x480, 25 frames, max_pts 8192, max_kf 64, as
              examples/multi_sequence.py), frames built per sequence: every
              sequence tracked on every frame, each ATE <= 2 cm (trajectory
              rebuilt from the final keyframe poses, as the example writes
              it), B3 launched twice per batched tracked step (not 2 x 4), B1
              and B2 once per sequence per frame, the batched step and chain
              under sync debug "error" and vmap's per-sample fallback warning
              ("performance drop") an error; the first 5 frames of the 4
              sequences stepped batched without the mapper against each
              sequence stepped alone on the card (flags equal, poses to 1e-4
              m), and with the chains (printed); the batched chain replayed
              (bit for bit the run's own), a masked row bit for bit its
              input, the first chain's rows bit for bit the solo chain on
              the card, the last chain's rows against the solo chain
              printed beside the card's solo chain against the CPU path;
              one batched step and one solo step under torch.profiler
              (launches, device-busy); ms per batched step and chain,
              aggregate frames/s.
 13. pipelined  System(configs/TUM3.yaml, pipeline_depth=4) with every
              default at full capacities (mapper and loop closing on) on the
              mapping phase's 30 frames, in turns with pipeline_depth=0 (0,
              4, 4, 0): every chunk dispatch, single dispatch and keyframe
              chain under CUDA's sync debug mode "error"; the lag contract
              (the first 4 calls return None, call i finalizes frame i - 4),
              every frame tracked, ATE, the two pipelined trajectories byte
              for byte equal, one telemetry read per chunk (plus one per
              frame the save's drain dispatches singly), B1 and B2 launched 4
              times and B3 twice per tracked frame in each chunk; ms per call
              (median over 4-call group means, as bench.py), the calls
              without a chain and the whole run end to end, and one chunk
              under torch.profiler (launches, device-busy, idle share); the
              launches and device time of the step's device-side switches;
              pipeline_depth 1 and 2 on 12 frames. Then save_map, load_map in
              a fresh System on the card and on the CPU path (every field bit
              for bit equal), 5 frames in localization mode (the map
              unchanged), and the system phase's blackout fixture pipelined
              (OK after the flush).
 14. loop     System(settings) with every default, loop closing on, full
              capacities: (a) tests/test_loop_e2e.py's fixture,
              SyntheticSequence(190 frames, 320x240, seed 0, "loop", 10 fps,
              depth_noise 0.03) with loop closing on and off, held to the
              five assertions the reference passes on the CPU (a loop
              closed, all frames tracked in both runs, the no-loop ATE and
              gap above 8 cm, gap_on < 0.5 gap_off, ATE_on < 1.15 ATE_off);
              every chain under CUDA's sync debug mode "error". (The
              configs/TUM2.yaml run on the same circuit at 640x480 was cut
              for the run's budget when the mesh phase came.) The first
              accepted closure of the loop-on run is
              replayed from its pre-closure state on the card (bit for bit
              equal to the run's own), under torch.profiler (launches,
              device-busy), and on the CPU path (every index and flag
              equal); the same for the run's last global-BA slice (the one
              with the outlier sweep). Printed: ms per closure, per slice,
              per tracked call and per chain.
 15. mesh     config 5 sharded over a (seq, lm) device mesh (parallel/batch.py
              with DeviceMesh + DTensor, eval/dryrun_mesh.py spawned by
              dryrun_mesh.spawn): the batched phase's 4 sequences on a
              (1, 1) mesh of one process over NCCL (NCCL takes one rank
              per card; the (2, 2) mesh runs on four cards or on the
              CPU), 5 frames stepped and the mapper chain once on frame
              0's map, every step and the chain under sync debug "error":
              the steps bit for bit the batched phase's steps without the
              mapper, the chain bit for bit its first chain, every frame
              tracked, the map at rest on (Shard(0), Shard(1)) for pt_*
              and (Shard(0), Replicate()) for the rest, B1 and B2 once per
              local sequence per frame and B3 twice per tracked step on
              every rank, frame 1 under torch.profiler with each launch
              on the card; ms per sharded step and chain. Then the
              reference dryrun's shapes in the same rank (its four lines).
              Last: after it (a child process profiling the card) a
              profile in this process twice saw no device event (PERF.md).
Then one JSON line with the kernels (launches: B1-B3 from mesh, this
slice's path, summed over its ranks; B4 from fast; the system, batched,
pipelined and loop phases print their own), and as
the last line
{"ok": true, "device": {...}} -- printed only if every phase passed. Any
failure exits non-zero; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BUDGET_S = 900.0  # whole run, build included (the caller's limit is 1200 s; 475-580 s measured)
N_FRAMES = 30
N_TIMED = 20
# the system phase: frames SYS_STRIDE apart at SYS_MOTION times the
# sequence's motion, a blackout, then the first frames again (on the CPU
# path at 640x480 the relocalizer recovers on the first of them)
SYS_BEFORE, SYS_BLACK, SYS_AFTER, SYS_STRIDE, SYS_MOTION = 20, 5, 10, 3, 6.0
# the mapping phase
MAP_FRAMES = 30
MAP_DEPTH_RANGE = 3.0  # metres, TUM1 run only
PIPE_K = 4  # the pipelined phase's pipeline_depth, as bench.py runs the reference
# the loop phase: tests/test_loop_e2e.py's fixture
LOOP_FRAMES, LOOP_REVISIT = 190, 150
# the low_texture phase (BASELINE.json config 3): the reference test's scene
# (tests/test_lines.py:15) at full width
LT_FRAMES = 30
# the batched phase (BASELINE.json config 5): examples/multi_sequence.py's
# capacities, 4 sequences of its seed rule 11 b + 1
BATCH_SEEDS = (1, 12, 23, 34)
BATCH_FRAMES = 25
BATCH_CAPS = dict(max_pts=8192, max_kf=64)
BATCH_SOLO_FRAMES = 5  # frames of each sequence also run alone
BATCH_PROFILE_FRAME = 10
MESH_FRAMES = BATCH_SOLO_FRAMES  # the mesh phase's frames, held to the batched steps without the mapper
MESH_PROFILE_FRAME = 1  # its frame built and stepped under torch.profiler
# one rank on the one card, over NCCL (a (1, 1) mesh): NCCL takes one rank
# per card, and DTensor's functional collectives crash over gloo on CUDA
# tensors (torch 2.11), so a (2, 2) mesh runs on four cards or on the CPU
MESH_RANKS = 1
# the host_lines phase
HL_FRAMES = 30
HL_CPU_FRAMES = 3  # frames whose line fields are held against the CPU path
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
# A batched row against the same sequence run alone on the card: the
# step's ops reduce over a batch in other orders than over one sequence,
# B3 solves each problem in a block of its own either way; flags equal,
# poses to 1e-4 m
TOL_BATCH_POSE = 1e-4
# Descriptor bits on the card against the CPU path (ORB and LBD): the
# patches and gradients come from float32 sums in other orders, so a
# compare that sits on a near-tie may flip (tests/test_torch_orb.py holds
# the port to the reference at the same rule); undistorted keyline
# endpoints and 2-D lines to 1e-3 px
TOL_DESC_BITS = 0.995
TOL_LINE_GEOM = 1e-3
# A keyframe chain on the card against the CPU path from one pre-chain
# state: every index, flag, counter and descriptor equal; local BA's plain
# LM phase follows float32 rounding (cuBLAS and the CPU's BLAS sum the
# normal equations in other orders), and weakly constrained landmarks move
# with it (tests/test_torch_mapping.py measures the same against the
# reference): keyframe poses to 5e-3, point positions to a median of 1 mm
# and a 99th percentile of 1 cm. The chain uses no atomics on floats, so a
# replay of a chain on the card from its pre-chain state is held to the
# run's own chain bit for bit.
TOL_CHAIN_POSE = 5e-3
TOL_CHAIN_PT_MEDIAN = 1e-3
TOL_CHAIN_PT_P99 = 1e-2
# A closure on the card against the CPU path from one pre-closure state:
# every index and flag equal (the RANSAC hypotheses and every gate are
# discrete); keyframe poses to 1e-3 and point positions to a 99th percentile
# of 1 cm: OptimizeSim3's LM and the 20 Gauss-Newton steps of the essential
# graph (dense 1792 x 1792 solves) round in another order on each, and the
# landmarks follow the poses. A global-BA slice is LM over the whole map:
# the chain's tolerances. Replays on the card of a closure and a slice are
# held bit for bit (no float atomics in either).
TOL_CLOSE_POSE = 1e-3
TOL_CLOSE_PT_P99 = 1e-2
CLOSE_EXACT = ("kf_valid", "kf_lm_idx", "kf_ln_idx", "pt_valid", "pt_replaced", "pt_nobs", "n_kf", "n_pt", "n_ln")
CHAIN_EXACT = ("kf_valid", "kf_frame_id", "kf_seq", "kf_feat_valid", "kf_lm_idx", "kf_ln_idx", "kf_ln_valid",
               "pt_desc", "pt_valid", "pt_ref_kf", "pt_first_kf", "pt_first_seq", "pt_nobs", "pt_replaced",
               "ln_desc", "ln_valid", "ln_ref_kf", "ln_first_seq", "ln_nobs", "n_kf", "n_pt", "n_ln")


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
    from plslam_tpu_torch.pipeline.tracking import ST_OK, ST_UNINIT, TEL_N_LN, TEL_STATUS, TEL_TRACKED, Tracker
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
        known = False  # the status the host read (System knows it the same way)
        for g, d, _ in frames:
            t0 = time.perf_counter()
            state, out = tracker.step(state, builder(g, d), initialised=known)
            torch.cuda.synchronize()
            ms_frame.append((time.perf_counter() - t0) * 1e3)
            tel.append(out.telemetry.cpu().numpy())
            known = int(tel[-1][TEL_STATUS]) != ST_UNINIT
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


def _system_inputs(settings):
    """The system phase's fixture: SYS_BEFORE frames SYS_STRIDE apart, a
    blackout, then the first frames again -> (sequence, (gray, depth, t)
    per call, ground-truth frame index per call or None)."""
    from plslam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=SYS_STRIDE * SYS_BEFORE, seed=0, settings=settings, motion_scale=SYS_MOTION)
    before = [SYS_STRIDE * i for i in range(SYS_BEFORE)]
    after = [SYS_STRIDE * i for i in range(SYS_AFTER)]
    inputs = [seq.frame(i) for i in before]
    g, d, t = inputs[-1]
    inputs += [(np.zeros_like(g), d, t + 0.03 * (j + 1)) for j in range(SYS_BLACK)]
    inputs += [(g, d, t + 2.0) for g, d, t in (seq.frame(i) for i in after)]
    return seq, inputs, before + [None] * SYS_BLACK + after


def run_system(settings):
    """System.track_rgbd over a blackout and a return to the start, on the
    card; checked and printed. -> the kernel launches counted during
    exactly this run."""
    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.io.trajectory import load_trajectory_tum
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose as pose_mod
    from plslam_tpu_torch.system import System

    with Phase("system"):
        seq, inputs, gt_index = _system_inputs(settings)
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


def _to(ts, device):
    """A TrackState's tensors on `device` (copies)."""
    return type(ts)(*(_to(f, device) if isinstance(f, tuple) else f.to(device, copy=True) for f in ts))


def _triangulated(m, k):
    """(points, map lines) the keyframe chain of keyframe k created: points
    bound to a depthless feature of k (insertion takes depth), and map lines
    created with k and bound in another keyframe's row (insertion binds k's
    row only). numpy map."""
    lm = m.kf_lm_idx[k]
    lmc = np.clip(lm, 0, None)
    pts = int(np.sum((lm >= 0) & (m.kf_uv[k, :, 2] < 0) & m.pt_valid[lmc] & (m.pt_first_seq[lmc] == m.kf_seq[k])))
    rows = (m.kf_ln_idx >= 0) & m.kf_ln_valid & m.kf_valid[:, None]
    rows[k] = False
    seen = np.zeros_like(m.ln_valid)
    seen[m.kf_ln_idx[rows]] = True
    return pts, int(np.sum(m.ln_valid & (m.ln_first_seq == m.kf_seq[k]) & seen))


def _differing(a, b, prefix=""):
    """Names of the fields of two TrackStates that are not bit for bit
    equal (NaN equal to NaN)."""
    import torch

    out = []
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            out += _differing(x, y, f"{prefix}{name}.")
        elif not (torch.equal(x, y) or (x.is_floating_point() and x.shape == y.shape
                                        and bool(torch.all((x == y) | (x.isnan() & y.isnan()))))):
            out.append(prefix + name)
    return out


def _ranged(name, fn, args):
    """fn(*args) inside a profiler range named "stage:<name>"."""
    import torch

    with torch.profiler.record_function(f"stage:{name}"):
        return fn(*args)


def run_mapping(name, settings, depth_range=None, **kw):
    """System(settings, **kw) with the local mapper over MAP_FRAMES frames on
    the card, checked and printed; -> the kernel launches counted during
    exactly this run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.eval.profile_step import _busy_us
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose as pose_mod
    from plslam_tpu_torch.system import System

    numpy_map = lambda m: m._replace(**{f: getattr(m, f).cpu().numpy() for f in m._fields})  # noqa: E731
    with Phase(name):
        seq = SyntheticSequence(n_frames=MAP_FRAMES, seed=0, settings=settings)
        inputs = []
        for g, d, t in (seq.frame(i) for i in range(MAP_FRAMES)):
            if depth_range is not None:
                d = np.where(d > depth_range, 0.0, d).astype(np.float32)
            inputs.append((g, d, t))
        slam = System(settings, **kw)
        require(slam._mapper is not None and not slam.use_loop_closing, "not the mapper-on, loop-closing-off System")
        chains = []
        dispatch = slam._dispatch_kf_chain

        def watched(kf_id):
            """The chain as System runs it, with CUDA's sync debug mode set to
            "error" inside it; timed between two synchronisations."""
            pre, pre_bow = slam.state, slam._reloc.kf_bow.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                aux = dispatch(kf_id)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            chains.append(dict(kf_id=kf_id, ms=(time.perf_counter() - t0) * 1e3, pre=pre, pre_bow=pre_bow,
                               post=slam.state))
            return aux

        slam._dispatch_kf_chain = watched
        wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
        for w in wrappers:
            w.launches = 0
        rows, ms_call = [], []
        for g, d, t in inputs:
            t0 = time.perf_counter()
            Tcw = slam.track_rgbd(g, d, t)
            torch.cuda.synchronize()
            ms_call.append((time.perf_counter() - t0) * 1e3)
            rows.append((Tcw, slam.get_tracking_state(), slam.last_frame_was_kf))
        launches = {w.__name__: w.launches for w in wrappers}
        n = len(inputs)

        tracked = [k for k in range(n) if rows[k][0] is not None]
        ate, n_pairs = ate_rmse([(seq.timestamp(k), np.linalg.inv(rows[k][0])) for k in tracked], seq.gt_trajectory())
        n_kf_frames = sum(r[2] for r in rows)
        made, moved = [], []
        for c in chains:
            pre, post = numpy_map(c["pre"].m), numpy_map(c["post"].m)
            made.append(_triangulated(post, c["kf_id"]))
            base = _triangulated(pre, c["kf_id"])
            made[-1] = (made[-1][0] - base[0], made[-1][1])
            moved.append(float(np.abs(post.kf_pose - pre.kf_pose)[post.kf_valid & pre.kf_valid].max()))
            c["tri"] = made[-1]
        key = [k for k in range(n) if rows[k][2]]
        log("state per call: " + " ".join(r[1][0] for r in rows) + "  (O = OK, L = LOST); keyframes on " + str(key))
        log(f"tracked {len(tracked)}/{n}; ATE RMSE {ate * 100:.4f} cm over {n_pairs} frames; "
            f"{int(slam.state.m.n_kf)} keyframes, {int(slam.state.m.n_pt)} points, {int(slam.state.m.n_ln)} map lines")
        log("chains (keyframe: ms, points / map lines triangulated, largest window pose move): "
            + "; ".join(f"{c['kf_id']}: {c['ms']:.2f} ms, {c['tri'][0]} / {c['tri'][1]}, {mv:.2e}"
                        for c, mv in zip(chains, moved)))
        plain = [ms_call[k] for k in tracked if not rows[k][2]]
        log(f"median {statistics.median([ms_call[k] for k in tracked]):.3f} ms per tracked call "
            f"({statistics.median(plain):.3f} ms without a keyframe); median "
            f"{statistics.median([c['ms'] for c in chains]):.3f} ms per keyframe chain "
            f"(first {chains[0]['ms']:.3f} ms)")
        log(f"launches during the run: {launches}; telemetry reads {slam.telemetry_reads} for {n} calls; "
            f"aux reads {slam.aux_reads} for {len(chains)} chains")
        require(len(tracked) == n and all(r[1] == "OK" for r in rows), "a frame was not tracked")
        require(ate <= 0.02, f"ATE {ate:.4f} m above 2 cm")
        require(int(slam.state.m.n_kf) >= 2 and len(chains) == n_kf_frames >= 2, "not one chain per keyframe")
        require(slam.telemetry_reads == n and slam.aux_reads == len(chains), "not one read per call and per chain")
        require(sum(p + q for p, q in made) > 0, "the mapper triangulated nothing")
        require(max(moved) > 0.0, "local BA moved no window pose")
        require(launches["fast_blur_stack"] == n and launches["gather_patches"] == n and launches["pose_lm"] > 0,
                "B1/B2 not launched once per call, or B3 not at all")

        # one chain under the profiler: the run's last chain replayed from
        # its pre-chain state (the run's own state is not touched), each
        # mapper stage inside a profiler range of its own
        last = chains[-1]
        slam._reloc.kf_bow = last["pre_bow"].clone()
        mapper = slam._mapper
        stages = {"cull": mapper, "triangulate": mapper, "triangulate_lines": mapper, "fuse": mapper,
                  "fuse_lines": mapper, "targets": mapper, "fuse_subset": mapper, "refresh": mapper,
                  "refresh_lines": mapper, "kf_cull": mapper, "ensure_free_slot": mapper, "run": mapper._ba}
        for st, owner in stages.items():
            attr = "run" if owner is mapper._ba else f"_{st}_impl"
            fn = getattr(owner, attr)
            setattr(owner, attr, lambda *a, _fn=fn, _st=st: _ranged(_st, _fn, a))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            replay, _, _ = slam._kf_chain(last["pre"], last["kf_id"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        for st, owner in stages.items():
            delattr(owner, "run" if owner is mapper._ba else f"_{st}_impl")
        apart = _differing(replay, last["post"])
        log(f"the replayed chain against the run's own: fields not bit for bit equal {apart or 'none'}")
        require(not apart, "the card's chain does not repeat itself")
        # the stage ranges also appear on the device's timeline: not work
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("stage:")]
        require(bool(on_card), "the profiler recorded no device activity")
        copies = [e for e in on_card if e.name.startswith(("Memcpy", "Memset"))]
        kernels = [e for e in on_card if not e.name.startswith(("Memcpy", "Memset"))]
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in on_card]) / 1e3
        log(f"one chain (keyframe {last['kf_id']}) under the profiler: {len(kernels)} kernel launches, "
            f"{len(copies)} copies, {busy:.3f} ms device-busy in {wall:.3f} ms, idle {1.0 - busy / wall:.1%}")
        by_name = {}
        for e in kernels:
            t = by_name.setdefault(e.name[:60], [0, 0.0])
            t[0] += 1
            t[1] += (e.time_range.end - e.time_range.start) / 1e3
        log("  kernels with the most device time (launches, ms): " + "; ".join(
            f"{k} ({v[0]}, {v[1]:.3f})" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]))
        # launches by stage: the host's kernel-launch calls inside each range
        cpu_events = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
        launch_at = [e.time_range.start for e in cpu_events if "LaunchKernel" in e.name]
        per_stage = {}
        for e in cpu_events:
            if e.name.startswith("stage:"):
                n_in = sum(e.time_range.start <= t <= e.time_range.end for t in launch_at)
                per_stage[e.name[6:]] = per_stage.get(e.name[6:], 0) + n_in
        per_stage["rest of the chain"] = len(launch_at) - sum(per_stage.values())
        log("  kernel launches by stage (local BA is `run`): "
            + ", ".join(f"{k} {v}" for k, v in per_stage.items()))

        # the first chain that triangulates, on the CPU path from the same state
        first = next((c for c in chains if sum(c["tri"]) > 0), None)
        require(first is not None, "no chain triangulated")
        cpu = System(settings, device="cpu", **kw)
        cpu._reloc.kf_bow = first["pre_bow"].cpu()
        ts, _, _ = cpu._kf_chain(_to(first["pre"], "cpu"), first["kf_id"])
        got, want = numpy_map(ts.m), numpy_map(first["post"].m)

        def entries(f):  # entries that differ (rows of a descriptor table)
            d = np.asarray(getattr(got, f) != getattr(want, f))
            return int(d.reshape(d.shape[0], -1).any(1).sum()) if f.endswith("desc") else int(d.sum())

        differ = {f: entries(f) for f in CHAIN_EXACT if entries(f)}
        dpose = float(np.abs(got.kf_pose - want.kf_pose).max())
        dp = np.linalg.norm(got.pt_pos - want.pt_pos, axis=1)[want.pt_valid]
        log(f"chain of keyframe {first['kf_id']} vs CPU path: entries differing {differ or 'none'} (tol 0); "
            f"|dTcw| {dpose:.2e} (tol {TOL_CHAIN_POSE}); point positions median {np.median(dp):.2e} m, "
            f"99th percentile {np.percentile(dp, 99):.2e} m, max {dp.max():.2e} m")
        require(not differ and dpose <= TOL_CHAIN_POSE and np.median(dp) <= TOL_CHAIN_PT_MEDIAN
                and np.percentile(dp, 99) <= TOL_CHAIN_PT_P99, "card and CPU chains disagree")
        require(np.array_equal(ts.local_set.numpy(), first["post"].local_set.cpu().numpy()),
                "card and CPU working sets disagree")
    return launches


def _strict(torch, fn, *args):
    """fn(*args) under CUDA's sync debug mode "error": any host
    synchronisation inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _pipe_run(settings, inputs, depth, traj, profile_chunk=None, **kw):
    """System(settings, pipeline_depth=depth, **kw) over `inputs` on the
    card, every chunk, single dispatch and keyframe chain under CUDA's sync
    debug mode "error", each call timed without a synchronisation; the B1-B3
    launches of each chunk, which call finalized which frame, and chunk
    `profile_chunk` under torch.profiler. Saves the trajectory to `traj`.
    -> dict of results."""
    import torch

    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose as pose_mod
    from plslam_tpu_torch.system import System

    slam = System(settings, pipeline_depth=depth, **kw)
    wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
    out = dict(slam=slam, chunks=0, singles=0, chunk_launches=[], finalized=[], prof=None, call=None)
    chunk, single, chain, fin = (slam._dispatch_chunk, slam._dispatch_single, slam._dispatch_kf_chain,
                                 slam._finalize_one)

    def watched_chunk():
        before = [w.launches for w in wrappers]
        if out["chunks"] == profile_chunk:
            out["prof"] = _profiled(lambda: _strict(torch, chunk))[1:]
        else:
            _strict(torch, chunk)
        out["chunk_launches"].append([w.launches - b for w, b in zip(wrappers, before)])
        out["chunks"] += 1

    def watched_single(*a):
        out["singles"] += 1
        return _strict(torch, single, *a)

    def watched_finalize():
        ret = fin()
        out["finalized"].append((out["call"], slam._timestamps[-1]))
        return ret

    slam._dispatch_chunk, slam._dispatch_single, slam._finalize_one = watched_chunk, watched_single, watched_finalize
    out["chain_calls"] = []  # the call (None: the save's drain) that dispatched each chain

    def watched_chain(k):
        out["chain_calls"].append(out["call"])
        return _strict(torch, chain, k)

    slam._dispatch_kf_chain = watched_chain
    for w in wrappers:
        w.launches = 0
    out["ms"], out["rets"] = [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for i, (g, d, t) in enumerate(inputs):
        out["call"] = i
        t0 = time.perf_counter()
        out["rets"].append(slam.track_rgbd(g, d, t))
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    out["call"] = None
    slam.save_trajectory_tum(traj)  # finalizes the frames still in flight
    torch.cuda.synchronize()
    out["total_ms"] = (time.perf_counter() - t_all) * 1e3
    out["launches"] = {w.__name__: w.launches for w in wrappers}
    return out


def _group_median(ms, k):
    """bench.py's steady-state per-call time: the median over the means of
    consecutive k-call groups (a pipelined call's time is bimodal)."""
    n = len(ms) // k
    return float(np.median(np.asarray(ms[: n * k]).reshape(n, k).mean(1)))


def run_pipelined(settings):
    """System(settings, pipeline_depth=PIPE_K) with every default at full
    capacities on the card (see the module docstring); -> the B1-B3
    launches of the first pipelined run."""
    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.io.trajectory import load_trajectory_tum
    from plslam_tpu_torch.system import System

    K = PIPE_K
    with Phase("pipelined"):
        # the mapping phase's 30 frames, and the next 5 for localization mode
        seq = SyntheticSequence(n_frames=MAP_FRAMES + 5, seed=0, settings=settings)
        inputs = [seq.frame(i) for i in range(MAP_FRAMES)]
        n = len(inputs)
        work = ROOT / ".torch_build"
        work.mkdir(parents=True, exist_ok=True)
        # in turns: pipeline_depth=0, K, K, 0 (the second K run profiles one chunk)
        sync = _pipe_run(settings, inputs, 0, work / "chip_smoke_pipe_sync.txt")
        runs = [_pipe_run(settings, inputs, K, work / f"chip_smoke_pipe_{j}.txt", profile_chunk=3 if j else None)
                for j in range(2)]
        sync2 = _pipe_run(settings, inputs, 0, work / "chip_smoke_pipe_sync2.txt")
        one = runs[0]
        slam = one["slam"]
        require(sync["slam"].use_loop_closing and slam._mapper is not None and slam.tracker.max_kf == 256,
                "not the System with every default at full capacities")
        # the lag contract: the first K calls return None, call i finalizes
        # exactly frame i - K, the save finalizes the last K
        during = [(c, t) for c, t in one["finalized"] if c is not None]
        lag_ok = (all(r is None for r in one["rets"][:K]) and all(r is not None for r in one["rets"][K:])
                  and [c for c, _ in during] == list(range(K, n))
                  and all(t == seq.timestamp(c - K) for c, t in during) and len(one["finalized"]) == n)
        est = load_trajectory_tum(work / "chip_smoke_pipe_0.txt")
        ate, n_pairs = ate_rmse(est, seq.gt_trajectory())
        same = (work / "chip_smoke_pipe_1.txt").read_bytes() == (work / "chip_smoke_pipe_0.txt").read_bytes()
        same0 = (work / "chip_smoke_pipe_sync2.txt").read_bytes() == (work / "chip_smoke_pipe_sync.txt").read_bytes()
        per_chunk = one["chunk_launches"]
        log(f"pipeline_depth={K}: tracked {sum(slam.tracked_flags)}/{n}; ATE RMSE {ate * 100:.4f} cm over {n_pairs} "
            f"frames; lag contract exact {lag_ok}; second run's trajectory byte-equal {same}; "
            f"{one['chunks']} chunks + {one['singles']} frames dispatched singly (the save's drain), "
            f"telemetry reads {slam.telemetry_reads} ({slam.telemetry_reads / n:.4f} per call; "
            f"{sync['slam'].telemetry_reads / n:.4f} at pipeline_depth=0); aux reads {slam.aux_reads} for "
            f"{slam._loop._kf_counter} chains; the two pipeline_depth=0 runs byte-equal {same0}")
        log("B1 / B2 / B3 launches per chunk: " + " ".join("/".join(map(str, c)) for c in per_chunk))
        log(f"launches during the first pipelined run: {one['launches']}")
        for name, r in (("pipeline_depth=0", sync), (f"pipeline_depth={K}", one),
                        (f"pipeline_depth={K} (profiles a chunk)", runs[1]), ("pipeline_depth=0", sync2)):
            plain = [m for i, m in enumerate(r["ms"]) if i not in r["chain_calls"]]
            log(f"{name}: ms per track_rgbd call, median over {K}-call group means {_group_median(r['ms'], K):.3f}; "
                f"median of the calls that dispatch no chain {statistics.median(plain):.3f}; the {n} calls and "
                f"the save's drain end to end {r['total_ms']:.1f} ms; {len(r['chain_calls'])} chains, dispatched "
                f"in calls {r['chain_calls']}")
        log(f"ms per call: pipeline_depth={K} " + " ".join(f"{m:.1f}" for m in one["ms"]))
        log("ms per call: pipeline_depth=0 " + " ".join(f"{m:.1f}" for m in sync["ms"]))
        wall, launches, copies, busy, top = runs[1]["prof"]
        log(f"one chunk ({K} frames, the second run's 4th) under the profiler: {launches} kernel launches "
            f"({launches / K:.0f} per frame), {copies} copies, {busy:.3f} ms device-busy in {wall:.3f} ms "
            f"(dispatch to its last kernel), idle {1.0 - busy / wall:.1%}")
        log(f"  chunk kernels with the most device time (launches, ms): {top}")
        require(lag_ok, "the lag contract does not hold")
        require(slam.tracked_flags == [True] * n, "a frame was not tracked")
        require(ate <= 0.02, f"ATE {ate:.4f} m above 2 cm")
        require(same, "two pipelined runs wrote different trajectories")
        require(one["chunks"] == n // K and one["singles"] == n % K
                and slam.telemetry_reads == one["chunks"] + one["singles"], "not one telemetry read per chunk")
        require(sync["slam"].telemetry_reads == n, "not one telemetry read per call at pipeline_depth=0")
        require(all(c[0] == K and c[1] == K for c in per_chunk) and per_chunk[0][2] == 2 * (K - 1)
                and all(c[2] == 2 * K for c in per_chunk[1:]),
                "B1/B2 not launched K times per chunk, or B3 not twice per tracked frame")
        require(slam.aux_reads == slam._loop._kf_counter >= 2, "not one aux read per chain")

        # what deciding the step's switches on the device costs, at full
        # capacities on the run's state: the init branch (run beside the
        # track branch while the status is unknown) and the working-set scan
        # (every frame of a mapper-less System)
        tr, st = slam.tracker, slam.state
        frame = slam.builder(*inputs[-1][:2])
        for what, fn in (("init branch", lambda: tr._do_init(st, frame)),
                         ("working-set scan", lambda: tr._compute_local_set(st.m, st.ref_kf))):
            n_launch = _profiled(fn, attempts=3)[2]
            log(f"{what}: {n_launch} kernel launches, {cuda_ms(torch, fn):.4f} ms on the card")

        # the other depths on the first 12 frames: the same contract
        for k in (1, 2):
            r = _pipe_run(settings, inputs[:12], k, work / f"chip_smoke_pipe_k{k}.txt")
            ok = ([c for c, _ in r["finalized"] if c is not None] == list(range(k, 12))
                  and r["slam"].tracked_flags == [True] * 12
                  and r["slam"].telemetry_reads == r["chunks"] + r["singles"] == 12 // k)
            log(f"pipeline_depth={k}, 12 frames: lag contract, 12/12 tracked and one read per chunk {ok}")
            require(ok, f"pipeline_depth={k} breaks the contract")

        # snapshots: the run's map saved and loaded in a fresh System on the
        # card (and on the CPU path), then tracked in localization mode
        path = work / "chip_smoke_map.npz"
        slam.save_map(path)
        fresh = System(settings, pipeline_depth=K)
        fresh.load_map(path)
        apart = _differing(fresh.state, slam.state)
        bow_eq = bool(torch.equal(fresh._reloc.kf_bow, slam._reloc.kf_bow))
        cpu = System(settings, device="cpu")
        cpu.load_map(path)
        apart_cpu = _differing(cpu.state, _to(slam.state, "cpu"))
        fresh.activate_localization_mode()
        m0 = _to(fresh.state.m, fresh.device)
        for g, d, t in (seq.frame(i) for i in range(MAP_FRAMES, MAP_FRAMES + 5)):
            fresh.track_rgbd(g, d, t)
        fresh._flush_pending()
        moved = _differing(fresh.state.m, m0)
        log(f"snapshot ({path.stat().st_size} bytes): loaded on the card, fields not bit for bit equal "
            f"{apart or 'none'}, BoW rows equal {bow_eq}, keyframe timestamps equal "
            f"{fresh._kf_timestamps == slam._kf_timestamps}; loaded on the CPU path, fields not equal "
            f"{apart_cpu or 'none'}; 5 localization-mode frames: tracked {sum(fresh.tracked_flags)}/5, "
            f"map fields changed {moved or 'none'}")
        require(not apart and bow_eq and fresh._kf_timestamps == slam._kf_timestamps, "the snapshot does not load back")
        require(not apart_cpu, "the snapshot does not load on the CPU path")
        require(fresh.tracked_flags == [True] * 5 and not moved, "localization mode changed the map")

        # the system phase's blackout fixture, pipelined (mapper-less)
        _, binputs, _ = _system_inputs(settings)
        black = _pipe_run(settings, binputs, K, work / "chip_smoke_pipe_black.txt",
                          use_local_mapping=False, use_loop_closing=False)
        bs = black["slam"]
        log(f"blackout fixture at pipeline_depth={K}: {len(binputs)} calls, tracked {sum(bs.tracked_flags)}; "
            f"state after the flush {bs.get_tracking_state()}; telemetry reads {bs.telemetry_reads} "
            f"({black['chunks']} chunks + {black['singles']} singly)")
        require(bs.get_tracking_state() == "OK", "not OK after the blackout's flush")
        require(all(bs.tracked_flags[:SYS_BEFORE]) and bs.telemetry_reads == black["chunks"] + black["singles"],
                "blackout fixture: a frame before the blackout lost, or not one read per dispatch")
        require(all(v > 0 for v in one["launches"].values()), "a kernel of the pipelined path was not launched")
    return one["launches"]


def _gap(est, seq, revisit):
    """|t| of the estimated pose of frame `revisit` relative to frame 0 (the
    ground truth there is the start pose: the loop gap)."""
    by_t = {round(t, 4): T for t, T in est}
    e0, ew = by_t.get(round(seq.timestamp(0), 4)), by_t.get(round(seq.timestamp(revisit), 4))
    return float(np.linalg.norm((np.linalg.inv(e0) @ ew)[:3, 3])) if e0 is not None and ew is not None else np.nan


def _loop_run(name, settings, seq, frames, revisit, use_loop):
    """System(settings, use_loop_closing=use_loop) over `frames` (those of
    `seq`, rendered once for both runs) on the card,
    each chain under CUDA's sync debug mode "error"; with loop closing the
    first accepted closure and the last global-BA slice of its queue are
    recorded with their inputs. -> dict of results."""
    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.io.trajectory import load_trajectory_tum
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose as pose_mod
    from plslam_tpu_torch.system import System

    slam = System(settings, use_loop_closing=use_loop)
    loop = slam._loop
    out = dict(chain_ms=[], call_ms=[], slice_ms=[], closure=None, slice=None, closures_ms=[], gate_fired=0)
    dispatch = slam._dispatch_kf_chain

    def watched_chain(kf_id):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            aux = dispatch(kf_id)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out["chain_ms"].append((time.perf_counter() - t0) * 1e3)
        out["gate_fired"] += int(float(aux[0]) > 0)  # read after the timing, outside the chain
        return aux

    slam._dispatch_kf_chain = watched_chain
    if loop is not None:
        close, pump = loop.close_loop, loop.pump_gba
        host = ("_kf_counter", "last_loop_kfn", "_loop_edges", "n_loops_closed", "gba_queue", "_gba_k")

        def watched_close(state, k, cand):
            pre = {f: getattr(loop, f) for f in host}
            pre["_loop_edges"], pre["gba_queue"] = list(pre["_loop_edges"]), list(pre["gba_queue"])
            post, closed = close(state, k, cand)
            if closed:
                out["closures_ms"].append(loop.last_closure_ms)
                if out["closure"] is None:
                    out["closure"] = dict(state=state, k=k, cand=cand, host=pre, post=post,
                                          supporters=loop.last_supporters, frame=len(slam._timestamps))
            return post, closed

        def watched_pump(state):
            sl = loop.gba_queue[0] if loop.gba_queue else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            post = pump(state)
            torch.cuda.synchronize()
            out["slice_ms"].append((time.perf_counter() - t0) * 1e3)
            if sl is not None and sl[2] and out["slice"] is None:  # the queue's last slice: the outlier sweep
                out["slice"] = dict(state=state, post=post, slice=sl, k=loop._gba_k)
            return post

        loop.close_loop, loop.pump_gba = watched_close, watched_pump
    wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
    for w in wrappers:
        w.launches = 0
    tracked = []
    for g, d, t in frames:
        t0 = time.perf_counter()
        Tcw = slam.track_rgbd(g, d, t)
        torch.cuda.synchronize()
        out["call_ms"].append((time.perf_counter() - t0) * 1e3)
        tracked.append(Tcw is not None)
    out["launches"] = {w.__name__: w.launches for w in wrappers}
    out["queue_left"] = len(loop.gba_queue) if loop is not None else 0
    traj = ROOT / ".torch_build" / f"chip_smoke_{name.replace(' ', '_')}_{int(use_loop)}.txt"
    traj.parent.mkdir(parents=True, exist_ok=True)
    slam.save_trajectory_tum(traj)
    slam.shutdown()
    est = load_trajectory_tum(traj)
    out["ate"], _ = ate_rmse(est, seq.gt_trajectory())
    out["gap"] = _gap(est, seq, revisit)
    out["n_tracked"], out["n"] = sum(tracked), seq.n_frames
    out["loops"] = slam.n_loops_closed
    out["slam"] = slam
    log(f"{name}, loop closing {'on' if use_loop else 'off'}: tracked {out['n_tracked']}/{out['n']}, ATE RMSE "
        f"{out['ate'] * 100:.4f} cm, gap {out['gap'] * 100:.4f} cm, loops closed {out['loops']}, "
        f"{len(out['chain_ms'])} chains, the loop gate fired on {out['gate_fired']}; "
        f"median {statistics.median(out['call_ms']):.3f} ms per call, "
        f"{statistics.median(out['chain_ms']):.3f} ms per chain; launches {out['launches']}")
    return out


def _profiled(fn, attempts=1):
    """fn() under torch.profiler -> (result, wall ms, kernel launches,
    copies, device-busy ms). A profile in which the profiler delivered no
    device event is taken again, up to `attempts` in all: that happens now
    and then to a profile of a dozen launches after the process's earlier
    profiles (PERF.md §7). Pass attempts > 1 only for an fn without side
    effects."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_tpu_torch.eval.profile_step import _busy_us

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_card:
            break
        log(f"profile {attempt} of {attempts}: the profiler delivered no device event")
    require(bool(on_card), "the profiler recorded no device activity")
    copies = [e for e in on_card if e.name.startswith(("Memcpy", "Memset"))]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in on_card]) / 1e3
    by_name = {}
    for e in on_card:
        if e not in copies:
            v = by_name.setdefault(e.name[:60], [0, 0.0])
            v[0] += 1
            v[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = "; ".join(f"{k} ({v[0]}, {v[1]:.3f})" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5])
    return res, wall, len(on_card) - len(copies), len(copies), busy, top


def _closure_checks(name, settings, run):
    """The run's first accepted closure and its last global-BA slice:
    replayed on the card (bit for bit), under the profiler, and on the CPU
    path from the same inputs."""
    import torch

    from plslam_tpu_torch.pipeline.loopclosing import LoopCloser
    from plslam_tpu_torch.pipeline.tracking import Tracker
    from plslam_tpu_torch.solvers.local_ba import LocalBA

    numpy_map = lambda m: m._replace(**{f: getattr(m, f).cpu().numpy() for f in m._fields})  # noqa: E731
    loop = run["slam"]._loop
    c = run["closure"]

    def close_from(lc, state):
        for f, v in c["host"].items():
            setattr(lc, f, list(v) if isinstance(v, list) else v)
        return lc.close_loop(state, c["k"], c["cand"])

    (replay, closed), wall, launches, copies, busy, top = _profiled(lambda: close_from(loop, c["state"]))
    apart = _differing(replay, c["post"])
    log(f"{name}: closure of keyframe {c['k']} onto {c['cand']} (frame {c['frame']}, {c['supporters']} supporters), "
        f"replayed: fields not bit for bit equal {apart or 'none'}; under the profiler {launches} kernel launches, "
        f"{copies} copies, {busy:.3f} ms device-busy in {wall:.3f} ms, idle {1.0 - busy / wall:.1%}")
    log(f"  closure kernels with the most device time (launches, ms): {top}")
    require(closed and not apart and loop.last_supporters == c["supporters"],
            "the card's closure does not repeat itself")

    cpu_tr = Tracker(settings, device="cpu", max_kf=loop.tracker.max_kf, max_pts=loop.tracker.max_pts)
    cpu_loop = LoopCloser(cpu_tr)
    t0 = time.perf_counter()
    cts, cclosed = close_from(cpu_loop, _to(c["state"], "cpu"))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got, want = numpy_map(cts.m), numpy_map(c["post"].m)
    differ = {f: int(np.sum(getattr(got, f) != getattr(want, f))) for f in CLOSE_EXACT
              if not np.array_equal(getattr(got, f), getattr(want, f))}
    dpose = float(np.abs(got.kf_pose - want.kf_pose).max())
    dp = np.linalg.norm(got.pt_pos - want.pt_pos, axis=1)[want.pt_valid]
    log(f"{name}: the closure on the CPU path ({cpu_ms:.0f} ms): closed {cclosed}, supporters "
        f"{cpu_loop.last_supporters}, entries differing {differ or 'none'} (tol 0); |dTcw| {dpose:.2e} "
        f"(tol {TOL_CLOSE_POSE}); points 99th percentile {np.percentile(dp, 99):.2e} m (tol {TOL_CLOSE_PT_P99})")
    require(cclosed and not differ and cpu_loop.last_supporters == c["supporters"]
            and cpu_loop.n_loops_closed == c["host"]["n_loops_closed"] + 1 and dpose <= TOL_CLOSE_POSE
            and np.percentile(dp, 99) <= TOL_CLOSE_PT_P99, "card and CPU closures disagree")

    sl = run["slice"]
    require(sl is not None, "no global-BA slice with the outlier sweep ran")
    runner = loop._gba.slice_runner(*sl["slice"])
    m_rep, wall, launches, copies, busy, top = _profiled(lambda: runner(sl["state"].m, sl["k"]))
    apart = _differing(m_rep, sl["post"].m)
    log(f"{name}: global-BA slice {sl['slice']} replayed: fields not bit for bit equal {apart or 'none'}; under "
        f"the profiler {launches} kernel launches, {copies} copies, {busy:.3f} ms device-busy in {wall:.3f} ms, "
        f"idle {1.0 - busy / wall:.1%}")
    log(f"  slice kernels with the most device time (launches, ms): {top}")
    require(not apart, "the card's global-BA slice does not repeat itself")
    t0 = time.perf_counter()
    cm = LocalBA(cpu_tr, global_mode=True).slice_runner(*sl["slice"])(_to(sl["state"], "cpu").m, sl["k"])
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got, want = numpy_map(cm), numpy_map(sl["post"].m)
    differ = {f: int(np.sum(getattr(got, f) != getattr(want, f))) for f in CLOSE_EXACT
              if not np.array_equal(getattr(got, f), getattr(want, f))}
    dpose = float(np.abs(got.kf_pose - want.kf_pose).max())
    dp = np.linalg.norm(got.pt_pos - want.pt_pos, axis=1)[want.pt_valid]
    log(f"{name}: the slice on the CPU path ({cpu_ms:.0f} ms): entries differing {differ or 'none'} (tol 0); "
        f"|dTcw| {dpose:.2e} (tol {TOL_CHAIN_POSE}); points median {np.median(dp):.2e} m, 99th percentile "
        f"{np.percentile(dp, 99):.2e} m (tol {TOL_CHAIN_PT_MEDIAN}, {TOL_CHAIN_PT_P99})")
    require(not differ and dpose <= TOL_CHAIN_POSE and np.median(dp) <= TOL_CHAIN_PT_MEDIAN
            and np.percentile(dp, 99) <= TOL_CHAIN_PT_P99, "card and CPU global-BA slices disagree")


def run_low_texture():
    """BASELINE.json config 3: System with every default on the low-texture scene
    (see the module docstring); -> ms per call and per chain."""
    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.system import System

    with Phase("low_texture"):
        seq = SyntheticSequence(n_frames=LT_FRAMES, height=480, width=640, seed=5, low_texture=True)
        settings = seq.settings
        require(settings.use_lines and settings.line_backend == "device", "the scene's settings should run device lines")
        slam = System(settings)
        require(slam._mapper is not None, "System runs without its local mapper")
        chains = []
        dispatch = slam._dispatch_kf_chain

        def watched(kf_id):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = _strict(torch, dispatch, kf_id)
            torch.cuda.synchronize()
            chains.append((time.perf_counter() - t0) * 1e3)
            return aux

        slam._dispatch_kf_chain = watched
        ms_call, rows = [], []
        for i in range(LT_FRAMES):
            g, d, t = seq.frame(i)
            t0 = time.perf_counter()
            Tcw = slam.track_rgbd(g, d, t)
            torch.cuda.synchronize()
            ms_call.append((time.perf_counter() - t0) * 1e3)
            rows.append((Tcw, slam.last_frame_was_kf))
        tracked = [k for k in range(LT_FRAMES) if rows[k][0] is not None]
        m = slam.state.m
        n_lines = int(m.ln_valid.sum())
        n_reobs = int((m.ln_nobs[m.ln_valid] > 2).sum())
        n_reobs_all = int((m.ln_nobs > 2).sum())
        with tempfile.TemporaryDirectory() as tmp:
            slam.save_trajectory_tum(Path(tmp) / "traj.txt")
            from plslam_tpu_torch.io.trajectory import load_trajectory_tum

            ate, n_pairs = ate_rmse(load_trajectory_tum(Path(tmp) / "traj.txt"), seq.gt_trajectory())
        plain = [ms_call[k] for k in tracked if not rows[k][1]]
        log(f"tracked {len(tracked)}/{LT_FRAMES}; {n_lines} map lines, {n_reobs_all} observed more than twice "
            f"({n_reobs} of them valid); {int(m.n_kf)} keyframes, {int(m.n_pt)} points; ATE RMSE {ate * 100:.4f} cm "
            f"over {n_pairs} frames")
        log(f"median {statistics.median(ms_call):.3f} ms per call ({statistics.median(plain):.3f} ms without a "
            f"keyframe); {len(chains)} chains, median {statistics.median(chains):.3f} ms per chain (first "
            f"{chains[0]:.3f} ms); every chain under sync debug \"error\"")
        # the reference's config-3 assertions (tests/test_lines.py:188-207)
        require(len(tracked) == LT_FRAMES, "a frame was not tracked")
        require(n_lines > 10, f"{n_lines} map lines, not more than 10")
        require(n_reobs_all > 5, f"{n_reobs_all} lines observed more than twice, not more than 5")
        require(ate < 0.02, f"ATE {ate:.4f} m not below 2 cm")
    return dict(ms_call=statistics.median(ms_call), ms_chain=statistics.median(chains))


def _bits_equal(a, b):
    return float((np.unpackbits(a, -1) == np.unpackbits(b, -1)).mean())


def _host_lines_run(settings, frames, depth):
    """System(settings, pipeline_depth=depth) with every default over
    frames on the card, every dispatch and chain under sync debug "error"
    -> dict: the System, its first frames' FrameData, ms per call, host
    LSD ms per call, ms per chain, the B1-B3 launches."""
    import torch

    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose as pose_mod
    from plslam_tpu_torch.system import System

    slam = System(settings, pipeline_depth=depth)
    require(slam.builder.host_lines and slam._mapper is not None and slam._loop is not None,
            "System should run host lines with its mapper and loop closer")
    wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
    out = dict(slam=slam, frames=[], lsd_ms=[], chain_ms=[], ms=[])
    single, chunk, chain, step, detect = (slam._dispatch_single, slam._dispatch_chunk, slam._dispatch_kf_chain,
                                          slam._step, slam.builder.detect_lines)

    def watched_step(*a):
        frame, tel = step(*a)
        if len(out["frames"]) < HL_CPU_FRAMES:
            out["frames"].append(frame)
        return frame, tel

    def watched_detect(gray):
        t0 = time.perf_counter()
        res = detect(gray)
        out["lsd_ms"].append((time.perf_counter() - t0) * 1e3)
        return res

    def watched_chain(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = _strict(torch, chain, k)
        torch.cuda.synchronize()
        out["chain_ms"].append((time.perf_counter() - t0) * 1e3)
        return aux

    slam._step, slam.builder.detect_lines, slam._dispatch_kf_chain = watched_step, watched_detect, watched_chain
    slam._dispatch_single = lambda *a: _strict(torch, single, *a)
    slam._dispatch_chunk = lambda: _strict(torch, chunk)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    for g, d, t in frames:
        t0 = time.perf_counter()
        slam.track_rgbd(g, d, t)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    slam._flush_pending()
    torch.cuda.synchronize()
    out["launches"] = {w.__name__: w.launches for w in wrappers}
    return out


def run_host_lines():
    """System with line_backend "host" and every default (see the module
    docstring)."""
    import dataclasses

    import torch

    from plslam_tpu_torch import load_settings
    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.io import viewer
    from plslam_tpu_torch.io.png import read_png
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.io.trajectory import load_trajectory_tum
    from plslam_tpu_torch.system import System

    with Phase("host_lines"):
        settings = dataclasses.replace(load_settings(ROOT / "configs" / "TUM3.yaml"), line_backend="host")
        seq = SyntheticSequence(n_frames=HL_FRAMES, seed=0, settings=settings)
        frames = [seq.frame(i) for i in range(HL_FRAMES)]
        # warm-up on a throwaway System: the process-wide constant tables
        # are uploaded at a first use, which synchronises
        warm = System(settings)
        for g, d, t in frames[:2]:
            warm.track_rgbd(g, d, t)
        warm._flush_pending()
        del warm
        runs = {depth: _host_lines_run(settings, frames, depth) for depth in (0, PIPE_K)}
        for depth, r in runs.items():
            slam = r["slam"]
            flags = slam.tracked_flags
            with tempfile.TemporaryDirectory() as tmp:
                slam.save_trajectory_tum(Path(tmp) / "traj.txt")
                ate, n_pairs = ate_rmse(load_trajectory_tum(Path(tmp) / "traj.txt"), seq.gt_trajectory())
            n_ln = int(slam.state.m.ln_valid.sum())
            r.update(flags=flags, ate=ate, n_kf=int(slam.state.m.n_kf))
            log(f"pipeline_depth={depth}: tracked {sum(flags)}/{HL_FRAMES}; ATE RMSE {ate * 100:.4f} cm over "
                f"{n_pairs} frames; {n_ln} map lines, {r['n_kf']} keyframes; host LSD median "
                f"{statistics.median(r['lsd_ms']):.3f} ms per frame (max {max(r['lsd_ms']):.3f}); median "
                f"{statistics.median(r['ms']):.3f} ms per call; {len(r['chain_ms'])} chains, median "
                f"{statistics.median(r['chain_ms']):.3f} ms per chain; launches {r['launches']}; every "
                f"dispatch and chain under sync debug \"error\"")
            require(len(flags) == HL_FRAMES and all(flags), f"pipeline_depth={depth}: a frame was not tracked")
            require(ate <= 0.02, f"pipeline_depth={depth}: ATE {ate:.4f} m above 2 cm")
            require(n_ln > 0, f"pipeline_depth={depth}: no map line")
            require(r["launches"]["fast_blur_stack"] == HL_FRAMES and r["launches"]["gather_patches"] == HL_FRAMES
                    and r["launches"]["pose_lm"] > 0, f"pipeline_depth={depth}: B1-B3 not launched")
        sync, piped = runs[0], runs[PIPE_K]
        require(piped["flags"] == sync["flags"], "the pipelined run's flags differ from the synchronous run's")

        # the System's first frames against the port's CPU path
        cpu = FrameBuilder(settings, device="cpu")
        for i, (g, d, _) in enumerate(frames[:HL_CPU_FRAMES]):
            raw = cpu.detect_lines(g)
            ref = cpu(g, d, *raw)
            for depth, r in runs.items():
                f = r["frames"][i]
                valid = f.ln_valid.cpu().numpy()
                geom = max(float((getattr(f, k).cpu() - getattr(ref, k)).abs()[torch.from_numpy(valid)].max())
                           for k in ("ln_sp", "ln_ep", "ln_line2d"))
                bits = _bits_equal(f.ln_desc.cpu().numpy()[valid], ref.ln_desc.numpy()[valid])
                log(f"frame {i}, pipeline_depth={depth}, vs CPU path: {int(valid.sum())} keylines, valid equal "
                    f"{np.array_equal(valid, ref.ln_valid.numpy())}, geometry |d| {geom:.2e} (tol {TOL_LINE_GEOM}), "
                    f"LBD bits equal {bits:.5f} (tol {TOL_DESC_BITS})")
                require(np.array_equal(valid, raw[2]) and np.array_equal(valid, ref.ln_valid.numpy()),
                        "keyline validity differs from the host LSD's")
                require(geom <= TOL_LINE_GEOM and bits >= TOL_DESC_BITS, "card and CPU line fields disagree")
        # the System's raw endpoints are the host code's: rebuild from them on the card, bit for bit
        card = FrameBuilder(settings)
        g, d, _ = frames[0]
        again = card(g, d, *card.detect_lines(g))
        for k in ("ln_sp", "ln_ep", "ln_valid"):
            require(torch.equal(again._asdict()[k], sync["frames"][0]._asdict()[k]),
                    f"{k}: the System's upload of the endpoints changed them")

        slam = sync["slam"]
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            slam.dump_debug_images(tmp, gray=frames[-1][0])
            dump_ms = (time.perf_counter() - t0) * 1e3
            frame_img, map_img = viewer.draw_frame(frames[-1][0], slam.state), viewer.draw_map(slam.state)
            ok = [np.array_equal(read_png(Path(tmp) / name)[..., ::-1], img)
                  for name, img in (("frame.png", frame_img), ("map.png", map_img))]
        drawn = int((map_img != 30).any(-1).sum())
        log(f"dump_debug_images: {dump_ms:.3f} ms; frame.png {frame_img.shape} equal {ok[0]}, map.png "
            f"{map_img.shape} equal {ok[1]} ({drawn} pixels drawn)")
        require(all(ok) and drawn > 100, "the debug images do not decode to the drawings")


def run_vocab():
    """The vocabulary harvest on the card and the tree (see the module
    docstring)."""
    import torch

    from plslam_tpu_torch.features.orb import ORBExtractor
    from plslam_tpu_torch.loopclosing import train_vocab as tv
    from plslam_tpu_torch.loopclosing.vocab import ASSET

    with Phase("vocab"):
        corpus = np.load(ROOT / "tests" / "data" / "vocab_corpus_ref.npz")
        ref, per_ref = corpus["desc"], corpus["per_frame"]
        asset = np.load(ASSET)
        require(len(ref) == int(asset["n_train"]), "the corpus is not the shipped codebook's")
        seen, describe = [], tv._descriptors

        def recording(ext, gray, device):
            desc = describe(ext, gray, device)
            seen.append((gray, desc))
            return desc

        tv._descriptors = recording
        try:
            t0 = time.perf_counter()
            desc = tv.harvest_descriptors()
            harvest_s = time.perf_counter() - t0
        finally:
            tv._descriptors = describe
        t0 = time.perf_counter()
        words = tv.train_tree(desc)
        train_s = time.perf_counter() - t0
        log(f"harvest on the card: {len(desc)} descriptors from {len(seen)} frames in {harvest_s:.3f} s "
            f"(reference corpus {len(ref)}); train_tree {train_s:.3f} s: {len(words)} words (shipped "
            f"{len(asset['words'])})")
        require(len(desc) == len(ref) and [len(x) for _, x in seen] == per_ref.tolist(),
                "the descriptor count differs from the reference's")
        rows = (desc != ref).any(1)
        bits = _bits_equal(desc, ref)
        same_words = words.shape == asset["words"].shape and np.array_equal(words, asset["words"])
        n_word_diff = len({w.tobytes() for w in words} ^ {w.tobytes() for w in asset["words"]}) // 2
        log(f"descriptors differing from the reference's: {int(rows.sum())} of {len(ref)} (bits equal {bits:.6f}, "
            f"tol {TOL_DESC_BITS}); words: equal to the shipped codebook {same_words}, {n_word_diff} differ")
        require(bits >= TOL_DESC_BITS, "the harvest's descriptor bits differ from the reference's beyond near-ties")
        if rows.any():
            starts = np.concatenate([[0], np.cumsum(per_ref)])
            f = int(np.searchsorted(starts, int(np.argmax(rows)), side="right")) - 1
            gray = seen[f][0]
            ext = ORBExtractor(240, 320, n_features=500)
            img = torch.from_numpy(np.ascontiguousarray(gray, np.float32))
            card, cpu = ext(img.to("cuda")), ext(img)
            v = cpu.valid.numpy()
            same_kp = np.array_equal(card.valid.cpu().numpy(), v) and np.array_equal(card.octave.cpu().numpy(),
                                                                                        cpu.octave.numpy())
            d_uv = float(np.abs(card.uv.cpu().numpy()[v] - cpu.uv.numpy()[v]).max())
            d_ang = float(np.abs(np.angle(np.exp(1j * (card.angle.cpu().numpy()[v] - cpu.angle.numpy()[v])))).max())
            cd, rd = seen[f][1], ref[starts[f]:starts[f + 1]]
            cc = cpu.desc.numpy()[v]
            log(f"first frame that differs: {f} (scene {f // 8}, frame {f % 8}): {int((cd != rd).any(1).sum())} of "
                f"{len(rd)} descriptors differ from the reference's; card vs CPU path: keypoints equal {same_kp}, "
                f"|duv| {d_uv:.2e}, |dangle| {d_ang:.2e}, {int((cd != cc).any(1).sum())} descriptors differ, bits "
                f"equal {_bits_equal(cd, cc):.5f}; CPU path vs reference: {int((cc != rd).any(1).sum())} differ")
            require(same_kp and d_uv <= 1e-3 and d_ang <= 1e-3 and _bits_equal(cd, cc) >= TOL_DESC_BITS,
                    "the card's ORB parts from the CPU path beyond near-ties on that frame")


def _known_status(status):
    """What a host knows of a batch's statuses: False all UNINIT, True none,
    None mixed (examples/multi_sequence.py)."""
    from plslam_tpu_torch.examples.multi_sequence import known_status

    return known_status(np.asarray(status, np.int64))


def run_batched():
    """BASELINE.json config 5: BatchedTracker + BatchedMapper on 4 sequences (see
    the module docstring); -> the B1-B3 launches of the batched run."""
    import warnings

    import torch

    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.parallel.batch import BatchedMapper, BatchedTracker, stack, unstack
    from plslam_tpu_torch.pipeline import tracking as T
    from plslam_tpu_torch.pipeline.mapping import LocalMapper
    from plslam_tpu_torch.solvers import pose as pose_mod

    B = len(BATCH_SEEDS)
    with Phase("batched"), warnings.catch_warnings():
        # a per-sample fallback of torch.func.vmap is an error here
        warnings.filterwarnings("error", message=".*performance drop.*")
        seqs = [SyntheticSequence(n_frames=BATCH_FRAMES, height=480, width=640, seed=s) for s in BATCH_SEEDS]
        settings = seqs[0].settings
        inputs = [[s.frame(i) for s in seqs] for i in range(BATCH_FRAMES)]
        builder = FrameBuilder(settings)
        tracker = T.Tracker(settings, max_pts=BATCH_CAPS["max_pts"], max_kf=BATCH_CAPS["max_kf"])
        mapper = LocalMapper(tracker)
        bt, bm = BatchedTracker(tracker, batch=B), BatchedMapper(mapper)

        # warm-up on a throwaway state: constant tables, cuBLAS, the chain
        ws = bt.init_state()
        for i in range(2):
            ws, wo = bt.step(ws, stack([builder(g, d) for g, d, _ in inputs[i]]), initialised=i > 0)
        bm.process(ws.m, wo.kf_id, torch.ones(B, dtype=torch.bool, device=wo.kf_id.device))
        del ws, wo
        torch.cuda.synchronize()

        wrappers = (fast_cuda.fast_blur_stack, patches.gather_patches, pose_mod.pose_lm)
        for w in wrappers:
            w.launches = 0
        state = bt.init_state()
        known = False
        rows, b3_step, ms_build, ms_step, ms_chain, prof_in, first_chain = [], [], [], [], [], None, None
        for i in range(BATCH_FRAMES):
            t0 = time.perf_counter()
            batch = stack([builder(g, d) for g, d, _ in inputs[i]])  # B1, B2 once per sequence
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i == BATCH_PROFILE_FRAME:
                prof_in = (state, batch, known)
            b3 = pose_mod.pose_lm.launches
            state, out = _strict(torch, bt.step, state, batch, known)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            b3_step.append(pose_mod.pose_lm.launches - b3)
            new_kf = out.new_kf.cpu().numpy()
            if new_kf.any():  # no sequence made a keyframe: the masked chain would change nothing
                pre_m = state.m
                state = state._replace(m=_strict(torch, bm.process, state.m, out.kf_id, out.new_kf))
                torch.cuda.synchronize()
                last_chain = (pre_m, out.kf_id, out.new_kf, state.m)
                first_chain = first_chain or last_chain
                ms_chain.append((time.perf_counter() - t2) * 1e3)
            t3 = time.perf_counter()
            ms_build.append((t1 - t0) * 1e3)
            ms_step.append((t2 - t1) * 1e3)
            tel = out.telemetry.cpu().numpy()
            known = _known_status(tel[:, T.TEL_STATUS])
            rows.append(dict(tel=tel, Tcw=out.Tcw.cpu().numpy().astype(np.float64), ms=(t3 - t1) * 1e3,
                             chain=bool(new_kf.any())))
        launches = {w.__name__: w.launches for w in wrappers}
        kf_poses = state.m.kf_pose.cpu().numpy().astype(np.float64)

        n = BATCH_FRAMES
        tracked = np.array([[bool(r["tel"][b, T.TEL_TRACKED]) for r in rows] for b in range(B)])
        ates = []
        for b in range(B):
            est = [(seqs[b].timestamp(i), np.linalg.inv(rows[i]["tel"][b, T.TEL_REL_POSE].reshape(4, 4)
                                                         .astype(np.float64) @ kf_poses[b, int(rows[i]["tel"][b, T.TEL_REF_KF])]))
                   for i in range(n) if tracked[b, i]]
            ates.append(ate_rmse(est, seqs[b].gt_trajectory())[0])
        kf_frames = [[i for i in range(n) if rows[i]["tel"][b, T.TEL_NEW_KF]] for b in range(B)]
        log(f"seeds {list(BATCH_SEEDS)}, {n} frames, 640x480, max_pts {BATCH_CAPS['max_pts']}, "
            f"max_kf {BATCH_CAPS['max_kf']}")
        for b in range(B):
            log(f"  seq {b}: tracked {int(tracked[b].sum())}/{n}, ATE {ates[b] * 100:.4f} cm, keyframes on {kf_frames[b]}")
        step_t = ms_step[1:]
        chain_n = sum(r["chain"] for r in rows)
        total_s = sum(r["ms"] for r in rows[1:]) / 1e3
        total_e2e_s = total_s + sum(ms_build[1:]) / 1e3
        log(f"B3 launches per batched step: {b3_step}")
        log(f"median {statistics.median(step_t):.3f} ms per batched step ({B} sequences), median "
            f"{statistics.median(ms_build[1:]):.3f} ms building the {B} frames; {chain_n} batched chains, median "
            f"{statistics.median(ms_chain):.3f} ms per chain; aggregate {(n - 1) * B / total_s:.2f} frames/s over "
            f"frames 1-{n - 1} (step + chain, as the example counts), {(n - 1) * B / total_e2e_s:.2f} frames/s with "
            f"the frame builds")
        log(f"launches during the run: {launches}")
        require(tracked.all(), "a sequence lost a frame")
        require(max(ates) <= 0.02, f"ATE {max(ates):.4f} m above 2 cm")
        require(all(c == 0 for c in b3_step[:1]) and all(c == 2 for c in b3_step[1:]),
                "B3 not launched twice per batched tracked step")
        require(launches["fast_blur_stack"] == B * n and launches["gather_patches"] == B * n,
                "B1/B2 not launched once per sequence per frame")

        # one batched step and one solo step from the same state, profiled
        st, bat, kn = prof_in
        _, wall_b, launch_b, copy_b, busy_b, _ = _profiled(lambda: bt.step(st, bat, kn))
        _, wall_s, launch_s, copy_s, busy_s, _ = _profiled(lambda: tracker.step(unstack(st, 0), unstack(bat, 0), kn))
        log(f"frame {BATCH_PROFILE_FRAME} under torch.profiler: batched step {launch_b} launches, {copy_b} copies, "
            f"{busy_b:.3f} ms device-busy in {wall_b:.3f} ms; one solo step {launch_s} launches, {copy_s} copies, "
            f"{busy_s:.3f} ms device-busy in {wall_s:.3f} ms; launches ratio {launch_b / launch_s:.3f}")

        # the step alone: the first frames of the 4 sequences batched
        # without the mapper, against each sequence stepped alone
        bs, kn, bouts = bt.init_state(), False, []
        for i in range(BATCH_SOLO_FRAMES):
            bs, bo = bt.step(bs, stack([builder(g, d) for g, d, _ in inputs[i]]), initialised=kn)
            tel = bo.telemetry.cpu().numpy()
            kn = _known_status(tel[:, T.TEL_STATUS])
            bouts.append((tel, bo.Tcw.cpu().numpy()))
        flags = [T.TEL_TRACKED, T.TEL_NEW_KF, T.TEL_STATUS, T.TEL_KF_ID, T.TEL_REF_KF]

        def solo_run(b, with_mapper, n=BATCH_SOLO_FRAMES, times=None):
            """Sequence b alone: its outputs per frame; with `times` the
            ms of each frame's build and of its step + chain appended."""
            s, kn_b, outs = tracker.init_state(), False, []
            for i in range(n):
                g, d, _ = inputs[i][b]
                t0 = time.perf_counter()
                f = builder(g, d)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                s, o = tracker.step(s, f, initialised=kn_b)
                if with_mapper and bool(o.new_kf):
                    s = s._replace(m=mapper.process(s.m, o.kf_id))
                tel = o.telemetry.cpu().numpy()
                if times is not None:
                    times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
                kn_b = int(tel[T.TEL_STATUS]) != T.ST_UNINIT
                outs.append((tel, o.Tcw.cpu().numpy()))
            return outs

        # sequence 0 alone over the whole run, timed as the batched loop is
        solo_t = []
        solo_run(0, True, n, solo_t)
        solo_s = sum(t[1] for t in solo_t[1:]) / 1e3
        solo_e2e_s = solo_s + sum(t[0] for t in solo_t[1:]) / 1e3
        log(f"sequence 0 alone, {n} frames with the mapper: {(n - 1) / solo_s:.2f} frames/s (step + chain), "
            f"{(n - 1) / solo_e2e_s:.2f} frames/s with the frame builds; the batched run's aggregate is "
            f"{(n - 1) * B / total_s / ((n - 1) / solo_s):.2f}x / {(n - 1) * B / total_e2e_s / ((n - 1) / solo_e2e_s):.2f}x "
            f"that; median {statistics.median(t[1] for t in solo_t[1:] ):.3f} ms per solo frame (step and any chain)")

        worst, closed = 0.0, []
        for b in range(B):
            for i, (tel, Tcw) in enumerate(solo_run(b, False)):
                same = bool(np.array_equal(tel[flags], bouts[i][0][b, flags]))
                dT = float(np.abs(Tcw - bouts[i][1][b]).max())
                worst = max(worst, dT)
                require(same and dT <= TOL_BATCH_POSE,
                        f"seq {b} frame {i}: batched step and solo step disagree (flags equal {same}, |dTcw| {dT:.2e})")
            # with the chains (closed loop): printed, not held: local BA's
            # LM follows float32 rounding, which differs between a batched
            # and a solo product, and the next frames track on its result
            closed.append([(bool(np.array_equal(tel[flags], rows[i]["tel"][b, flags])),
                            float(np.abs(Tcw - rows[i]["Tcw"][b]).max()))
                           for i, (tel, Tcw) in enumerate(solo_run(b, True))])
        log(f"first {BATCH_SOLO_FRAMES} frames, steps only, batched against each sequence alone: flags equal, "
            f"largest |dTcw| {worst:.2e} (tol {TOL_BATCH_POSE}); with the chains (the main run's rows): flags "
            f"equal on {sum(c[0] for r in closed for c in r)}/{B * BATCH_SOLO_FRAMES} frames, |dTcw| per sequence "
            "and frame " + "; ".join(" ".join(f"{c[1]:.1e}" for c in r) for r in closed))

        # the chain alone. The run's last batched chain replayed batched:
        # bit for bit the run's own (no float atomics). The first chain (one
        # keyframe per sequence) row by row against LocalMapper.process on
        # that sequence's pre-chain map on the card: bit for bit. The last
        # chain the same way, printed beside the card's solo chain against
        # the CPU path on the same map: once local BA moves a camera, its
        # LM follows float32 rounding, which a batched and a solo product or
        # solve round differently, as the card and the CPU do.
        pre_m, k, do, post_run = last_chain
        post = _strict(torch, bm.process, pre_m, k, do)
        apart = _differing(post, post_run)
        require(not apart, f"the replayed batched chain differs from the run's own in {apart}")
        numpy_map = lambda m: m._replace(**{f: getattr(m, f).cpu().numpy() for f in m._fields})  # noqa: E731

        def diff(got, want):
            differ = {f: int(np.sum(getattr(got, f) != getattr(want, f))) for f in CHAIN_EXACT
                      if not np.array_equal(getattr(got, f), getattr(want, f))}
            dp = np.linalg.norm(got.pt_pos - want.pt_pos, axis=1)[want.pt_valid & got.pt_valid]
            return (f"entries differing {differ or 'none'}, |dTcw| "
                    f"{float(np.abs(got.kf_pose - want.kf_pose).max()):.2e}, point positions median "
                    f"{np.median(dp):.2e} m, 99th percentile {np.percentile(dp, 99):.2e} m")

        for label, (pre_c, k_c, do_c, post_c) in (("first", first_chain), ("last", last_chain)):
            yardstick = label == "last"
            for b in range(B):
                row = unstack(post_c, b)
                if not bool(do_c[b]):
                    require(not _differing(row, unstack(pre_c, b)), f"seq {b}: a masked chain changed the map")
                    continue
                solo = mapper.process(unstack(pre_c, b), k_c[b])
                msg = f"{label} chain, seq {b}, keyframe {int(k_c[b])}: batched row vs solo chain on the card: "
                if label == "first":
                    apart = _differing(row, solo)
                    log(msg + f"fields not bit for bit equal {apart or 'none'}")
                    require(not apart, f"seq {b}: the first batched chain differs from the solo chain")
                    continue
                msg += diff(numpy_map(row), numpy_map(solo))
                if yardstick:  # one CPU chain at these capacities takes seconds
                    yardstick = False
                    cpu_mapper = LocalMapper(T.Tracker(settings, device="cpu", **BATCH_CAPS))
                    msg += "; solo chain on the card vs the CPU path: " + diff(
                        numpy_map(solo), numpy_map(cpu_mapper.process(_to(unstack(pre_c, b), "cpu"), int(k_c[b]))))
                log(msg)
    # what the mesh phase compares with: the steps without the mapper and
    # the first chain (frame 0's keyframes)
    chain0 = {f: getattr(first_chain[3], f).cpu().numpy() for f in first_chain[3]._fields}
    return launches, dict(steps=bouts[:MESH_FRAMES], chain0=chain0)


def run_mesh(batched):
    """The mesh phase (see the module docstring): config 5 on a (seq, lm)
    mesh of MESH_RANKS processes on the card, against the batched phase's
    unsharded run (`batched`), then the small dry run. -> the launches of
    the B1-B3 wrappers summed over the ranks."""
    from plslam_tpu_torch.eval import dryrun_mesh
    from plslam_tpu_torch.pipeline import tracking as T

    with Phase("mesh"), tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/config5.npz"
        t0 = time.perf_counter()
        # then the reference dryrun's shapes in the same ranks, its four
        # lines printed by rank 0
        dryrun_mesh.spawn(MESH_RANKS, "cuda", f"{tmp}/store", out, config5=True, n_frames=MESH_FRAMES,
                          profile_frame=MESH_PROFILE_FRAME, small_after=True)
        wall = time.perf_counter() - t0
        z = dict(np.load(out))
        names = [str(x) for x in z["launch_names"]]
        launches = dict(zip(names, (int(x) for x in z["launches"].sum(0))))
        seen = dict(zip(names, (int(x) for x in z["kernels_seen"].sum(0))))
        seq, lm = (int(x) for x in z["mesh_shape"])
        ms_step = [round(float(z[f"['ms_step'][{i}]"]), 3) for i in range(MESH_FRAMES)]
        ms_chain = round(float(z["['ms_chain'][0]"]), 3)
        log(f"config 5 on a (seq {seq}, lm {lm}) mesh of {MESH_RANKS} process(es) on one card, backend "
            f"{z['backend']}: {MESH_FRAMES} frames and one chain, {wall:.2f} s with the ranks' start-up and the "
            f"small dry run; ms per sharded step {ms_step}, the chain {ms_chain} ms")
        log(f"wrapper launches per rank {dict(zip(names, z['launches'].T.tolist()))}; on the card by the profiler "
            f"during frame {MESH_PROFILE_FRAME} {dict(zip(names, z['kernels_seen'].T.tolist()))}")
        worst = 0.0
        for i, (tel_b, Tcw_b) in enumerate(batched["steps"]):
            tel, Tcw = z[f"['out{i}'].telemetry"], z[f"['out{i}'].Tcw"]
            require(bool(tel[:, T.TEL_TRACKED].all()), f"mesh: a sequence lost frame {i}")
            require(np.array_equal(tel, tel_b), f"mesh: frame {i}'s telemetry differs from the batched run's")
            worst = max(worst, float(np.abs(Tcw - Tcw_b).max()))
        require(worst == 0.0, f"mesh: poses differ from the batched run's by up to {worst:.2e}")
        apart = [f for f, w in batched["chain0"].items()
                 if not np.array_equal(z[f"['chain0'].{f}"], w, equal_nan=w.dtype.kind == "f")]
        require(not apart, f"mesh: the chain differs from the batched run's first chain in {apart}")
        places = {k[len("placement['chain0']."):]: str(v) for k, v in z.items() if k.startswith("placement['chain0'].")}
        bad = [f for f, p in places.items()
               if p != ("Shard(dim=0),Shard(dim=1)" if f.startswith("pt_") else "Shard(dim=0),Replicate()")]
        require(places and not bad, f"mesh: map fields not at rest in the reference's placements: {bad}")
        log(f"the {MESH_FRAMES} sharded steps equal the batched phase's steps without the mapper and the chain its "
            "first chain, bit for bit; every pt_* field at rest on (Shard(0), Shard(1)), every other on "
            "(Shard(0), Replicate())")
        # the frames are built on every lm rank of a seq group (Replicate)
        B, steps = len(BATCH_SEEDS), MESH_FRAMES - 1
        for k, run_n, frame_n in (("fast_blur_stack", B * MESH_FRAMES * lm, B * lm),
                                  ("gather_patches", B * MESH_FRAMES * lm, B * lm),
                                  ("pose_lm", 2 * steps * MESH_RANKS, 2 * MESH_RANKS)):
            require(launches[k] == run_n and seen[k] == frame_n,
                    f"mesh: {k} launched {launches[k]} times (expected {run_n}), the profiler saw {seen[k]} on the "
                    f"card during frame {MESH_PROFILE_FRAME} (expected {frame_n})")
        log(f"B1 and B2 once per local sequence per frame on every rank ({B} x {MESH_FRAMES} x lm {lm}), B3 twice "
            f"per tracked step on every rank; the profiler saw frame {MESH_PROFILE_FRAME}'s on the card")
    return launches


def run_loop():
    """The loop phase (see the module docstring). -> kernel launches of the
    fixture's loop-on run."""
    from plslam_tpu_torch.io.synthetic import SyntheticSequence

    with Phase("loop"):
        seq = SyntheticSequence(n_frames=LOOP_FRAMES, height=240, width=320, seed=0, trajectory="loop", fps=10.0,
                                depth_noise=0.03)
        frames = [seq.frame(i) for i in range(seq.n_frames)]
        off = _loop_run("loop fixture", seq.settings, seq, frames, LOOP_REVISIT, False)
        on = _loop_run("loop fixture", seq.settings, seq, frames, LOOP_REVISIT, True)
        log(f"loop fixture: closures at {on['closure'] and on['closure']['frame']}, {on['closures_ms']} ms each "
            f"(last_closure_ms); global-BA slices {[round(v, 3) for v in on['slice_ms']]} ms")
        checks = {
            "a loop closed": on["loops"] >= 1,
            "all frames tracked (both runs)": on["n_tracked"] == off["n_tracked"] == LOOP_FRAMES,
            "no-loop ATE and gap above 8 cm": off["ate"] > 0.08 and off["gap"] > 0.08,
            "gap_on < 0.5 gap_off": on["gap"] < 0.5 * off["gap"],
            "ATE_on < 1.15 ATE_off": on["ate"] < 1.15 * off["ate"],
        }
        log("loop fixture, tests/test_loop_e2e.py's assertions: " + "; ".join(f"{k} {v}" for k, v in checks.items()))
        require(on["closure"] is not None, "the loop fixture closed no loop")
        _closure_checks("loop fixture", seq.settings, on)
        require(all(checks.values()), "the loop fixture fails tests/test_loop_e2e.py's assertions")
    return on["launches"]


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
        card_line = smi.stdout.strip().splitlines()[0]  # "<name>, <power limit>", as nvidia-smi gives them
        log(card_line)
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
        # under torch.func.vmap (parallel/batch.py): 4 sequences' P = 2
        # problems, each sequence laid out as above, through the custom op's
        # vmap rule: one launch of 8 problems
        prs = [pose_problem_pair(np.random.default_rng(10 + b)) for b in range(4)]
        ptsv = pose_mod.PointObs(*(torch.stack(f) for f in zip(*[
            (T(q["xw"]), T(q["obs"]).expand(2, -1, -1), T(q["isig"]).expand(2, -1), T(q["stereo"]).expand(2, -1),
             T(q["valid"])) for q in prs])))
        solve_v = torch.func.vmap(lambda p: pose_mod.pose_optimization(T02, p, pr["K"], pr["bf"])[:2])
        before = pose_mod.pose_lm.launches
        Tkv, pkv = solve_v(ptsv)
        n_v = pose_mod.pose_lm.launches - before
        outs = [pose_mod.pose_optimization_plain(T02, pose_mod.PointObs(*(f[b] for f in ptsv)), pr["K"], pr["bf"])
                for b in range(4)]
        torch.cuda.synchronize()
        ev = max(float((Tkv[b] - o[0]).abs().max()) for b, o in enumerate(outs))
        flipsv = [int((pkv[b, i] != o[1][i]).sum()) for b, o in enumerate(outs) for i in range(2)]
        ms3_v = cuda_ms(torch, lambda: solve_v(ptsv))
        log(f"B3 under vmap, 4 sequences x P = 2: {n_v} launch(es), |dT| {ev:.3e} (tol {TOL_B3_POSE}), inlier "
            f"flips {flipsv} (tol {TOL_B3_FLIPS} each), {ms3_v:.4f} ms for the 8 problems")
        require(n_v == 1, f"B3's vmap rule made {n_v} launches for 8 problems, not 1")
        require(bool(torch.isfinite(Tkv).all()) and ev <= TOL_B3_POSE and max(flipsv) <= TOL_B3_FLIPS,
                "B3 under vmap disagrees with its plain twin")
        err3 = max(err3, ev)
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
    log(f"kernel launches during the system run: {run_system(lines_settings)}")
    run_mapping("mapping TUM1", settings, depth_range=MAP_DEPTH_RANGE)
    run_mapping("mapping TUM3", lines_settings, use_loop_closing=False)
    run_low_texture()
    run_host_lines()
    run_vocab()
    # the kernels line counts the launches of this slice's path, the mesh
    # (B4 from the fast phase: it is not on the step)
    batched_launches, batched = run_batched()
    log(f"kernel launches during the batched run: {batched_launches}")
    pipe_launches = run_pipelined(lines_settings)
    log(f"kernel launches during the first pipelined run: {pipe_launches}")
    loop_launches = run_loop()
    log(f"kernel launches during the loop fixture's loop-on run: {loop_launches}")
    for name, n in run_mesh(batched).items():
        kernels[name]["launches"] = n

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {BUDGET_S:.0f} s) on {card_line}")
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
