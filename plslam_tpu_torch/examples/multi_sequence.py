"""Batched multi-sequence offline mapping (BASELINE.json config 5).

Port of examples/multi_sequence.py: B independent RGB-D sequences go
through one vmapped tracking step per frame index (parallel/batch.py), and
with --map through one vmapped mapper chain on the frames where a sequence
made a keyframe; every sequence's state stays on the card. Frames are built
per sequence (FrameBuilder: kernels B1 and B2 once per sequence per frame).

    python -m plslam_tpu_torch.examples.multi_sequence --batch 4 --frames 40 [--map] [--cpu]

Writes one TUM trajectory per sequence (<out-prefix>_<b>.txt) and prints
the aggregate frames/s, and per sequence the tracked frames and the ATE
against the synthetic ground truth.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from plslam_tpu_torch.eval.ate import ate_rmse
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.io.trajectory import load_trajectory_tum, save_trajectory_tum
from plslam_tpu_torch.parallel.batch import BatchedMapper, BatchedTracker, stack
from plslam_tpu_torch.pipeline import tracking as T
from plslam_tpu_torch.pipeline.mapping import LocalMapper


def known_status(status: np.ndarray):
    """The host's knowledge of a batch's statuses for BatchedTracker.step:
    False when every sequence is UNINIT, True when none is, else None."""
    uninit = status == T.ST_UNINIT
    if uninit.all():
        return False
    return True if not uninit.any() else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins of the kernels)")
    ap.add_argument("--map", action="store_true",
                    help="run the vmapped mapper chain too (triangulation + fuse + local BA per keyframe)")
    ap.add_argument("--out-prefix", default="multiseq")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    B = args.batch
    seqs = [SyntheticSequence(n_frames=args.frames, height=args.height, width=args.width, seed=11 * b + 1)
            for b in range(B)]
    settings = seqs[0].settings
    fb = FrameBuilder(settings, device=device)
    tracker = T.Tracker(settings, max_pts=8192, max_kf=64, device=device)
    bt = BatchedTracker(tracker, batch=B)
    bm = BatchedMapper(LocalMapper(tracker)) if args.map else None
    state = bt.init_state()

    logs = [[] for _ in range(B)]  # (t, rel_pose, ref, tracked)
    initialised = False
    t_total = 0.0
    for i in range(args.frames):
        batch = stack([fb(*s.frame(i)[:2]) for s in seqs])
        t0 = time.perf_counter()
        state, out = bt.step(state, batch, initialised=initialised)
        new_kf = out.new_kf.cpu().numpy()
        if bm is not None and new_kf.any():  # no sequence made a keyframe: nothing to map
            state = state._replace(m=bm.process(state.m, out.kf_id, out.new_kf))
        tel = out.telemetry.cpu().numpy()  # waits for the frame's work
        if i > 0:
            t_total += time.perf_counter() - t0
        initialised = known_status(tel[:, T.TEL_STATUS].astype(np.int64))
        for b in range(B):
            logs[b].append((seqs[b].timestamp(i), tel[b, T.TEL_REL_POSE].reshape(4, 4).astype(np.float64),
                            int(tel[b, T.TEL_REF_KF]), bool(tel[b, T.TEL_TRACKED])))

    fps = (args.frames - 1) * B / t_total if t_total > 0 else float("nan")
    print(f"batch={B}: {fps:.1f} aggregate frames/sec ({fps / B:.1f} per sequence)")
    kf_poses = state.m.kf_pose.cpu().numpy().astype(np.float64)
    results = []
    for b in range(B):
        out_file = f"{args.out_prefix}_{b}.txt"
        save_trajectory_tum(out_file, [x[0] for x in logs[b]], [x[1] for x in logs[b]], [x[2] for x in logs[b]],
                            kf_poses[b], tracked_mask=[x[3] for x in logs[b]])
        rmse, _ = ate_rmse(load_trajectory_tum(out_file), seqs[b].gt_trajectory())
        n_tracked = sum(x[3] for x in logs[b])
        results.append(dict(tracked=n_tracked, ate_m=float(rmse)))
        print(f"  seq {b}: tracked {n_tracked}/{args.frames}, ATE {rmse * 100:.2f} cm -> {out_file}")
    return dict(fps=fps, sequences=results)


if __name__ == "__main__":
    torch.set_grad_enabled(False)
    main()
