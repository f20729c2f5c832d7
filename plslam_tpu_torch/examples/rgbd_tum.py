"""RGB-D SLAM example: the equivalent of Examples/RGB-D/rgbd_tum.cc.

Port of examples/rgbd_tum.py. TUM data:

    python -m plslam_tpu_torch.examples.rgbd_tum --settings configs/TUM1.yaml \\
        --sequence DATA/rgbd_dataset_freiburg1_xyz --assoc fr1_xyz.txt --out CameraTrajectory.txt

No dataset (the synthetic sequence; --low-texture for BASELINE.json config 3):

    python -m plslam_tpu_torch.examples.rgbd_tum --synthetic --frames 60 [--low-texture] [--cpu]

Prints the reference CLI's median and mean per-frame track time, and the
ATE RMSE where ground truth exists.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from plslam_tpu_torch.eval.ate import ate_rmse
from plslam_tpu_torch.io.trajectory import load_trajectory_tum
from plslam_tpu_torch.system import System


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", default=None, help="TUM*.yaml settings file")
    ap.add_argument("--sequence", default=None, help="TUM sequence directory")
    ap.add_argument("--assoc", default=None, help="association file")
    ap.add_argument("--synthetic", action="store_true", help="use the synthetic sequence")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--low-texture", action="store_true")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins of the kernels)")
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--pipeline", type=int, default=0, metavar="K",
                    help="frames kept in flight before a frame's host side runs (0 = synchronous)")
    args = ap.parse_args(argv)

    if args.synthetic:
        from plslam_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(n_frames=args.frames, low_texture=args.low_texture)
        settings = seq.settings
        gt = seq.gt_trajectory()
    else:
        if not (args.settings and args.sequence and args.assoc):
            ap.error("--settings/--sequence/--assoc required without --synthetic")
        from plslam_tpu_torch.config import load_settings
        from plslam_tpu_torch.io.tum import TumSequence, load_groundtruth

        settings = load_settings(args.settings)
        seq = TumSequence(args.sequence, args.assoc, settings.depth_map_factor)
        gt_file = Path(args.sequence) / "groundtruth.txt"
        gt = load_groundtruth(gt_file) if gt_file.exists() else None

    slam = System(settings, use_local_mapping=not args.no_ba, pipeline_depth=args.pipeline,
                  device="cpu" if args.cpu else "cuda")
    times, kf_frame = [], []  # per call; did the frame finalized in it insert a keyframe
    for i in range(seq.n_frames):
        gray, depth, t = seq.frame(i)
        t0 = time.perf_counter()
        slam.track_rgbd(gray, depth, t)
        times.append(time.perf_counter() - t0)
        kf_frame.append(slam.last_frame_was_kf)
        if i % 20 == 0:
            print(f"frame {i:4d}: {slam.get_tracking_state():>6s} kf={slam.n_keyframes} pts={slam.n_map_points}")

    slam.shutdown()
    n_tracked = sum(slam.tracked_flags)
    slam.save_trajectory_tum(args.out)
    if args.kf_out:
        slam.save_keyframe_trajectory_tum(args.kf_out)

    times_ms = np.sort(np.array(times[2:])) * 1e3  # the first frames build and warm up
    print("-------")
    print(f"tracked {n_tracked}/{seq.n_frames} frames")
    print(f"median tracking time: {np.median(times_ms):.2f} ms")
    print(f"mean tracking time:   {times_ms.mean():.2f} ms")
    t_arr = np.array(times[2:]) * 1e3
    kf_arr = np.array(kf_frame[2:], bool)
    if kf_arr.any() and (~kf_arr).any():
        def pct(x, q):
            return float(np.percentile(x, q))
        print(f"latency p50/p99 non-KF: {pct(t_arr[~kf_arr], 50):.2f}/{pct(t_arr[~kf_arr], 99):.2f} ms | "
              f"KF frames: {pct(t_arr[kf_arr], 50):.2f}/{pct(t_arr[kf_arr], 99):.2f} ms ({int(kf_arr.sum())} KFs)")
    result = dict(tracked=n_tracked, frames=seq.n_frames, median_ms=float(np.median(times_ms)),
                  mean_ms=float(times_ms.mean()), ate_m=None)
    if gt is not None:
        rmse, n = ate_rmse(load_trajectory_tum(args.out), gt)
        result["ate_m"] = float(rmse)
        print(f"ATE RMSE: {rmse * 100:.2f} cm over {n} associated frames")
    return result


if __name__ == "__main__":
    torch.set_grad_enabled(False)
    main()
