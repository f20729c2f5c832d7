"""Where the time of one tracking step goes on the card.

    python3 -m plslam_tpu_torch.eval.profile_step configs/TUM3.yaml [--frames 20]

Runs FrameBuilder -> Tracker.step over synthetic frames (seed 0) on the
card: `--warmup` frames untimed, `--frames` frames timed without the
profiler, then `--frames` more under torch.profiler. Prints one JSON line:
the median ms per frame without the profiler (wall clock, each frame
synchronised), and under it: host ms per frame (the profiler's overhead
included), device-busy ms per frame (the union of the device intervals),
the idle share of the card, kernel launches per frame and the kernels with
the most device time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from plslam_tpu_torch import load_settings
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.pipeline.tracking import ST_UNINIT, Tracker

    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA card", file=sys.stderr)
        return 1
    s = load_settings(args.config)
    w, f = args.warmup, args.frames
    seq = SyntheticSequence(n_frames=w + 2 * f, seed=0, settings=s)
    frames = [seq.frame(i)[:2] for i in range(w + 2 * f)]
    builder, tracker = FrameBuilder(s), Tracker(s)
    state = tracker.init_state()
    known = False  # the status as System knows it: read until the state is initialised

    def run(chunk):
        nonlocal state, known
        wall = []
        for g, d in chunk:
            t0 = time.perf_counter()
            state, _ = tracker.step(state, builder(g, d), initialised=known)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            known = known or int(state.status) != ST_UNINIT
        return wall

    run(frames[:w])
    plain = run(frames[w : w + f])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run(frames[w + f :])
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        print("profile_step: the profiler recorded no device activity", file=sys.stderr)
        return 1
    copies = [e for e in on_card if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in on_card if not e.name.startswith(("Memcpy", "Memset"))]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels + copies]) / 1e3
    by_name = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    wall_ms = sum(wall)
    print(json.dumps({
        "config": args.config, "device": torch.cuda.get_device_name(0), "frames": f,
        "median_ms_per_frame": statistics.median(plain),
        "host_ms_per_frame": wall_ms / f,
        "device_busy_ms_per_frame": busy_ms / f,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_frame": len(kernels) / f,
        "copies_per_frame": len(copies) / f,
        "top_kernels": [{"name": k[:80], "launches_per_frame": v[0] / f, "ms_per_frame": v[1] / f}
                        for k, v in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
