#!/usr/bin/env python
"""`System` on the synthetic loop circuit, for the port or the reference.

    python tools/loop_circuit.py --package port --config configs/TUM2.yaml --frames 80 130 190
    python tools/loop_circuit.py --package ref --config configs/TUM2.yaml --frames 190
    python tools/loop_circuit.py --package port --device cpu --fixture --replay-first-closure

Drives `System(settings)` with every default (loop closing on, or off with
`--loop off`) over `SyntheticSequence(trajectory="loop", depth_noise=0.03,
seed=0)`: `--config` renders through that calibration (its resolution and
fps), `--fixture` is tests/test_loop_e2e.py's own (320x240, 10 fps, the
default camera). One JSON line per run: frames tracked, loops closed, ATE
RMSE and the loop gap (the estimated pose of the dwell frame `revisit`
relative to frame 0; in truth both are the start pose). The port runs on
`--device` (the card by default); the reference runs on the CPU.

`--replay-first-closure` (the port on the CPU only) keeps the state before
the port's first accepted closure, runs the reference's `close_loop` on the
same state and prints how the two closures compare, with the error of the
loop transform each accepted against the ground truth.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _sequence(synthetic, load_settings, args, n):
    kw = dict(n_frames=n, seed=0, trajectory="loop", depth_noise=0.03)
    if args.fixture:
        return synthetic.SyntheticSequence(height=240, width=320, fps=10.0, **kw)
    return synthetic.SyntheticSequence(settings=load_settings(str(ROOT / args.config)), **kw)


def _gap(est, seq, revisit):
    by_t = {round(t, 4): T for t, T in est}
    e0, ew = by_t.get(round(seq.timestamp(0), 4)), by_t.get(round(seq.timestamp(revisit), 4))
    return float(np.linalg.norm((np.linalg.inv(e0) @ ew)[:3, 3])) if e0 is not None and ew is not None else None


def _rel_err(kf_pose, fid, a, b, seq):
    """|t| of (estimated T_a T_b^-1) against the ground truth's."""
    P = np.asarray(kf_pose, np.float64)
    gt = np.linalg.inv(seq.gt_pose_wc(int(fid[a]))) @ seq.gt_pose_wc(int(fid[b]))
    return float(np.linalg.norm((P[a] @ np.linalg.inv(P[b]) @ np.linalg.inv(gt))[:3, 3]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "ref"), default="port")
    ap.add_argument("--config", default="configs/TUM2.yaml")
    ap.add_argument("--fixture", action="store_true", help="tests/test_loop_e2e.py's 320x240 fixture")
    ap.add_argument("--frames", type=int, nargs="+", default=[190])
    ap.add_argument("--loop", choices=("on", "off"), nargs="+", default=["on"])
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--replay-first-closure", action="store_true")
    ap.add_argument("--out", default=str(ROOT / ".torch_build" / "loop_circuit"), help="logs and trajectories")
    args = ap.parse_args()

    if args.package == "ref" or args.replay_first_closure:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.package == "port":
        from plslam_tpu_torch import load_settings
        from plslam_tpu_torch.eval.ate import ate_rmse
        from plslam_tpu_torch.io import synthetic
        from plslam_tpu_torch.io.trajectory import load_trajectory_tum
        from plslam_tpu_torch.system import System

        make = lambda s, on, log: System(s, use_loop_closing=on, device=args.device, log_path=log)  # noqa: E731
    else:
        from plslam_tpu.config import load_settings
        from plslam_tpu.eval import ate_rmse
        from plslam_tpu.io import synthetic
        from plslam_tpu.io.trajectory import load_trajectory_tum
        from plslam_tpu.system import System

        make = lambda s, on, log: System(s, use_loop_closing=on, log_path=log)  # noqa: E731

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for n in args.frames:
        seq = _sequence(synthetic, load_settings, args, n)
        revisit = min(max(int(0.75 * n), 2) + 8, n - 1)
        for mode in args.loop:
            tag = f"{args.package}_{'fixture' if args.fixture else Path(args.config).stem}_{n}_{mode}"
            slam = make(seq.settings, mode == "on", out / f"{tag}.jsonl")
            first = {}
            if args.replay_first_closure and slam._loop is not None:
                close = slam._loop.close_loop

                def watched(state, k, cand, _close=close, _first=first):
                    post, closed = _close(state, k, cand)
                    if closed and not _first:
                        _first.update(pre=state, post=post, k=k, cand=cand, host=dict(
                            _kf_counter=slam._loop._kf_counter, _loop_edges=list(slam._loop._loop_edges[:-1])))
                    return post, closed

                slam._loop.close_loop = watched
            t0 = time.perf_counter()
            for i in range(n):
                slam.track_rgbd(*seq.frame(i))
            slam.shutdown()
            slam.save_trajectory_tum(out / f"{tag}.txt")
            est = load_trajectory_tum(out / f"{tag}.txt")
            ate, _ = ate_rmse(est, seq.gt_trajectory())
            gap = _gap(est, seq, revisit)
            print(json.dumps(dict(package=args.package, config="fixture" if args.fixture else args.config, frames=n,
                                  loop=mode, tracked=int(sum(slam.tracked_flags)), loops=int(slam.n_loops_closed),
                                  ate_cm=ate * 100, gap_cm=None if gap is None else gap * 100, revisit=revisit,
                                  seconds=time.perf_counter() - t0)), flush=True)
            if first:
                _replay_on_reference(first, seq, args)
    return 0


def _replay_on_reference(first, seq, args):
    """The reference's close_loop on the state the port closed from."""
    import jax
    import jax.numpy as jnp

    from plslam_tpu.config import load_settings
    from plslam_tpu.io import synthetic as jsynthetic
    from plslam_tpu.pipeline.loopclosing import LoopCloser
    from plslam_tpu.pipeline.tracking import Tracker

    jseq = _sequence(jsynthetic, load_settings, args, seq.n_frames)
    tr = Tracker(jseq.settings)
    loop = LoopCloser(tr)
    loop._kf_counter = first["host"]["_kf_counter"]
    loop._loop_edges = first["host"]["_loop_edges"]

    def to_jax(x):
        if hasattr(x, "_fields"):
            return type(x)(*(to_jax(f) for f in x))
        return jnp.asarray(x.cpu().numpy())

    ref_post, closed = loop.close_loop(to_jax(first["pre"]), first["k"], first["cand"])
    got, want = first["post"].m, jax.tree_util.tree_map(np.asarray, ref_post.m)
    fid = want.kf_frame_id
    differ = {f: int(np.sum(getattr(got, f).cpu().numpy() != getattr(want, f)))
              for f in ("kf_lm_idx", "pt_valid", "pt_replaced")}
    print(json.dumps(dict(
        replay="first closure", k=int(first["k"]), cand=int(first["cand"]), frame_k=int(fid[first["k"]]),
        reference_closed=bool(closed), entries_differing=differ,
        max_pose_diff=float(np.abs(got.kf_pose.cpu().numpy() - want.kf_pose).max()),
        loop_edge_err_before_cm=100 * _rel_err(first["pre"].m.kf_pose.cpu().numpy(), fid, first["k"], first["cand"],
                                               seq),
        loop_edge_err_port_cm=100 * _rel_err(got.kf_pose.cpu().numpy(), fid, first["k"], first["cand"], seq),
        loop_edge_err_reference_cm=100 * _rel_err(want.kf_pose, fid, first["k"], first["cand"], seq))), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
