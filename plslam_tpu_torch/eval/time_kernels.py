"""Kernel times on the card through the port's own wrappers; with
--parent, the same for an earlier checkout, in turns.

    python3 -m plslam_tpu_torch.eval.time_kernels [--parent DIR] [--reps N] [--out FILE]

Each time is the median over --reps runs of one wrapper call's device
time (CUDA events, the card kept busy ~1 ms while the host enqueues the
call, as chip_smoke.py times), at the main path's shapes:
  B1  fast_blur_stack on the 8-level pyramid of a 640x480 synthetic frame
      (configs/TUM1.yaml);
  B4  fast_scores on that frame;
  B2  gather_patches: 1,000 39x39 windows of that frame's 8-level stack
      (io/synthetic.py patch_centres, the centres of chip_smoke.py), and
      one window (what a launch costs as timed here);
  floor  PyTorch's own fill of one float, the least any launch reads
      as timed here;
  B3  pose_lm at N = 1024, L = 128 (io/synthetic.py pose_problem) with
      valid lines, without, and with no valid row (its latency floor);
      one point-only problem; and the tracker's two point-only problems
      (pose_problem_pair): one stacked launch where the checkout's
      pose_lm takes a problem axis, else one launch each.

--parent is an unpacked earlier checkout (for example `git archive` of the
parent commit into a git-ignored directory). The inputs are made once, by
this tree, and each tree's wrappers are timed in a process of their own,
each building its kernels with its own _build.py, in the order parent,
this, this, parent. Prints the card's name and power limit, one line per
timing, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SLEEP_CYCLES = 2_000_000


def _inputs(path: Path):
    """The inputs of every timing, made by this tree on the CPU -> path (.npz)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from plslam_tpu_torch import load_settings
    from plslam_tpu_torch.io.synthetic import SyntheticSequence, patch_centres, pose_problem, pose_problem_pair
    from plslam_tpu_torch.ops import pyramid

    s = load_settings(ROOT / "configs" / "TUM1.yaml")
    gray = SyntheticSequence(n_frames=1, seed=0, settings=s).frame(0)[0]
    stack = pyramid.build_pyramid_stack(torch.from_numpy(gray), s.n_levels, s.scale_factor)
    pb = pose_problem(np.random.default_rng(1), with_lines=True)
    pr = pose_problem_pair(np.random.default_rng(1))
    shapes = pyramid.level_shapes(s.height, s.width, s.n_levels, s.scale_factor)
    yx = patch_centres(np.random.default_rng(0), shapes, s.height)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, gray=gray, stack=stack.numpy(),
             level_hw=np.array(pyramid.level_shapes(s.height, s.width, s.n_levels, s.scale_factor)),
             th=np.array([s.ini_th_fast, s.min_th_fast], np.float32), patch_yx=yx, K=pb["K"], bf=np.float32(pb["bf"]),
             **{f"pts{i}": a for i, a in enumerate(pb["pts"])}, **{f"lines{i}": a for i, a in enumerate(pb["lines"])},
             **{f"pair_{k}": pr[k] for k in ("xw", "valid", "obs", "isig", "stereo")})


def _worker(tree: Path, inputs: Path, reps: int) -> dict:
    """Time `tree`'s wrappers on the saved inputs (run in a process of its own)."""
    sys.path.insert(0, str(tree))
    import torch

    import plslam_tpu_torch
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose

    if Path(plslam_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise RuntimeError(f"imported {plslam_tpu_torch.__file__}, not the package of {tree}")
    dev = torch.device("cuda")
    d = dict(np.load(inputs))
    T = lambda k: torch.from_numpy(d[k]).to(dev)  # noqa: E731

    def cuda_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    stack, gray = T("stack"), T("gray")
    flat, patch_yx = stack.reshape(-1, stack.shape[-1]), T("patch_yx")
    one_float = torch.empty(1, device=dev)
    shapes = [tuple(int(v) for v in hw) for hw in d["level_hw"]]
    ini, mn = (float(v) for v in d["th"])
    K, bf = d["K"], float(d["bf"])
    T0 = torch.eye(4, device=dev)
    pts = pose.PointObs(*(T(f"pts{i}") for i in range(5)))
    lines = pose.LineObs(*(T(f"lines{i}") for i in range(5)))
    no_line = lines._replace(valid=torch.zeros_like(lines.valid))
    no_row = pts._replace(valid=torch.zeros_like(pts.valid))
    pair = pose.PointObs(T("pair_xw"), T("pair_obs").expand(2, -1, -1), T("pair_isig").expand(2, -1),
                         T("pair_stereo").expand(2, -1), T("pair_valid"))
    one = [pose.PointObs(*(f[p] for f in pair)) for p in range(2)]
    try:
        pose.pose_lm(T0.expand(2, 4, 4), pair, K, bf)
        two = lambda: pose.pose_lm(T0.expand(2, 4, 4), pair, K, bf)  # noqa: E731
        two_launches = 1
    except ValueError:  # a pose_lm without a problem axis
        two = lambda: [pose.pose_lm(T0, o, K, bf) for o in one]  # noqa: E731
        two_launches = 2
    out = {
        "B1": cuda_ms(lambda: fast_cuda.fast_blur_stack(stack, shapes, ini, mn)),
        "B4": cuda_ms(lambda: fast_cuda.fast_scores(gray, ini, mn)),
        "B2": cuda_ms(lambda: patches.gather_patches(flat, patch_yx, 39)),
        "B2_one_window": cuda_ms(lambda: patches.gather_patches(flat, patch_yx[:1], 39)),
        "floor_fill_one_float": cuda_ms(lambda: one_float.fill_(0.0)),
        "B3_lines_valid": cuda_ms(lambda: pose.pose_lm(T0, pts, K, bf, lines)),
        "B3_no_valid_line": cuda_ms(lambda: pose.pose_lm(T0, pts, K, bf, no_line)),
        "B3_no_valid_row": cuda_ms(lambda: pose.pose_lm(T0, no_row, K, bf, no_line)),
        "B3_one_point_problem": cuda_ms(lambda: pose.pose_lm(T0, one[0], K, bf)),
        "B3_two_point_problems": cuda_ms(two),
    }
    torch.cuda.synchronize()
    out["B3_two_point_problems_launches"] = two_launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", nargs=2, type=Path, metavar=("TREE", "INPUTS"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        print(json.dumps(_worker(*args.worker, args.reps)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)

    inputs = ROOT / ".torch_build" / "time_kernels" / "inputs.npz"
    _inputs(inputs)
    trees = [ROOT] if args.parent is None else [args.parent, ROOT, ROOT, args.parent]
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree.resolve()), str(inputs),
                               "--reps", str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))

    result = {"card": card, "reps": args.reps}
    for key in runs[0]:
        if args.parent is None:
            result[key] = {"this": runs[0][key]}
        else:
            result[key] = {"parent": [runs[0][key], runs[3][key]], "this": [runs[1][key], runs[2][key]]}
        print(f"{key}: " + ", ".join(f"{k} {v}" for k, v in result[key].items()), flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
