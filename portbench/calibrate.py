"""Readings for the correctness limits: many seeds of one cell in one
process, the program's numbers and the control's side by side.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 10 [--out FILE]

Each seed is one run of the cell as portbench/run.py makes it (set-up,
window, checks), with the control computed beside the program: the
reference with TF32 on, put in the program's place, on the same inputs
(portbench/check.py). Prints one JSON line per seed (and appends it to
--out): the end-to-end metrics, each number and the control's. The lower
reading of a number is the largest the program gives over the seeds, the
upper the smallest the control gives; the limit lies between them. Each
line also holds `control_correct`, the harness's verdict with the
control's numbers put where the program's go; the exit code is 1 if the
control came out correct on any seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    control_passed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, control=True)
        line = dict(workload=cell.name, seed=seed, correct=r["correct"], attempted=r["attempted"],
                    failed=r["failed"], metrics={k: v["value"] for k, v in r["metrics"].items()},
                    program={k: v["value"] for k, v in r["checks"].items()}, control=r["control"],
                    control_correct=r["control_correct"],
                    info=r["info"], run_s=time.perf_counter() - t0, device=r["device"])
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        control_passed |= r["control_correct"]
    return 1 if control_passed else 0


if __name__ == "__main__":
    sys.exit(main())
