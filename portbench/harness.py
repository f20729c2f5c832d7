"""The benchmark harness: find a cell's files by name, set it up, run its
closed-loop window, check what the window produced, print one result.

A cell (`workloads` in BENCHMARK.json) names a configuration and a traffic
mix. The configuration's file (`configs[].file`) names the entry that
drives the port (`portbench/entries/<entry>.py`) and holds the settings it
runs with; the traffic mix is `portbench/traffic/<traffic>.json`; the
correctness limits are `portbench/limits/<cell>.json`; each metric is read
by `portbench/metrics/<metric>.py`. Adding a cell or a metric adds files
and entries, and edits none of these.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from portbench import capture, check, guard, host, trace
from portbench.errors import NoResult

ROOT = Path(__file__).resolve().parent.parent
MARK_S = 5.0  # the window's frame count is noted every MARK_S seconds (a diagnostic on standard error)


def _load_module(path: Path, prefix: str):
    """A module of the benchmark found by file name (names may hold dots)."""
    if not path.is_file():
        raise NoResult(f"missing {path}")
    mod_name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one cell is, found by its name from BENCHMARK.json."""

    def __init__(self, name: str, root: Path = ROOT, config_override: dict | None = None,
                 traffic_override: dict | None = None):
        """config_override / traffic_override: keys replaced in the
        configuration and traffic files (the CPU tests shrink a cell)."""
        bench_file = root / "BENCHMARK.json"
        if not bench_file.is_file():
            raise NoResult(f"no BENCHMARK.json in {root}")
        bench = json.loads(bench_file.read_text())
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise NoResult(f"no cell {name!r} in BENCHMARK.json")
        self.root, self.name = root, name
        self.workload = by_name[name]
        cfg_entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = json.loads((root / cfg_entry["file"]).read_text())
        if config_override:
            self.config = {**self.config, **config_override}
        pb = root / "portbench"
        self.traffic = json.loads((pb / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.traffic.update(traffic_override or {})
        self.limits = json.loads((pb / "limits" / f"{name}.json").read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def entry(self):
        return _load_module(self.root / "portbench" / "entries" / f"{self.config['entry']}.py", "portbench_entry_")

    def reader(self, metric: str):
        return _load_module(self.root / "portbench" / "metrics" / f"{metric}.py", "portbench_metric_")


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None, control: bool = False, log=None) -> dict:
    """One run of `cell` -> the result dict (the printed line's keys, with
    `checks` last). With control=True the result also carries the
    control's readings beside the program's, and `control_correct`: the
    verdict of the same comparison with the control's numbers put where
    the program's go (portbench/calibrate.py)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    torch.set_grad_enabled(False)
    dev = torch.device(device)
    seed = int(seed)
    if seed < 0:
        raise NoResult(f"--seed must be a whole number >= 0, got {seed}")
    tracer = trace.Tracer(cell.config.get("trace", {}), dev) if traced else None

    entry = cell.entry()
    sess = entry.Session(cell, seed, seconds, dev, log)  # set-up: build, frames, warm-up, fresh session
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    guard.require_clean("after set-up")

    rng = np.random.default_rng([seed, 0x5EED])
    chk = cell.config["check"]
    caps = capture.Captures(rng, int(chk["frames"]), int(chk["pose_problems"]), int(chk.get("ba_problems", 0)))
    sess.install(caps)
    if tracer is not None:
        sess.instrument(tracer)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    frames = 0
    marks = []  # (seconds into the window, frames) at the first call ending past each MARK_S
    host0 = host.snapshot()
    t0 = time.perf_counter()
    while True:
        if tracer is not None:
            tracer.before_call(t0, seconds, frames)
        c0 = time.perf_counter_ns()
        frames += sess.call()
        c1 = time.perf_counter_ns()
        if tracer is not None:
            tracer.after_call(c0, c1, frames)
        if c1 / 1e9 - t0 >= MARK_S * (len(marks) + 1):
            marks.append((round(c1 / 1e9 - t0, 4), frames))
        if (c1 / 1e9 - t0) >= seconds:
            break
    window_s = c1 / 1e9 - t0
    host_window = host.window(host0, host.snapshot())
    if tracer is not None:
        tracer.close(frames)
    dev_info = device_info(torch, dev, cell.chips)
    guard.require_clean("after the window")
    caps.uninstall()
    out = sess.finish()  # the program drains what is in flight; its outputs
    sess.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check.evaluate(cell, sess, caps, out, dev, control=control)
    limits = {k: v["limit"] for k, v in cell.limits.items() if not k.startswith("_")}
    correct = check.judge(numbers, limits)

    rec = dict(frames=frames, window_s=window_s, setup_s=setup_s, shapes=sess.shapes(),
               device=dev_info, traced=traced)
    if tracer is not None:
        rec.update(tracer.record())
    metric_list = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in metric_list:
        v = cell.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(frames), "failed": int(out["untracked"]),
              "metrics": metrics, "device": dev_info}
    if tracer is not None:
        result["device"] = {**dev_info, "busy_s": rec["busy_s"], "window_s": rec["profile_window_s"]}
        result["breakdown"] = rec["breakdown"]
    result["checks"] = {k: {"value": _finite(numbers.get(k, math.nan)), "limit": lim} for k, lim in limits.items()}
    if control:
        result["control"] = {k[len("control."):]: v for k, v in numbers.items() if k.startswith("control.")}
        # the control in the program's place: its numbers where it has them, judged as the program's are
        result["control_correct"] = check.judge({**numbers, **result["control"]}, limits)
    result["info"] = {**out.get("info", {}), **{k[5:]: v for k, v in numbers.items() if k.startswith("diag.")},
                      "host": host_window, "frames_at": marks}
    if tracer is not None:
        p = rec["profile"]
        result["info"].update(profile_frames=p["frames"], profile_events=p["events"],
                              profile_events_inside=p["events_inside"],
                              span_s={k: [len(v), sum(e - s for s, e in v) / 1e9] for k, v in rec["spans"].items()})
    return result


def _finite(v):
    """A number for the JSON line: None where it is not finite."""
    v = float(v)
    return v if math.isfinite(v) else None


def _fmt(v):
    return "none" if v is None else repr(float(v))


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoResult(f"cell {cell.name} needs {cell.chips} CUDA card(s), this machine has {n}")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
        guard.require_clean("before the result")
    except (NoResult, guard.Loaded) as e:
        print(f"portbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    info = result.pop("info")
    print(f"portbench: {cell.name} seed {args.seed}: " + json.dumps(info), file=sys.stderr)
    print(f"correct {result['correct']}; each number compared, beside its limit:", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {_fmt(v['value'])} limit {_fmt(v['limit'])}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
