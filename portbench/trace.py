"""Tracing for the `--trace 1` run: host spans from the benchmark's own
wrappers around the calls into each layer, and torch.profiler over a short
sub-window for the device.

Spans: `call` (each call of the entry, the harness loop), and what the
entry wraps (`dispatch`, `chain`). They are host clocks over the whole
traced window; no synchronisation is added to them.

Profiler sub-window: it opens at the first call that starts after
`profile_start` x the window's seconds and closes after the first call that
ends `profile_seconds` later (keys of the configuration's "trace" group),
with a device synchronisation at each end so that it holds its own
frames' device work. Only CUDA activity is recorded (kernels, copies,
sets). Device busy time is the union of their intervals (copy of
`_busy_us` in plslam_tpu_torch/eval/profile_step.py). Kernel events are
unix-epoch nanoseconds, as the spans are once shifted by the offset of
the wall clock to the performance counter taken when the sub-window opens;
an idle gap is named by the innermost span open at its middle.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict

SPAN_DEPTH = {"call": 0, "dispatch": 1, "chain": 1}  # nesting, for naming idle gaps


def busy_ns(intervals) -> float:
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


def merged(intervals):
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    def __init__(self, opts: dict, device):
        self.start_share = float(opts.get("profile_start", 0.4))
        self.prof_seconds = float(opts.get("profile_seconds", 3.0))
        self.device = device
        self.spans: dict[str, list] = defaultdict(list)
        self.calls_ms: list[float] = []
        self._prof = None
        self._p = None  # (p0 ns, frames at p0)
        self.profile: dict | None = None

    # ------------------------------------------------------------ spans
    def span_fn(self, fn, name: str):
        spans = self.spans[name]

        def wrapped(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                spans.append((t0, time.perf_counter_ns()))

        return wrapped

    def wrap(self, obj, attr: str, name: str):
        """Span every call of obj.<attr> (an instance attribute shadows it)."""
        setattr(obj, attr, self.span_fn(getattr(obj, attr), name))

    # ------------------------------------------------------------ the loop
    def before_call(self, t0: float, seconds: float, frames: int):
        if self._prof is None and self.profile is None and time.perf_counter() - t0 >= self.start_share * seconds:
            self._open(frames)

    def after_call(self, c0: int, c1: int, frames: int):
        self.spans["call"].append((c0, c1))
        self.calls_ms.append((c1 - c0) / 1e6)
        if self._prof is not None and c1 - self._p[0] >= self.prof_seconds * 1e9:
            self._close(frames)

    def close(self, frames: int):
        if self._prof is not None:
            self._close(frames)

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def _open(self, frames: int):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else [ProfilerActivity.CPU]
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._wall_off = time.time_ns() - time.perf_counter_ns()
        self._p = (time.perf_counter_ns(), frames)

    def _close(self, frames: int):
        import torch

        self._sync()
        p1 = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        p0, f0 = self._p
        events = self._prof.profiler.kineto_results.events()
        dev = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
        kernels = defaultdict(lambda: [0, 0.0])
        iv = []
        n_kernels = 0
        for e in dev:
            s, d = e.start_ns(), e.duration_ns()
            iv.append((s, s + d))
            if not e.name().startswith(("Memcpy", "Memset")):
                n_kernels += 1
            k = kernels[e.name()]
            k[0] += 1
            k[1] += d / 1e9
        off = self._wall_off
        w0, w1 = p0 + off, p1 + off
        inside = sum(1 for s, e in iv if w0 - 1e6 <= s and e <= w1 + 1e6)
        self.profile = dict(window_s=(p1 - p0) / 1e9, frames=frames - f0, busy_s=busy_ns(iv) / 1e9,
                            launches=n_kernels, kernels=dict(kernels), events=len(iv),
                            events_inside=inside, gaps=self._gaps(merged(iv), w0, w1, off))
        self._prof = None

    def _gaps(self, busy, w0: int, w1: int, off: int) -> dict:
        """Idle seconds of the sub-window by the innermost span open at each
        gap's middle ("host" where none is)."""
        import numpy as np

        bounds = np.array([[s, e] for s, e in busy], dtype=np.float64).reshape(-1, 2)
        g0 = np.concatenate([[w0], bounds[:, 1]])
        g1 = np.concatenate([bounds[:, 0], [w1]])
        g0, g1 = np.clip(g0, w0, w1), np.clip(g1, w0, w1)
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        mid = (g0 + g1) / 2
        label = np.full(mid.shape, "host", dtype=object)
        depth = np.full(mid.shape, -1)
        for name, v in self.spans.items():
            if not v:
                continue
            se = np.array(v, dtype=np.float64) + off  # each name's spans are disjoint, in call order
            j = np.searchsorted(se[:, 0], mid, side="right") - 1
            ok = (j >= 0) & (se[np.clip(j, 0, None), 1] >= mid)
            d = SPAN_DEPTH.get(name, 2)
            take = ok & (d > depth)
            label[take], depth[take] = name, d
        by = defaultdict(float)
        for name, sec in zip(label, (g1 - g0) / 1e9):
            by[name] += float(sec)
        return dict(by)

    # ------------------------------------------------------------ output
    def record(self) -> dict:
        """What the metric readers and the result line read."""
        p = self.profile or dict(window_s=0.0, frames=0, busy_s=0.0, launches=0, kernels={}, events=0,
                                 events_inside=0, gaps={})
        top = sorted(p["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(p["gaps"].items(), key=lambda kv: -kv[1])[:10]
        return dict(spans={k: list(v) for k, v in self.spans.items()}, calls_ms=list(self.calls_ms), profile=p,
                    busy_s=p["busy_s"], profile_window_s=p["window_s"],
                    breakdown=dict(device_ops=[[n[:120], v[1]] for n, v in top],
                                   idle_gaps=[[n, s] for n, s in gaps]))
