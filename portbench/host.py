"""What the host did during a window, for telling slow runs from fast
ones: how much of the window the main thread spent on a CPU, how often it
was switched out against its will, the CPUs it may use and the one it was
on, the host's steal time (a virtual machine's CPUs taken by other
guests), its load and clock. Read from the process's own counters and
/proc (nothing is written); where a file is missing its keys are left
out. Printed on standard error with the run's other diagnostics."""

from __future__ import annotations

import os
import resource
import time


def _read(path: str) -> str | None:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    snap = dict(wall=time.perf_counter(), thread_cpu=time.thread_time(), process_cpu=time.process_time(),
                invol=ru.ru_nivcsw, vol=ru.ru_nvcsw)
    stat = _read("/proc/stat")
    if stat:
        f = [int(x) for x in stat.split("\n", 1)[0].split()[1:]]
        snap.update(host_total=sum(f[:8]), host_steal=f[7] if len(f) > 7 else 0, host_idle=f[3] + f[4])
    me = _read("/proc/self/stat")
    if me:
        snap["cpu"] = int(me.rsplit(")", 1)[1].split()[36])
    return snap


def _mhz() -> float | None:
    info = _read("/proc/cpuinfo")
    if not info:
        return None
    v = [float(line.split(":")[1]) for line in info.splitlines() if line.startswith("cpu MHz")]
    return sum(v) / len(v) if v else None


def window(a: dict, b: dict) -> dict:
    """The host's share of a window that ran from snapshot a to snapshot b."""
    dt = b["wall"] - a["wall"]
    out = dict(thread_cpu_share=(b["thread_cpu"] - a["thread_cpu"]) / dt,
               process_cpu_share=(b["process_cpu"] - a["process_cpu"]) / dt,
               involuntary_switches_per_s=(b["invol"] - a["invol"]) / dt,
               voluntary_switches_per_s=(b["vol"] - a["vol"]) / dt,
               cpus_allowed=len(os.sched_getaffinity(0)))
    if "host_total" in a and "host_total" in b and b["host_total"] > a["host_total"]:
        tot = b["host_total"] - a["host_total"]
        out.update(host_steal_share=(b["host_steal"] - a["host_steal"]) / tot,
                   host_busy_share=1.0 - (b["host_idle"] - a["host_idle"]) / tot)
    if "cpu" in a and "cpu" in b:
        out.update(cpu_at_start=a["cpu"], cpu_at_end=b["cpu"])
    load = _read("/proc/loadavg")
    if load:
        out["loadavg_1min"] = float(load.split()[0])
    mhz = _mhz()
    if mhz is not None:
        out["cpu_mhz_mean"] = mhz
    return out
