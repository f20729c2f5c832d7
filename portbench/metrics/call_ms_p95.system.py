"""call_ms_p95.system: the 95th percentile of the host time of each call
into the entry (one System.track_rgbd), over every call of the traced
window."""

import statistics


def read(rec):
    v = rec.get("calls_ms", [])
    return statistics.quantiles(v, n=100, method="inclusive")[94] if len(v) >= 20 else None
