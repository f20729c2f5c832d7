"""device_idle_pct: share of the profiled sub-window in which no kernel,
copy or set ran on the card (100 x (1 - busy / window))."""


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
