"""fast_blur_roofline: kernel B1 (csrc/fast_blur.cu, FAST at two thresholds
and the blur over the frame's pyramid stack) as a share of its roofline:
the least time its bytes and operations need on this card
(portbench/counts.py) over its mean device time in the profiled
sub-window."""

from portbench import counts

KERNEL = "fast_kernel<true"  # B1's instantiation (B4 is fast_kernel<false, ...>)


def read(rec):
    p, s = rec.get("profile"), rec["shapes"]
    hits = [v for name, v in (p or {}).get("kernels", {}).items() if KERNEL in name]
    n, t = sum(v[0] for v in hits), sum(v[1] for v in hits)
    b = counts.bound_s(*counts.fast_blur(s["height"], s["width"], s["level_shapes"]), rec["device"]["kind"])
    if not n or t <= 0 or b is None:
        return None
    return 100.0 * b[0] / (t / n)
