"""patches_roofline: kernel B2 (csrc/patches.cu, the 39x39 window of each
of the frame's keypoint slots from the blurred stack) as a share of its
roofline: the least time its bytes need on this card (portbench/counts.py)
over its mean device time in the profiled sub-window."""

from portbench import counts

KERNEL = "gather_patches_kernel"


def read(rec):
    p, s = rec.get("profile"), rec["shapes"]
    hits = [v for name, v in (p or {}).get("kernels", {}).items() if KERNEL in name]
    n, t = sum(v[0] for v in hits), sum(v[1] for v in hits)
    b = counts.bound_s(*counts.patches(s["patches"]), rec["device"]["kind"])
    if not n or t <= 0 or b is None:
        return None
    return 100.0 * b[0] / (t / n)
