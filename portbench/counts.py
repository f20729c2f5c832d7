"""The yardstick of the kernel metrics: the card's peaks, the least time a
count of bytes and operations needs, and what kernels B1 and B2 must move
and compute for one frame, from the frame's shapes.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), at the full
700 W power limit: HBM 3.35 TB/s, float32 outside the tensor cores 67
TFLOP/s (copied from chip_smoke.py's HBM_BYTES_PER_S and F32_FLOPS). A
card that is not in the table gets no roofline number. The bound is
chip_smoke.py's `bound_ms`: the larger of bytes over bandwidth and
operations over the float32 rate.
"""

from __future__ import annotations

PEAKS = {
    # torch.cuda.get_device_name() -> (HBM bytes/s, float32 FLOP/s)
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}
FAST_CELL = 32  # the FAST fallback cell: B1 computes each level's extent rounded up to it
PATCH_D = 39  # B2's window side


def bound_s(n_bytes: float, n_ops: float, kind: str):
    """(least seconds, "bytes" | "operations") on card `kind`, or None."""
    if kind not in PEAKS:
        return None
    bw, flops = PEAKS[kind]
    t_bytes, t_ops = n_bytes / bw, n_ops / flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def live_extents(level_shapes, height: int, width: int, cell: int = FAST_CELL):
    """Per-level (h, w) rounded up to the FAST cell, clipped to the plane."""
    return [(min(-(-h // cell) * cell, height), min(-(-w // cell) * cell, width)) for h, w in level_shapes]


def fast_blur(height: int, width: int, level_shapes) -> tuple[float, float]:
    """B1 on one frame's pyramid stack f32[L, H, W] -> (bytes, operations).
    Reads: each level's live extent with the 3-px halo past its right and
    bottom edges, once. Writes: the three f32[L, H, W] outputs (s_hi, s_lo,
    blur). Per live pixel: 16 ring differences; per threshold 16 x (2 sub,
    2 max, 2 add, 2 compare); 4 final selects; 28 blur multiply-adds:
    16 + 256 + 4 + 56 = 332 float32 operations (chip_smoke.py's count)."""
    ext = live_extents(level_shapes, height, width)
    live = sum(h * w for h, w in ext)
    read = sum(min(h + 3, height) * min(w + 3, width) for h, w in ext)
    L = len(level_shapes)
    return 4.0 * read + 3 * 4.0 * L * height * width, 332.0 * live


def patches(k: int, size: int = PATCH_D) -> tuple[float, float]:
    """B2 gathering k windows of size x size floats -> (bytes, operations):
    each window read once and written once, and the k int32 centres read
    (the bound chip_smoke.py keeps for B2); a copy computes nothing."""
    return 2 * 4.0 * k * size * size + 8.0 * k, 0.0
