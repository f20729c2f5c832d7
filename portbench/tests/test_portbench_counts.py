"""The yardstick's arithmetic: peaks, bounds, the kernels' byte and
operation counts, the device-busy union, and the readers built on them."""

import importlib.util
from pathlib import Path

import pytest

from portbench import counts, trace
from portbench.reference import frontend

METRICS = Path(__file__).resolve().parents[1] / "metrics"
H100 = "NVIDIA H100 80GB HBM3"
SETTINGS = dict(height=480, width=640, n_levels=8, scale_factor=1.2, n_features=1000)


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_bound_is_the_larger_of_bytes_and_operations():
    t, by = counts.bound_s(3.35e12, 1.0, H100)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = counts.bound_s(1.0, 67e12 * 2, H100)
    assert by == "operations" and t == pytest.approx(2.0)
    assert counts.bound_s(1.0, 1.0, "some other card") is None


def test_fast_blur_counts_at_640x480():
    _, shapes = frontend.level_budget(SETTINGS)
    n_bytes, n_ops = counts.fast_blur(480, 640, shapes)
    ext = counts.live_extents(shapes, 480, 640)
    assert ext[0] == (480, 640)
    assert all(h % 32 == 0 or h == 480 for h, _ in ext)
    # three f32[8, 480, 640] writes and at least one read of each live pixel
    live = sum(h * w for h, w in ext)
    assert n_bytes >= 3 * 4 * 8 * 480 * 640 + 4 * live
    assert n_ops == 332 * live
    # ~34 MB: ~10 us at 3.35 TB/s, bound by bytes
    t, by = counts.bound_s(n_bytes, n_ops, H100)
    assert by == "bytes" and 9e-6 < t < 13e-6


def test_patches_counts():
    n_bytes, n_ops = counts.patches(1000)
    assert n_bytes == 2 * 4 * 1000 * 39 * 39 + 8 * 1000 and n_ops == 0
    t, by = counts.bound_s(n_bytes, n_ops, H100)
    assert by == "bytes" and t == pytest.approx(n_bytes / 3.35e12)


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 41)]
    assert trace.busy_ns(iv) == 15 + 11 + 1
    assert trace.merged(iv) == [[0, 15], [20, 31], [40, 41]]


def _rec(kernels, frames=10, window_s=1.0, busy_s=0.25):
    per_level, shapes = frontend.level_budget(SETTINGS)
    return dict(frames=frames, window_s=window_s, shapes=dict(height=480, width=640, levels=8,
                                                              level_shapes=shapes, patches=sum(per_level)),
                device=dict(kind=H100),
                profile=dict(window_s=window_s, frames=frames, busy_s=busy_s, launches=3000, kernels=kernels))


def test_roofline_readers():
    per_level, shapes = frontend.level_budget(SETTINGS)
    b1, _ = counts.bound_s(*counts.fast_blur(480, 640, shapes), H100)
    b2, _ = counts.bound_s(*counts.patches(sum(per_level)), H100)
    rec = _rec({"void fast_kernel<true, true>(CUtensorMap, float const*)": [10, 10 * 3 * b1],
                "void fast_kernel<false, true>(CUtensorMap, float const*)": [5, 1.0],
                "gather_patches_kernel(float const*, int2 const*, float*, Window, int)": [10, 10 * 2 * b2]})
    assert reader("fast_blur_roofline")(rec) == pytest.approx(100 / 3)
    assert reader("patches_roofline")(rec) == pytest.approx(50.0)
    assert reader("device_idle_pct")(rec) == pytest.approx(75.0)
    assert reader("launches_per_frame")(rec) == pytest.approx(300.0)
    # a kernel that is not in the trace gives no number, not 0
    assert reader("fast_blur_roofline")(_rec({})) is None
    rec["device"]["kind"] = "some other card"
    assert reader("patches_roofline")(rec) is None


def test_span_readers():
    rec = dict(frames=100, window_s=10.0,
               spans={"dispatch": [(0, 2_000_000)] * 50, "chain": [(0, 300_000_000), (0, 500_000_000)]},
               calls_ms=[float(i) for i in range(1, 101)])
    assert reader("dispatch_ms_per_frame")(rec) == pytest.approx(1.0)
    assert reader("chain_ms")(rec) == pytest.approx(400.0)
    assert reader("chains_per_100_frames")(rec) == pytest.approx(2.0)
    assert reader("call_ms_p95.system")(rec) == pytest.approx(95.05)
    assert reader("frames_per_s")(rec) == pytest.approx(10.0)
    assert reader("chain_ms")(dict(rec, spans={"dispatch": []})) is None
