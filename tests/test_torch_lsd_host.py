"""Port parity, the host LSD behind `line_backend: "host"`: the port's
ops/lsd.py (native/lsd.cpp built by the port into .torch_build/) against
the reference's (the same source built by native/Makefile), then the
host-lines FrameBuilder -> Tracker.step on configs/TUM3.yaml scaled to
320x240, reference (JAX, CPU) against the port (PyTorch, CPU), and the
host-lines System through its pipelined dispatch.

Tolerances: the two libraries are one source built by one compiler with
one set of flags, so segments are equal bit for bit; the line front end
after them is PERF.md §2's: line validity and descriptors equal, geometry
within 1e-3; per step the status, keyframe flag and map-line count equal,
poses within 1e-3 m. The System's pipelined run is the same computation
as its synchronous one on the CPU: flags and poses equal."""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.config import load_settings as jload_settings
from plslam_tpu.features.frame import FrameBuilder as JFrameBuilder
from plslam_tpu.ops import lsd as jlsd
from plslam_tpu.pipeline.tracking import Tracker as JTracker
from plslam_tpu_torch import _build, load_settings
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.ops import lsd
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.system import System

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM3.yaml"
N_FRAMES = 5
CAPS = dict(max_kf=32, max_pts=4096)


def _half_host(s):
    return dataclasses.replace(s, width=320, height=240, fx=s.fx / 2, fy=s.fy / 2, cx=s.cx / 2, cy=s.cy / 2,
                               line_backend="host")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _reference_lsd_loaded():
    """The reference builds native/build/liblsd.so with make at first use,
    and another test process may be building it right now: retry a
    failed load until that build has finished."""
    for _ in range(30):
        if jlsd._native_lib() is not None:
            return
        jlsd._native_lib.cache_clear()
        time.sleep(1.0)
    pytest.fail("the reference's native LSD library does not load")


@pytest.fixture(scope="module")
def run():
    _reference_lsd_loaded()
    s, js = _half_host(load_settings(CFG)), _half_host(jload_settings(CFG))
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=0, settings=s)
    frames = [seq.frame(i) for i in range(N_FRAMES)]

    jb, jt = JFrameBuilder(js), JTracker(js, **CAPS)
    assert not jb.device_lines
    jst = jt.init_state()._replace(status=jnp.asarray(tracking.ST_UNINIT))
    ref, jframes = [], []
    for g, d, _ in frames:
        jf = jb(jnp.asarray(g), jnp.asarray(d), *jb.detect_lines(g))
        jframes.append(_np(jf))
        jst, out = jt.step(jst, jf)
        ref.append(_np(out))

    b, t = FrameBuilder(s, device="cpu"), tracking.Tracker(s, device="cpu", **CAPS)
    assert b.host_lines
    st, got, frames_t = t.init_state(), [], []
    for g, d, _ in frames:
        f = b(g, d, *b.detect_lines(g))
        st, out = t.step(st, f)
        got.append(out)
        frames_t.append(f)
    return dict(s=s, seq=seq, inputs=frames, ref=ref, got=got, jframes=jframes, frames=frames_t)


def test_detect_lines_equal_reference(run):
    rect = np.full((240, 320), 60.0, np.float32)
    rect[60:180, 80:240] = 200.0
    synth = run["inputs"][0][0]
    flat = np.full((120, 160), 128.0, np.float32)
    counts = {}
    for name, img in (("rect", rect), ("synthetic", synth), ("flat", flat)):
        for cap in (8, 32, 128):
            ref = jlsd.detect_lines_native(img, cap)
            for got in (lsd.detect_lines_native(img, cap), lsd.detect_lines_host(img, cap)):
                assert [a.dtype for a in got] == [np.float32, np.float32, np.bool_]
                assert [a.shape for a in got] == [(cap, 2), (cap, 2), (cap,)]
                for a, b in zip(got, ref):
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} capacity {cap}")
            counts[name, cap] = int(ref[2].sum())
    assert counts["rect", 128] == 4 and counts["flat", 128] == 0
    assert counts["synthetic", 8] == 8 and counts["synthetic", 128] > 8


def test_missing_compiler_raises(run, tmp_path, monkeypatch):
    """No compiler, no library: the host LSD raises and returns no empty
    set (the reference would fall back to OpenCV, then to no lines)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lsd", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    img = run["inputs"][0][0]
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        lsd.detect_lines_host(img)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        FrameBuilder(run["s"], device="cpu").detect_lines(img)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_host_lines_frame_fields(run):
    for jf, f in zip(run["jframes"], run["frames"]):
        np.testing.assert_array_equal(f.ln_valid.numpy(), jf.ln_valid)
        np.testing.assert_array_equal(f.ln_desc.numpy(), jf.ln_desc)
        for name in ("ln_sp", "ln_ep", "ln_line2d", "ln_depth_sp", "ln_depth_ep"):
            np.testing.assert_allclose(getattr(f, name).numpy(), getattr(jf, name), atol=1e-3, err_msg=name)
        assert jf.ln_valid.sum() > 5


def test_host_lines_steps_match_reference(run):
    for r, g in zip(run["ref"], run["got"]):
        assert bool(g.tracked) == bool(r.tracked)
        assert bool(g.new_kf) == bool(r.new_kf)
        assert int(g.telemetry[tracking.TEL_STATUS]) == int(r.telemetry[tracking.TEL_STATUS])
        assert int(g.telemetry[tracking.TEL_N_LN]) == int(r.telemetry[tracking.TEL_N_LN])
        np.testing.assert_allclose(g.Tcw.numpy(), r.Tcw, atol=1e-3)
    assert all(bool(r.tracked) for r in run["ref"])
    assert int(run["ref"][-1].telemetry[tracking.TEL_N_LN]) > 0


def test_system_host_lines_pipelined_equals_synchronous(run):
    """The host LSD's endpoints travel with the frame's images through the
    single dispatch, a chunk's staging and the drain: the pipelined run
    (two frames per chunk, the last frame drained singly) gives the
    synchronous run's flags and poses, and the step's map lines."""
    rows = {}
    for depth in (0, 2):
        slam = System(run["s"], use_local_mapping=False, use_loop_closing=False, pipeline_depth=depth,
                      device="cpu", **CAPS)
        rets = [slam.track_rgbd(g, d, t) for g, d, t in run["inputs"]]
        if depth:
            assert rets[:depth] == [None] * depth
        slam._flush_pending()
        rows[depth] = (slam.tracked_flags, slam._rel_poses, int(slam.state.m.n_ln), slam.telemetry_reads)
    assert rows[0][0] == rows[2][0] == [True] * N_FRAMES
    for a, b in zip(rows[0][1], rows[2][1]):
        np.testing.assert_array_equal(a, b)
    assert rows[0][2] == rows[2][2] == int(run["ref"][-1].telemetry[tracking.TEL_N_LN])
    assert rows[2][3] == N_FRAMES // 2 + N_FRAMES % 2  # two chunks and one drained frame
