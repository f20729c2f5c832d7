"""Port parity, the point+line slice: FrameBuilder -> Tracker.step on a
synthetic TUM3 sequence (configs/TUM3.yaml: lines on, device LSD, scaled to
320x240), reference (JAX, CPU) against the port (PyTorch, CPU).

Tolerances: the front ends agree to float32 rounding, so statuses,
keyframe flags and the number of map lines must be equal and poses agree
within 1e-3 m; from one shared state and frame (with live map lines) the
step agrees to 1e-4 in poses and line geometry, exactly in every flag,
index and counter."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.config import load_settings as jload_settings
from plslam_tpu.features.frame import FrameBuilder as JFrameBuilder
from plslam_tpu.pipeline.tracking import Tracker as JTracker
from plslam_tpu_torch import convert, load_settings
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.pipeline import tracking

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM3.yaml"
N_FRAMES, MID = 5, 3  # frame MID inserts a keyframe with new map lines
CAPS = dict(max_kf=32, max_pts=4096)


def _half(s):
    return dataclasses.replace(s, width=320, height=240, fx=s.fx / 2, fy=s.fy / 2, cx=s.cx / 2, cy=s.cy / 2)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def run():
    s, js = _half(load_settings(CFG)), _half(jload_settings(CFG))
    assert s.use_lines and s.line_backend == "device"
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=0, settings=s)
    frames = [seq.frame(i) for i in range(N_FRAMES)]

    jb, jt = JFrameBuilder(js), JTracker(js, **CAPS)
    jst = jt.init_state()._replace(status=jnp.asarray(tracking.ST_UNINIT))
    ref, jframes, mid_state = [], [], None
    for i, (g, d, _) in enumerate(frames):
        jf = jb(jnp.asarray(g), jnp.asarray(d))
        if i == MID:
            mid_state = _np(jst)
        jframes.append(_np(jf))
        jst, out = jt.step(jst, jf)
        ref.append(_np(out))

    b, t = FrameBuilder(s, device="cpu"), tracking.Tracker(s, device="cpu", **CAPS)
    st, got, frames_t = t.init_state(), [], []
    for g, d, _ in frames:
        f = b(g, d)
        st, out = t.step(st, f)
        got.append(out)
        frames_t.append(f)
    return dict(s=s, ref=ref, got=got, jt=jt, jst=jst, t=t, st=st,
                jframes=jframes, frames=frames_t, mid_state=mid_state, inputs=frames)


def test_status_keyframes_and_map_lines_per_frame(run):
    for r, g in zip(run["ref"], run["got"]):
        assert bool(g.tracked) == bool(r.tracked)
        assert bool(g.new_kf) == bool(r.new_kf)
        assert int(g.telemetry[tracking.TEL_STATUS]) == int(r.telemetry[tracking.TEL_STATUS])
        assert int(g.telemetry[tracking.TEL_N_LN]) == int(r.telemetry[tracking.TEL_N_LN])
        np.testing.assert_allclose(g.Tcw.numpy(), r.Tcw, atol=1e-3)
    assert all(bool(r.tracked) for r in run["ref"])
    assert int(run["ref"][-1].telemetry[tracking.TEL_N_LN]) > 0
    assert sum(bool(r.new_kf) for r in run["ref"][1:]) >= 1


def test_frame_line_fields(run):
    for jf, f in zip(run["jframes"], run["frames"]):
        np.testing.assert_array_equal(f.ln_valid.numpy(), jf.ln_valid)
        np.testing.assert_array_equal(f.ln_desc.numpy(), jf.ln_desc)
        np.testing.assert_array_equal(f.ln_pm1.numpy(), jf.ln_pm1.astype(np.float32))
        for name in ("ln_sp", "ln_ep", "ln_depth_sp", "ln_depth_ep"):
            np.testing.assert_allclose(getattr(f, name).numpy(), getattr(jf, name), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(f.ln_line2d.numpy(), jf.ln_line2d, atol=1e-3)
        ok = jf.ln_valid
        np.testing.assert_allclose(f.ln_angle.numpy()[ok], jf.ln_angle[ok], atol=1e-4)
        assert ok.sum() > 20 and (jf.ln_depth_sp[ok] > 0).mean() > 0.5


_LINE_MAP_FIELDS = ("ln_valid", "ln_desc", "ln_nobs", "ln_visible", "ln_found", "ln_ref_kf", "ln_first_kf",
                    "ln_first_seq", "kf_ln_idx", "kf_ln_valid", "kf_ln_desc", "n_ln")
_LINE_MAP_GEOMETRY = ("ln_sw", "ln_ew", "ln_normal", "ln_dist", "kf_ln_obs", "kf_ln_sp", "kf_ln_ep")


def test_single_step_from_shared_state_with_live_lines(run):
    """Both trackers take frame MID from the reference's converted state:
    map lines from two keyframes, their counters, and a keyframe insert
    in this step that adds map lines and binds matched ones."""
    d, jf = run["mid_state"], run["jframes"][MID]
    assert int(d.m.n_ln) > 0 and d.m.kf_ln_valid.any()
    jst = jax.tree_util.tree_map(jnp.asarray, d)
    jst = jst._replace(status=jnp.asarray(int(d.status)))  # weakly typed, as the step leaves it
    jst2, jout = run["jt"].step(jst, jax.tree_util.tree_map(jnp.asarray, jf))
    jst2, jout = _np(jst2), _np(jout)
    st2, out = run["t"].step(convert.track_state_from_numpy(d, "cpu"), convert.frame_from_numpy(jf, "cpu"))
    assert bool(jout.new_kf) and int(jst2.m.n_ln) > int(d.m.n_ln)
    np.testing.assert_allclose(out.Tcw.numpy(), jout.Tcw, atol=1e-4)
    for name in ("tracked", "new_kf", "kf_id", "ref_kf", "n_inliers", "n_matches"):
        assert int(getattr(out, name)) == int(getattr(jout, name)), name
    for name in _LINE_MAP_FIELDS + ("pt_valid", "kf_lm_idx", "pt_nobs", "n_pt", "n_kf"):
        np.testing.assert_array_equal(getattr(st2.m, name).numpy(), getattr(jst2.m, name), err_msg=name)
    for name in _LINE_MAP_GEOMETRY:
        np.testing.assert_allclose(getattr(st2.m, name).numpy(), getattr(jst2.m, name), atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(st2.last.lm_idx.numpy(), jst2.last.lm_idx)
    # some keylines bound to existing map lines: their nobs grew
    assert (jst2.m.ln_nobs > d.m.ln_nobs)[d.m.ln_valid].any()


def test_project_lines_matches_reference(run):
    d = run["mid_state"]
    T = run["ref"][MID].Tcw
    ref = [np.asarray(a) for a in run["jt"]._project_lines(jax.tree_util.tree_map(jnp.asarray, d.m), jnp.asarray(T))]
    got = [a.numpy() for a in run["t"]._project_lines(convert.map_state_from_numpy(d.m, "cpu"), torch.from_numpy(T))]
    np.testing.assert_array_equal(got[2], ref[2])
    vis = ref[2]
    assert vis.sum() > 10
    np.testing.assert_allclose(got[0][vis], ref[0][vis], atol=1e-3)
    np.testing.assert_allclose(got[1][vis], ref[1][vis], atol=1e-4)


def test_convert_carries_live_line_fields(run):
    d = run["mid_state"]
    st = convert.track_state_from_numpy(d, "cpu")
    for name in _LINE_MAP_FIELDS + _LINE_MAP_GEOMETRY:
        np.testing.assert_array_equal(getattr(st.m, name).numpy(), getattr(d.m, name), err_msg=name)
    f = convert.frame_from_numpy(run["jframes"][MID], "cpu")
    np.testing.assert_array_equal(f.ln_pm1.numpy(), run["jframes"][MID].ln_pm1.astype(np.float32))
    assert f.ln_pm1.dtype == torch.float32 and f.ln_valid.any()


def test_host_line_backend_is_not_ported(run):
    """The host line backend is ported: a host-lines FrameBuilder builds
    frame MID from the host LSD's endpoints (ops/lsd.py) with the device
    builder's point fields, keylines where the host LSD found segments, and
    refuses a build without endpoints (tests/test_torch_lsd_host.py holds
    it to the reference)."""
    s = dataclasses.replace(run["s"], line_backend="host")
    b = FrameBuilder(s, device="cpu")
    g, d = (torch.from_numpy(a) for a in run["inputs"][MID][:2])
    sp, ep, valid = b.detect_lines(g.numpy())
    assert valid.sum() > 5 and valid[: valid.sum()].all()
    f = b.build(g, d, torch.from_numpy(sp), torch.from_numpy(ep), torch.from_numpy(valid))
    np.testing.assert_array_equal(f.ln_valid.numpy(), valid)
    dev = run["frames"][MID]
    for name in ("uvr", "desc", "valid", "octave"):
        assert torch.equal(getattr(f, name), getattr(dev, name)), name
    assert torch.equal(b(g.numpy(), d.numpy()).ln_desc, f.ln_desc)  # __call__ detects the lines itself
    with pytest.raises(ValueError, match="host"):
        b.build(g, d)
    with pytest.raises(ValueError, match="line_backend"):
        FrameBuilder(dataclasses.replace(s, line_backend="gpu"), device="cpu")
