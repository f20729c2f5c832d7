"""Port parity, the debug images: io/raster.py against cv2.circle and
cv2.line (LINE_8), the port's draw_frame / draw_map (io/viewer.py) against
the reference's cv2 drawing on the same state (converted to numpy), the
PNG encoder (io/png.py write_png) against cv2.imread and the port's
decoder, and System.dump_debug_images.

Tolerances: every pixel equal, except inside the banner's box
(cv2.getTextSize of the banner string at the banner's origin), where the
reference writes with cv2's anti-aliased Hershey font and the port with a
stroke font of its own; the banner strings themselves are equal."""

import dataclasses
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax

from plslam_tpu.io import viewer as jviewer
from plslam_tpu_torch import load_settings
from plslam_tpu_torch.io import raster, viewer
from plslam_tpu_torch.io.png import read_png, write_png
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.system import System

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM3.yaml"
N_FRAMES = 3


def _half(s):
    return dataclasses.replace(s, width=320, height=240, fx=s.fx / 2, fy=s.fy / 2, cx=s.cx / 2, cy=s.cy / 2)


def _numpy_state(state):
    return jax.tree_util.tree_map(lambda t: t.numpy(), state)


@pytest.fixture(scope="module")
def run():
    """The mapper-less System after 3 frames at 320x240 (lines on): map
    points, map lines and keyframes to draw."""
    s = _half(load_settings(CFG))
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=0, settings=s)
    slam = System(s, use_local_mapping=False, use_loop_closing=False, device="cpu", max_kf=32, max_pts=4096)
    for i in range(N_FRAMES):
        g, d, t = seq.frame(i)
        assert slam.track_rgbd(g, d, t) is not None
    m = slam.state.m
    assert int(m.pt_valid.sum()) > 100 and int(m.ln_valid.sum()) > 5 and int(m.kf_valid.sum()) >= 1
    return dict(slam=slam, gray=g)


def _reference_frame(gray, state, monkeypatch):
    """The reference's draw_frame, with the cv2.putText call it makes
    recorded -> (image, putText's arguments)."""
    calls, put_text = [], cv2.putText

    def recording(img, *args):
        calls.append(args)
        return put_text(img, *args)

    monkeypatch.setattr(cv2, "putText", recording)
    img = jviewer.draw_frame(gray, state)
    monkeypatch.setattr(cv2, "putText", put_text)
    assert len(calls) == 1
    return img, calls[0]


def test_raster_equals_cv2():
    rng = np.random.default_rng(7)
    H, W = 60, 80
    for trial in range(900):
        want = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        got = want.copy()
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        kind = trial % 3
        if kind == 0:  # 1-px lines, endpoints inside, outside and far outside the image
            span = 100 if trial % 2 else 100000
            p0, p1 = (tuple(int(v) for v in rng.integers(-span, span, 2)) for _ in range(2))
            if trial % 5 == 0:
                p0, p1 = tuple(int(v) for v in rng.integers(0, 60, 2)), tuple(int(v) for v in rng.integers(0, 60, 2))
            cv2.line(want, p0, p1, color, 1)
            raster.line(got, p0, p1, color)
        else:  # filled and 1-px circles at the viewer's radii, across the borders
            c = tuple(int(v) for v in rng.integers(-8, 90, 2))
            r = int(rng.choice([1, 2, 4, 5]))
            cv2.circle(want, c, r, color, -1 if kind == 1 else 1)
            raster.circle(got, c[0], c[1], r, color, fill=kind == 1)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
    gray = np.zeros((H, W), np.float32)  # one channel: the synthetic frames' stripes
    want = gray.copy()
    cv2.line(want, (-5, 3), (70, 50), 235.0, 3)
    raster.thick_line(gray, (-5, 3), (70, 50), 235.0, 3)
    np.testing.assert_array_equal(gray, want)


def test_draw_frame_equals_reference_outside_the_banner(run, monkeypatch):
    slam, gray = run["slam"], run["gray"]
    H = gray.shape[0]
    for status in (1, 0, 2, 7):  # OK, NOT INITIALIZED, LOST, unknown
        state = slam.state._replace(status=torch.tensor(status, dtype=slam.state.status.dtype))
        want, (text, org, font, scale, _, thickness, _) = _reference_frame(gray, _numpy_state(state), monkeypatch)
        got = viewer.draw_frame(gray, state)
        n_tracked = int((slam.state.last.lm_idx >= 0).sum())
        assert text == viewer.banner_text(status, n_tracked) and org == (10, H - 12)
        (w, h), base = cv2.getTextSize(text, font, scale, thickness)
        box = np.zeros(gray.shape, bool)
        box[H - 12 - h:H - 12 + base + 1, 10:10 + w + 1] = True
        assert got.shape == want.shape == gray.shape + (3,) and got.dtype == np.uint8
        np.testing.assert_array_equal(got[~box], want[~box])
        plain = np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, -1)
        drawn = (got != plain).any(-1)
        assert drawn[box].sum() > 50  # the banner is written, inside its box
    assert n_tracked > 20 and (slam.state.last.valid & (slam.state.last.lm_idx < 0)).any()


def test_draw_map_equals_reference(run):
    slam = run["slam"]
    state = slam.state
    np.testing.assert_array_equal(viewer.draw_map(state), jviewer.draw_map(_numpy_state(state)))
    # a map line reaching far out of the view and the camera outside it:
    # both clipped as cv2 clips them
    m = state.m
    k = int(torch.nonzero(m.ln_valid)[0])
    far = state._replace(m=m._replace(ln_ew=m.ln_ew.clone().index_fill_(0, torch.tensor([k]), 40.0)),
                         last=state.last._replace(Tcw=state.last.Tcw.clone().index_fill_(1, torch.tensor([3]), 9.0)))
    got, want = viewer.draw_map(far, size=320), jviewer.draw_map(_numpy_state(far), size=320)
    np.testing.assert_array_equal(got, want)
    assert (got == [60, 60, 200]).all(-1).sum() > 100
    # an empty map: the background only
    empty = slam.tracker.init_state()
    np.testing.assert_array_equal(viewer.draw_map(empty), jviewer.draw_map(_numpy_state(empty)))


def test_write_png_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((7, 11), (240, 320), (5, 9, 3), (64, 48, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = tmp_path / "img.png"
        write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
        back = read_png(path)
        np.testing.assert_array_equal(back if img.ndim == 2 else back[..., ::-1], img)  # read_png: file order, RGB
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8), np.zeros(4, np.uint8)):
        with pytest.raises(ValueError):
            write_png(tmp_path / "bad.png", bad)


def test_dump_debug_images(run, tmp_path):
    slam, gray = run["slam"], run["gray"]
    slam.dump_debug_images(tmp_path / "a", gray=gray)
    frame, the_map = viewer.draw_frame(gray, slam.state), viewer.draw_map(slam.state)
    for name, img in (("frame.png", frame), ("map.png", the_map)):
        path = tmp_path / "a" / name
        np.testing.assert_array_equal(cv2.imread(str(path)), img)
        np.testing.assert_array_equal(read_png(path)[..., ::-1], img)
    slam.dump_debug_images(tmp_path / "b")
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["map.png"]
