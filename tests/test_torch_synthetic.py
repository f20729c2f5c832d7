"""Port parity, the synthetic sequence: the port's numpy renderer
(plslam_tpu_torch/io/synthetic.py) against the reference's, which draws
with OpenCV (plslam_tpu/io/synthetic.py), from the same seed.

Tolerance 1e-3 gray levels (depth in metres): the stripes are the same
pixels (the port copies cv2.line's rasterisation), and the texture blur
sums float64 taps where OpenCV sums float32 ones, so texels differ by
float32 rounding only (~1e-4 of a 0..255 range)."""

from pathlib import Path

import numpy as np
import pytest

from plslam_tpu.config import load_settings as jload_settings
from plslam_tpu.io import synthetic as jsynthetic
from plslam_tpu_torch import load_settings
from plslam_tpu_torch.io import synthetic

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM1.yaml"
FRAMES = (0, 10, 29)
TOL = 1e-3


@pytest.fixture(scope="module", params=["640x480", "320x240"])
def pair(request):
    """(port, reference) sequences, seed 0: 640x480 through the shipped TUM1
    calibration (the frames the smoke runs track, lens distortion
    included), 320x240 through the default pinhole camera."""
    kw = dict(n_frames=30, seed=0)
    if request.param == "640x480":
        return (synthetic.SyntheticSequence(settings=load_settings(CFG), **kw),
                jsynthetic.SyntheticSequence(settings=jload_settings(CFG), **kw))
    return (synthetic.SyntheticSequence(height=240, width=320, **kw),
            jsynthetic.SyntheticSequence(height=240, width=320, **kw))


@pytest.mark.parametrize("i", FRAMES)
def test_frame_equals_reference(pair, i):
    port, ref = pair
    g, d, ts = port.frame(i)
    jg, jd, jts = ref.frame(i)
    assert g.shape == jg.shape == (port.height, port.width) and g.dtype == jg.dtype == np.float32
    assert ts == jts
    assert float(np.abs(g - jg).max()) <= TOL
    assert float(np.abs(d - jd).max()) <= TOL
    np.testing.assert_array_equal(port.gt_pose_wc(i), ref.gt_pose_wc(i))


def test_texture_equals_reference(pair):
    port, ref = pair
    assert port.tex.shape == ref.tex.shape == (2048, 2048)
    assert float(np.abs(port.tex - ref.tex).max()) <= TOL
    # the stripes (values 20 and 235, far from the blurred 40..210 range)
    # cover exactly the same pixels
    for v in (20.0, 235.0):
        np.testing.assert_array_equal(port.tex == v, ref.tex == v)


def test_draw_line_equals_cv2():
    """The rasteriser alone against cv2.line on clipped and unclipped
    segments of every thickness the texture draws."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for _ in range(300):
        w, h = (int(v) for v in rng.integers(16, 64, 2))
        p0 = tuple(int(v) for v in rng.integers(-w, 2 * w, 2))
        p1 = tuple(int(v) for v in rng.integers(-h, 2 * h, 2))
        t = int(rng.integers(2, 5))
        want = np.zeros((h, w), np.float32)
        cv2.line(want, p0, p1, 235.0, thickness=t)
        got = np.zeros((h, w), np.float32)
        synthetic._draw_line(got, p0, p1, 235.0, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{(w, h)} {p0} {p1} thickness {t}")


@pytest.fixture(scope="module")
def circuits():
    """The loop-closure fixtures' sequences (tests/test_loop_e2e.py): port and
    reference, 320x240 at 10 fps with the depth-noise field."""
    kw = dict(n_frames=190, height=240, width=320, seed=0, fps=10.0, depth_noise=0.03)
    return {tr: (synthetic.SyntheticSequence(trajectory=tr, **kw), jsynthetic.SyntheticSequence(trajectory=tr, **kw))
            for tr in ("loop", "rect")}


@pytest.mark.parametrize("i", (0, 95, 189))
@pytest.mark.parametrize("trajectory", ("loop", "rect"))
def test_circuit_frame_equals_reference(circuits, trajectory, i):
    """The circuits' frames, patch layouts and noisy depth equal the
    reference's (the start, the far side and the dwell at the start)."""
    port, ref = circuits[trajectory]
    assert port.patches == ref.patches
    g, d, ts = port.frame(i)
    jg, jd, jts = ref.frame(i)
    assert ts == jts
    assert float(np.abs(g - jg).max()) <= TOL
    assert float(np.abs(d - jd).max()) <= TOL
    np.testing.assert_array_equal(port.gt_pose_wc(i), ref.gt_pose_wc(i))
