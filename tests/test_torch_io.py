"""Port parity, the TUM reader: plslam_tpu_torch/io/png.py and io/tum.py
against cv2.imread and the reference's plslam_tpu/io/tum.py, on files that
the tests write (cv2.imwrite for the TUM layout; a hand-written encoder for
each of the five PNG row filters). Everything is compared exactly: a
decoder has no rounding of its own, and the gray conversion copies
OpenCV's integer arithmetic."""

import struct
import zlib

import numpy as np
import pytest
import torch

from plslam_tpu.io import tum as jtum
from plslam_tpu_torch.io import png, tum

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

# (bit depth, colour type, channels, numpy dtype)
FORMATS = {"gray8": (8, 0, 1, np.uint8), "rgb8": (8, 2, 3, np.uint8), "rgba8": (8, 6, 4, np.uint8),
           "gray16": (16, 0, 1, np.uint16)}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img, fmt, filt, interlace=0, ctype=None):
    """A PNG of img (file channel order; uint16 stored big-endian) whose
    every row uses row filter `filt` (PNG spec, section 9)."""
    depth, ct, ch, _ = FORMATS[fmt]
    H, W = img.shape[:2]
    raw = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = raw.reshape(H, -1).astype(np.int64)
    bpp = ch * depth // 8
    out = bytearray()
    for y in range(H):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if filt == 0:
            pred = np.zeros_like(cur)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = up
        elif filt == 3:
            pred = (left + up) >> 1
        else:
            pred = np.array([_paeth(a, b, c) for a, b, c in zip(left, up, upleft)])
        out.append(filt)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ct if ctype is None else ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


def _image(fmt, seed=0, H=13, W=17):
    _, _, ch, dt = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    hi = 65536 if dt == np.uint16 else 256
    img = rng.integers(0, hi, (H, W) if ch == 1 else (H, W, ch)).astype(dt)
    img[:3] = img[:3, :1]  # flat runs, and gray pixels in the colour images
    return img


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_row_filter_equals_cv2(tmp_path, fmt, filt):
    img = _image(fmt, seed=filt)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, fmt, filt))
    got = png.read_png(path)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, img)
    if fmt in ("rgb8", "rgba8"):  # OpenCV returns BGR(A)
        want = want[..., [2, 1, 0, 3][: got.shape[2]]]
    np.testing.assert_array_equal(got, want)
    if fmt != "gray16":
        np.testing.assert_array_equal(png.to_gray(got), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("case", ["interlaced", "palette", "bad_crc"])
def test_unsupported_file_raises(tmp_path, case):
    img = _image("rgb8")
    data = _encode(img, "rgb8", 0, interlace=int(case == "interlaced"), ctype=3 if case == "palette" else None)
    if case == "bad_crc":
        data = data[:40] + bytes([data[40] ^ 1]) + data[41:]
    path = tmp_path / "u.png"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        png.read_png(path)


def test_to_gray_rejects_16_bit():
    with pytest.raises(ValueError):
        png.to_gray(np.zeros((4, 4), np.uint16))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A TUM-layout sequence written with cv2.imwrite: 8-bit RGB frames,
    16-bit depth (x5000), an association file and ground truth."""
    from plslam_tpu_torch.io.synthetic import SyntheticSequence

    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    seq = SyntheticSequence(n_frames=3, height=240, width=320, seed=2)
    rng = np.random.default_rng(0)
    assoc, gt = ["# t_rgb rgb t_depth depth"], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(3):
        g, d, t = seq.frame(i)
        rgb = np.clip(g[..., None] + rng.normal(0, 12, g.shape + (3,)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / "rgb" / f"{t:.6f}.png"), rgb)
        cv2.imwrite(str(root / "depth" / f"{t:.6f}.png"), np.round(d * 5000).astype(np.uint16))
        assoc.append(f"{t:.6f} rgb/{t:.6f}.png {t + 0.001:.6f} depth/{t:.6f}.png")
        Twc = seq.gt_pose_wc(i)
        from scipy.spatial.transform import Rotation

        q = Rotation.from_matrix(Twc[:3, :3]).as_quat()
        gt.append(f"{t:.6f} " + " ".join(f"{v:.7f}" for v in list(Twc[:3, 3]) + list(q)))
    assoc.append("malformed line")
    (root / "assoc.txt").write_text("\n".join(assoc) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return root, seq


def test_load_associations_equals_reference(tum_dir):
    root, _ = tum_dir
    got = tum.load_associations(root / "assoc.txt")
    assert got == jtum.load_associations(root / "assoc.txt") and len(got) == 3


def test_tum_sequence_equals_reference(tum_dir):
    root, _ = tum_dir
    port, ref = tum.TumSequence(root, root / "assoc.txt"), jtum.TumSequence(root, root / "assoc.txt")
    assert port.n_frames == ref.n_frames == 3
    for i in range(3):
        g, d, t = port.frame(i)
        jg, jd, jt = ref.frame(i)
        assert t == jt == port.timestamp(i)
        assert g.dtype == jg.dtype == np.float32 and d.dtype == jd.dtype == np.float32
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(d, jd)
    with pytest.raises(FileNotFoundError):
        tum.TumSequence(root / "rgb", root / "assoc.txt").frame(0)


def test_load_groundtruth_equals_reference(tum_dir):
    root, _ = tum_dir
    got, want = tum.load_groundtruth(root / "groundtruth.txt"), jtum.load_groundtruth(root / "groundtruth.txt")
    assert len(got) == len(want) == 3
    for (t, T), (jt, jT) in zip(got, want):
        assert t == jt
        np.testing.assert_array_equal(T, jT)


def test_rgbd_tum_example_on_tum_files(tum_dir, tmp_path):
    """python -m plslam_tpu_torch.examples.rgbd_tum --settings --sequence
    --assoc --cpu on the written sequence: every frame tracked, ATE
    against its ground truth file."""
    from plslam_tpu_torch.examples import rgbd_tum

    root, seq = tum_dir
    s = seq.settings
    (tmp_path / "cam.yaml").write_text("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in {
        "Camera.fx": s.fx, "Camera.fy": s.fy, "Camera.cx": s.cx, "Camera.cy": s.cy, "Camera.k1": 0, "Camera.k2": 0,
        "Camera.p1": 0, "Camera.p2": 0, "Camera.k3": 0, "Camera.width": s.width, "Camera.height": s.height,
        "Camera.fps": s.fps, "Camera.bf": s.bf, "Camera.RGB": 1, "ThDepth": s.th_depth, "DepthMapFactor": 5000.0,
        "UseLines": 0, "UseLoopClosing": 0, "ORBextractor.nFeatures": s.n_features}.items()))
    res = rgbd_tum.main(["--settings", str(tmp_path / "cam.yaml"), "--sequence", str(root), "--assoc",
                         str(root / "assoc.txt"), "--cpu", "--no-ba", "--out", str(tmp_path / "traj.txt")])
    assert res["tracked"] == res["frames"] == 3
    assert res["ate_m"] is not None and res["ate_m"] < 0.02
