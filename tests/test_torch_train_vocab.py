"""Port parity, vocabulary training (loopclosing/train_vocab.py): the
binary k-medians and the tree bit for bit against the reference's on
seeded descriptors (the empty-cluster reseed included), the synthetic
harvest (3 scenes x 1 frame, 320x240, the port's ORB on the CPU against
the reference's JAX ORB) and the TUM harvest on a tiny sequence folder
the test writes, and `main`'s codebook file.

Tolerances: k-medians and the tree are the reference's numpy code on the
same bits: equal. A harvest runs ORB, whose descriptor bits may flip
where a BRIEF compare sits on a near-tie (tests/test_torch_orb.py): the
same descriptor count, bits equal on >= 99.5%; the number of descriptors
that differ is stated in the assertion (0 of 999 on the synthetic harvest
when this was written). The committed reference corpus (tests/data/vocab_corpus_ref.npz,
which chip_smoke.py's vocab phase holds the card to) holds these frames'
reference descriptors."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from plslam_tpu.loopclosing import train_vocab as jtv
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.loopclosing import train_vocab as tv

torch.set_num_threads(2)

CORPUS = Path(__file__).resolve().parent / "data" / "vocab_corpus_ref.npz"


def _bits_equal(a, b):
    return (np.unpackbits(a, -1) == np.unpackbits(b, -1)).mean()


@pytest.fixture(scope="module")
def harvests(tmp_path_factory):
    """The reference's and the port's harvests: 3 synthetic scenes x 1
    frame, and a TUM folder of two sequences (3 and 2 listed frames, one
    listed file missing) at 320x240, as cv2.imwrite writes RGB PNGs."""
    tum = tmp_path_factory.mktemp("tum")
    for name, seed, n in (("seq_a", 7, 3), ("seq_b", 8, 2)):
        (tum / name / "rgb").mkdir(parents=True)
        seq = SyntheticSequence(n_frames=n, height=240, width=320, seed=seed)
        lines = ["# color images"]
        for i in range(n):
            g = np.clip(seq.frame(i)[0], 0, 255).astype(np.uint8)
            bgr = np.stack([g, np.roll(g, 3, 1), 255 - g], -1)  # colour, so the gray rule matters
            cv2.imwrite(str(tum / name / "rgb" / f"{i}.png"), bgr)
            lines.append(f"{i * 0.1:.6f} rgb/{i}.png")
        lines.append("9.000000 rgb/missing.png")
        (tum / name / "rgb.txt").write_text("\n".join(lines) + "\n")
    return dict(
        ref=jtv.harvest_descriptors(n_seeds=3, frames_per_seed=1),
        got=tv.harvest_descriptors(n_seeds=3, frames_per_seed=1, device="cpu"),
        ref_tum=jtv.harvest_descriptors_tum(tum),
        got_tum=tv.harvest_descriptors_tum(tum, device="cpu"),
        tum=tum,
    )


def test_kmedians_equal_reference():
    for seed, (n, k) in enumerate([(500, 10), (57, 10), (12, 10), (3000, 7)]):
        bits = np.random.default_rng(seed).integers(0, 2, (n, 256), dtype=np.uint8)
        got = tv.kmedians(bits, k, np.random.default_rng(100 + seed))
        ref = jtv.kmedians(bits, k, np.random.default_rng(100 + seed))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    # three distinct rows for five centres: duplicate centres leave clusters
    # empty, and each is reseeded from the farthest point
    rows = np.random.default_rng(9).integers(0, 2, (3, 256), dtype=np.uint8)
    bits = rows[np.random.default_rng(10).integers(0, 3, 60)]
    got = tv.kmedians(bits, 5, np.random.default_rng(11))
    ref = jtv.kmedians(bits, 5, np.random.default_rng(11))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(got[1])) < 5  # some cluster stayed empty: the reseed ran


def test_train_tree_equal_reference():
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 256, (2500, 32), dtype=np.uint8)
    desc[1000:1400] = desc[:400] ^ rng.integers(0, 2, (400, 32), dtype=np.uint8)  # near-duplicates
    np.testing.assert_array_equal(tv._unpack(desc), jtv._unpack(desc))
    np.testing.assert_array_equal(tv._pack(tv._unpack(desc)), desc)
    for kw in (dict(), dict(k=4, depth=3, seed=1, min_node=8)):
        got, ref = tv.train_tree(desc, **kw), jtv.train_tree(desc, **kw)
        assert got.dtype == np.uint8 and got.shape[1] == 32
        np.testing.assert_array_equal(got, ref)


def test_harvest_equals_reference(harvests):
    ref, got = harvests["ref"], harvests["got"]
    assert got.dtype == np.uint8 and got.shape == ref.shape and len(ref) > 500
    n_diff = int((got != ref).any(1).sum())
    assert _bits_equal(got, ref) >= 0.995, f"{n_diff} of {len(ref)} descriptors differ"
    # the committed reference corpus holds these frames: scene s, frame 0
    corpus = np.load(CORPUS)
    starts = np.concatenate([[0], np.cumsum(corpus["per_frame"])])
    np.testing.assert_array_equal(np.concatenate([corpus["desc"][starts[8 * s]:starts[8 * s + 1]] for s in range(3)]),
                                  ref)


def test_harvest_tum_equals_reference(harvests):
    ref, got = harvests["ref_tum"], harvests["got_tum"]
    assert got.dtype == np.uint8 and got.shape == ref.shape and len(ref) > 500
    n_diff = int((got != ref).any(1).sum())
    assert _bits_equal(got, ref) >= 0.995, f"{n_diff} of {len(ref)} descriptors differ"
    with pytest.raises(FileNotFoundError):
        tv.harvest_descriptors_tum(harvests["tum"] / "seq_a", device="cpu")


def test_main_writes_the_codebook(tmp_path, monkeypatch):
    desc = np.random.default_rng(2).integers(0, 256, (400, 32), dtype=np.uint8)
    monkeypatch.setattr(tv, "harvest_descriptors", lambda device: desc)
    out = tmp_path / "voc.npz"
    tv.main(["--out", str(out), "--cpu"])
    f = np.load(out)
    assert sorted(f.files) == sorted(np.load(tv.ASSET).files) == ["depth", "k", "n_train", "words"]
    np.testing.assert_array_equal(f["words"], jtv.train_tree(desc))
    assert int(f["n_train"]) == 400 and int(f["k"]) == 10 and int(f["depth"]) == 4
