"""Port parity, ORB front end part 2 and point matching: the whole
extractor on a synthetic TUM1 frame (keypoints, octaves and validity equal;
descriptor bits equal on >= 99.5% of valid slots: the blurred patches come
from float32 products summed in another order, so a compare that sits on a
near-tie may flip), steered BRIEF bit-exact on shared patches, and the
tie rules the reference gets from jax.lax.top_k / argmin."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.config import load_settings as jload_settings
from plslam_tpu.features.orb import ORBExtractor as JORB
from plslam_tpu.matching import points as jmatch
from plslam_tpu.ops import brief as jbrief
from plslam_tpu.ops import orientation as jorient
from plslam_tpu.ops import select as jselect
from plslam_tpu_torch import load_settings
from plslam_tpu_torch.features.orb import ORBExtractor
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.matching import points as match
from plslam_tpu_torch.ops import brief, orientation, select

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM1.yaml"


def _half(s):
    return dataclasses.replace(s, width=320, height=240, fx=s.fx / 2, fy=s.fy / 2, cx=s.cx / 2, cy=s.cy / 2)


@pytest.fixture(scope="module")
def extracted():
    s, js = _half(load_settings(CFG)), _half(jload_settings(CFG))
    gray, _, _ = SyntheticSequence(n_frames=1, seed=0, settings=s).frame(0)
    kw = lambda x: dict(n_features=x.n_features, scale_factor=x.scale_factor, n_levels=x.n_levels,  # noqa: E731
                        ini_th_fast=x.ini_th_fast, min_th_fast=x.min_th_fast)
    ref = JORB(js.height, js.width, **kw(js))(jnp.asarray(gray))
    got = ORBExtractor(s.height, s.width, **kw(s))(torch.from_numpy(gray))
    return {k: np.asarray(v) for k, v in ref._asdict().items()}, {k: v.numpy() for k, v in got._asdict().items()}


def test_keypoints_equal(extracted):
    ref, got = extracted
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["octave"], ref["octave"])
    np.testing.assert_allclose(got["uv"], ref["uv"], atol=1e-3)
    np.testing.assert_allclose(got["response"], ref["response"], rtol=1e-5, atol=1e-3)
    assert ref["valid"].sum() > 500


def test_angles_and_descriptors(extracted):
    ref, got = extracted
    v = ref["valid"]
    d_ang = np.angle(np.exp(1j * (got["angle"][v] - ref["angle"][v])))  # modulo 2 pi
    assert np.abs(d_ang).max() < 1e-3
    bits_equal = np.unpackbits(got["desc"][v], -1) == np.unpackbits(ref["desc"][v], -1)
    assert bits_equal.mean() >= 0.995, bits_equal.mean()


def test_steered_brief_bit_exact_on_shared_patches():
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 255, (200, brief.PATCH_D, brief.PATCH_D)).astype(np.float32)
    p[:20] = np.round(p[:20])  # many exact pixel ties
    ang = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    ref = np.asarray(jbrief.steered_brief(jnp.asarray(p), jnp.asarray(ang)))
    np.testing.assert_array_equal(brief.steered_brief(torch.from_numpy(p), torch.from_numpy(ang)).numpy(), ref)
    # moments of uniform noise are small against their terms, so the
    # angle carries the float32 summation-order difference amplified
    ref_a = np.asarray(jorient.ic_angle(jnp.asarray(p)))
    np.testing.assert_allclose(orientation.ic_angle(torch.from_numpy(p)).numpy(), ref_a, atol=1e-3)


def test_pattern_unpack_and_hamming():
    for a, b in zip(brief.pattern(), jbrief.pattern()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    da = rng.integers(0, 256, (50, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (70, 32), dtype=np.uint8)
    pa, pb = brief.unpack_bits_pm1(torch.from_numpy(da)), brief.unpack_bits_pm1(torch.from_numpy(db))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(jbrief.unpack_bits_pm1(jnp.asarray(da)), np.float32))
    ham = (np.unpackbits(da[:, None] ^ db[None], -1)).sum(-1)
    np.testing.assert_array_equal(match.hamming_matrix(pa, pb).numpy(), ham)


def test_topk_ties_lower_index_first():
    """Equal cell maxima (and the zero cells) come out lower index first,
    as jax.lax.top_k orders them; within a cell the first maximum wins."""
    score = np.zeros((2, 64, 96), np.float32)
    score[0, ::8, ::8] = 5.0  # 4 equal corners per 16x16 cell, all cells tied
    score[0, 20, 40] = 7.0
    score[1, 3, 3] = score[1, 3, 70] = score[1, 50, 3] = 2.0
    ref = jax.vmap(lambda s: jselect.select_topk_grid(s, 30, cell=16))(jnp.asarray(score))
    got = select.select_topk_grid(torch.from_numpy(score), 30, cell=16)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    yx = np.array([[8, 8], [20, 40], [1, 1], [63, 95]], np.int32)
    np.testing.assert_allclose(
        select.subpixel_refine(torch.from_numpy(score[0]), torch.from_numpy(yx)).numpy(),
        np.asarray(jselect.subpixel_refine(jnp.asarray(score[0]), jnp.asarray(yx))), atol=1e-6)


def test_matching_tie_rules():
    rng = np.random.default_rng(3)
    n, m = 120, 90
    desc_a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    desc_b = desc_a[rng.permutation(n)[:m]].copy()
    desc_b[::7] = desc_b[1::7][: len(desc_b[::7])]  # duplicates: argmin ties
    pa = brief.unpack_bits_pm1(torch.from_numpy(desc_a))
    pb = brief.unpack_bits_pm1(torch.from_numpy(desc_b))
    ja, jb = jbrief.unpack_bits_pm1(jnp.asarray(desc_a)), jbrief.unpack_bits_pm1(jnp.asarray(desc_b))
    uv_a = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    uv_b = (uv_a[:m] + rng.normal(0, 2, (m, 2))).astype(np.float32)
    oct_a, oct_b = rng.integers(0, 3, n).astype(np.int32), rng.integers(0, 3, m).astype(np.int32)
    ang_a = rng.choice([0.1, 0.2, 1.5, 3.0], n).astype(np.float32)  # equal histogram counts
    ang_b = np.zeros(m, np.float32)
    va, vb = rng.uniform(size=n) < 0.9, rng.uniform(size=m) < 0.9
    T = torch.from_numpy
    for radius in (3.0, 200.0):
        ref = jmatch.search_by_projection(
            jnp.asarray(uv_a), jnp.asarray(oct_a), ja, jnp.asarray(va), jnp.asarray(uv_b), jnp.asarray(oct_b),
            jb, jnp.asarray(vb), radius=radius, th_dist=100, nn_ratio=0.9,
            kp_angle=jnp.asarray(ang_a), lm_angle=jnp.asarray(ang_b))
        got = match.search_by_projection(
            T(uv_a), T(oct_a), pa, T(va), T(uv_b), T(oct_b), pb, T(vb), radius=radius, th_dist=100,
            nn_ratio=0.9, kp_angle=T(ang_a), lm_angle=T(ang_b))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    ref = jmatch.match_descriptors(ja, jnp.asarray(va), jb, jnp.asarray(vb), th_dist=50, nn_ratio=0.7,
                                   angle_a=jnp.asarray(ang_a), angle_b=jnp.asarray(ang_b))
    got = match.match_descriptors(pa, T(va), pb, T(vb), th_dist=50, nn_ratio=0.7, angle_a=T(ang_a), angle_b=T(ang_b))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    rot = rng.choice([0.0, 0.5, 1.0, 2.0, -1.0], 200).astype(np.float32)
    ok = rng.uniform(size=200) < 0.8
    np.testing.assert_array_equal(
        match.rotation_consistency_mask(T(rot), T(ok)).numpy(),
        np.asarray(jmatch.rotation_consistency_mask(jnp.asarray(rot), jnp.asarray(ok))))
