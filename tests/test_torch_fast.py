"""Port parity, ORB front end part 1: the pyramid stack, FAST scores, the
NMS / fallback / border tail, and kernel B1's plain twin, against the JAX
reference on the CPU. The CUDA kernel is held against the twin on the
card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.ops import fast as jfast
from plslam_tpu.ops import pyramid as jpyr
from plslam_tpu_torch.ops import fast, fast_cuda, pyramid

torch.set_num_threads(2)

H, W, L, SCALE = 240, 320, 8, 1.2
SHAPES = pyramid.level_shapes(H, W, L, SCALE)


@pytest.fixture(scope="module")
def stack():
    """A smooth random image (the FAST thresholds see real corners) and its
    8-level stack, from the reference's own builder."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))[:H, :W]
    img = img + rng.normal(0, 3, (H, W)).astype(np.float32)
    return np.asarray(jpyr.build_pyramid_stack(jnp.asarray(img), L, SCALE)), img


def test_matrices_bit_equal():
    for a, b in zip(pyramid.pyramid_matrices(H, W, L, SCALE), jpyr.pyramid_matrices(H, W, L, SCALE)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pyramid.blur_matrices(H, W), jpyr.blur_matrices(H, W)):
        np.testing.assert_array_equal(a, b)
    assert pyramid.level_shapes(480, 640, 8, 1.2) == jpyr.level_shapes(480, 640, 8, 1.2)


def test_pyramid_and_blur(stack):
    ref_stack, img = stack
    got = pyramid.build_pyramid_stack(torch.from_numpy(img), L, SCALE).numpy()
    # same weights, float32 products summed in another order: ~1e-5 of 255
    np.testing.assert_allclose(got, ref_stack, atol=2e-3)
    ref_blur = np.asarray(jpyr.blur_stack(jnp.asarray(ref_stack)))
    np.testing.assert_allclose(pyramid.blur_stack(torch.from_numpy(ref_stack)).numpy(), ref_blur, atol=2e-3)


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_scores(stack, threshold):
    ref_stack, _ = stack
    ref = np.asarray(jax.vmap(jfast.fast_scores, (0, None))(jnp.asarray(ref_stack), threshold))
    got = fast.fast_scores(torch.from_numpy(ref_stack), threshold).numpy()
    # identical differences -> identical corner masks; the 16-term score
    # sums may differ in the last float32 bits
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    assert (ref > 0).sum() > 100


def test_fallback_nms_border_tail(stack):
    ref_stack, _ = stack
    s = jnp.asarray(ref_stack)
    hi = jax.vmap(jfast.fast_scores, (0, None))(s, 20.0)
    lo = jax.vmap(jfast.fast_scores, (0, None))(s, 7.0)
    ref = np.asarray(jfast.fallback_nms_border_stack(hi, lo, SHAPES, 32, 19))
    got = fast.fallback_nms_border_stack(
        torch.from_numpy(np.asarray(hi)), torch.from_numpy(np.asarray(lo)), SHAPES, 32, 19
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_b1_twin_matches_reference_where_live(stack):
    """The twin zeroes whole FAST cells beyond each level's extent (as the
    kernel does without computing them); inside, it is the reference's
    dual-threshold scores and blur, and the score map that reaches
    selection is unchanged."""
    ref_stack, _ = stack
    s = jnp.asarray(ref_stack)
    r_hi = np.asarray(jax.vmap(jfast.fast_scores, (0, None))(s, 20.0))
    r_lo = np.asarray(jax.vmap(jfast.fast_scores, (0, None))(s, 7.0))
    r_blur = np.asarray(jpyr.blur_stack(s))
    hi, lo, blur = (t.numpy() for t in fast_cuda.fast_blur_stack(torch.from_numpy(ref_stack), SHAPES, 20.0, 7.0))
    live = np.zeros((L, H, W), bool)
    for l, (h, w) in enumerate(fast_cuda.live_extents(SHAPES, H, W)):
        live[l, :h, :w] = True
        assert h >= SHAPES[l][0] and w >= SHAPES[l][1] and h % 32 in (0, H % 32)
    for got, ref in ((hi, r_hi), (lo, r_lo), (blur, r_blur)):
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-6, atol=2e-3)
        assert not got[~live].any()
    ref_score = np.asarray(jfast.fallback_nms_border_stack(r_hi, r_lo, SHAPES, 32, 19))
    got_score = fast.fallback_nms_border_stack(torch.from_numpy(hi), torch.from_numpy(lo), SHAPES, 32, 19)
    np.testing.assert_allclose(got_score.numpy(), ref_score, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got_score.numpy() > 0, ref_score > 0)


@pytest.mark.parametrize("shape", [(96, 128), (480, 640)])
def test_fast_with_fallback_single_image(shape):
    """The single-image entry (kernel B4's path; its plain scores on the
    CPU) against the reference's fast_with_fallback: identical maps."""
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    img = rng.uniform(0, 255, (h // 4 + 1, w // 4 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))[:h, :w] + rng.normal(0, 3, (h, w)).astype(np.float32)
    ref = np.asarray(jax.jit(jfast.fast_with_fallback, static_argnums=(3, 4))(jnp.asarray(img), 20.0, 7.0, 32, 19))
    got = fast.fast_with_fallback(torch.from_numpy(img), 20.0, 7.0, 32, 19)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).sum() > 50
    hi, lo = fast_cuda.fast_scores(torch.from_numpy(img), 20.0, 7.0)  # B4's plain twin on a CPU tensor
    np.testing.assert_array_equal(hi.numpy() > 0, np.asarray(jfast.fast_scores(jnp.asarray(img), 20.0)) > 0)
    np.testing.assert_array_equal(lo.numpy() > 0, np.asarray(jfast.fast_scores(jnp.asarray(img), 7.0)) > 0)
