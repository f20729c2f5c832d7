"""Port parity, kernel B2: the plain 39x39 patch gather against the JAX
reference's dynamic_slice gather (exact), including centres whose window
leaves the image (dynamic_slice's start rules). The CUDA kernel is held
against the twin on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.ops import patches as jpatches
from plslam_tpu_torch.ops import brief, patches

torch.set_num_threads(2)

D = brief.PATCH_D


def _inputs(seed, rows=8 * 60, cols=80, k=300):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (rows, cols)).astype(np.float32)
    yx = np.stack([rng.integers(-5, rows + 5, k), rng.integers(-5, cols + 5, k)], -1).astype(np.int32)
    yx[:4] = [[0, 0], [rows - 1, cols - 1], [19, 19], [rows - 20, cols - 20]]
    return img, yx


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_gather_equals_reference(seed):
    img, yx = _inputs(seed)
    ref = np.asarray(jpatches.gather_patches(jnp.asarray(img), jnp.asarray(yx), D))
    got = patches.gather_patches_plain(torch.from_numpy(img), torch.from_numpy(yx), D).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cpu_tensors_take_the_plain_path():
    img, yx = _inputs(2)
    n0 = patches.gather_patches.launches
    got = patches.gather_patches(torch.from_numpy(img), torch.from_numpy(yx), D)
    assert patches.gather_patches.launches == n0
    assert torch.equal(got, patches.gather_patches_plain(torch.from_numpy(img), torch.from_numpy(yx), D))
