"""Port parity, relocalization: the JAX reference (CPU) against the port's
plain path (PyTorch, CPU) for the modules BoW + PnP relocalization runs:
`utils/jax_random.py`, `solvers/sim3_solver._horn`, `solvers/pnp.py`,
`loopclosing/vocab.py` and `pipeline/reloc.Relocalizer`.

Tolerances: `randint` equal exactly (the same integers, bit for bit, for
spans below, at and above 2^16, where JAX's uint32 multiplier wraps to 0);
Horn's R and t within 1e-5 on well-conditioned point sets (the 4x4
eigenvector comes from two different solvers; its sign does not matter);
PnP inlier sets equal and Tcw within 1e-4; BoW vectors equal exactly (the
Hamming products are exact, ties go to the lowest word); L1 and TF-IDF
scores within 1e-6 (sums over 4,096 words in another order) with the same
candidate order. One whole relocalization from one shared state (the same
outcome, candidate keyframe and landmark bindings, Tcw within 1e-4) and the
BoW database rows are held to the reference's in tests/test_torch_system.py,
whose reference run compiles the reference's relocalizer once for both."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.loopclosing import vocab as jvocab
from plslam_tpu.ops import brief as jbrief
from plslam_tpu.pipeline.reloc import Relocalizer as JRelocalizer
from plslam_tpu.solvers import pnp as jpnp
from plslam_tpu.solvers import sim3_solver as jsim3
from plslam_tpu_torch.loopclosing import vocab
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.pipeline.reloc import Relocalizer
from plslam_tpu_torch.solvers import pnp, sim3_solver
from plslam_tpu_torch.utils import jax_random

torch.set_num_threads(2)

@pytest.mark.parametrize("maxval", [1, 2, 3, 7, 100, 1000, 65536, 65537, 2**31 - 1])
def test_randint_equals_jax_random(maxval):
    for seed in (0, 1, 2**32 - 1):
        ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (256, 3), 0, maxval))
        for mx in (maxval, torch.tensor(maxval, dtype=torch.int32)):
            got = jax_random.randint(seed, (256, 3), mx)
            assert got.dtype == torch.int64 and np.array_equal(got.numpy(), ref)
    # the traced maxval of the reference's PnP; another shape
    f = jax.jit(lambda n: jax.random.randint(jax.random.PRNGKey(0), (256, 3), 0, jnp.maximum(n, 1)))
    assert np.array_equal(np.asarray(f(jnp.int32(maxval))), jax_random.randint(0, (256, 3), maxval).numpy())
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (3, 4, 5), 0, maxval))
    assert np.array_equal(jax_random.randint(5, (3, 4, 5), maxval).numpy(), ref)


def _rigid(rng, n):
    ang = rng.normal(size=3) * 0.5
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rng.normal(size=3)
    p2 = rng.uniform(-2, 2, (n, 3))
    p1 = p2 @ R.T + t + rng.normal(0, 0.01, (n, 3))
    return p1.astype(np.float32), p2.astype(np.float32), R, t


def test_horn_matches_reference():
    rng = np.random.default_rng(0)
    sets = [_rigid(rng, 12) for _ in range(16)]
    p1 = np.stack([s[0] for s in sets])
    p2 = np.stack([s[1] for s in sets])
    w = rng.uniform(0.5, 1.5, (16, 12)).astype(np.float32)
    for fix_scale in (True, False):
        Rj, tj, sj = jsim3._horn(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w), fix_scale=fix_scale)
        Rt, tt, st = sim3_solver._horn(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(w),
                                       fix_scale=fix_scale)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy()[0], sets[0][2], atol=1e-2)


def _pnp_problem(rng, n=400):
    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1]], np.float32)
    xw = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(1.5, 4.0, n)], -1)
    ang = np.array([0.05, -0.1, 0.03])
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0.2, -0.1, 0.3])
    pc = xw @ R.T + t
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]] + rng.normal(0, 0.5, (n, 2))
    bad = rng.uniform(size=n) < 0.3  # gross outliers: wrong landmark
    xw = np.where(bad[:, None], xw + rng.uniform(-0.5, 0.5, (n, 3)), xw)
    depth = np.where(rng.uniform(size=n) < 0.8, pc[:, 2] + rng.normal(0, 0.01, n), 0.0)
    valid = rng.uniform(size=n) < 0.9
    isig = 1.0 / 1.2 ** (2 * rng.integers(0, 3, n))
    f = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return f(xw), f(uv), f(depth), f(isig), valid, K


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_matches_reference(seed):
    args = _pnp_problem(np.random.default_rng(seed))
    ref = jax.jit(jpnp.solve_pnp_ransac)(*map(jnp.asarray, args))
    got = pnp.solve_pnp_ransac(*map(torch.from_numpy, args))
    assert bool(got.ok) == bool(ref.ok) and bool(got.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 200
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)


def test_vocabulary_bow_matches_reference():
    assert vocab.ASSET.read_bytes() == Path(jvocab.__file__).parent.parent.joinpath(
        "assets", "orbvoc_tpu.npz").read_bytes()
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 256, (1024, 32), dtype=np.uint8)
    desc[10] = desc[11]  # duplicates quantize alike
    valid = rng.uniform(size=1024) < 0.8
    for jv, tv in ((jvocab.Vocabulary(), vocab.Vocabulary()),
                   (jvocab.random_vocabulary(512), vocab.random_vocabulary(512))):
        np.testing.assert_array_equal(tv.words, jv.words)
        ref_pm1 = jbrief.unpack_bits_pm1(jnp.asarray(desc))
        got_pm1 = brief.unpack_bits_pm1(torch.from_numpy(desc))
        np.testing.assert_array_equal(tv.quantize(got_pm1, torch.from_numpy(valid)).numpy(),
                                      np.asarray(jv.quantize(ref_pm1, jnp.asarray(valid))))
        b_ref = np.asarray(jv.bow(ref_pm1, jnp.asarray(valid)))
        b_got = tv.bow(got_pm1, torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(b_got, b_ref)
        np.testing.assert_allclose(vocab.l1_score(torch.from_numpy(b_got), torch.from_numpy(b_got[::-1].copy())),
                                   np.asarray(jvocab.l1_score(b_ref, b_ref[::-1])), atol=1e-6)


def test_tfidf_scores_match_reference():
    rng = np.random.default_rng(3)
    v = vocab.Vocabulary()
    rows = []
    base = rng.integers(0, 256, (600, 32), dtype=np.uint8)
    for _ in range(24):  # overlapping views: keyframes share descriptors
        d = base[rng.choice(600, 300, replace=False)]
        rows.append(v.bow(brief.unpack_bits_pm1(torch.from_numpy(d)), torch.ones(300, dtype=torch.bool)).numpy())
    kf_bow = np.zeros((32, v.n_words), np.float32)
    kf_bow[:24] = rows
    kf_valid = np.zeros(32, bool)
    kf_valid[:24] = rng.uniform(size=24) < 0.9
    q = rows[5] * 0.5 + rows[7] * 0.5
    ref = np.array(JRelocalizer.tfidf_scores_device(jnp.asarray(kf_bow), jnp.asarray(q), jnp.asarray(kf_valid)))
    got = Relocalizer.tfidf_scores_device(torch.from_numpy(kf_bow), torch.from_numpy(q),
                                         torch.from_numpy(kf_valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    ref[~kf_valid], got[~kf_valid] = -1, -1
    np.testing.assert_array_equal(np.argsort(-got)[:5], np.argsort(-ref)[:5])
