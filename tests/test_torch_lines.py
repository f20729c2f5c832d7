"""Port parity, the line modules: device LSD, LBD and line matching, the
JAX reference against the port's plain path on the CPU, same numpy inputs.

Tolerances, and why:
  * support_maps: equal, except pixels where the reference's compiled
    arithmetic (fused multiply-adds, its own arctan2) lands on the other
    side of the 22.5 degree tolerance or of the gradient threshold within
    float32 rounding; at most 0.01% of the [8, H, W] maps, and each such
    pixel within 1e-4 of a threshold.
  * detect_lines_device: valid masks equal, endpoints within 1e-3 px
    (float32 rounding in the subpixel step).
  * lbd_descriptor: bits equal (both modes).
  * search_lines_by_projection: matches and distances equal.
Each parity hazard named below has a case that shows it: the reference's
nanmedian (mean of the two middle values), argmax ties over the density
bins (first index), the 2x2 mean pool's summation order, jnp.linspace's
sample positions, and bf16 round-to-nearest-even."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.matching import lines as jlines
from plslam_tpu.ops import brief as jbrief
from plslam_tpu.ops import lbd as jlbd
from plslam_tpu.ops import lsd_device as jlsd
from plslam_tpu_torch import load_settings
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.matching import lines
from plslam_tpu_torch.ops import brief, lbd, lsd_device

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parents[1] / "configs" / "TUM3.yaml"


@pytest.fixture(scope="module")
def gray():
    """Frame 1 of the synthetic TUM3 sequence at 640x480 (textured plane,
    stripes, floating patches: many straight edges)."""
    s = load_settings(CFG)
    return SyntheticSequence(n_frames=2, seed=0, settings=s).frame(1)[0]


@pytest.fixture(scope="module")
def detected(gray):
    """Reference and port detections at 640x480 (downscale 2) and at
    320x240 (downscale 1)."""
    out = {}
    for name, img in (("full", gray), ("half", np.ascontiguousarray(gray[::2, ::2]))):
        ref = [np.asarray(a) for a in jax.jit(jlsd.detect_lines_device)(jnp.asarray(img))]
        got = [a.numpy() for a in lsd_device.detect_lines_device(torch.from_numpy(img))]
        out[name] = (img, ref, got)
    return out


def test_dir_tables_equal():
    for a, b in zip(lsd_device._dir_tables(), jlsd._dir_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(lbd._pairs(), jlbd._pairs()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lbd._band_assign(), jlbd._band_assign())


def test_support_maps(gray):
    ref_sup, ref_mag = (np.asarray(a) for a in jlsd.support_maps(jnp.asarray(gray)))
    sup, mag = (a.numpy() for a in lsd_device.support_maps(torch.from_numpy(gray)))
    np.testing.assert_allclose(mag, ref_mag, rtol=1e-6)
    diff = np.argwhere(sup != ref_sup)
    assert len(diff) <= 1e-4 * sup.size, len(diff)
    # every differing pixel sits on a threshold within float32 rounding
    g = gray.astype(np.float64)
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    gy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5
    for b, y, x in diff:
        ang = np.arctan2(gy[y, x], gx[y, x]) + np.pi / 2 - b * np.pi / 8
        d = abs((ang + np.pi / 2) % np.pi - np.pi / 2)
        near_angle = abs(d - np.deg2rad(22.5)) < 1e-4
        near_mag = abs(np.hypot(gx[y, x], gy[y, x]) - lsd_device.GRAD_TH) < 1e-4
        assert near_angle or near_mag, (b, y, x)
    assert ref_sup.sum() > 10000


@pytest.mark.parametrize("size", ["full", "half"])
def test_detect_lines_device(detected, size):
    _, (r_sp, r_ep, r_ok), (sp, ep, ok) = detected[size]
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_allclose(sp, r_sp, atol=1e-3)
    np.testing.assert_allclose(ep, r_ep, atol=1e-3)
    assert ok.sum() >= 40


@pytest.mark.parametrize("size,exact", [("full", None), ("half", None), ("full", True), ("half", False)])
def test_lbd_descriptor_bits(detected, size, exact):
    """None: the production pick (fast grid at 640x480, exact at 320x240)."""
    img, (sp, ep, ok), _ = detected[size]
    ref = np.asarray(jlbd.lbd_descriptor(*jlbd.image_gradients(jnp.asarray(img)), jnp.asarray(sp),
                                         jnp.asarray(ep), jnp.asarray(ok), exact=exact))
    gx, gy = lbd.image_gradients(torch.from_numpy(img))
    got = lbd.lbd_descriptor(gx, gy, torch.from_numpy(sp), torch.from_numpy(ep), torch.from_numpy(ok), exact=exact)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.unpackbits(ref[ok]).mean() > 0.3


def test_density_argmax_takes_first_of_tied_bins(gray):
    """Densities are multiples of 1/17: many pixels tie between bins, and
    the anchor's bin is the first of the tied maxima, as jnp.argmax."""
    img = np.ascontiguousarray(gray[::2, ::2])
    sup, _ = lsd_device.support_maps(torch.from_numpy(img))
    dens = lsd_device.oriented_density(sup)
    top2 = torch.topk(dens, 2, dim=0).values
    ties = (top2[0] == top2[1]) & (top2[0] >= lsd_device.DENSITY_TH)
    assert int(ties.sum()) > 10
    got = torch.argmax(dens, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(jnp.asarray(dens.numpy()), 0)))
    first = torch.argmax((dens == dens.amax(0)).to(torch.int8), 0)  # lowest index among the maxima
    assert torch.equal(got[ties], first[ties])


def test_mean_pool_summation_order():
    """At the production shape the reference's compiled 2x2 mean sums the
    block row-major; PyTorch's own mean reduction rounds differently on
    some pixels."""
    img = np.random.default_rng(3).uniform(0, 255, (480, 640)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda g: g.reshape(240, 2, 320, 2).mean((1, 3)))(jnp.asarray(img)))
    np.testing.assert_array_equal(lsd_device._mean_pool(torch.from_numpy(img), 2).numpy(), ref)
    assert (torch.from_numpy(img).reshape(240, 2, 320, 2).mean((1, 3)).numpy() != ref).any()


@pytest.mark.parametrize("n", [lbd._FAST_S, lbd.N_SAMPLES])
def test_linspace_sample_positions(n):
    ref = np.asarray(jnp.linspace(0.0, 1.0, n))
    np.testing.assert_array_equal(lbd._linspace01(n, "cpu").numpy(), ref)


def test_bf16_round_to_nearest_even():
    """Gradient values halfway between two bf16 numbers round to the even one."""
    base = np.float32([1.0, 3.0, -5.5, 100.0, 0.75])
    ulp = np.float32(2.0) ** (np.floor(np.log2(np.abs(base))) - 7)
    v = np.concatenate([base + ulp / 2, base + 3 * ulp / 2, base - ulp / 2]).astype(np.float32)
    ref = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(torch.from_numpy(v).to(torch.bfloat16).to(torch.float32).numpy(), ref)
    assert (ref != v).sum() >= 10


def _line_case(rng, n, dists):
    """n frame lines and n map lines; map line j sits on frame line j
    (far from the others) with its descriptor `dists[j]` bits away."""
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    mdesc = desc.copy()
    for j, k in enumerate(dists):
        bits = np.unpackbits(mdesc[j])
        bits[rng.choice(256, int(k), replace=False)] ^= 1
        mdesc[j] = np.packbits(bits)
    mid = np.stack([np.arange(n) * 100.0 + 50.0, np.full(n, 240.0)], -1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return mid, ang, desc, mid + 1.5, ang + np.float32(0.1), mdesc


def _match_both(mid, ang, desc, pmid, pang, mdesc, valid=None, mvalid=None):
    n, m = len(mid), len(pmid)
    valid = np.ones(n, bool) if valid is None else valid
    mvalid = np.ones(m, bool) if mvalid is None else mvalid
    jpm = [jbrief.unpack_bits_pm1(jnp.asarray(d)) for d in (desc, mdesc)]
    ref = jlines.search_lines_by_projection(jnp.asarray(mid), jnp.asarray(ang), jpm[0], jnp.asarray(valid),
                                            jnp.asarray(pmid), jnp.asarray(pang), jpm[1], jnp.asarray(mvalid))
    T = torch.from_numpy
    got = lines.search_lines_by_projection(T(mid), T(ang), brief.unpack_bits_pm1(T(desc)), T(valid),
                                           T(pmid), T(pang), brief.unpack_bits_pm1(T(mdesc)), T(mvalid))
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def test_search_lines_even_count_median():
    """Six candidates with best distances 2, 4, 6, 10, 12, 20: the
    reference's gate (mean of the middle pair: 8 + 2 * 1.4826 * 4 + 1 =
    20.86) admits the line at 20; the lower middle value (6, gate 18.86)
    would reject it."""
    dists = [2, 4, 6, 10, 12, 20]
    (r_m, r_d), (g_m, g_d) = _match_both(*_line_case(np.random.default_rng(5), 6, dists))
    np.testing.assert_array_equal(g_m, r_m)
    np.testing.assert_array_equal(g_d, r_d)
    assert r_m[5] == 5 and r_d[5] == 20
    x = torch.tensor(dists, dtype=torch.float32)

    def gate(median):
        med = median(x)
        return float(med + 2.0 * 1.4826 * median(torch.abs(x - med)) + 1.0)

    assert gate(torch.nanmedian) < 20 <= gate(lambda v: torch.nanquantile(v, 0.5))


def test_search_lines_random_scene():
    """Many lines, shared windows, rejected angles, invalid rows, an odd
    number of candidates."""
    rng = np.random.default_rng(11)
    n, m = 96, 200
    mid = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    src = rng.integers(0, n, m)
    pmid = (mid[src] + rng.normal(0, 8, (m, 2))).astype(np.float32)
    pang = (ang[src] + rng.normal(0, 0.4, m) + np.pi * rng.integers(0, 2, m)).astype(np.float32)
    mdesc = desc[src].copy()
    flips = rng.integers(0, 256, (m, 40))
    for j in range(m):
        bits = np.unpackbits(mdesc[j])
        bits[flips[j, : rng.integers(0, 40)]] ^= 1
        mdesc[j] = np.packbits(bits)
    valid, mvalid = rng.uniform(size=n) < 0.9, rng.uniform(size=m) < 0.9
    (r_m, r_d), (g_m, g_d) = _match_both(mid, ang, desc, pmid, pang, mdesc, valid, mvalid)
    np.testing.assert_array_equal(g_m, r_m)
    np.testing.assert_array_equal(g_d, r_d)
    assert (r_m >= 0).sum() > 20
