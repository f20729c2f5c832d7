"""LBD (Line Band Descriptor), 256 bits per line.

Port of plslam_tpu/ops/lbd.py: gradients sampled over the line's support
region (BANDS x BAND_W px across the line, samples along it), rotated into
the line frame, per-band mean and std of both components, L2-normalised,
then binarised by a fixed seeded set of component pairs (bit = v[i] > v[j]).

Two sampling modes, as in the reference: `exact` (16 x 63 bilinear samples)
and the fast grid (12 x 16 nearest samples of the gradients rounded to
bfloat16, band statistics through a band-assignment matrix).
`lbd_descriptor` picks the fast grid at min(H, W) >= 320. The reference's
TPU mechanics are not carried over: the fast path's u32 packing of two
bf16 halves becomes two direct gathers with the same bf16 rounding, and
the pair-sign matmul becomes `v[:, ii] > v[:, jj]` (the same bits: the
sign of an IEEE difference is exact).

Parity with the reference's CPU results: sums over samples run in the
reference's order (sequential, row-major over the reduced axes), a mean
multiplies by the float32 reciprocal of the count, and `linspace`
samples are iota * (1 / (n - 1)) with the last one exactly 1, as the
reference's compiled code computes them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops.lsd_device import image_gradients  # noqa: F401  (part of this module's API)

N_SAMPLES = 16  # longitudinal samples along the segment (exact path)
BANDS = C.LBD_BANDS  # 9
BAND_W = C.LBD_BAND_WIDTH  # 7
N_BITS = 256
_PAIR_SEED = 0x1BD
_FAST_S = 12
_FAST_OFFS = np.arange(-30.0, 31.0, 4.0).astype(np.float32)  # 16 taps, stride 4


@functools.lru_cache(maxsize=1)
def _band_assign():
    """A f32[16, BANDS]: column b averages the fast taps that fall in band b."""
    half = (BANDS * BAND_W - 1) / 2.0
    b = np.clip(((_FAST_OFFS + half) // BAND_W).astype(np.int64), 0, BANDS - 1)
    A = np.zeros((len(_FAST_OFFS), BANDS), np.float32)
    A[np.arange(len(_FAST_OFFS)), b] = 1.0
    A /= np.maximum(A.sum(0, keepdims=True), 1.0)
    return A


@functools.lru_cache(maxsize=1)
def _pairs():
    """The reference's 256 component pairs (i, j), from its seeded stream."""
    dim = BANDS * 4
    rs = np.random.RandomState(_PAIR_SEED)
    pairs = set()
    while len(pairs) < N_BITS:
        i, j = rs.randint(0, dim), rs.randint(0, dim)
        if i != j and (i, j) not in pairs:
            pairs.add((i, j))
    arr = np.asarray(sorted(pairs), np.int32)
    rs.shuffle(arr)
    return arr[:, 0], arr[:, 1]


@functools.lru_cache(maxsize=4)
def _tables_on(device: str):
    """(ii, jj, band assignment, fast offsets) on `device`, copied once (a
    per-frame copy from host memory would block the host)."""
    ii, jj = _pairs()
    return tuple(torch.from_numpy(a).to(device) for a in
                 (ii.astype(np.int64), jj.astype(np.int64), _band_assign(), _FAST_OFFS))


def _recip(n: int) -> float:
    """1 / n rounded in float32, as the reference's compiled division."""
    return float(np.float32(1.0) / np.float32(n))


def _linspace01(n: int, device):
    t = torch.arange(n, dtype=torch.float32, device=device) * _recip(n - 1)
    t[-1] = 1.0
    return t


def _bilinear(img, x, y):
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    ax, ay = x - x0, y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (1 - ay) * ((1 - ax) * v00 + ax * v01) + ay * ((1 - ax) * v10 + ax * v11)


def _seq_sum(g, dims):
    """Sum of g over `dims` (ascending), term by term in row-major order."""
    g = g.movedim(dims, tuple(range(g.ndim - len(dims), g.ndim)))
    g = g.reshape(*g.shape[: g.ndim - len(dims)], -1)
    acc = g[..., 0]
    for i in range(1, g.shape[-1]):
        acc = acc + g[..., i]
    return acc


def lbd_vector(gx, gy, sp, ep, valid, exact: bool = False):
    """Float LBD band vectors. sp/ep f32[L, 2] (x, y) -> f32[L, BANDS*4]."""
    d = ep - sp
    length = torch.sqrt(torch.sum(d * d, -1, keepdim=True))
    d = d / torch.clamp(length, min=1e-6)
    n = torch.stack([-d[:, 1], d[:, 0]], -1)  # left normal

    n_s = N_SAMPLES if exact else _FAST_S
    t = _linspace01(n_s, sp.device)
    half = (BANDS * BAND_W - 1) / 2.0
    if exact:
        off = torch.arange(BANDS * BAND_W, dtype=torch.float32, device=sp.device) - half
    else:
        off = _tables_on(str(sp.device))[3]
    base = sp[:, None, :] + (ep - sp)[:, None, :] * t[None, :, None]  # [L, S, 2]
    pts = base[:, :, None, :] + n[:, None, None, :] * off[None, None, :, None]
    x, y = pts[..., 0], pts[..., 1]  # [L, S, n_off]

    if exact:
        gxs = _bilinear(gx, x, y)
        gys = _bilinear(gy, x, y)
    else:
        H, W = gx.shape
        xi = torch.clamp(torch.round(x).long(), 0, W - 1)
        yi = torch.clamp(torch.round(y).long(), 0, H - 1)
        gxs = gx[yi, xi].to(torch.bfloat16).to(torch.float32)
        gys = gy[yi, xi].to(torch.bfloat16).to(torch.float32)
    g_par = gxs * d[:, None, None, 0] + gys * d[:, None, None, 1]
    g_prp = gxs * n[:, None, None, 0] + gys * n[:, None, None, 1]

    if exact:
        r = _recip(N_SAMPLES * BAND_W)

        def stats(g):  # band stats over (S, BAND_W)
            gb = g.reshape(g.shape[0], N_SAMPLES, BANDS, BAND_W)
            mean = _seq_sum(gb, (1, 3)) * r
            c = gb - mean[:, None, :, None]
            return mean, torch.sqrt(_seq_sum(c * c, (1, 3)) * r)
    else:
        A = _tables_on(str(sp.device))[2]  # [n_off, BANDS]
        r = _recip(n_s)

        def stats(g):  # band stats over the subsampled grid
            mean = torch.matmul(_seq_sum(g, (1,)), A) * r
            e2 = torch.matmul(_seq_sum(g * g, (1,)), A) * r
            return mean, torch.sqrt(torch.clamp(e2 - mean * mean, min=0.0))

    m_prp, s_prp = stats(g_prp)
    m_par, s_par = stats(g_par)
    v = torch.cat([m_prp, s_prp, m_par, s_par], -1)  # [L, BANDS*4]
    v = v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)), min=1e-6)
    return torch.where(valid[:, None], v, 0.0)


def lbd_descriptor(gx, gy, sp, ep, valid, exact: bool | None = None):
    """-> u8[L, 32] binary LBD; `exact` None picks the fast grid at
    min(H, W) >= 320."""
    if exact is None:
        exact = min(gx.shape[-2:]) < 320
    v = lbd_vector(gx, gy, sp, ep, valid, exact=exact)
    ii, jj = _tables_on(str(v.device))[:2]
    bits = (v[:, ii] > v[:, jj]).to(torch.int32).reshape(v.shape[0], 32, 8)
    pw = (1 << torch.arange(8, dtype=torch.int32, device=v.device))
    return torch.sum(bits * pw, -1).to(torch.uint8)
