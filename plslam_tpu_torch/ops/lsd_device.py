"""Dense line segment detection on the device.

Port of plslam_tpu/ops/lsd_device.py: an EDLines/LSD hybrid in which
every stage is a whole-plane tensor op of fixed shape.
  1. central-difference gradients -> magnitude + orientation;
  2. N_DIRS line-direction bins; per bin an aligned-support map (gradient
     strong and perpendicular to the bin direction, within ANGLE_TOL_DEG);
  3. oriented integration: the aligned density along a LINE_INTEG-px
     segment through each pixel (shifted adds of the support map);
  4. one anchor per grid cell + global top-k (ops/select.py);
  5. walk extents from per-bin extent planes (pointer doubling with static
     shifts), a parabolic subpixel step across the line;
  6. overlap suppression (a longer segment absorbs a shorter near-collinear
     one) and packing of the survivors, longest first, into `capacity` rows.

The reference's TPU idioms become direct indexing with the same results:
`gather2d_mxu` (a one-hot matmul gather) is `plane[rows, cols]`, and the
one-hot table read `oh_b @ dirs` is `dirs[b_of]`. Parity details: the 2x2
mean pool sums its four pixels in row-major order, as the reference's CPU
reduction does; `jnp.remainder` is C's fmod moved into [0, pi); argmax
over the density bins keeps the first maximum.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops import select

N_DIRS = 8  # line-direction bins over [0, pi)
LINE_INTEG = 17  # oriented integration length (px)
WALK = 80  # max endpoint walk per side (px)
GAP_BREAK = 3  # consecutive empty support pixels that end a segment
DENSITY_TH = 0.6  # min aligned density over the integration window
ANGLE_TOL_DEG = 22.5
GRAD_TH = 5.0
# deg2rad(22.5) rounded to float32 once, as the reference computes it
_ANGLE_TOL = float(np.float32(ANGLE_TOL_DEG) * np.float32(np.pi / 180.0))


@functools.lru_cache(maxsize=4)
def _dir_tables(n_dirs: int = N_DIRS, integ: int = LINE_INTEG):
    """Per-bin unit directions f32[B, 2] and oriented line kernels
    f32[B, integ, integ] (numpy; the reference's tables)."""
    thetas = np.arange(n_dirs) * np.pi / n_dirs
    dirs = np.stack([np.cos(thetas), np.sin(thetas)], -1).astype(np.float32)
    r = integ // 2
    kernels = np.zeros((n_dirs, integ, integ), np.float32)
    cc = r
    for b, (dx, dy) in enumerate(dirs):
        for t in range(-r, r + 1):
            x = int(round(cc + t * dx))
            y = int(round(cc + t * dy))
            kernels[b, y, x] = 1.0
    kernels /= kernels.sum(axis=(1, 2), keepdims=True)
    return dirs, kernels


@functools.lru_cache(maxsize=4)
def _dirs_on(device: str):
    """The direction table on `device`, copied once (a per-frame copy from
    host memory would block the host)."""
    return torch.from_numpy(_dir_tables()[0]).to(device)


def image_gradients(img):
    """Central differences f32[H, W] -> (gx, gy), zero on the one-pixel rim
    (the gradients of both the support maps and LBD)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * 0.5
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) * 0.5
    return gx, gy


def _remainder(x, y: float):
    """jnp.remainder for a positive float divisor: fmod moved into [0, y)."""
    m = torch.fmod(x, y)
    return torch.where(m < 0, m + y, m)


# fdlibm's atanf / atan2f constants (s_atanf.c, e_atan2f.c) as the C
# compiler rounds their decimal literals to float32 (the hex words in
# fdlibm's comments are not always those values)
def _f32s(*lits):
    return [float(np.float32(v)) for v in lits]


_ATAN_HI = _f32s("4.6364760399e-01", "7.8539812565e-01", "9.8279368877e-01", "1.5707962513e+00")
_ATAN_LO = _f32s("5.0121582440e-09", "3.7748947079e-08", "3.4473217170e-08", "7.5497894159e-08")
_AT = _f32s("3.3333334327e-01", "-2.0000000298e-01", "1.4285714924e-01", "-1.1111110449e-01",
            "9.0908870101e-02", "-7.6918758452e-02", "6.6610731184e-02", "-5.8335702866e-02",
            "4.9768779427e-02", "-3.6531571299e-02", "1.6285819933e-02")
_PI, _PI_O_2, _PI_LO = _f32s("3.1415927410e+00", "1.5707963705e+00", "-8.7422776573e-08")


def _atanf_fdlibm(x):
    """fdlibm's atanf on a finite f32 tensor, operation for operation."""
    ix = x.view(torch.int32) & 0x7FFFFFFF
    ax = torch.abs(x)
    one = torch.ones_like(x)
    # argument reduction: id -1 (|x| < 0.4375) keeps x, ids 0-3 reduce |x|
    t = torch.where(ix < 0x3F300000, (2.0 * ax - 1.0) / (2.0 + ax),
        torch.where(ix < 0x3F980000, (ax - 1.0) / (ax + 1.0),
        torch.where(ix < 0x401C0000, (ax - 1.5) / (1.5 * ax + one), -1.0 / ax)))
    idx = ((ix >= 0x3F300000).int() + (ix >= 0x3F980000).int() + (ix >= 0x401C0000).int())
    small = ix < 0x3EE00000
    t = torch.where(small, x, t)
    z = t * t
    w = z * z
    a = _AT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8] + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    hi = torch.tensor(_ATAN_HI, dtype=x.dtype, device=x.device)[idx]
    lo = torch.tensor(_ATAN_LO, dtype=x.dtype, device=x.device)[idx]
    zz = hi - ((t * (s1 + s2) - lo) - t)
    out = torch.where(small, torch.where(ix < 0x31000000, x, t - t * (s1 + s2)), torch.where(x < 0, -zz, zz))
    big = torch.where(x < 0, -(_ATAN_HI[3] + _ATAN_LO[3]), _ATAN_HI[3] + _ATAN_LO[3])
    return torch.where(ix >= 0x4C000000, big, out)


def atan2_fdlibm(y, x):
    """The C library's atan2f (fdlibm's e_atan2f.c, which XLA's CPU backend
    calls) on finite f32 tensors, so angles equal the reference's to the
    bit on the CPU."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    k = (iy - ix) >> 23
    q = torch.where(ix == 0, torch.ones_like(x), torch.abs(y / torch.where(ix == 0, 1.0, x)))
    z = _atanf_fdlibm(q)
    z = torch.where(k > 60, _PI_O_2 + 0.5 * _PI_LO, torch.where((hx < 0) & (k < -60), 0.0, z))
    neg_y, neg_x = hy < 0, hx < 0
    out = torch.where(neg_x, torch.where(neg_y, (z - _PI_LO) - _PI, _PI - (z - _PI_LO)), torch.where(neg_y, -z, z))
    out = torch.where(ix == 0, torch.where(neg_y, -_PI_O_2, _PI_O_2), out)
    out = torch.where(iy == 0, torch.where(neg_x, torch.where(neg_y, -_PI, _PI), y), out)
    return torch.where(hx == 0x3F800000, _atanf_fdlibm(y), out)


def support_maps(gray, grad_th: float = GRAD_TH, n_dirs: int = N_DIRS):
    """-> (support f32[B, H, W] aligned-gradient indicator, mag f32[H, W])."""
    gx, gy = image_gradients(gray)
    if gray.device.type == "cpu":
        # the reference's CPU results to the bit (a last-bit difference
        # flips support pixels at the angle tolerance and, through them,
        # whole segments): a correctly rounded square root, which torch's
        # vectorised float32 one is not, and the C library's atan2f
        mag = torch.sqrt((gx * gx + gy * gy).double()).float()
        line_ang = atan2_fdlibm(gy, gx) + math.pi / 2
    else:
        mag = torch.sqrt(gx * gx + gy * gy)
        line_ang = torch.atan2(gy, gx) + math.pi / 2
    # the line runs perpendicular to the gradient; fold into [0, pi)
    thetas = torch.arange(n_dirs, dtype=torch.float32, device=gray.device) * (math.pi / n_dirs)
    d = line_ang[None] - thetas[:, None, None]
    d = torch.abs(_remainder(d + math.pi / 2, math.pi) - math.pi / 2)
    sup = (d < _ANGLE_TOL) & (mag > grad_th)[None]
    return sup.to(torch.float32), mag


def oriented_density(sup):
    """Aligned density f32[B, H, W]: each bin's support averaged over its
    LINE_INTEG-px line kernel, as shifted adds of the kernel's taps (sums
    of 0/1 values, exact in any order). Densities are multiples of 1/17,
    so bins tie often."""
    _, kern_np = _dir_tables()
    B, H, W = sup.shape
    r_i = LINE_INTEG // 2
    sup_p = F.pad(sup, (r_i, r_i, r_i, r_i))
    dens = []
    for b in range(B):
        taps = np.argwhere(kern_np[b] > 0)
        acc = None
        for oy, ox in taps:
            sl = sup_p[b, oy : oy + H, ox : ox + W]
            acc = sl if acc is None else acc + sl
        dens.append(acc * (1.0 / len(taps)))
    return torch.stack(dens)


def _shift(plane, oy: int, ox: int):
    """plane sampled at p + (oy, ox); zeros outside the frame."""
    H, W = plane.shape
    py0, py1 = max(oy, 0), max(-oy, 0)
    px0, px1 = max(ox, 0), max(-ox, 0)
    p = F.pad(plane, (px1, px0, py1, py0))
    return p[py0 : py0 + H, px0 : px0 + W]


def _o_of(t, dx, dy):
    return int(round(t * dy)), int(round(t * dx))  # (rows, cols)


_N_LEVELS_WALK = int(np.ceil(np.log2(WALK)))  # run cap 2^n >= WALK


def _extent_plane(g, dx: float, dy: float):
    """i32[H, W]: walk extent from every pixel along +(dx, dy): the run of
    the support dilated by GAP_BREAK - 1 steps along the walk (and 1 px
    across it), counted by pointer doubling."""
    d1 = _shift(g, *_o_of(1, dx, dy))
    for t in range(2, GAP_BREAK + 1):
        d1 = d1 | _shift(g, *_o_of(t, dx, dy))
    poy, pox = int(round(dx)), int(round(-dy))
    if (poy, pox) != (0, 0):
        d1 = d1 | _shift(d1, poy, pox) | _shift(d1, -poy, -pox)
    r = d1.to(torch.int32)
    for k in range(_N_LEVELS_WALK):
        step = 1 << k
        r = r + torch.where(r == step, _shift(r, *_o_of(step, dx, dy)), 0)
    return torch.clamp(r, max=WALK)


def _mean_pool(gray, d: int):
    """d x d block mean; the block's pixels are summed in row-major order."""
    Hf, Wf = gray.shape
    b = gray[: (Hf // d) * d, : (Wf // d) * d].reshape(Hf // d, d, Wf // d, d)
    acc = None
    for i in range(d):
        for j in range(d):
            acc = b[:, i, :, j] if acc is None else acc + b[:, i, :, j]
    return acc * (1.0 / (d * d))


def detect_lines_device(
    gray,
    capacity: int = C.MAX_LINES,
    min_length_frac: float = C.MIN_LINE_LENGTH_FRAC,
    n_candidates: int = 256,
    cell: int = 32,
    downscale: int | None = None,
):
    """gray f32[H, W] (0..255) -> (sp f32[L, 2], ep f32[L, 2], valid bool[L]).

    Endpoints in (x, y) full-resolution pixels, longest first. `downscale`
    None picks 2 when min(H, W) >= 320 (detection on the 2x2 mean-pooled
    image, endpoints mapped back to pixel centres), else 1."""
    if downscale is None:
        downscale = 2 if min(gray.shape) >= 320 else 1
    if downscale > 1:
        d = downscale
        sp, ep, ok = detect_lines_device(
            _mean_pool(gray, d), capacity, min_length_frac, n_candidates,
            cell=max(8, cell // d), downscale=1,
        )
        off = (d - 1) * 0.5
        return sp * d + off, ep * d + off, ok

    dev = gray.device
    H, W = gray.shape
    dirs_np, _ = _dir_tables()
    dirs = _dirs_on(str(dev))
    sup, mag = support_maps(gray)

    dens = oriented_density(sup)
    score = dens.amax(0)
    bbest = torch.argmax(dens, 0)  # first maximum, as jnp.argmax
    score = torch.where(score >= DENSITY_TH, score, 0.0)
    # break plateau ties toward the gradient peak, far below the density quantum
    score = torch.where(score > 0.0, score + mag * (0.02 / (LINE_INTEG * 100.0)), 0.0)
    bmask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    bmask[3 : H - 3, 3 : W - 3] = True
    score = torch.where(bmask, score, 0.0)

    # 4. one anchor per cell, then the global top-k (no NMS: responses are
    # plateaus along the edge)
    yx, _, cand_ok = select.select_topk_grid(score[None], n_candidates, cell=cell)
    yx, cand_ok = yx[0].long(), cand_ok[0]
    yy, xx = yx[:, 0], yx[:, 1]

    # 5. walk extents from the per-bin extent planes
    b_of = bbest[yy, xx]
    d_of = dirs[b_of]  # [K, 2]
    sup_b = sup > 0
    ext_pos = torch.stack([_extent_plane(sup_b[b], float(dirs_np[b, 0]), float(dirs_np[b, 1]))
                           for b in range(N_DIRS)])
    ext_neg = torch.stack([_extent_plane(sup_b[b], -float(dirs_np[b, 0]), -float(dirs_np[b, 1]))
                           for b in range(N_DIRS)])
    t_pos = ext_pos[b_of, yy, xx].to(torch.float32)
    t_neg = ext_neg[b_of, yy, xx].to(torch.float32)
    length = t_pos + t_neg
    diag = float(np.hypot(H, W))
    min_len = max(min_length_frac * diag, float(LINE_INTEG))
    ok = cand_ok & (length >= min_len)

    # subpixel: parabola through the gradient magnitude across the line
    n_y = torch.round(d_of[:, 0]).long()
    n_x = torch.round(-d_of[:, 1]).long()

    def mag_at(dy_i, dx_i):
        return mag[torch.clamp(yy + dy_i, 0, H - 1), torch.clamp(xx + dx_i, 0, W - 1)]

    m0 = mag_at(0, 0)
    mm = mag_at(-n_y, -n_x)
    mp = mag_at(n_y, n_x)
    denom = mm - 2.0 * m0 + mp
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (mm - mp) / torch.where(denom == 0, 1.0, denom), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    off_x = delta * (-d_of[:, 1])
    off_y = delta * d_of[:, 0]
    cy = yy.to(torch.float32) + off_y
    cx = xx.to(torch.float32) + off_x
    sp = torch.stack([cx - t_neg * d_of[:, 0], cy - t_neg * d_of[:, 1]], -1)
    ep = torch.stack([cx + t_pos * d_of[:, 0], cy + t_pos * d_of[:, 1]], -1)

    # 6. overlap suppression, sort-free: precedence is "longer, ties by index"
    idx = torch.arange(sp.shape[0], device=dev)
    prec = (length[:, None] > length[None, :]) | (
        (length[:, None] == length[None, :]) & (idx[:, None] < idx[None, :])
    )
    mid = 0.5 * (sp + ep)
    n_i = torch.stack([-d_of[:, 1], d_of[:, 0]], -1)
    diff = mid[None, :, :] - mid[:, None, :]  # [K_i, K_j, 2]
    perp = torch.abs(torch.sum(diff * n_i[:, None, :], -1))
    along = torch.abs(torch.sum(diff * d_of[:, None, :], -1))
    cosang = torch.abs(torch.sum(d_of[:, None, :] * d_of[None, :, :], -1))
    covered = (
        (perp < 3.0) & (cosang > 0.966) & (along < 0.5 * length[:, None] + 2.0)
        & ok[:, None] & ok[None, :] & prec
    )
    alive = ok
    for _ in range(2):  # a suppressed segment cannot itself suppress
        alive = ok & ~torch.any(covered & alive[:, None], 0)
    ok = alive

    # pack the survivors longest first into capacity + 1 rows (the last is
    # scratch for the rest)
    rank = torch.sum(prec & ok[:, None], 0)
    slot = torch.where(ok & (rank < capacity), rank, capacity)
    out_sp = torch.zeros((capacity + 1, 2), dtype=torch.float32, device=dev)
    out_ep = torch.zeros_like(out_sp)
    out_ok = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    out_sp[slot] = sp
    out_ep[slot] = ep
    out_ok[slot] = ok
    return out_sp[:capacity], out_ep[:capacity], out_ok[:capacity]
