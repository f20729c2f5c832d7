"""Point-descriptor matching as dense masked distance matrices.

Port of plslam_tpu/matching/points.py: the full N x M Hamming matrix from
+-1 unpacked bits (dot = 256 - 2 * hamming), the reference's gates (window,
octave, threshold, ratio, rotation histogram) as masks, and mutual-nearest
assignment. Tie rules follow the reference: argmin keeps the first minimum,
the histogram's top-3 bins come lower bin first on equal counts.
"""

from __future__ import annotations

import math

import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops.select import topk_lower_index_first

BIG = 1e9


def hamming_matrix(pm1_a, pm1_b):
    """+-1 descriptors [N, 256] x [M, 256] -> Hamming f32[N, M] (exact:
    float32 sums of +-1 products are integers below 2^24)."""
    dot = torch.matmul(pm1_a.to(torch.float32), pm1_b.to(torch.float32).t())
    return (256.0 - dot) * 0.5


def best_two(dist, axis: int):
    """(best, second_best, argbest) along `axis` of a masked distance matrix."""
    best = torch.amin(dist, axis)
    arg = torch.argmin(dist, axis)  # first minimum, as jnp.argmin
    iota_shape = [1, 1]
    iota_shape[axis] = dist.shape[axis]
    iota = torch.arange(dist.shape[axis], device=dist.device).reshape(iota_shape)
    second = torch.min(torch.where(iota == arg.unsqueeze(axis), BIG, dist), axis).values
    return best, second, arg.to(torch.int32)


def rotation_consistency_mask(rot_diff, match_valid, n_bins=C.HISTO_LENGTH, keep=3):
    """Keep only matches whose keypoint-angle difference falls in one of
    the 3 most populated of 30 bins (ComputeThreeMaxima; secondary bins
    below 10% of the top count are discarded)."""
    two_pi = torch.full((), 2.0 * math.pi, dtype=torch.float32, device=rot_diff.device)
    frac = torch.remainder(rot_diff, two_pi) / two_pi
    bins = torch.clamp((frac * n_bins).to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.int32, device=rot_diff.device).index_add(0, bins, match_valid.to(torch.int32))
    counts, top_bins = topk_lower_index_first(hist, keep)
    top_bins = torch.where(counts.to(torch.float32) >= 0.1 * counts[0].to(torch.float32), top_bins, -1)
    in_top = (bins[:, None] == top_bins[None, :]).any(-1)
    return match_valid & in_top


def search_by_projection(
    kp_uv,
    kp_octave,
    kp_pm1,
    kp_valid,
    pred_uv,
    pred_octave,
    lm_pm1,
    lm_valid,
    radius,
    scale_factor: float = C.SCALE_FACTOR,
    th_dist: float = C.TH_LOW,
    nn_ratio: float | None = None,
    kp_angle=None,
    lm_angle=None,
    octave_tol: int = 1,
):
    """Windowed projection matching (ORBmatcher::SearchByProjection).

    Search window per landmark: radius * scale^pred_octave pixels (radius
    a float or a tensor broadcastable to [M]); keypoint octave within
    octave_tol of the prediction; mutual-nearest assignment.
    Returns (match_kp i32[M], -1 unmatched; dist f32[M])."""
    D = hamming_matrix(kp_pm1, lm_pm1)  # [N, M]
    du = kp_uv[:, None, 0] - pred_uv[None, :, 0]
    dv = kp_uv[:, None, 1] - pred_uv[None, :, 1]
    sf = torch.full((), scale_factor, dtype=torch.float32, device=D.device)
    r = (radius * torch.pow(sf, pred_octave.to(torch.float32)))[None, :]
    in_window = (torch.abs(du) <= r) & (torch.abs(dv) <= r)
    oct_ok = torch.abs(kp_octave[:, None] - pred_octave[None, :]) <= octave_tol
    pair_ok = in_window & oct_ok & kp_valid[:, None] & lm_valid[None, :]
    Dm = torch.where(pair_ok, D, BIG)

    best, second, best_kp = best_two(Dm, axis=0)  # per landmark [M]
    ok = best < th_dist
    if nn_ratio is not None:
        ok &= best < nn_ratio * second
    best_lm_of_kp = torch.argmin(Dm, 1)
    ok &= best_lm_of_kp[best_kp.long()] == torch.arange(Dm.shape[1], device=D.device)

    if kp_angle is not None and lm_angle is not None:
        ok = rotation_consistency_mask(kp_angle[best_kp.long()] - lm_angle, ok)
    return torch.where(ok, best_kp, -1), torch.where(ok, best, BIG)


def match_descriptors(
    pm1_a,
    valid_a,
    pm1_b,
    valid_b,
    th_dist: float = C.TH_LOW,
    nn_ratio: float | None = C.NN_RATIO_DEFAULT,
    angle_a=None,
    angle_b=None,
    pair_mask=None,
):
    """Brute-force matching with ratio test + mutual check; `pair_mask`
    bool[A, B] gates pairs further (the epipolar constraint of
    SearchForTriangulation). Returns match_b i32[A] (index into b, -1
    unmatched), dist f32[A]."""
    D = hamming_matrix(pm1_a, pm1_b)
    pair_ok = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        pair_ok = pair_ok & pair_mask
    Dm = torch.where(pair_ok, D, BIG)
    best, second, best_b = best_two(Dm, axis=1)
    ok = best < th_dist
    if nn_ratio is not None:
        ok &= best < nn_ratio * second
    best_a_of_b = torch.argmin(Dm, 0)
    ok &= best_a_of_b[best_b.long()] == torch.arange(Dm.shape[0], device=D.device)
    if angle_a is not None and angle_b is not None:
        ok = rotation_consistency_mask(angle_a - angle_b[best_b.long()], ok)
    return torch.where(ok, best_b, -1), torch.where(ok, best, BIG)
