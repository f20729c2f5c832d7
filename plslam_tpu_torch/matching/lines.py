"""Line matching: LBD Hamming distances under geometric gates.

Port of plslam_tpu/matching/lines.py: one frame-line x map-line Hamming
matrix, masked by the midpoint window, the direction difference modulo pi
and the validity flags, then a median + MAD adaptive distance gate over
the candidates' best distances (lineDescriptorMAD), resolved mutual-nearest.

`jnp.nanmedian` averages the two middle values of an even count;
`torch.nanquantile(x, 0.5)` interpolates the same way (`torch.nanmedian`
would return the lower one). `nanmedian` below is that quantile written
with ops that have a `torch.func.vmap` batching rule (nanquantile has none
and would run once per sequence in parallel/batch.py).
"""

from __future__ import annotations

import numpy as np
import torch

from plslam_tpu_torch.matching.points import BIG, best_two, hamming_matrix


def nanmedian(x):
    """torch.nanquantile(x, 0.5) over all elements, bit for bit: ATen's
    linear interpolation between the sorted non-NaN values (NaN sorts
    last) at rank 0.5 (n - 1); NaN when every value is NaN."""
    s = torch.sort(x.reshape(-1)).values
    n = torch.sum(~torch.isnan(s))
    rank = torch.clamp((n - 1).to(x.dtype) * 0.5, min=0)
    below = rank.to(torch.long)
    weight = rank - below.to(x.dtype)
    above = torch.ceil(rank).to(torch.long)
    return torch.lerp(s.gather(0, below.reshape(1)), s.gather(0, above.reshape(1)), weight)[0]


def search_lines_by_projection(
    ln_mid,
    ln_angle,
    ln_pm1,
    ln_valid,
    pred_mid,
    pred_angle,
    ml_pm1,
    ml_valid,
    radius: float = 30.0,
    angle_tol: float = np.deg2rad(30.0),
    th_dist: float = 100.0,
    use_mad: bool = True,
):
    """frame keylines [L] vs projected map lines [M].

    Returns (match_ln i32[M] frame-line index per map line, dist f32[M])."""
    D = hamming_matrix(ln_pm1, ml_pm1)  # [L, M]
    du = ln_mid[:, None, 0] - pred_mid[None, :, 0]
    dv = ln_mid[:, None, 1] - pred_mid[None, :, 1]
    in_window = (torch.abs(du) <= radius) & (torch.abs(dv) <= radius)
    dang = torch.abs(ln_angle[:, None] - pred_angle[None, :])
    dang = torch.minimum(torch.remainder(dang, np.pi), np.pi - torch.remainder(dang, np.pi))
    ang_ok = dang <= angle_tol
    pair_ok = in_window & ang_ok & ln_valid[:, None] & ml_valid[None, :]
    Dm = torch.where(pair_ok, D, BIG)

    best, _, best_ln = best_two(Dm, axis=0)  # per map line
    ok = best < th_dist
    if use_mad:
        cand = torch.where(ok, best, torch.nan)
        med = nanmedian(cand)
        mad = 1.4826 * nanmedian(torch.abs(cand - med))
        gate = torch.where(torch.isfinite(med), med + 2.0 * mad + 1.0, th_dist)
        ok &= best <= torch.clamp(gate, max=th_dist)
    best_ml_of_ln = torch.argmin(Dm, 1)
    mutual = best_ml_of_ln[best_ln.long()] == torch.arange(Dm.shape[1], device=Dm.device)
    ok &= mutual
    return torch.where(ok, best_ln, -1), torch.where(ok, best, BIG)
