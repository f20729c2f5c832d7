"""The map: a fixed-capacity struct-of-arrays of tensors.

Port of plslam_tpu/slammap/state.py: every keyframe and landmark lives at
a fixed slot with a validity mask; observations are the per-keyframe
landmark-index rows kf_lm_idx / kf_ln_idx. Field names, dtypes and
capacities are the reference's. The one-hot contractions the reference
uses in place of scatters (a TPU workaround) are direct index operations
here, with the same integer results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plslam_tpu_torch import constants as C


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor  # f32[K, 4, 4] Tcw
    kf_valid: torch.Tensor  # bool[K]
    kf_frame_id: torch.Tensor  # i32[K]
    kf_seq: torch.Tensor  # i32[K] monotonic creation number (slots recycle)
    kf_uv: torch.Tensor  # f32[K, F, 3] undistorted (u, v, u_r); u_r<0: mono
    kf_octave: torch.Tensor  # i32[K, F]
    kf_angle: torch.Tensor  # f32[K, F]
    kf_desc: torch.Tensor  # u8[K, F, 32]
    kf_feat_valid: torch.Tensor  # bool[K, F]
    kf_lm_idx: torch.Tensor  # i32[K, F] map-point id or -1
    kf_ln_obs: torch.Tensor  # f32[K, L, 3]
    kf_ln_idx: torch.Tensor  # i32[K, L]
    kf_ln_valid: torch.Tensor  # bool[K, L]
    kf_ln_desc: torch.Tensor  # u8[K, L, 32]
    kf_ln_sp: torch.Tensor  # f32[K, L, 2]
    kf_ln_ep: torch.Tensor  # f32[K, L, 2]
    # --- map points ---
    pt_pos: torch.Tensor  # f32[P, 3]
    pt_desc: torch.Tensor  # u8[P, 32]
    pt_normal: torch.Tensor  # f32[P, 3] mean viewing direction
    pt_dist: torch.Tensor  # f32[P, 2] (dmin, dmax) scale-invariance band
    pt_valid: torch.Tensor  # bool[P]
    pt_ref_kf: torch.Tensor  # i32[P]
    pt_first_kf: torch.Tensor  # i32[P]
    pt_first_seq: torch.Tensor  # i32[P]
    pt_nobs: torch.Tensor  # i32[P]
    pt_visible: torch.Tensor  # f32[P]
    pt_found: torch.Tensor  # f32[P]
    pt_replaced: torch.Tensor  # i32[P] Replace forwarding (-1 none)
    # --- map lines ---
    ln_sw: torch.Tensor  # f32[Q, 3]
    ln_ew: torch.Tensor  # f32[Q, 3]
    ln_desc: torch.Tensor  # u8[Q, 32]
    ln_normal: torch.Tensor  # f32[Q, 3]
    ln_dist: torch.Tensor  # f32[Q, 2]
    ln_valid: torch.Tensor  # bool[Q]
    ln_ref_kf: torch.Tensor  # i32[Q]
    ln_first_kf: torch.Tensor  # i32[Q]
    ln_first_seq: torch.Tensor  # i32[Q]
    ln_nobs: torch.Tensor  # i32[Q]
    ln_visible: torch.Tensor  # f32[Q]
    ln_found: torch.Tensor  # f32[Q]
    # --- counters ---
    n_kf: torch.Tensor  # i32[] number of valid keyframes
    n_pt: torch.Tensor  # i32[] number of valid map points
    n_ln: torch.Tensor  # i32[] number of valid map lines
    next_kf_seq: torch.Tensor  # i32[] monotonic keyframe creation counter


def empty_map(
    max_kf: int = C.MAX_KF,
    max_feat: int = C.MAX_FEAT,
    max_lines: int = C.MAX_LINES,
    max_pts: int = C.MAX_PTS,
    max_maplines: int = C.MAX_MAPLINES,
    device="cpu",
) -> MapState:
    K, F, L, P, Q = max_kf, max_feat, max_lines, max_pts, max_maplines
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    u8 = dict(dtype=torch.uint8, device=device)
    b = dict(dtype=torch.bool, device=device)
    return MapState(
        kf_pose=torch.eye(4, **f32).repeat(K, 1, 1),
        kf_valid=torch.zeros(K, **b),
        kf_frame_id=torch.zeros(K, **i32),
        kf_seq=torch.zeros(K, **i32),
        kf_uv=torch.zeros((K, F, 3), **f32),
        kf_octave=torch.zeros((K, F), **i32),
        kf_angle=torch.zeros((K, F), **f32),
        kf_desc=torch.zeros((K, F, 32), **u8),
        kf_feat_valid=torch.zeros((K, F), **b),
        kf_lm_idx=torch.full((K, F), -1, **i32),
        kf_ln_obs=torch.zeros((K, L, 3), **f32),
        kf_ln_idx=torch.full((K, L), -1, **i32),
        kf_ln_valid=torch.zeros((K, L), **b),
        kf_ln_desc=torch.zeros((K, L, 32), **u8),
        kf_ln_sp=torch.zeros((K, L, 2), **f32),
        kf_ln_ep=torch.zeros((K, L, 2), **f32),
        pt_pos=torch.zeros((P, 3), **f32),
        pt_desc=torch.zeros((P, 32), **u8),
        pt_normal=torch.zeros((P, 3), **f32),
        pt_dist=torch.zeros((P, 2), **f32),
        pt_valid=torch.zeros(P, **b),
        pt_ref_kf=torch.zeros(P, **i32),
        pt_first_kf=torch.zeros(P, **i32),
        pt_first_seq=torch.zeros(P, **i32),
        pt_nobs=torch.zeros(P, **i32),
        pt_visible=torch.ones(P, **f32),
        pt_found=torch.ones(P, **f32),
        pt_replaced=torch.full((P,), -1, **i32),
        ln_sw=torch.zeros((Q, 3), **f32),
        ln_ew=torch.zeros((Q, 3), **f32),
        ln_desc=torch.zeros((Q, 32), **u8),
        ln_normal=torch.zeros((Q, 3), **f32),
        ln_dist=torch.zeros((Q, 2), **f32),
        ln_valid=torch.zeros(Q, **b),
        ln_ref_kf=torch.zeros(Q, **i32),
        ln_first_kf=torch.zeros(Q, **i32),
        ln_first_seq=torch.zeros(Q, **i32),
        ln_nobs=torch.zeros(Q, **i32),
        ln_visible=torch.ones(Q, **f32),
        ln_found=torch.ones(Q, **f32),
        n_kf=torch.zeros((), **i32),
        n_pt=torch.zeros((), **i32),
        n_ln=torch.zeros((), **i32),
        next_kf_seq=torch.zeros((), **i32),
    )


def refresh_counts(m: MapState) -> MapState:
    """n_kf / n_pt / n_ln = number of currently valid entities."""
    return m._replace(
        n_kf=torch.sum(m.kf_valid).to(torch.int32),
        n_pt=torch.sum(m.pt_valid).to(torch.int32),
        n_ln=torch.sum(m.ln_valid).to(torch.int32),
    )


def observation_matrix(m: MapState):
    """bool[K, P] incidence: keyframe k observes map point p."""
    K, F = m.kf_lm_idx.shape
    P = m.pt_valid.shape[0]
    ok = (m.kf_lm_idx >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    cols = torch.where(ok, m.kf_lm_idx, P).long()  # column P collects the drops
    return torch.zeros((K, P + 1), dtype=torch.bool, device=ok.device).scatter(1, cols, True)[:, :P]


def covisibility(m: MapState, obs=None):
    """i32[K, K] shared-landmark counts, zero diagonal."""
    if obs is None:
        obs = observation_matrix(m)
    o = obs.to(torch.float32)
    w = (o @ o.t()).to(torch.int32)
    return w * (1 - torch.eye(w.shape[0], dtype=torch.int32, device=w.device))


def _incidence_counts(ids, ok, P, w=None, reduce_rows=False):
    """Observation counts from per-row id lists: i32[K, P] with
    out[k, p] = sum_f w[k, f] * (ids[k, f] == p) over the rows where `ok`,
    or with reduce_rows=True the i32[P] column sums. One integer
    `index_add` with a drop column where the reference contracts two
    one-hot operands (a TPU workaround for slow scatters); the counts are
    the same integers."""
    K, F = ids.shape
    wgt = ok.to(torch.int32) if w is None else torch.where(ok, w, 0).to(torch.int32)
    col = torch.where(ok, ids, P).long()
    if reduce_rows:
        cnt = torch.zeros(P + 1, dtype=torch.int32, device=ids.device)
        return cnt.index_add(0, col.reshape(-1), wgt.reshape(-1))[:P]
    cnt = torch.zeros((K, P + 1), dtype=torch.int32, device=ids.device)
    return cnt.scatter_add(1, col, wgt)[:, :P]


def clear_dead_references(m: MapState) -> MapState:
    """Drop kf_lm_idx / kf_ln_idx references to invalidated landmarks, so a
    recycled slot is never reached through a stale reference."""
    lm = m.kf_lm_idx
    lm_ok = (lm >= 0) & m.pt_valid[torch.clamp(lm, min=0).long()]
    ln = m.kf_ln_idx
    ln_ok = (ln >= 0) & m.ln_valid[torch.clamp(ln, min=0).long()]
    return m._replace(kf_lm_idx=torch.where(lm_ok, lm, -1), kf_ln_idx=torch.where(ln_ok, ln, -1))


def weighted_point_nobs(m: MapState):
    """i32[P]: observations per map point, stereo ones (u_r >= 0) counting
    2 and mono ones 1 (MapPoint::AddObservation)."""
    P = m.pt_valid.shape[0]
    ok = (m.kf_lm_idx >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    w = torch.where(m.kf_uv[..., 2] >= 0, 2, 1).to(torch.int32)
    return _incidence_counts(m.kf_lm_idx, ok, P, w=w, reduce_rows=True)


def line_observation_matrix(m: MapState):
    """bool[K, Q] incidence: keyframe k observes map line q."""
    Q = m.ln_valid.shape[0]
    ok = (m.kf_ln_idx >= 0) & m.kf_ln_valid & m.kf_valid[:, None]
    return _incidence_counts(m.kf_ln_idx, ok, Q) > 0


def point_obs_count(m: MapState, obs=None):
    """i32[P]: number of keyframes observing each point."""
    if obs is None:
        obs = observation_matrix(m)
    return torch.sum(obs, 0).to(torch.int32)
