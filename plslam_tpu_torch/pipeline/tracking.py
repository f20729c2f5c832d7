"""The tracking front end: one step per frame over (TrackState, FrameData).

Port of plslam_tpu/pipeline/tracking.py: stereo initialisation from
depth, motion-model projection matching + pose LM (kernel B3), the
TrackReferenceKeyFrame fallback, TrackLocalMap over the covisibility
working set, map-line matching by projection, the joint point+line pose LM
(B3 with line rows), the keyframe decision, and masked in-step keyframe /
landmark / map-line insertion. State is fixed-capacity and mask-driven
like the reference's.

Differences in mechanism (results are the reference's):
  * The reference's `lax.cond`s are decided on the device, with no host
    synchronisation in the step. The ref-KF fallback (tracking.py:700) is
    computed beside the motion-model result and picked with `torch.where`.
    The init/track switch (:871) runs one branch where the caller knows
    the status (`step(..., initialised=)`; System always knows it at
    `pipeline_depth=0`, and from the first finalized frame on when
    pipelined) and both, picked field by field with `torch.where`, where
    it does not: an unknown status costs the init branch (a few fills, no
    B3 launch) and the pick. The in-step working-set refresh (:908, only
    with `in_step_local_refresh`) is computed on every frame and kept
    where a keyframe was inserted: the covisibility scan on every frame of
    a mapper-less caller. chip_smoke.py's pipelined phase measures the
    launches and device time of both (PERF.md, §5).
  * Scatters with `mode="drop"` route out-of-range rows to a scratch row;
    among duplicate targets the last source row wins, as on the
    reference's CPU backend.
  * `jnp.nonzero(size=...)` becomes a cumsum compaction (no host sync).
  * Point-only settings (`UseLines: 0`) skip line matching, the line rows
    of the joint solve and map-line insertion: no keyline is ever valid
    there, so the reference's line work changes nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.config import Settings
from plslam_tpu_torch.features.frame import FrameData
from plslam_tpu_torch.features.orb import inv_sigma2_table
from plslam_tpu_torch.geometry import camera, se3
from plslam_tpu_torch.matching import lines as line_ops
from plslam_tpu_torch.matching import points as match_ops
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.slammap.state import MapState, empty_map, refresh_counts
from plslam_tpu_torch.solvers.pose import LineObs, PointObs, pose_optimization
from plslam_tpu_torch.utils.device import resolve_device

ST_UNINIT = 0
ST_OK = 1
ST_LOST = 2


class LastFrame(NamedTuple):
    uvr: torch.Tensor  # f32[N, 3]
    octave: torch.Tensor  # i32[N]
    angle: torch.Tensor  # f32[N]
    desc: torch.Tensor  # u8[N, 32] observed descriptors (frame-to-frame matching)
    depth: torch.Tensor  # f32[N] measured depth (temporary VO points)
    valid: torch.Tensor  # bool[N]
    lm_idx: torch.Tensor  # i32[N] landmark per feature (-1 none)
    Tcw: torch.Tensor  # f32[4, 4]


class TrackState(NamedTuple):
    m: MapState
    velocity: torch.Tensor  # f32[4, 4] Tcl (current <- last)
    vel_ok: torch.Tensor  # bool[]
    ref_kf: torch.Tensor  # i32[]
    frames_since_kf: torch.Tensor  # i32[]
    status: torch.Tensor  # i32[]
    frame_id: torch.Tensor  # i32[]
    only_tracking: torch.Tensor  # bool[] localization-only mode
    local_set: torch.Tensor  # i32[WS] landmark ids of the local map, -1 fill
    last: LastFrame


class StepOut(NamedTuple):
    Tcw: torch.Tensor  # f32[4, 4]
    tracked: torch.Tensor  # bool[]
    new_kf: torch.Tensor  # bool[]
    kf_id: torch.Tensor  # i32[] slot of the new KF (valid when new_kf)
    ref_kf: torch.Tensor  # i32[]
    rel_pose: torch.Tensor  # f32[4, 4] Tcr (current <- ref KF)
    n_inliers: torch.Tensor  # i32[]
    n_matches: torch.Tensor  # i32[]
    telemetry: torch.Tensor  # f32[TEL_FIXED + 32 + max_kf], layout TEL_*


# StepOut.telemetry layout: everything a host loop needs per frame in one
# f32 vector, so one device->host read serves a frame.
TEL_TRACKED = 0
TEL_NEW_KF = 1
TEL_KF_ID = 2
TEL_REF_KF = 3
TEL_N_INLIERS = 4
TEL_N_MATCHES = 5
TEL_STATUS = 6
TEL_N_KF = 7
TEL_N_PT = 8
TEL_N_LN = 9
TEL_FIXED = 10
TEL_REL_POSE = slice(TEL_FIXED, TEL_FIXED + 16)
TEL_TCW = slice(TEL_FIXED + 16, TEL_FIXED + 32)
TEL_KF_VALID = TEL_FIXED + 32  # [max_kf] post-insert kf_valid


class _BranchOut(NamedTuple):
    """Per-branch result; all map mutation happens after the branch."""

    do_insert: torch.Tensor  # bool[]
    lm_of_kp: torch.Tensor  # i32[N]
    ml_of_ln: torch.Tensor  # i32[L] map-line binding per keyline
    Tcw: torch.Tensor  # f32[4, 4]
    last_Tcw: torch.Tensor  # f32[4, 4]
    update_last: torch.Tensor  # bool[]
    status: torch.Tensor  # i32[]
    tracked: torch.Tensor  # bool[]
    velocity: torch.Tensor  # f32[4, 4]
    vel_ok: torch.Tensor  # bool[]
    fsk_no_insert: torch.Tensor  # i32[]
    n_inliers: torch.Tensor  # i32[]
    n_matches: torch.Tensor  # i32[]
    count_counters: torch.Tensor  # bool[]
    vis_ws: torch.Tensor  # bool[WS]
    already: torch.Tensor  # bool[P]
    ml_vis: torch.Tensor  # bool[Q] projected map-line visibility


def _drop_target(idx, n):
    """Indices outside [0, n) go to the scratch row n."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _as_rows(val, dst, n):
    """A tensor or Python scalar as n rows shaped like dst's. Scalars are
    filled on the device (a host-made tensor would be a blocking copy)."""
    if not torch.is_tensor(val):
        val = torch.full((), val, dtype=dst.dtype, device=dst.device)
    return val.to(dst.dtype).expand((n,) + dst.shape[1:])


def set_drop(dst, idx, val):
    """dst.at[idx].set(val, mode="drop"), functional. Among duplicate
    indices the last source row wins (the reference's CPU order)."""
    n = dst.shape[0]
    tgt = _drop_target(idx, n)
    pos = torch.arange(tgt.shape[0], device=dst.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=dst.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    tgt = torch.where(last[tgt] == pos, tgt, n)
    val = _as_rows(val, dst, tgt.shape[0])
    out = torch.cat([dst, dst[:1]], 0)
    out[tgt] = val
    return out[:n]


def add_drop(dst, idx, val):
    """dst.at[idx].add(val, mode="drop"), functional."""
    n = dst.shape[0]
    tgt = _drop_target(idx, n)
    val = _as_rows(val, dst, tgt.shape[0])
    out = torch.cat([dst, torch.zeros_like(dst[:1])], 0)
    out.index_put_((tgt,), val, accumulate=True)
    return out[:n]


def set_row(a, k, row, do):
    """a.at[k].set(where(do, row, a[k])) for a 0-dim index tensor k."""
    kk = k.reshape(1).long()
    out = a.clone()
    out.index_copy_(0, kk, torch.where(do, row, a.index_select(0, kk)[0])[None])
    return out


def free_slots(valid, want):
    """First-free-slot allocation: the entries where `want` is set take the
    free slots (valid False) in index order -> (slot per entry, want
    restricted to the entries that got one)."""
    pos = torch.cumsum(want.to(torch.int32), 0) - 1
    free_order = torch.argsort(valid.to(torch.int8), stable=True)  # free slots first
    want = want & (pos < torch.sum(~valid))
    return free_order[torch.clamp(pos, min=0).long()].to(torch.int32), want


def take_row(a, k):
    """a[k] for a Python int or a 0-dim index tensor k. Indexing with a 0-dim
    tensor reads it back to the host (a device synchronisation);
    `index_select` does not."""
    if torch.is_tensor(k):
        return a.index_select(0, k.reshape(1).long())[0]
    return a[k]


def _norm(x):
    return torch.sqrt(torch.sum(x * x, -1))


class Tracker:
    """Static-config tracking pipeline. Use init_state() and step()."""

    def __init__(
        self,
        settings: Settings,
        max_kf: int = C.MAX_KF,
        max_pts: int = C.MAX_PTS,
        max_feat: int = C.MAX_FEAT,
        max_lines: int = C.MAX_LINES,
        max_maplines: int = C.MAX_MAPLINES,
        in_step_local_refresh: bool = True,
        device="cuda",
    ):
        """in_step_local_refresh: recompute the TrackLocalMap working set
        inside the step on keyframe frames. A caller that refreshes it
        itself after changing the map (`refresh_local_set`) sets it False."""
        self.s = settings
        self.device = resolve_device(device)
        K, _ = settings.intrinsics()
        self.K_host = K
        self.K = torch.from_numpy(K).to(self.device)
        self.bf = float(settings.bf)
        self.width, self.height = settings.width, settings.height
        self.depth_th = float(settings.depth_th)
        self.max_kf, self.max_pts, self.max_feat = max_kf, max_pts, max_feat
        self.max_lines, self.max_maplines = max_lines, max_maplines
        self.n_levels = settings.n_levels
        self.log_scale = float(np.log(settings.scale_factor))
        self.kf_max_frames = int(round(settings.fps))
        self.ws_cap = min(C.LOCAL_SET_CAP, max_pts)
        self.in_step_local_refresh = bool(in_step_local_refresh)
        self.inv_sigma2 = torch.from_numpy(inv_sigma2_table(settings.n_levels, settings.scale_factor)).to(self.device)

    # ------------------------------------------------------------ helpers
    def _scalar(self, value, dtype):
        return torch.full((), value, dtype=dtype, device=self.device)

    def _eye4(self):
        return se3.identity(device=self.device)

    # -------------------------------------------------------------- state
    def init_state(self) -> TrackState:
        N, dev = self.max_feat, self.device
        return TrackState(
            m=empty_map(self.max_kf, self.max_feat, self.max_lines, self.max_pts, self.max_maplines, device=dev),
            velocity=self._eye4(),
            vel_ok=self._scalar(False, torch.bool),
            ref_kf=self._scalar(0, torch.int32),
            frames_since_kf=self._scalar(0, torch.int32),
            status=self._scalar(ST_UNINIT, torch.int32),
            frame_id=self._scalar(0, torch.int32),
            only_tracking=self._scalar(False, torch.bool),
            local_set=torch.full((self.ws_cap,), -1, dtype=torch.int32, device=dev),
            last=LastFrame(
                uvr=torch.zeros((N, 3), dtype=torch.float32, device=dev),
                octave=torch.zeros(N, dtype=torch.int32, device=dev),
                angle=torch.zeros(N, dtype=torch.float32, device=dev),
                desc=torch.zeros((N, 32), dtype=torch.uint8, device=dev),
                depth=torch.zeros(N, dtype=torch.float32, device=dev),
                valid=torch.zeros(N, dtype=torch.bool, device=dev),
                lm_idx=torch.full((N,), -1, dtype=torch.int32, device=dev),
                Tcw=self._eye4(),
            ),
        )

    # --------------------------------------------------------- map insert
    def _insert_keyframe(self, m: MapState, frame: FrameData, Tcw, lm_of_kp, ml_of_ln, do, frame_id):
        """Masked KeyFrame + MapPoint / MapLine creation (CreateNewKeyFrame /
        StereoInitialization) into the first free slots."""
        N, P = self.max_feat, self.max_pts
        do = do & torch.any(~m.kf_valid)
        k = torch.argmax((~m.kf_valid).to(torch.int32)).to(torch.int32)  # first free KF slot

        # new landmarks: depth-valid unmatched features, depth-sorted; all
        # close ones plus up to NEW_KF_MAX_CLOSE_POINTS in all
        cand = frame.valid & (frame.depth > 0) & (lm_of_kp < 0)
        close = cand & (frame.depth < self.depth_th)
        order = torch.argsort(torch.where(cand, frame.depth, torch.inf), stable=True)
        rank = torch.empty(N, dtype=torch.int32, device=self.device)
        rank[order] = torch.arange(N, dtype=torch.int32, device=self.device)
        promote = cand & (close | (rank < C.NEW_KF_MAX_CLOSE_POINTS)) & do
        new_id, promote = free_slots(m.pt_valid, promote)
        scatter_id = torch.where(promote, new_id, P)

        Twc = se3.inverse(Tcw)
        cam_center = se3.translation(Twc)
        p_world = se3.transform(Twc, camera.backproject(self.K, frame.uvr[:, :2], frame.depth))
        dvec = p_world - cam_center
        dist = _norm(dvec)
        normal = dvec / torch.clamp(dist, min=1e-6)[:, None]
        dmax = dist * torch.exp(frame.octave.to(torch.float32) * self.log_scale)
        dmin = dmax / float(self.s.scale_factor ** (self.n_levels - 1))

        m = m._replace(
            pt_pos=set_drop(m.pt_pos, scatter_id, p_world),
            pt_desc=set_drop(m.pt_desc, scatter_id, frame.desc),
            pt_normal=set_drop(m.pt_normal, scatter_id, normal),
            pt_dist=set_drop(m.pt_dist, scatter_id, torch.stack([dmin, dmax], -1)),
            pt_valid=set_drop(m.pt_valid, scatter_id, True),
            pt_ref_kf=set_drop(m.pt_ref_kf, scatter_id, k.expand(N)),
            pt_first_kf=set_drop(m.pt_first_kf, scatter_id, k.expand(N)),
            pt_first_seq=set_drop(m.pt_first_seq, scatter_id, m.next_kf_seq.expand(N)),
            pt_nobs=set_drop(m.pt_nobs, scatter_id, 2),  # stereo observation counts double
            pt_visible=set_drop(m.pt_visible, scatter_id, 1.0),
            pt_found=set_drop(m.pt_found, scatter_id, 1.0),
            pt_replaced=set_drop(m.pt_replaced, scatter_id, -1),
        )

        # new map lines: unmatched keylines with both endpoint depths in
        # the close range, into the first free slots; matched map lines gain
        # the observation (point-only settings have no valid keyline)
        L = self.max_lines
        row_ln = torch.full((L,), -1, dtype=torch.int32, device=self.device)
        if self.s.use_lines:
            m, row_ln = self._insert_lines(m, frame, Twc, cam_center, ml_of_ln, do, k)
        m = m._replace(
            kf_ln_obs=set_row(m.kf_ln_obs, k, frame.ln_line2d, do),
            kf_ln_idx=set_row(m.kf_ln_idx, k, row_ln, do),
            kf_ln_valid=set_row(m.kf_ln_valid, k, frame.ln_valid, do),
            kf_ln_desc=set_row(m.kf_ln_desc, k, frame.ln_desc, do),
            kf_ln_sp=set_row(m.kf_ln_sp, k, frame.ln_sp, do),
            kf_ln_ep=set_row(m.kf_ln_ep, k, frame.ln_ep, do),
        )

        # keyframe row
        row_lm = torch.where(promote, new_id, torch.where(do, lm_of_kp, -1))
        matched = do & frame.valid & (lm_of_kp >= 0)
        m = m._replace(
            kf_pose=set_row(m.kf_pose, k, Tcw, do),
            kf_valid=set_row(m.kf_valid, k, self._scalar(True, torch.bool), do),
            kf_frame_id=set_row(m.kf_frame_id, k, frame_id, do),
            kf_seq=set_row(m.kf_seq, k, m.next_kf_seq, do),
            next_kf_seq=m.next_kf_seq + do.to(torch.int32),
            kf_uv=set_row(m.kf_uv, k, frame.uvr, do),
            kf_octave=set_row(m.kf_octave, k, frame.octave, do),
            kf_angle=set_row(m.kf_angle, k, frame.angle, do),
            kf_desc=set_row(m.kf_desc, k, frame.desc, do),
            kf_feat_valid=set_row(m.kf_feat_valid, k, frame.valid, do),
            kf_lm_idx=set_row(m.kf_lm_idx, k, row_lm, do),
            # observation bookkeeping for matched existing landmarks
            pt_nobs=add_drop(m.pt_nobs, torch.where(matched, lm_of_kp, P),
                             torch.where(frame.depth > 0, 2, 1).to(torch.int32)),
            # newest KF observation becomes the representative descriptor
            pt_desc=set_drop(m.pt_desc, torch.where(matched, lm_of_kp, P), frame.desc),
        )
        return refresh_counts(m), row_lm, k, do

    def _insert_lines(self, m: MapState, frame: FrameData, Twc, cam_center, ml_of_ln, do, k):
        """MapLine creation for a keyframe insert: unmatched keylines with
        both endpoint depths in the close range go to the first free slots;
        matched map lines count the observation and take the newest
        descriptor. -> (map, the keyframe row's map line per keyline)."""
        L, Q = self.max_lines, self.max_maplines
        ln_cand = (frame.ln_valid & (frame.ln_depth_sp > 0) & (frame.ln_depth_ep > 0)
                   & (frame.ln_depth_sp < self.depth_th) & (frame.ln_depth_ep < self.depth_th)
                   & (ml_of_ln < 0) & do)
        ln_new_id, ln_cand = free_slots(m.ln_valid, ln_cand)
        ln_scatter = torch.where(ln_cand, ln_new_id, Q)
        sw_w = se3.transform(Twc, camera.backproject(self.K, frame.ln_sp, frame.ln_depth_sp))
        ew_w = se3.transform(Twc, camera.backproject(self.K, frame.ln_ep, frame.ln_depth_ep))
        # viewing normal and distance band at the midpoint (lines are
        # detected on level 0: the band spans the whole pyramid)
        ln_dvec = 0.5 * (sw_w + ew_w) - cam_center
        ln_d = _norm(ln_dvec)
        ln_normal = ln_dvec / torch.clamp(ln_d, min=1e-6)[:, None]
        ln_dmin = ln_d / float(self.s.scale_factor ** (self.n_levels - 1))
        m = m._replace(
            ln_sw=set_drop(m.ln_sw, ln_scatter, sw_w),
            ln_ew=set_drop(m.ln_ew, ln_scatter, ew_w),
            ln_normal=set_drop(m.ln_normal, ln_scatter, ln_normal),
            ln_dist=set_drop(m.ln_dist, ln_scatter, torch.stack([ln_dmin, ln_d], -1)),
            ln_desc=set_drop(m.ln_desc, ln_scatter, frame.ln_desc),
            ln_valid=set_drop(m.ln_valid, ln_scatter, True),
            ln_ref_kf=set_drop(m.ln_ref_kf, ln_scatter, k.expand(L)),
            ln_first_kf=set_drop(m.ln_first_kf, ln_scatter, k.expand(L)),
            ln_first_seq=set_drop(m.ln_first_seq, ln_scatter, m.next_kf_seq.expand(L)),
            ln_nobs=set_drop(m.ln_nobs, ln_scatter, 2),
            ln_visible=set_drop(m.ln_visible, ln_scatter, 1.0),
            ln_found=set_drop(m.ln_found, ln_scatter, 1.0),
        )
        row_ln = torch.where(ln_cand, ln_new_id, torch.where(do, ml_of_ln, -1))
        ln_matched = torch.where(do & frame.ln_valid & (ml_of_ln >= 0), ml_of_ln, Q)
        m = m._replace(
            ln_nobs=add_drop(m.ln_nobs, ln_matched, 2),
            ln_desc=set_drop(m.ln_desc, ln_matched, frame.ln_desc),
        )
        return m, row_ln

    # ---------------------------------------------------------- local set
    def _compute_local_set(self, m: MapState, k):
        """Landmark ids observed by keyframe k and its top LOCAL_COVIS_KFS
        covisible keyframes, deduplicated, ascending, -1 fill to ws_cap.
        k is a 0-dim tensor; nothing here reads the device back."""
        P = self.max_pts
        row = take_row(m.kf_lm_idx, k)
        row_ok = take_row(m.kf_feat_valid, k) & (row >= 0)
        member_k = set_drop(torch.zeros(P, dtype=torch.bool, device=self.device),
                            torch.where(row_ok, row, P), True)
        # covisibility weight of every KF against k: how many of its
        # features observe a landmark of k
        ids = m.kf_lm_idx
        ok = m.kf_feat_valid & (ids >= 0) & m.kf_valid[:, None]
        w = torch.sum(ok & member_k[torch.clamp(ids, min=0).long()], 1).to(torch.int32)
        w = set_drop(w, k.reshape(1), 0)
        top = torch.argsort(-w, stable=True)[: C.LOCAL_COVIS_KFS]
        rows = m.kf_lm_idx[top]
        rows_ok = m.kf_feat_valid[top] & (rows >= 0) & (w[top] > 0)[:, None]
        member = set_drop(member_k, torch.where(rows_ok, rows, P).reshape(-1), True)
        member &= m.pt_valid
        # first ws_cap member ids in ascending order (jnp.nonzero(size=...))
        pos = torch.cumsum(member.to(torch.int32), 0) - 1
        tgt = torch.where(member & (pos < self.ws_cap), pos, self.ws_cap).long()
        ws = torch.full((self.ws_cap + 1,), -1, dtype=torch.int32, device=self.device)
        ws.scatter_(0, tgt, torch.arange(P, dtype=torch.int32, device=self.device))
        return ws[: self.ws_cap]

    def refresh_local_set(self, ts: TrackState) -> TrackState:
        """The working set recomputed around the current reference keyframe,
        for callers that change the map outside the step (System after a
        relocalization). Device work only, no host sync."""
        return ts._replace(local_set=self._compute_local_set(ts.m, ts.ref_kf))

    # ------------------------------------------------------------ project
    def _project_points_subset(self, pos, normal, dist_band, valid, Tcw):
        """Frustum + scale-band + viewing-angle gates (Frame::isInFrustum).
        -> (uv, pred_oct, vis, view_cos)."""
        p_cam = se3.transform(Tcw, pos)
        uv = camera.project(self.K, p_cam)
        in_img = camera.in_image(uv, self.width, self.height)
        cam_center = se3.translation(se3.inverse(Tcw))
        dvec = pos - cam_center
        dist = _norm(dvec)
        dmin, dmax = dist_band[:, 0], dist_band[:, 1]
        in_band = (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
        view_cos = torch.sum(dvec * normal, -1) / torch.clamp(dist, min=1e-6)
        vis = valid & (p_cam[:, 2] > 0.05) & in_img & in_band & (view_cos > 0.5)
        ratio = torch.clamp(dmax / torch.clamp(dist, min=1e-6), min=1.0)
        pred_oct = torch.clamp(torch.ceil(torch.log(ratio) / self.log_scale).to(torch.int32), 0, self.n_levels - 1)
        return uv, pred_oct, vis, view_cos

    def _project_lines(self, m: MapState, Tcw):
        """Project map-line endpoints -> (mid [Q, 2], angle [Q], vis [Q]):
        frustum, viewing-angle and midpoint distance-band gates."""
        sp_c = se3.transform(Tcw, m.ln_sw)
        ep_c = se3.transform(Tcw, m.ln_ew)
        sp_uv = camera.project(self.K, sp_c)
        ep_uv = camera.project(self.K, ep_c)
        mid = 0.5 * (sp_uv + ep_uv)
        seg = ep_uv - sp_uv
        ang = torch.atan2(seg[:, 1], seg[:, 0])
        cam_center = se3.translation(se3.inverse(Tcw))
        dvec = 0.5 * (m.ln_sw + m.ln_ew) - cam_center
        dist = _norm(dvec)
        in_band = (dist >= 0.8 * m.ln_dist[:, 0]) & (dist <= 1.2 * m.ln_dist[:, 1])
        view_cos = torch.sum(dvec * m.ln_normal, -1) / torch.clamp(dist, min=1e-6)
        vis = (m.ln_valid & (sp_c[:, 2] > 0.05) & (ep_c[:, 2] > 0.05)
               & camera.in_image(mid, self.width, self.height) & in_band & (view_cos > 0.5))
        return mid, ang, vis

    # --------------------------------------------------------- pose solve
    def _point_obs(self, frame: FrameData, xw, valid):
        return PointObs(
            xw=xw,
            obs=frame.uvr,
            inv_sigma2=self.inv_sigma2[torch.clamp(frame.octave, 0, self.n_levels - 1).long()],
            is_stereo=frame.depth > 0,
            valid=valid,
        )

    def _solve_pose(self, frame: FrameData, lm_of_kp, pt_pos, Tcw0):
        has = frame.valid & (lm_of_kp >= 0)
        pts = self._point_obs(frame, pt_pos[torch.clamp(lm_of_kp, min=0).long()], has)
        Tcw, inlier, _ = pose_optimization(Tcw0, pts, self.K_host, self.bf)
        return Tcw, inlier & has

    # --------------------------------------------------------------- step
    def _do_init(self, ts: TrackState, frame: FrameData) -> _BranchOut:
        min_init = min(100, self.max_feat // 2)
        enough = (torch.sum(frame.valid & (frame.depth > 0)) > min_init) & ~ts.only_tracking
        I = self._eye4()
        zero = self._scalar(0, torch.int32)
        return _BranchOut(
            do_insert=enough,
            lm_of_kp=torch.full((self.max_feat,), -1, dtype=torch.int32, device=self.device),
            ml_of_ln=torch.full((self.max_lines,), -1, dtype=torch.int32, device=self.device),
            Tcw=I, last_Tcw=I, update_last=self._scalar(True, torch.bool),
            status=torch.where(enough, ST_OK, ST_UNINIT).to(torch.int32),
            tracked=enough, velocity=ts.velocity, vel_ok=self._scalar(False, torch.bool),
            fsk_no_insert=zero, n_inliers=zero, n_matches=zero,
            count_counters=self._scalar(False, torch.bool),
            vis_ws=torch.zeros(self.ws_cap, dtype=torch.bool, device=self.device),
            already=torch.zeros(self.max_pts, dtype=torch.bool, device=self.device),
            ml_vis=torch.zeros(self.max_maplines, dtype=torch.bool, device=self.device),
        )

    def _do_track(self, ts: TrackState, frame: FrameData) -> _BranchOut:
        m, N, P = ts.m, self.max_feat, self.max_pts
        dev = self.device
        iota_n = torch.arange(N, dtype=torch.int32, device=dev)
        # ---- 0. CheckReplacedInLastFrame: follow Replace forwarding (two
        # hops), then drop bindings to invalidated landmarks
        lm_last = ts.last.lm_idx
        for _ in range(2):
            fwd = m.pt_replaced[torch.clamp(lm_last, min=0).long()]
            lm_last = torch.where((lm_last >= 0) & (fwd >= 0), fwd, lm_last)
        lm_last = torch.where((lm_last >= 0) & m.pt_valid[torch.clamp(lm_last, min=0).long()], lm_last, -1)
        last = ts.last._replace(lm_idx=lm_last)

        # ---- 1. motion-model matching against the last frame's landmarks
        # and depth-backprojected (temporary VO) points
        T_pred = torch.where(ts.vel_ok, se3.compose(ts.velocity, last.Tcw), last.Tcw)
        has_lm = last.valid & (last.lm_idx >= 0)
        has_vo = last.valid & (last.depth > 0)
        vo_pos = se3.transform(se3.inverse(last.Tcw), camera.backproject(self.K, last.uvr[:, :2], last.depth))
        tgt_pos = torch.where(has_lm[:, None], m.pt_pos[torch.clamp(last.lm_idx, min=0).long()], vo_pos)
        tgt_valid = has_lm | has_vo
        # windows are placed from the observed geometry where depth exists;
        # the solve still uses the landmark position where bound
        win_pos = torch.where(has_vo[:, None], vo_pos, tgt_pos)
        lp_cam = se3.transform(T_pred, win_pos)
        lp_uv = camera.project(self.K, lp_cam)
        tgt_valid &= lp_cam[:, 2] > 0.05
        radius = torch.where(ts.vel_ok, 7.0, 15.0).to(torch.float32)
        match_kp, _ = match_ops.search_by_projection(
            frame.uvr[:, :2], frame.octave, frame.pm1, frame.valid,
            lp_uv, last.octave, brief.unpack_bits_pm1(last.desc), tgt_valid,
            radius=radius, th_dist=C.TH_HIGH,
            kp_angle=frame.angle, lm_angle=last.angle,
        )
        tgt_of_kp = set_drop(torch.full((N,), -1, dtype=torch.int32, device=dev),
                             torch.where(match_kp >= 0, match_kp, N), torch.where(match_kp >= 0, iota_n, -1))
        has1 = (tgt_of_kp >= 0) & frame.valid
        tgt_c = torch.clamp(tgt_of_kp, min=0).long()
        n1 = torch.sum(has1)

        # ---- 1b. TrackReferenceKeyFrame fallback, computed beside the
        # motion-model result and selected (the reference's lax.cond)
        ref = ts.ref_kf
        ref_lm_row = take_row(m.kf_lm_idx, ref)
        ref_feat_valid = take_row(m.kf_feat_valid, ref)
        mb, _ = match_ops.match_descriptors(
            frame.pm1, frame.valid, brief.unpack_bits_pm1(take_row(m.kf_desc, ref)),
            ref_feat_valid & (ref_lm_row >= 0),
            th_dist=C.TH_LOW, nn_ratio=0.7, angle_a=frame.angle, angle_b=take_row(m.kf_angle, ref),
        )
        lm_fb = torch.where(mb >= 0, ref_lm_row[torch.clamp(mb, min=0).long()], -1)
        has_fb = frame.valid & (lm_fb >= 0)
        enough = torch.sum(has_fb) >= C.MIN_MATCHES_REF_KF
        # both solves start from the last validated pose (the velocity only
        # places windows) and depend on each other in nothing: one stacked
        # call, one launch of B3 on the card (problem 0: motion model, 1:
        # fallback). The frame's observations are shared, not copied.
        obs = self._point_obs(frame, tgt_pos[tgt_c], has1)
        both = PointObs(
            xw=torch.stack([obs.xw, m.pt_pos[torch.clamp(lm_fb, min=0).long()]]),
            obs=obs.obs.expand(2, -1, -1), inv_sigma2=obs.inv_sigma2.expand(2, -1),
            is_stereo=obs.is_stereo.expand(2, -1), valid=torch.stack([has1, has_fb & enough]),
        )
        Tcw_2, inl_2, _ = pose_optimization(last.Tcw.expand(2, -1, -1), both, self.K_host, self.bf)
        Tcw1, inl1 = Tcw_2[0], inl_2[0] & has1
        tgt_lm = last.lm_idx[tgt_c]
        lm_mm = torch.where(inl1 & (tgt_of_kp >= 0) & (tgt_lm >= 0), tgt_lm, -1)
        ok_mm = (n1 >= C.MIN_MATCHES_MOTION_MODEL) & (torch.sum(inl1) >= 10)
        Tcw_fb, inl_fb = torch.where(enough, Tcw_2[1], last.Tcw), inl_2[1]
        lm_fb = torch.where(inl_fb & has_fb & enough, lm_fb, -1)
        Tcw1 = torch.where(ok_mm, Tcw1, Tcw_fb)
        lm_of_kp = torch.where(ok_mm, lm_mm, lm_fb)

        # ---- 2. TrackLocalMap over the covisibility working set
        ws = ts.local_set
        wsc = torch.clamp(ws, min=0).long()
        valid_ws = (ws >= 0) & m.pt_valid[wsc]
        uv_p, oct_p, vis, _ = self._project_points_subset(m.pt_pos[wsc], m.pt_normal[wsc], m.pt_dist[wsc], valid_ws, Tcw1)
        already = set_drop(torch.zeros(P, dtype=torch.bool, device=dev), torch.where(lm_of_kp >= 0, lm_of_kp, P), True)
        vis &= ~already[wsc]
        match_kp2, _ = match_ops.search_by_projection(
            frame.uvr[:, :2], frame.octave, frame.pm1, frame.valid & (lm_of_kp < 0),
            uv_p, oct_p, brief.unpack_bits_pm1(m.pt_desc[wsc]), vis,
            radius=3.0, th_dist=C.TH_HIGH, nn_ratio=0.9,
        )
        lm_of_kp = set_drop(lm_of_kp, torch.where(match_kp2 >= 0, match_kp2, N), torch.where(match_kp2 >= 0, ws, -1))
        n2 = torch.sum(lm_of_kp >= 0).to(torch.int32)

        # ---- 2b. map-line matching (LSDmatcher::SearchByProjection);
        # skipped for point-only settings, where no keyline is ever valid
        # and so no map line exists
        L, Q = self.max_lines, self.max_maplines
        ml_of_ln = torch.full((L,), -1, dtype=torch.int32, device=dev)
        ml_vis = torch.zeros(Q, dtype=torch.bool, device=dev)
        lines = None
        if self.s.use_lines:
            ml_mid, ml_ang, ml_vis = self._project_lines(m, Tcw1)
            match_ln, _ = line_ops.search_lines_by_projection(
                0.5 * (frame.ln_sp + frame.ln_ep), frame.ln_angle, frame.ln_pm1, frame.ln_valid,
                ml_mid, ml_ang, brief.unpack_bits_pm1(m.ln_desc), ml_vis,
            )
            ml_of_ln = set_drop(ml_of_ln, torch.where(match_ln >= 0, match_ln, L),
                                torch.where(match_ln >= 0, torch.arange(Q, dtype=torch.int32, device=dev), -1))
            mlc = torch.clamp(ml_of_ln, min=0).long()
            lines = LineObs(sw=m.ln_sw[mlc], ew=m.ln_ew[mlc], line2d=frame.ln_line2d,
                            inv_sigma2=torch.ones(L, dtype=torch.float32, device=dev),
                            valid=(ml_of_ln >= 0) & frame.ln_valid)

        # ---- 2c. joint point+line refinement
        has2 = frame.valid & (lm_of_kp >= 0)
        Tcw2, inl2, inl_ln = pose_optimization(
            Tcw1, self._point_obs(frame, m.pt_pos[torch.clamp(lm_of_kp, min=0).long()], has2),
            self.K_host, self.bf, lines=lines,
        )
        lm_of_kp = torch.where(inl2 & has2, lm_of_kp, -1)
        if lines is not None:
            ml_of_ln = torch.where(inl_ln & lines.valid, ml_of_ln, -1)
        n_inliers = torch.sum(lm_of_kp >= 0).to(torch.int32)
        # chi2-validated line inliers count toward the TrackLocalMap gate
        n_ln_inliers = torch.sum(ml_of_ln >= 0).to(torch.int32)
        ok = n_inliers + C.LINE_INLIER_GATE_WEIGHT * n_ln_inliers >= C.MIN_INLIERS_TRACK_LOCAL_MAP

        # ---- 3. keyframe policy (NeedNewKeyFrame); close-point thresholds
        # scale with the feature budget
        close = (frame.depth > 0) & (frame.depth < self.depth_th) & frame.valid
        tracked_close = torch.sum(close & (lm_of_kp >= 0))
        free_close = torch.sum(close & (lm_of_kp < 0))
        feat_scale = min(1.0, self.s.n_features / 1000.0)
        need_close = (tracked_close < round(C.KF_TRACKED_CLOSE_MIN * feat_scale)) & (
            free_close > round(C.KF_NONTRACKED_CLOSE_MIN * feat_scale)
        )
        ref_lm_ok = (ref_lm_row >= 0) & ref_feat_valid
        ref_nobs = m.pt_nobs[torch.clamp(ref_lm_row, min=0).long()]
        min_obs = torch.where(m.n_kf <= 2, 2, 3)
        ref_matches = torch.sum(ref_lm_ok & (ref_nobs >= min_obs))
        c1 = ts.frames_since_kf + 1 >= self.kf_max_frames
        c2 = (n_inliers < C.KF_REF_RATIO_RGBD * ref_matches.to(torch.float32)) | need_close
        c1b = ts.frames_since_kf + 1 >= C.KF_MIN_FRAMES
        need_kf = ok & (c1 | c2) & c1b & (n_inliers > 15) & ~ts.only_tracking

        was_ok = torch.clamp(ts.status, 0, 2) == ST_OK
        return _BranchOut(
            do_insert=need_kf, lm_of_kp=lm_of_kp, ml_of_ln=ml_of_ln,
            Tcw=Tcw2, last_Tcw=torch.where(ok, Tcw2, last.Tcw),
            update_last=ok | was_ok,
            status=torch.where(ok, ST_OK, ST_LOST).to(torch.int32),
            tracked=ok, velocity=se3.compose(Tcw2, se3.inverse(last.Tcw)), vel_ok=ok & was_ok,
            fsk_no_insert=ts.frames_since_kf + 1,
            n_inliers=n_inliers, n_matches=n2,
            count_counters=ok | was_ok,
            vis_ws=vis, already=already, ml_vis=ml_vis,
        )

    def step(self, ts: TrackState, frame: FrameData, initialised: bool | None = None):
        """One frame -> (new TrackState, StepOut). Nothing is read back.

        initialised: what the caller knows of ts.status. False: UNINIT, only
        the init branch runs; True: OK or LOST, only the track branch runs;
        None: unknown, both run and each output is picked on the device
        (the reference's lax.cond at tracking.py:871). Status returns to
        UNINIT only through init_state or a failed init, so once a frame
        has read OK or LOST every later state is initialised."""
        P = self.max_pts
        is_init = torch.clamp(ts.status, 0, 2) == ST_UNINIT
        if initialised is None:
            a, b = self._do_init(ts, frame), self._do_track(ts, frame)
            req = _BranchOut(*(torch.where(is_init, x, y) for x, y in zip(a, b)))
        else:
            req = self._do_track(ts, frame) if initialised else self._do_init(ts, frame)

        # ---- epilogue: all map mutation happens here
        m = ts.m
        cc = req.count_counters & ~ts.only_tracking
        wsc = torch.clamp(ts.local_set, min=0)
        m = m._replace(
            pt_visible=add_drop(m.pt_visible, torch.where(req.vis_ws & cc, wsc, P), 1.0)
            + torch.where(cc, req.already.to(torch.float32), 0.0),
            pt_found=add_drop(m.pt_found, torch.where((req.lm_of_kp >= 0) & cc, req.lm_of_kp, P), 1.0),
        )
        if self.s.use_lines:
            m = m._replace(
                ln_visible=m.ln_visible + torch.where(cc, req.ml_vis.to(torch.float32), 0.0),
                ln_found=add_drop(m.ln_found, torch.where((req.ml_of_ln >= 0) & cc, req.ml_of_ln,
                                                          self.max_maplines), 1.0),
            )
        m, row_lm, k, did_insert = self._insert_keyframe(
            m, frame, req.Tcw, req.lm_of_kp, req.ml_of_ln, req.do_insert, ts.frame_id)
        lm_final = torch.where(did_insert, row_lm, req.lm_of_kp)
        ref_kf = torch.where(did_insert, k, ts.ref_kf)
        local_set = ts.local_set
        # the reference's lax.cond at tracking.py:908, picked on the device:
        # the working set around a keyframe inserted here; callers that
        # refresh the set themselves skip the scan
        if self.in_step_local_refresh:
            local_set = torch.where(did_insert, self._compute_local_set(m, k), local_set)
        last_new = LastFrame(
            uvr=frame.uvr, octave=frame.octave, angle=frame.angle,
            desc=frame.desc, depth=frame.depth, valid=frame.valid,
            lm_idx=lm_final, Tcw=req.last_Tcw,
        )
        last = LastFrame(*(torch.where(req.update_last, a, b) for a, b in zip(last_new, ts.last)))
        n_init = torch.sum(row_lm >= 0).to(torch.int32)
        rel_pose = torch.where(is_init, self._eye4(), se3.compose(req.Tcw, se3.inverse(take_row(m.kf_pose, ref_kf))))
        new_ts = ts._replace(
            m=m,
            velocity=req.velocity,
            vel_ok=req.vel_ok,
            ref_kf=ref_kf,
            local_set=local_set,
            frames_since_kf=torch.where(did_insert, 0, req.fsk_no_insert).to(torch.int32),
            status=req.status,
            frame_id=ts.frame_id + 1,
            last=last,
        )
        n_inl = torch.where(is_init, n_init, req.n_inliers)
        n_mat = torch.where(is_init, n_init, req.n_matches)
        f = lambda x: x.to(torch.float32).reshape(-1)  # noqa: E731
        telemetry = torch.cat([
            f(req.tracked), f(did_insert), f(k), f(ref_kf), f(n_inl), f(n_mat), f(req.status),
            f(m.n_kf), f(m.n_pt), f(m.n_ln), f(rel_pose), f(req.Tcw), f(m.kf_valid),
        ])
        out = StepOut(
            Tcw=req.Tcw, tracked=req.tracked, new_kf=did_insert, kf_id=k, ref_kf=ref_kf,
            rel_pose=rel_pose, n_inliers=n_inl, n_matches=n_mat, telemetry=telemetry,
        )
        return new_ts, out
