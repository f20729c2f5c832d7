"""Local mapping: map maintenance and local bundle adjustment per keyframe.

Port of plslam_tpu/pipeline/mapping.py (the LocalMapping thread as one
chain the host runs after each keyframe insertion), in the reference's
order:

  * MapPointCulling + MapLineCulling: recent landmarks with a low found
    ratio or too few observations are invalidated.
  * CreateNewMapPoints: depthless features of the new keyframe matched
    under the epipolar constraint against its covisible keyframes and
    triangulated (solvers/triangulate.py); CreateNewMapLines: unbound
    keylines matched by LBD against the best covisible keyframe and
    triangulated by plane intersection.
  * SearchInNeighbors: every visible map point and line projected into
    the new keyframe (bind a free feature, or Replace a duplicate: the
    landmark with more observations wins), then the new keyframe's points
    into its first- and second-degree covisible neighbours.
  * LocalBundleAdjustment (solvers/local_ba.py).
  * Distinctive descriptors, normals and distance bands of the new
    keyframe's landmarks; KeyFrameCulling; and, always last, the eviction
    that keeps one keyframe slot free for the next insertion.

Differences in mechanism (results are the reference's): the neighbour
loops (`fori_loop` over triangulation partners, `lax.scan` over the 12
fuse targets) are Python loops of fixed count in which a disabled entry
changes nothing; a keyframe index is a 0-dim device tensor read with
`index_select` and written with `index_copy`, and compactions are cumsums
and stable sorts, so no stage reads the device back. Scatters with the
reference's mode="drop" go through `set_drop`: among repeated targets the
last write wins, as on the reference's CPU backend. Point-only settings (`UseLines: 0`) skip the three line
stages: no keyline is ever valid there, so they would change nothing.
"""

from __future__ import annotations

import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.geometry import se3
from plslam_tpu_torch.matching import lines as line_ops
from plslam_tpu_torch.matching import points as match_ops
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.ops.select import topk_lower_index_first
from plslam_tpu_torch.pipeline.tracking import add_drop, free_slots, set_drop, take_row
from plslam_tpu_torch.slammap.state import (
    MapState,
    clear_dead_references,
    covisibility,
    line_observation_matrix,
    observation_matrix,
    refresh_counts,
    weighted_point_nobs,
)
from plslam_tpu_torch.solvers import triangulate as tri
from plslam_tpu_torch.solvers.local_ba import LocalBA
from plslam_tpu_torch.utils.precision import mm


def _set_row(a, k, row):
    """a.at[k].set(row) for a 0-dim index tensor k."""
    return a.index_copy(0, k.reshape(1).long(), row[None].to(a.dtype))


def _line_angles(sp, ep):
    seg = ep - sp
    return 0.5 * (sp + ep), torch.atan2(seg[:, 1], seg[:, 0])


class LocalMapper:
    # fixed fan-out of the neighbour fuse pass (reference: 10 first-degree
    # + 5 second-degree each, deduplicated)
    MAX_FUSE_TARGETS = 12

    def __init__(self, tracker, enable_ba: bool = True, enable_fuse: bool = True, enable_kf_culling: bool = True):
        self.tracker = tracker
        self.enable_ba = enable_ba
        self.enable_fuse = enable_fuse
        self.enable_kf_culling = enable_kf_culling
        self._ba = LocalBA(tracker) if enable_ba else None
        self._lines = bool(tracker.s.use_lines)

    # ------------------------------------------------------------ cull
    def _cull_impl(self, m: MapState, k) -> MapState:
        """MapPointCulling / MapLineCulling over landmarks created in the
        last CULL_UNSEEN_KFS keyframes (age by creation sequence: slots
        recycle)."""
        seq_k = take_row(m.kf_seq, k)

        def bad(valid, found, visible, first_seq, nobs):
            age = seq_k - first_seq
            recent = (age >= 1) & (age <= C.CULL_UNSEEN_KFS)
            ratio = found / torch.clamp(visible, min=1.0)
            return valid & recent & (((ratio < C.CULL_FOUND_RATIO) & (visible > 2))
                                     | ((age >= 2) & (nobs <= C.KF_CULL_MIN_OBS)))

        m = m._replace(
            pt_valid=m.pt_valid & ~bad(m.pt_valid, m.pt_found, m.pt_visible, m.pt_first_seq, m.pt_nobs),
            ln_valid=m.ln_valid & ~bad(m.ln_valid, m.ln_found, m.ln_visible, m.ln_first_seq, m.ln_nobs),
        )
        return refresh_counts(clear_dead_references(m))

    # ------------------------------------------------------------ fuse
    def _fuse_impl(self, m: MapState, k, cand_mask) -> MapState:
        """SearchInNeighbors / ORBmatcher::Fuse: the map points in
        `cand_mask` projected into keyframe k, then bind / Replace."""
        tr = self.tracker
        P = tr.max_pts
        uv_p, oct_p, vis, _ = tr._project_points_subset(m.pt_pos, m.pt_normal, m.pt_dist, m.pt_valid,
                                                        take_row(m.kf_pose, k))
        row_lm = take_row(m.kf_lm_idx, k)
        bound = set_drop(torch.zeros(P, dtype=torch.bool, device=row_lm.device), torch.where(row_lm >= 0, row_lm, P),
                         True)
        match_kp, _ = match_ops.search_by_projection(
            take_row(m.kf_uv, k)[:, :2], take_row(m.kf_octave, k), brief.unpack_bits_pm1(take_row(m.kf_desc, k)),
            take_row(m.kf_feat_valid, k), uv_p, oct_p, brief.unpack_bits_pm1(m.pt_desc), vis & cand_mask & ~bound,
            radius=3.0, th_dist=C.TH_LOW,
        )
        ids = torch.arange(P, dtype=torch.int32, device=row_lm.device)
        return self._fuse_bind(m, k, self._invert(match_kp, ids))

    def _fuse_subset_impl(self, m: MapState, k, cand_ids) -> MapState:
        """_fuse_impl over a compact candidate list (i32[F] map-point ids,
        -1 empty): the new keyframe's own landmarks into a neighbour."""
        tr = self.tracker
        sid = torch.clamp(cand_ids, min=0).long()
        cand_ok = (cand_ids >= 0) & m.pt_valid[sid]
        uv_p, oct_p, vis, _ = tr._project_points_subset(m.pt_pos[sid], m.pt_normal[sid], m.pt_dist[sid], cand_ok,
                                                        take_row(m.kf_pose, k))
        row_lm = take_row(m.kf_lm_idx, k)
        bound = set_drop(torch.zeros(tr.max_pts, dtype=torch.bool, device=sid.device),
                         torch.where(row_lm >= 0, row_lm, tr.max_pts), True)
        match_kp, _ = match_ops.search_by_projection(
            take_row(m.kf_uv, k)[:, :2], take_row(m.kf_octave, k), brief.unpack_bits_pm1(take_row(m.kf_desc, k)),
            take_row(m.kf_feat_valid, k), uv_p, oct_p, brief.unpack_bits_pm1(m.pt_desc[sid]), vis & ~bound[sid],
            radius=3.0, th_dist=C.TH_LOW,
        )
        return self._fuse_bind(m, k, self._invert(match_kp, cand_ids))

    def _invert(self, match_kp, ids):
        """Matched feature slot per candidate -> candidate id per feature
        slot of the keyframe (-1 none)."""
        F = self.tracker.max_feat
        return set_drop(torch.full((F,), -1, dtype=torch.int32, device=ids.device),
                        torch.where(match_kp >= 0, match_kp, F), torch.where(match_kp >= 0, ids, -1))

    def _fuse_bind(self, m: MapState, k, cand_of_kp) -> MapState:
        """Bind / Replace tail of the point fuse passes: cand_of_kp i32[F]
        is the matched map point per feature slot of keyframe k."""
        P = self.tracker.max_pts
        cur = take_row(m.kf_lm_idx, k)
        has = cand_of_kp >= 0
        new_row = torch.where(has & (cur < 0), cand_of_kp, cur)  # a free feature binds the match
        # a feature holding another point: Replace(), the point with more
        # observations wins and the loser's references are rewritten
        dup = has & (cur >= 0) & (cand_of_kp != cur)
        a = torch.clamp(cur, min=0).long()
        b = torch.clamp(cand_of_kp, min=0).long()
        a_wins = m.pt_nobs[a] >= m.pt_nobs[b]
        winner = torch.where(a_wins, a, b)
        loser = torch.where(a_wins, b, a)
        rep = set_drop(torch.arange(P, dtype=torch.int32, device=cur.device), torch.where(dup, loser, P),
                       torch.where(dup, winner, -1))
        kf_lm = _set_row(m.kf_lm_idx, k, new_row)
        kf_lm = torch.where(kf_lm >= 0, rep[torch.clamp(kf_lm, min=0).long()], -1)
        loser_sid = torch.where(dup, loser, P)
        win_sid = torch.where(dup, winner, P)
        lc = torch.clamp(loser, 0, P - 1)
        # MapPoint::Replace: forwarding for stale references, the loser's
        # found / visible counts folded into the winner
        m = m._replace(
            kf_lm_idx=kf_lm,
            pt_valid=set_drop(m.pt_valid, loser_sid, False),
            pt_replaced=set_drop(m.pt_replaced, loser_sid, torch.where(dup, winner, -1)),
            pt_visible=add_drop(m.pt_visible, win_sid, m.pt_visible[lc]),
            pt_found=add_drop(m.pt_found, win_sid, m.pt_found[lc]),
        )
        # observation counts re-derived from the incidence (stereo 2, mono 1)
        return refresh_counts(m._replace(pt_nobs=weighted_point_nobs(m)))

    # --------------------------------------------------- triangulation
    def _triangulate_impl(self, m: MapState, k) -> MapState:
        """CreateNewMapPoints: depthless features of keyframe k matched
        epipolarly against its TRIANG_COVIS_KFS best covisible keyframes in
        turn (features bound by an earlier partner drop out) and
        triangulated into far landmarks."""
        tr = self.tracker
        P, F, Kc = tr.max_pts, tr.max_feat, tr.max_kf
        dev = m.kf_valid.device
        ar = torch.arange(Kc, device=dev)
        score = torch.where(m.kf_valid & (ar != k), take_row(covisibility(m), k), -1)
        top_score, top_ids = topk_lower_index_first(score, min(C.TRIANG_COVIS_KFS, Kc))
        nb_ok = top_score >= C.COVIS_TH
        Tk = take_row(m.kf_pose, k)
        desc_k = take_row(m.kf_desc, k)
        pm1_k = brief.unpack_bits_pm1(desc_k)
        oct_k = take_row(m.kf_octave, k)
        R, t = Tk[:3, :3], Tk[:3, 3]
        cam_c = -torch.sum(R * t[:, None], 0)  # -R^T t
        inv_s2 = tr.inv_sigma2

        def row(kf):
            uv = take_row(m.kf_uv, kf)
            return uv[:, :2], take_row(m.kf_feat_valid, kf) & (take_row(m.kf_lm_idx, kf) < 0) & (uv[:, 2] < 0)

        for i in range(top_ids.shape[0]):
            j = top_ids[i]
            uv1, free1 = row(k)
            uv2, free2 = row(j)
            Tj = take_row(m.kf_pose, j)
            epi_ok = tri.epipolar_distance(uv1, uv2, tri.fundamental_from_poses(Tk, Tj, tr.K)) < 3.84  # ~2 px
            mb, _ = match_ops.match_descriptors(pm1_k, free1, brief.unpack_bits_pm1(take_row(m.kf_desc, j)), free2,
                                                th_dist=C.TH_LOW, nn_ratio=0.6, pair_mask=epi_ok)
            mbc = torch.clamp(mb, min=0).long()
            uv2m = uv2[mbc]
            pw, par = tri.triangulate_midpoint(Tk, Tj, tr.K, uv1, uv2m)
            ok = (mb >= 0) & nb_ok[i] & tri.triangulation_checks(
                Tk, Tj, tr.K, uv1, uv2m, pw, par,
                inv_s2[torch.clamp(oct_k, 0, tr.n_levels - 1).long()],
                inv_s2[torch.clamp(take_row(m.kf_octave, j)[mbc], 0, tr.n_levels - 1).long()],
            )
            new_id, ok = free_slots(m.pt_valid, ok)
            sid = torch.where(ok, new_id, P)
            dvec = pw - cam_c
            dist = torch.linalg.norm(dvec, dim=-1)
            m = m._replace(
                pt_pos=set_drop(m.pt_pos, sid, pw),
                pt_desc=set_drop(m.pt_desc, sid, desc_k),
                pt_normal=set_drop(m.pt_normal, sid, dvec / torch.clamp(dist, min=1e-6)[:, None]),
                pt_dist=set_drop(m.pt_dist, sid, torch.stack([dist * 0.5, dist * 2.0], -1)),
                pt_valid=set_drop(m.pt_valid, sid, True),
                pt_ref_kf=set_drop(m.pt_ref_kf, sid, k),
                pt_first_kf=set_drop(m.pt_first_kf, sid, k),
                pt_first_seq=set_drop(m.pt_first_seq, sid, take_row(m.kf_seq, k)),
                pt_nobs=set_drop(m.pt_nobs, sid, 2),  # far points: mono observations
                pt_visible=set_drop(m.pt_visible, sid, 1.0),
                pt_found=set_drop(m.pt_found, sid, 1.0),
                pt_replaced=set_drop(m.pt_replaced, sid, -1),
            )
            # bind the observations in both keyframe rows
            kf_lm = _set_row(m.kf_lm_idx, k, torch.where(ok, new_id, take_row(m.kf_lm_idx, k)))
            row_j = set_drop(take_row(kf_lm, j), torch.where(ok, mb, F), torch.where(ok, new_id, -1))
            m = m._replace(kf_lm_idx=_set_row(kf_lm, j, row_j))
        return refresh_counts(m)

    def _triangulate_lines_impl(self, m: MapState, k) -> MapState:
        """CreateNewMapLines: unbound keylines of keyframe k matched by LBD
        against its best covisible keyframe j; each endpoint ray of k is
        intersected with the plane that j's observed line spans with its
        camera centre."""
        tr = self.tracker
        L, Q, Kc = tr.max_lines, tr.max_maplines, tr.max_kf
        dev = m.kf_valid.device
        cov_k = take_row(covisibility(m), k)
        j = torch.argmax(torch.where(m.kf_valid & (torch.arange(Kc, device=dev) != k), cov_k, -1))
        usable = (take_row(cov_k, j) >= C.COVIS_TH) & (j != k)

        free1 = take_row(m.kf_ln_valid, k) & (take_row(m.kf_ln_idx, k) < 0)
        free2 = take_row(m.kf_ln_valid, j) & (take_row(m.kf_ln_idx, j) < 0)
        sp_k, ep_k = take_row(m.kf_ln_sp, k), take_row(m.kf_ln_ep, k)
        mid1, ang1 = _line_angles(sp_k, ep_k)
        mid2, ang2 = _line_angles(take_row(m.kf_ln_sp, j), take_row(m.kf_ln_ep, j))
        mb, _ = line_ops.search_lines_by_projection(
            mid1, ang1, brief.unpack_bits_pm1(take_row(m.kf_ln_desc, k)), free1,
            mid2, ang2, brief.unpack_bits_pm1(take_row(m.kf_ln_desc, j)), free2,
            radius=60.0, use_mad=False,
        )  # k-line index per j-line
        mj_of_l = set_drop(torch.full((L,), -1, dtype=torch.int32, device=dev), torch.where(mb >= 0, mb, L),
                           torch.where(mb >= 0, torch.arange(L, dtype=torch.int32, device=dev), -1))
        matched = (mj_of_l >= 0) & free1 & usable

        K_m = tr.K
        Tk, Tj = take_row(m.kf_pose, k), take_row(m.kf_pose, j)
        R1, t1 = Tk[:3, :3], Tk[:3, 3]
        R2, t2 = Tj[:3, :3], Tj[:3, 3]
        c1 = mm(-R1.t(), t1)
        c2 = mm(-R2.t(), t2)
        n1w = mm(mm(take_row(m.kf_ln_obs, k), K_m), R1)  # plane normals in world: R^T K^T l
        l2 = take_row(m.kf_ln_obs, j)[torch.clamp(mj_of_l, min=0).long()]
        n2w = mm(mm(l2, K_m), R2)
        n1u = n1w / torch.clamp(torch.linalg.norm(n1w, dim=-1, keepdim=True), min=1e-9)
        n2u = n2w / torch.clamp(torch.linalg.norm(n2w, dim=-1, keepdim=True), min=1e-9)
        matched = matched & (torch.linalg.norm(torch.cross(n1u, n2u, dim=-1), dim=-1) > 0.02)  # ~1.1 deg
        Kinv_t = tri._inv(K_m).t()

        def intersect(px):  # endpoint pixels of k -> 3D on j's plane
            ray = mm(mm(torch.cat([px, torch.ones_like(px[:, :1])], -1), Kinv_t), R1)  # world directions
            denom = torch.sum(n2u * ray, -1)
            far = torch.abs(denom) > 1e-6
            s = torch.sum(n2u * (c2 - c1), -1) / torch.where(far, denom, 1.0)
            return c1 + s[:, None] * ray, far & (s > 0.05) & (s < 40.0)

        sw_w, ok_s = intersect(sp_k)
        ew_w, ok_e = intersect(ep_k)
        matched = matched & ok_s & ok_e
        for X in (sw_w, ew_w):  # both endpoints reproject near j's observed line
            pc = mm(X, R2.t()) + t2
            uvh = mm(pc / torch.clamp(pc[:, 2:3], min=1e-6), K_m.t())
            matched = matched & (pc[:, 2] > 0.05) & (torch.abs(torch.sum(uvh * l2, -1)) < 3.0)

        new_id, matched = free_slots(m.ln_valid, matched)
        sid = torch.where(matched, new_id, Q)
        # viewing normal and distance band at the midpoint, anchored at k
        ln_dvec = 0.5 * (sw_w + ew_w) - c1
        ln_d = torch.linalg.norm(ln_dvec, dim=-1)
        ln_dmin = ln_d / float(tr.s.scale_factor ** (tr.n_levels - 1))
        m = m._replace(
            ln_sw=set_drop(m.ln_sw, sid, sw_w),
            ln_ew=set_drop(m.ln_ew, sid, ew_w),
            ln_normal=set_drop(m.ln_normal, sid, ln_dvec / torch.clamp(ln_d, min=1e-6)[:, None]),
            ln_dist=set_drop(m.ln_dist, sid, torch.stack([ln_dmin, ln_d], -1)),
            ln_desc=set_drop(m.ln_desc, sid, take_row(m.kf_ln_desc, k)),
            ln_valid=set_drop(m.ln_valid, sid, True),
            ln_ref_kf=set_drop(m.ln_ref_kf, sid, k),
            ln_first_kf=set_drop(m.ln_first_kf, sid, k),
            ln_first_seq=set_drop(m.ln_first_seq, sid, take_row(m.kf_seq, k)),
            ln_nobs=set_drop(m.ln_nobs, sid, 2),
            ln_visible=set_drop(m.ln_visible, sid, 1.0),
            ln_found=set_drop(m.ln_found, sid, 1.0),
        )
        kf_ln = _set_row(m.kf_ln_idx, k, torch.where(matched, new_id, take_row(m.kf_ln_idx, k)))
        row_j = set_drop(take_row(kf_ln, j), torch.where(matched, mj_of_l, L), torch.where(matched, new_id, -1))
        return refresh_counts(m._replace(kf_ln_idx=_set_row(kf_ln, j, row_j)))

    # ------------------------------------------------------- line fuse
    def _fuse_lines_impl(self, m: MapState, k) -> MapState:
        """LSDmatcher::Fuse: map lines projected into keyframe k; bind free
        keylines, Replace duplicates (more observations wins)."""
        tr = self.tracker
        L, Q = tr.max_lines, tr.max_maplines
        dev = m.kf_valid.device
        ml_mid, ml_ang, ml_vis = tr._project_lines(m, take_row(m.kf_pose, k))
        cur = take_row(m.kf_ln_idx, k)
        bound = set_drop(torch.zeros(Q, dtype=torch.bool, device=dev), torch.where(cur >= 0, cur, Q), True)
        mid_k, ang_k = _line_angles(take_row(m.kf_ln_sp, k), take_row(m.kf_ln_ep, k))
        match_ln, _ = line_ops.search_lines_by_projection(
            mid_k, ang_k, brief.unpack_bits_pm1(take_row(m.kf_ln_desc, k)), take_row(m.kf_ln_valid, k),
            ml_mid, ml_ang, brief.unpack_bits_pm1(m.ln_desc), ml_vis & ~bound,
        )
        cand = set_drop(torch.full((L,), -1, dtype=torch.int32, device=dev), torch.where(match_ln >= 0, match_ln, L),
                        torch.where(match_ln >= 0, torch.arange(Q, dtype=torch.int32, device=dev), -1))
        has = cand >= 0
        new_row = torch.where(has & (cur < 0), cand, cur)
        dup = has & (cur >= 0) & (cand != cur)
        a = torch.clamp(cur, min=0).long()
        b = torch.clamp(cand, min=0).long()
        a_wins = m.ln_nobs[a] >= m.ln_nobs[b]
        winner = torch.where(a_wins, a, b)
        loser = torch.where(a_wins, b, a)
        rep = set_drop(torch.arange(Q, dtype=torch.int32, device=dev), torch.where(dup, loser, Q),
                       torch.where(dup, winner, -1))
        kf_ln = _set_row(m.kf_ln_idx, k, new_row)
        kf_ln = torch.where(kf_ln >= 0, rep[torch.clamp(kf_ln, min=0).long()], -1)
        m = m._replace(kf_ln_idx=kf_ln, ln_valid=set_drop(m.ln_valid, torch.where(dup, loser, Q), False))
        return refresh_counts(m._replace(ln_nobs=2 * torch.sum(line_observation_matrix(m), 0).to(torch.int32)))

    # --------------------------------------------------------- refresh
    def _distinctive(self, m: MapState, k, kf_idx, kf_feat_ok, kf_desc_all, cap):
        """ComputeDistinctiveDescriptors for the landmarks of keyframe k's
        row: observations gathered from k's top 32 covisible keyframes, the
        min-median Hamming descriptor per landmark. -> (row ids, ids ok,
        best descriptor per feature, keyframe ids [Kc], per-feature
        observation mask over them [N, Kc])."""
        tr = self.tracker
        dev = m.kf_valid.device
        Kc = min(32, tr.max_kf)
        score = torch.where(m.kf_valid, take_row(covisibility(m), k), -1).index_fill(0, k.reshape(1).long(), 2 ** 30)
        top, kf_sel = topk_lower_index_first(score, Kc)  # k first
        kf_ok = top > 0
        row = take_row(kf_idx, k)
        N = row.shape[0]
        sel_ok = (row >= 0) & take_row(kf_feat_ok, k)
        sel = set_drop(torch.full((cap,), -1, dtype=torch.int32, device=dev), torch.where(sel_ok, row, cap),
                       torch.arange(N, dtype=torch.int32, device=dev))  # feature slot per landmark
        ids_c = kf_idx[kf_sel]  # [Kc, N]
        ok_c = (ids_c >= 0) & kf_feat_ok[kf_sel] & kf_ok[:, None]
        slot_c = torch.where(ok_c, sel[torch.clamp(ids_c, min=0).long()], -1)
        # observation (slot, keyframe) -> flat row slot * Kc + kf; slot N drops
        flat = (torch.where(slot_c >= 0, slot_c, N).long() * Kc
                + torch.arange(Kc, device=dev)[:, None]).reshape(-1)
        D = set_drop(torch.zeros((N * Kc, 32), dtype=torch.uint8, device=dev), flat,
                     kf_desc_all[kf_sel].reshape(-1, 32)).reshape(N, Kc, 32)
        Msk = set_drop(torch.zeros(N * Kc, dtype=torch.bool, device=dev), flat, True).reshape(N, Kc)
        # pairwise Hamming per landmark, [N, Kc, Kc]
        pm1 = brief.unpack_bits_pm1(D)
        ham = (256.0 - mm(pm1, pm1.transpose(1, 2))) * 0.5
        dist = torch.where(Msk[:, :, None] & Msk[:, None, :], ham, 1e9)
        # min-median pick: the median of each row's valid distances (self 0
        # included), the first row with the least median
        srt = torch.sort(dist, -1).values
        cnt = torch.sum(Msk, -1)
        med_i = torch.clamp((cnt - 1) // 2, min=0)
        med = torch.gather(srt, -1, med_i[:, None, None].expand(N, Kc, 1))[..., 0]
        best_row = torch.argmin(torch.where(Msk, med, 1e9), -1)
        best = D[torch.arange(N, device=dev), best_row]
        slot_of_row = torch.clamp(sel[torch.clamp(row, min=0).long()], min=0).long()
        write_ok = sel_ok & (cnt[slot_of_row] > 0)
        return row, sel_ok, write_ok, best[slot_of_row], kf_sel, Msk[slot_of_row]

    def _normals(self, m: MapState, kf_sel, pos, obs_msk):
        """UpdateNormalAndDepth: mean viewing direction over the observing
        keyframes, and the distance to keyframe k (kf_sel[0])."""
        centers = se3.inverse(m.kf_pose[kf_sel])[:, :3, 3]  # [Kc, 3]
        dvec = pos[:, None, :] - centers[None, :, :]
        unit = dvec / torch.clamp(torch.linalg.norm(dvec, dim=-1, keepdim=True), min=1e-6)
        nsum = torch.sum(torch.where(obs_msk[..., None], unit, 0.0), 1)
        normal = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1, keepdim=True), min=1e-6)
        return normal, torch.linalg.norm(pos - centers[0], dim=-1)

    def _refresh_impl(self, m: MapState, k) -> MapState:
        """ComputeDistinctiveDescriptors + UpdateNormalAndDepth for every map
        point of keyframe k; the scale band is anchored at k's observation."""
        tr = self.tracker
        P = tr.max_pts
        row, sel_ok, write_ok, best, kf_sel, obs_msk = self._distinctive(m, k, m.kf_lm_idx, m.kf_feat_valid,
                                                                         m.kf_desc, P)
        m = m._replace(pt_desc=set_drop(m.pt_desc, torch.where(write_ok, row, P), best))
        normal, dist_k = self._normals(m, kf_sel, m.pt_pos[torch.clamp(row, min=0).long()], obs_msk)
        dmax = dist_k * torch.exp(take_row(m.kf_octave, k).to(torch.float32) * tr.log_scale)
        dmin = dmax / float(tr.s.scale_factor ** (tr.n_levels - 1))
        sid = torch.where(sel_ok & (torch.sum(obs_msk, -1) > 0), row, P)
        return m._replace(pt_normal=set_drop(m.pt_normal, sid, normal),
                          pt_dist=set_drop(m.pt_dist, sid, torch.stack([dmin, dmax], -1)))

    def _refresh_lines_impl(self, m: MapState, k) -> MapState:
        """The line twin of _refresh_impl (MapLine::UpdateAverageDir +
        ComputeDistinctiveDescriptors): LBD descriptor, midpoint normal and
        distance band of keyframe k's map lines."""
        tr = self.tracker
        Q = tr.max_maplines
        row, sel_ok, write_ok, best, kf_sel, obs_msk = self._distinctive(m, k, m.kf_ln_idx, m.kf_ln_valid,
                                                                         m.kf_ln_desc, Q)
        m = m._replace(ln_desc=set_drop(m.ln_desc, torch.where(write_ok, row, Q), best))
        rc = torch.clamp(row, min=0).long()
        normal, dmax = self._normals(m, kf_sel, 0.5 * (m.ln_sw[rc] + m.ln_ew[rc]), obs_msk)
        dmin = dmax / float(tr.s.scale_factor ** (tr.n_levels - 1))
        sid = torch.where(sel_ok & (torch.sum(obs_msk, -1) > 0), row, Q)
        return m._replace(ln_normal=set_drop(m.ln_normal, sid, normal),
                          ln_dist=set_drop(m.ln_dist, sid, torch.stack([dmin, dmax], -1)))

    # ------------------------------------------------------ kf culling
    def _reanchor(self, m: MapState) -> MapState:
        """SetBadFlag: landmarks whose reference keyframe is gone take the
        first surviving observer; observation counts re-derived."""
        obs = observation_matrix(m)
        kv = m.kf_valid
        pt_bad = m.pt_valid & ~kv[torch.clamp(m.pt_ref_kf, min=0).long()] & torch.any(obs, 0)
        pt_ref = torch.where(pt_bad, torch.argmax(obs.to(torch.uint8), 0).to(torch.int32), m.pt_ref_kf)
        ln_obs = line_observation_matrix(m)
        ln_bad = m.ln_valid & ~kv[torch.clamp(m.ln_ref_kf, min=0).long()] & torch.any(ln_obs, 0)
        ln_ref = torch.where(ln_bad, torch.argmax(ln_obs.to(torch.uint8), 0).to(torch.int32), m.ln_ref_kf)
        return m._replace(pt_ref_kf=pt_ref, ln_ref_kf=ln_ref, pt_nobs=weighted_point_nobs(m)), ln_obs

    def _drop_keyframes(self, m: MapState, kf_valid) -> MapState:
        return m._replace(kf_valid=kf_valid, kf_feat_valid=m.kf_feat_valid & kf_valid[:, None],
                          kf_ln_valid=m.kf_ln_valid & kf_valid[:, None])

    def _kf_cull_impl(self, m: MapState, k) -> MapState:
        """KeyFrameCulling: covisible keyframes of k whose landmarks are
        >= 90% seen by >= 3 other keyframes become bad."""
        obs = observation_matrix(m)
        pt_cnt = torch.sum(obs, 0)  # keyframes per point
        n_lm = torch.sum(obs, 1)
        frac = torch.sum((pt_cnt[None, :] >= C.KF_CULL_MIN_OBS + 1) & obs, 1) / torch.clamp(n_lm, min=1)
        ar = torch.arange(self.tracker.max_kf, device=obs.device)
        cullable = (m.kf_valid & (take_row(covisibility(m, obs), k) >= C.COVIS_TH) & (ar != 0) & (ar != k)
                    & (n_lm > 0) & (frac > C.KF_CULL_REDUNDANCY))
        m, _ = self._reanchor(self._drop_keyframes(m, m.kf_valid & ~cullable))
        return refresh_counts(m)

    def _targets_impl(self, m: MapState, k):
        """SearchInNeighbors targets: the top 10 first-degree and their top
        5 second-degree covisible keyframes, deduplicated, ascending, the
        first MAX_FUSE_TARGETS -> (ids, enabled flags)."""
        Kc = self.tracker.max_kf
        dev = m.kf_valid.device
        cov = covisibility(m)
        row = torch.where(m.kf_valid, take_row(cov, k), -1).index_fill(0, k.reshape(1).long(), -1)
        v1, first = topk_lower_index_first(row, min(10, Kc))
        ok1 = v1 >= C.COVIS_TH
        v2, sec = topk_lower_index_first(torch.where(m.kf_valid[None, :], cov[first], -1), min(5, Kc))
        ok2 = (v2 >= C.COVIS_TH) & ok1[:, None]
        ids = torch.cat([first, sec.reshape(-1)])
        flags = torch.cat([ok1, ok2.reshape(-1)])
        mask = set_drop(torch.zeros(Kc, dtype=torch.bool, device=dev), torch.where(flags, ids, Kc), True)
        mask = mask.index_fill(0, k.reshape(1).long(), False)
        sel = torch.sort(torch.where(mask, torch.arange(Kc, device=dev), Kc)).values[: self.MAX_FUSE_TARGETS]
        return torch.clamp(sel, 0, Kc - 1), sel < Kc

    # ----------------------------------------------- capacity eviction
    def _ensure_free_slot_impl(self, m: MapState, k) -> MapState:
        """Keep >= 1 free keyframe slot for the next insertion: when the
        ring is full, evict the keyframe sharing the fewest landmarks with
        k (never slot 0, never k); references re-anchored as in culling."""
        ar = torch.arange(self.tracker.max_kf, device=m.kf_valid.device)
        full = ~torch.any(~m.kf_valid)
        score = torch.where(m.kf_valid & (ar != 0) & (ar != k), take_row(covisibility(m), k),
                            torch.iinfo(torch.int32).max)
        victim = torch.argmin(score)
        m, ln_obs = self._reanchor(self._drop_keyframes(m, m.kf_valid & ~((ar == victim) & full)))
        return refresh_counts(m._replace(ln_nobs=2 * torch.sum(ln_obs, 0).to(torch.int32)))

    # ----------------------------------------------------------- chain
    def process(self, m: MapState, kf_id) -> MapState:
        """The whole per-keyframe chain after keyframe kf_id was inserted
        (a Python int or a 0-dim index tensor): cull -> triangulate (points,
        lines) -> fuse both ways -> local BA -> refresh -> keyframe cull ->
        eviction. Device work only: nothing is read back."""
        k = kf_id.reshape(()).long() if torch.is_tensor(kf_id) else torch.full(
            (), kf_id, dtype=torch.long, device=m.kf_valid.device)
        m = self._cull_impl(m, k)
        m = self._triangulate_impl(m, k)
        if self._lines:
            m = self._triangulate_lines_impl(m, k)
        if self.enable_fuse:
            # direction 1: every visible map landmark into the new keyframe
            m = self._fuse_impl(m, k, m.pt_valid)
            if self._lines:
                m = self._fuse_lines_impl(m, k)
            # direction 2: the new keyframe's points into its neighbours; a
            # disabled target gets no candidate and changes nothing
            tids, tflags = self._targets_impl(m, k)
            row = take_row(m.kf_lm_idx, k)
            cand_ids = torch.where(take_row(m.kf_feat_valid, k) & (row >= 0), row, -1)
            for i in range(tids.shape[0]):
                m = self._fuse_subset_impl(m, tids[i], torch.where(tflags[i], cand_ids, -1))
        if self._ba is not None:
            m = self._ba.run(m, k)
        m = self._refresh_impl(m, k)
        if self._lines:
            m = self._refresh_lines_impl(m, k)
        if self.enable_kf_culling:
            m = self._kf_cull_impl(m, k)
        return self._ensure_free_slot_impl(m, k)  # always last
