"""Loop closing on top of relocalization.

Port of plslam_tpu/pipeline/loopclosing.py (LoopClosing::DetectLoop,
ComputeSim3, CorrectLoop, RunGlobalBundleAdjustment). The flow is the
reference's:

  * DetectLoop (`_detect_gate_impl`): TF-IDF scores of the new keyframe
    against every keyframe, gated by the lowest score among its covisible
    neighbours, temporal-adjacency and shared-word gates, covisibility-group
    score accumulation, and the consistency of candidate groups over
    LOOP_CONSISTENT_GROUPS consecutive keyframes (groups carried on the
    device). System runs it inside its keyframe chain: device work only.
  * ComputeSim3 (`close_loop`): descriptor matches between the two
    keyframes -> landmark pairs -> RANSAC Horn (solvers/sim3_solver.py)
    -> OptimizeSim3 -> a guided projection top-up that must reach
    LOOP_TOTAL_MIN_MATCHES supporters.
  * CorrectLoop: the correction propagated over the current keyframe's
    covisible window, the essential graph (solvers/pose_graph.py),
    landmarks and line endpoints moved with their reference keyframes,
    SearchAndFuse of the loop side's landmarks into the window
    (`_fuse_loop_window`, the loop landmark always wins), and a queue of
    global-BA slices (`pump_gba`, solvers/local_ba.py in global mode) that
    System runs one per frame.

Closing is rare and host-orchestrated: like the reference it reads back
matches, covisibility and the observation matrix, and mixes float32 numpy
(the loop transform, its inverse, the pose delta) with device tensors in
the reference's dtypes. Differences in mechanism: the `lax.top_k` calls
keep the lower index among ties (`topk_lower_index_first`), scatters with
duplicate targets let the last source row win (`set_drop`, the reference's
CPU order), the bfloat16 products of 0/1 masks are float32 products (the
same integer counts), and SearchAndFuse's `lax.scan` is a Python loop of
FUSE_WINDOW_CAP steps with the disabled entries masked.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.geometry import se3
from plslam_tpu_torch.loopclosing.vocab import Vocabulary
from plslam_tpu_torch.matching import points as match_ops
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.ops.select import topk_lower_index_first
from plslam_tpu_torch.pipeline.reloc import Relocalizer
from plslam_tpu_torch.pipeline.tracking import set_drop, take_row
from plslam_tpu_torch.slammap.state import (MapState, covisibility, observation_matrix, refresh_counts,
                                           weighted_point_nobs)
from plslam_tpu_torch.solvers.local_ba import LocalBA
from plslam_tpu_torch.solvers.pose_graph import correct_landmarks, optimize_essential_graph
from plslam_tpu_torch.solvers.sim3_solver import optimize_sim3, solve_sim3_ransac


def edge_measurements(poses, edge):
    """S_meas[i, j] = T_i T_j^-1 for every pair of the dense edge mask
    (identity elsewhere) -> (R [K, K, 3, 3], t [K, K, 3], s [K, K])."""
    S = torch.einsum("aij,bjk->abik", poses, se3.inverse(poses))  # [K, K, 4, 4]
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    R = torch.where(edge[:, :, None, None], S[..., :3, :3], eye)
    t = torch.where(edge[:, :, None], S[..., :3, 3], 0.0)
    return R, t, torch.ones(edge.shape, dtype=poses.dtype, device=poses.device)


class LoopCloser(Relocalizer):
    """Relocalizer (BoW database + PnP rescue) plus loop detection and
    correction; see the module docstring for the flow."""

    # window keyframes fused per closure (the reference fuses every
    # covisible keyframe; beyond the cap the strongest-covisibility ones)
    FUSE_WINDOW_CAP = 16

    def __init__(self, tracker, vocab: Vocabulary | None = None, enable_gba: bool = True):
        super().__init__(tracker, vocab)
        self.enable_gba = enable_gba
        # consistency groups carried across keyframes on the device
        # (mvConsistentGroups): bool[G, K] membership, i32[G] consistency
        self._g_mask = torch.zeros((C.LOOP_MAX_GROUPS, tracker.max_kf), dtype=torch.bool, device=self.device)
        self._g_consist = torch.zeros(C.LOOP_MAX_GROUPS, dtype=torch.int32, device=self.device)
        self._loop_edges: list[tuple[int, int]] = []  # accepted loop edges
        # keyframes processed (slots recycle, so "10 keyframes since the
        # last loop" needs a counter of its own)
        self._kf_counter = 0
        self.last_loop_kfn = -C.LOOP_MIN_KFS_SINCE_LAST
        self.n_loops_closed = 0
        # time-sliced global BA: pending (iters1, iters2, erase) slices,
        # pumped one per frame by System
        self.gba_queue: list[tuple[int, int, bool]] = []
        self._gba_k = 0
        self.last_closure_ms = 0.0  # wall time of the last accepted closure
        self._gba = None  # the global-mode LocalBA, made at the first slice
        self.last_supporters = 0  # supporters of the last closure that reached its gate

    def reset(self):
        super().reset()
        self._zero_groups()
        self._loop_edges = []
        self._kf_counter = 0
        self.last_loop_kfn = -C.LOOP_MIN_KFS_SINCE_LAST
        self.n_loops_closed = 0
        self.gba_queue = []

    def _zero_groups(self):
        self._g_mask = torch.zeros_like(self._g_mask)
        self._g_consist = torch.zeros_like(self._g_consist)

    # ------------------------------------------------------------- pieces
    def _guided_match(self, m: MapState, Tcw, row: int, loop_mask):
        """SearchByProjection of a landmark subset into keyframe `row`'s
        features (ComputeSim3's guided top-up). -> i32[P]: feature slot per
        landmark or -1."""
        tr = self.tracker
        uv_p, oct_p, vis, _ = tr._project_points_subset(m.pt_pos, m.pt_normal, m.pt_dist, m.pt_valid, Tcw)
        match_kp, _ = match_ops.search_by_projection(
            m.kf_uv[row][:, :2], m.kf_octave[row], brief.unpack_bits_pm1(m.kf_desc[row]), m.kf_feat_valid[row],
            uv_p, oct_p, brief.unpack_bits_pm1(m.pt_desc), vis & loop_mask, radius=7.5, th_dist=C.TH_LOW,
        )
        return match_kp

    def _fuse_loop_impl(self, m: MapState, j, loop_mask) -> MapState:
        """SearchAndFuse into keyframe j (a 0-dim index tensor): the loop
        side's landmarks projected into it and fused; the loop landmark
        always wins (the reference Replace()s the current map point with the
        loop point)."""
        tr = self.tracker
        P = tr.max_pts
        uv_p, oct_p, vis, _ = tr._project_points_subset(m.pt_pos, m.pt_normal, m.pt_dist, m.pt_valid,
                                                        take_row(m.kf_pose, j))
        row_lm = take_row(m.kf_lm_idx, j)
        # landmarks the keyframe already holds are not bound again
        bound = set_drop(torch.zeros(P, dtype=torch.bool, device=row_lm.device), torch.where(row_lm >= 0, row_lm, P),
                         True)
        match_kp, _ = match_ops.search_by_projection(
            take_row(m.kf_uv, j)[:, :2], take_row(m.kf_octave, j), brief.unpack_bits_pm1(take_row(m.kf_desc, j)),
            take_row(m.kf_feat_valid, j), uv_p, oct_p, brief.unpack_bits_pm1(m.pt_desc), vis & loop_mask & ~bound,
            radius=4.0, th_dist=C.TH_LOW,
        )
        ids = torch.arange(P, dtype=torch.int32, device=row_lm.device)
        cand_of_kp = set_drop(torch.full((tr.max_feat,), -1, dtype=torch.int32, device=ids.device),
                              torch.where(match_kp >= 0, match_kp, tr.max_feat), torch.where(match_kp >= 0, ids, -1))
        has_cand = cand_of_kp >= 0
        new_row = torch.where(has_cand & (row_lm < 0), cand_of_kp, row_lm)
        dup = has_cand & (row_lm >= 0) & (cand_of_kp != row_lm)
        loser = torch.clamp(row_lm, min=0)  # the current side's point loses
        winner = torch.clamp(cand_of_kp, min=0)
        rep = set_drop(ids.clone(), torch.where(dup, loser, P), torch.where(dup, winner, -1))
        kf_lm = m.kf_lm_idx.index_copy(0, j.reshape(1).long(), new_row[None])
        kf_lm = torch.where(kf_lm >= 0, rep[torch.clamp(kf_lm, min=0).long()], -1)
        loser_sid = torch.where(dup, loser, P)
        m = m._replace(kf_lm_idx=kf_lm, pt_valid=set_drop(m.pt_valid, loser_sid, False),
                       pt_replaced=set_drop(m.pt_replaced, loser_sid, torch.where(dup, winner, -1)))
        # observation counts re-derived after Replace, as the mapper's fuse
        return refresh_counts(m._replace(pt_nobs=weighted_point_nobs(m)))

    def _fuse_loop_window(self, m: MapState, ids, flags, loop_mask) -> MapState:
        """SearchAndFuse over the corrected window: FUSE_WINDOW_CAP steps,
        ids i32[W] and flags bool[W] on the device; a disabled step fuses
        nothing."""
        for i in range(ids.shape[0]):
            m = self._fuse_loop_impl(m, ids[i], loop_mask & flags[i])
        return m

    # ----------------------------------------------------------- detection
    def _detect_gate_impl(self, kf_bow, m: MapState, k, g_mask, g_consist):
        """The whole DetectLoop gate on the device (LoopClosing::DetectLoop,
        KeyFrameDatabase::DetectLoopCandidates) for keyframe k (a Python
        int). -> (any enough-consistent candidate, the candidate mask
        bool[K], scores f32[K], the new groups bool[G, K], their
        consistency i32[G]). Nothing is read back."""
        G = C.LOOP_MAX_GROUPS
        K = self.tracker.max_kf
        dev = kf_bow.device
        ar = torch.arange(K, device=dev)
        cov = covisibility(m)
        bow = kf_bow[k]
        kf_valid = m.kf_valid
        scores = self.tfidf_scores_device(kf_bow, bow, kf_valid)
        neighbours = (cov[k] >= C.COVIS_TH) & kf_valid
        min_score = torch.where(torch.any(neighbours), torch.min(torch.where(neighbours, scores, torch.inf)),
                                C.LOOP_MIN_SCORE_FALLBACK)
        # culled keyframes keep stale BoW rows: never candidates
        fid = m.kf_frame_id
        cand = kf_valid & ~neighbours & (ar != k) & (fid < fid[k] - C.LOOP_TEMPORAL_GATE_FRAMES)
        # shared-word gate: more than 0.8 * maxCommonWords
        common = torch.where(cand, ((kf_bow > 0).to(torch.float32) @ (bow > 0).to(torch.float32)), 0.0)
        cmax = torch.max(common)
        cand = cand & (common > 0.8 * cmax) & (scores >= torch.clamp(min_score, min=1e-3)) & (cmax > 0)

        # group scores (lAccScoreAndMatch): a candidate's score summed over
        # its top-10 covisible members that are candidates too; groups
        # within 0.75 of the best survive, each as its best-scoring member
        n10 = min(10, K)
        topv, topi = topk_lower_index_first(cov, n10)  # [K, n10]
        mem_ok = (topv >= C.COVIS_TH) & cand[topi]
        mem = torch.zeros((K, K), dtype=torch.bool, device=dev).scatter_(1, topi, mem_ok)  # distinct per row
        mem = mem | torch.eye(K, dtype=torch.bool, device=dev)
        acc = torch.where(cand, mem.to(torch.float32) @ scores, -torch.inf)
        kept = cand & (acc >= 0.75 * torch.max(acc))
        best_mem = torch.argmax(torch.where(mem, scores[None, :], -torch.inf), 1)  # first maximum
        surv = set_drop(torch.zeros(K, dtype=torch.bool, device=dev), torch.where(kept, best_mem, K), True)

        # consistency over consecutive keyframes: the new groups are the
        # top-G survivors' covisibility sets; a group overlapping a previous
        # one inherits its consistency + 1 (padded when G > K)
        surv_score = torch.where(surv, scores, -torch.inf)
        if G > K:
            surv_score = torch.cat([surv_score, torch.full((G - K,), -torch.inf, device=dev)])
        gv, gi = topk_lower_index_first(surv_score, G)
        g_ok = gv > -torch.inf
        gi = torch.clamp(gi, max=K - 1)
        grp = ((cov >= C.COVIS_TH)[gi] | (ar[None, :] == gi[:, None])) & g_ok[:, None]
        inter = (grp.to(torch.float32) @ g_mask.to(torch.float32).t()) > 0  # [G, G_prev]
        prev_c = torch.amax(torch.where(inter, g_consist[None, :].to(torch.float32), 0.0), 1)
        new_consist = torch.where(g_ok, prev_c.to(torch.int32) + 1, 0)
        enough_g = new_consist >= C.LOOP_CONSISTENT_GROUPS
        enough = set_drop(torch.zeros(K, dtype=torch.bool, device=dev), torch.where(enough_g, gi, K), True)
        return torch.any(enough), enough, scores, grp, new_consist

    def begin_keyframe(self) -> bool:
        """Count a keyframe; -> whether detection runs for it (not within
        LOOP_MIN_KFS_SINCE_LAST keyframes of the last closure). System's
        keyframe chain runs the gate with this flag."""
        self._kf_counter += 1
        return self._kf_counter - self.last_loop_kfn >= C.LOOP_MIN_KFS_SINCE_LAST

    def detect(self, m: MapState, k: int):
        """-> the enough-consistent candidate keyframes, best score first,
        at most LOOP_MAX_CANDIDATES (LoopClosing::DetectLoop keeps them all
        and ComputeSim3 tries each). One flag read back per keyframe."""
        self.observe_keyframe(m, k)
        self._kf_counter += 1
        if self._kf_counter - self.last_loop_kfn < C.LOOP_MIN_KFS_SINCE_LAST:
            self._zero_groups()
            return []
        has_any, enough, scores, self._g_mask, self._g_consist = self._detect_gate_impl(
            self.kf_bow, m, k, self._g_mask, self._g_consist)
        if not bool(has_any):
            return []
        s = scores.cpu().numpy()
        return sorted(np.where(enough.cpu().numpy())[0].tolist(), key=lambda c: -s[c])[: C.LOOP_MAX_CANDIDATES]

    def try_candidates(self, state, kf_id: int, cands) -> tuple:
        """ComputeSim3 over candidates detected elsewhere (best first), until
        one closes. -> (state, closed)."""
        for cand in cands:
            state, closed = self.close_loop(state, int(kf_id), int(cand))
            if closed:
                return state, True
        return state, False

    def process(self, state, kf_id: int):
        """Detection and closure after a keyframe insertion. -> (state, closed)."""
        return self.try_candidates(state, kf_id, self.detect(state.m, kf_id))

    # ----------------------------------------------------------- correction
    def close_loop(self, state, k: int, cand: int):
        """Sim3 solve + loop correction between keyframes k and cand.
        -> (state, closed). The wall time of an accepted closure, device
        work included, lands in last_closure_ms."""
        t_close0 = time.perf_counter()
        m = state.m
        tr = self.tracker
        dev = self.device
        mb, _ = self._match_kfs(m.kf_desc[k], m.kf_feat_valid[k], m.kf_desc[cand], m.kf_feat_valid[cand])
        mb = mb.cpu().numpy()
        lm_k = m.kf_lm_idx[k].cpu().numpy()
        lm_c = m.kf_lm_idx[cand].cpu().numpy()
        pair_ok = (mb >= 0) & (lm_k >= 0)
        pair_ok[pair_ok] &= lm_c[mb[pair_ok]] >= 0
        if pair_ok.sum() < C.LOOP_BOW_MIN_MATCHES:
            return state, False
        mbc = np.clip(mb, 0, None)
        dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        pair_ok_t = dv(pair_ok)
        x1 = m.pt_pos[dv(np.where(pair_ok, lm_k, 0)).long()]
        x2 = m.pt_pos[dv(np.where(pair_ok, lm_c[mbc], 0)).long()]
        res = solve_sim3_ransac(x1, x2, pair_ok_t, tr.K, m.kf_pose[k], m.kf_pose[cand],
                                min_inliers=C.LOOP_SIM3_MIN_INLIERS)
        if not bool(res.ok):
            return state, False

        # OptimizeSim3: LM on bidirectional reprojection edges + chi2 prune
        mbc_t = dv(mbc).long()
        inv_s2 = tr.inv_sigma2
        oct1 = torch.clamp(m.kf_octave[k], 0, tr.n_levels - 1).long()
        oct2 = torch.clamp(m.kf_octave[cand][mbc_t], 0, tr.n_levels - 1).long()
        R_o, t_o, s_o, sim3_inl, n_inl = optimize_sim3(
            se3.transform(m.kf_pose[k], x1), se3.transform(m.kf_pose[cand], x2), m.kf_uv[k][:, :2],
            m.kf_uv[cand][mbc_t][:, :2], inv_s2[oct1], inv_s2[oct2], pair_ok_t, tr.K, res.R, res.t, res.s)
        if int(n_inl) < C.LOOP_SIM3_MIN_INLIERS:
            return state, False

        # the current keyframe's corrected pose: the loop transform composed
        # with the loop keyframe's trusted pose (float32 numpy, as the reference)
        T_12 = np.eye(4, dtype=np.float32)
        T_12[:3, :3] = R_o.cpu().numpy() * float(s_o)
        T_12[:3, 3] = t_o.cpu().numpy()
        poses_old = m.kf_pose
        poses_old_np = poses_old.cpu().numpy()
        T_cur_new = T_12 @ poses_old_np[cand]
        delta = dv(T_cur_new @ np.linalg.inv(poses_old_np[k]))

        # acceptance: guided SearchByProjection of the loop neighbourhood's
        # landmarks through the corrected pose; at least
        # LOOP_TOTAL_MIN_MATCHES distinct supporters (Sim3 inliers + top-up)
        cov_np = covisibility(m).cpu().numpy()
        loop_group = cov_np[cand] >= C.COVIS_TH
        loop_group[cand] = True
        obs_np = observation_matrix(m).cpu().numpy()
        loop_mask_np = obs_np[loop_group].any(0) & m.pt_valid.cpu().numpy()
        loop_mask = dv(loop_mask_np)
        match_g = self._guided_match(m, dv(T_cur_new), k, loop_mask).cpu().numpy()
        lm_c_of_pair = np.where(pair_ok, lm_c[mbc], -1)
        supporters = set(np.where(match_g >= 0)[0].tolist())
        supporters |= set(lm_c_of_pair[sim3_inl.cpu().numpy()].tolist())
        supporters.discard(-1)
        self.last_supporters = len(supporters)
        if len(supporters) < C.LOOP_TOTAL_MIN_MATCHES:
            return state, False

        # propagate over the current keyframe's covisible window
        covis = cov_np[k]
        window = covis >= C.COVIS_TH
        window[k] = True
        poses_prop = torch.where(dv(window)[:, None, None], torch.einsum("ij,kjl->kil", delta, poses_old), poses_old)

        # essential graph: spanning tree + strong covisibility + loop edges;
        # measurements from the pre-correction poses, the new loop edge from
        # the solve
        edge = cov_np >= C.COVIS_ESSENTIAL_TH
        # spanning tree: parent = the most covisible earlier valid keyframe
        kfv = m.kf_valid.cpu().numpy()
        fid = m.kf_frame_id.cpu().numpy()
        earlier = (fid[None, :] < fid[:, None]) & kfv[None, :] & kfv[:, None]
        cw = np.where(earlier, cov_np, -1)
        parent = cw.argmax(1)
        rows = np.where(cw.max(1) > 0)[0]
        edge[rows, parent[rows]] = True
        edge[k, cand] = edge[cand, k] = True
        for a, b in self._loop_edges:  # past closures' loop edges stay
            edge[a, b] = edge[b, a] = True
        Sm_R, Sm_t, Sm_s = edge_measurements(poses_old, dv(edge | edge.T))
        # the loop edge's measurement: S_k S_cand^-1 from the corrected pose
        M = (T_cur_new @ np.linalg.inv(poses_old_np[cand])).astype(np.float32)
        Mi = np.linalg.inv(M)
        pair = (torch.tensor([k, cand], device=dev), torch.tensor([cand, k], device=dev))
        Sm_R[pair] = dv(np.stack([M[:3, :3], Mi[:3, :3]]))
        Sm_t[pair] = dv(np.stack([M[:3, 3], Mi[:3, 3]]))
        fixed = np.zeros(tr.max_kf, bool)
        fixed[cand] = True
        poses_new = optimize_essential_graph(poses_prop, m.kf_valid, dv(fixed), dv(np.triu(edge | edge.T, 1)), Sm_R,
                                             Sm_t, Sm_s, n_iters=C.ESSENTIAL_GRAPH_ITERS)

        # landmarks and line endpoints follow their reference keyframes
        m = m._replace(
            kf_pose=poses_new,
            pt_pos=correct_landmarks(m.pt_pos, m.pt_valid, m.pt_ref_kf, poses_old, poses_new),
            ln_sw=correct_landmarks(m.ln_sw, m.ln_valid, m.ln_ref_kf, poses_old, poses_new),
            ln_ew=correct_landmarks(m.ln_ew, m.ln_valid, m.ln_ref_kf, poses_old, poses_new),
        )

        # SearchAndFuse into the corrected window (the current keyframe
        # always, then the strongest-covisibility members up to the cap)
        win_ids = np.where(window)[0]
        if len(win_ids) > self.FUSE_WINDOW_CAP:
            order = win_ids[np.argsort(-covis[win_ids])]
            win_ids = np.concatenate([[k], order[order != k][: self.FUSE_WINDOW_CAP - 1]])
        ids = np.zeros(self.FUSE_WINDOW_CAP, np.int64)
        flags = np.zeros(self.FUSE_WINDOW_CAP, bool)
        ids[: len(win_ids)] = win_ids
        flags[: len(win_ids)] = True
        m = self._fuse_loop_window(m, dv(ids), dv(flags), loop_mask)

        state = state._replace(m=m, last=state.last._replace(Tcw=delta @ state.last.Tcw),
                               vel_ok=torch.zeros((), dtype=torch.bool, device=dev))
        self.last_loop_kfn = self._kf_counter
        self.n_loops_closed += 1
        self._loop_edges.append((int(k), int(cand)))
        if dev.type == "cuda":  # the time covers the device work, not only its dispatch
            torch.cuda.synchronize(dev)
        self.last_closure_ms = (time.perf_counter() - t_close0) * 1e3

        if self.enable_gba:
            # GlobalBundleAdjustment, time-sliced: the 10 + 10 LM schedule as
            # a queue of slices System pumps one per frame (the reference
            # runs it in a transient thread while tracking goes on); a newer
            # closure replaces the pending queue
            n1 = n2 = C.GLOBAL_BA_ITERS
            step = max(1, C.GBA_SLICE_ITERS)
            q = [(min(step, n1 - s), 0, False) for s in range(0, n1, step)]
            q += [(0, min(step, n2 - s), False) for s in range(0, n2, step)]
            if q:
                q[-1] = q[-1][:2] + (True,)  # the outlier sweep on the last slice only
            self.gba_queue = q
            self._gba_k = int(k)
        return state, True

    def pump_gba(self, state):
        """Run one pending global-BA slice (between frames)."""
        if not self.gba_queue:
            return state
        if self._gba is None:
            self._gba = LocalBA(self.tracker, global_mode=True)
        i1, i2, erase = self.gba_queue.pop(0)
        return state._replace(m=self._gba.slice_runner(i1, i2, erase)(state.m, self._gba_k))

    def flush_gba(self, state):
        """Drain every pending slice."""
        while self.gba_queue:
            state = self.pump_gba(state)
        return state
