"""Relocalization after tracking loss, with or without loop closing.

Port of plslam_tpu/pipeline/reloc.py (Tracking::Relocalization): BoW
TF-IDF scoring of the lost frame against every keyframe's stored BoW row
-> the top 5 candidates -> dense descriptor matching against the
candidate's landmark-bearing features -> init-free PnP RANSAC
(solvers/pnp.py) -> pose LM (solvers/pose.py, kernel B3 on the card), with
the guided projection top-up after a 10-49-inlier solve;
>= MIN_INLIERS_AFTER_RELOC inliers revive tracking.

The BoW database (one row per keyframe slot, [max_kf, W]) lives on the
tracker's device and is updated in place by `observe_keyframe` without a
host sync. The relocalization itself reads back what the reference reads
back (scores, matches, inlier flags) and runs only on a LOST frame; its
host parts are numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.loopclosing.vocab import Vocabulary
from plslam_tpu_torch.matching import points as match_ops
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.slammap.state import MapState
from plslam_tpu_torch.solvers.pnp import solve_pnp_ransac
from plslam_tpu_torch.solvers.pose import PointObs, pose_optimization


class Relocalizer:
    """BoW database + PnP relocalization for one Tracker."""

    def __init__(self, tracker, vocab: Vocabulary | None = None):
        self.tracker = tracker
        self.device = tracker.device
        self.vocab = (vocab or Vocabulary()).to(self.device)
        self.kf_bow = torch.zeros((tracker.max_kf, self.vocab.n_words), dtype=torch.float32, device=self.device)

    def reset(self):
        """Stale BoW rows of a discarded map must not score against the new
        map's keyframes in recycled slots (System::Reset)."""
        self.kf_bow.zero_()

    def load_database(self, rows):
        """Restore BoW rows f32[max_kf, W] (numpy or tensor)."""
        rows = torch.from_numpy(np.array(rows, np.float32)) if isinstance(rows, np.ndarray) else rows
        if tuple(rows.shape) != tuple(self.kf_bow.shape):
            raise ValueError(f"BoW rows {tuple(rows.shape)}, expected {tuple(self.kf_bow.shape)}")
        self.kf_bow = rows.to(self.device, torch.float32).clone()

    # ------------------------------------------------------------- pieces
    def _bow_of_kf(self, desc, valid):
        return self.vocab.bow(brief.unpack_bits_pm1(desc), valid)

    def _match_kfs(self, desc_a, valid_a, desc_b, valid_b):
        return match_ops.match_descriptors(
            brief.unpack_bits_pm1(desc_a), valid_a, brief.unpack_bits_pm1(desc_b), valid_b,
            th_dist=C.TH_LOW, nn_ratio=0.75,
        )

    _pnp = staticmethod(solve_pnp_ransac)

    def _topup_match(self, m: MapState, Tcw, cand: int, kp_uv, kp_octave, kp_pm1, kp_free, lm_free,
                     radius: float, th_dist: float):
        """Guided SearchByProjection for the top-up: the candidate KF's
        still-unbound landmarks projected through the solved pose and matched
        into still-free keypoints. -> (kp slot per candidate-KF feature
        i32[F], its landmark ids i32[F])."""
        tr = self.tracker
        row = m.kf_lm_idx[cand]
        sid = torch.clamp(row, min=0).long()
        has = (row >= 0) & m.pt_valid[sid] & lm_free
        uv_p, oct_p, vis, _ = tr._project_points_subset(m.pt_pos[sid], m.pt_normal[sid], m.pt_dist[sid], has, Tcw)
        match_kp, _ = match_ops.search_by_projection(
            kp_uv, kp_octave, kp_pm1, kp_free, uv_p, oct_p, brief.unpack_bits_pm1(m.pt_desc[sid]), vis,
            radius=radius, th_dist=th_dist,
        )
        return match_kp, row

    # ------------------------------------------------------------ database
    def observe_keyframe(self, m: MapState, k: int):
        """Add keyframe slot k to the BoW database (KeyFrameDatabase::add):
        device work only, no host sync."""
        self.kf_bow[k] = self._bow_of_kf(m.kf_desc[k], m.kf_feat_valid[k])

    def rebuild_database(self, m: MapState):
        """Recompute the BoW rows of every valid keyframe."""
        self.kf_bow.zero_()
        for k in np.where(m.kf_valid.cpu().numpy())[0]:
            self.observe_keyframe(m, int(k))

    @staticmethod
    def tfidf_scores_device(kf_bow, bow, kf_valid):
        """DBoW2 L1 similarity with TF-IDF weighting, idf over the current
        keyframes: [K, W] x [W] -> [K], on the device."""
        df = torch.sum((kf_bow > 0) & kf_valid[:, None], 0).to(torch.float32)
        n_docs = torch.clamp(torch.sum(kf_valid), min=1).to(torch.float32)
        idf = torch.clamp(torch.log(n_docs / (1.0 + df)) + 1.0, min=0.0)

        def norm(v):
            w = v * idf
            return w / torch.clamp(torch.sum(torch.abs(w), -1, keepdim=True), min=1e-9)

        q = norm(bow[None, :])[0]
        return 1.0 - 0.5 * torch.sum(torch.abs(norm(kf_bow) - q[None, :]), -1)

    def _tfidf_scores(self, bow, kf_valid) -> np.ndarray:
        """Scores read back as a writable numpy array (relocalization only)."""
        return self.tfidf_scores_device(self.kf_bow, bow, kf_valid).cpu().numpy().copy()

    # ------------------------------------------------------- relocalization
    def relocalize(self, state, frame):
        """BoW candidates -> landmark matching -> pose solve. -> (state, ok)."""
        m = state.m
        tr = self.tracker
        dev = self.device
        kf_valid = m.kf_valid.cpu().numpy()
        scores = self._tfidf_scores(self._bow_of_kf(frame.desc, frame.valid), m.kf_valid)
        scores[~kf_valid] = -1  # culled / unallocated slots
        order = np.argsort(-scores)[:5]  # numpy's own order, as the reference
        inv_s2 = tr.inv_sigma2[torch.clamp(frame.octave, 0, tr.n_levels - 1).long()]
        for cand in order:
            if scores[cand] <= 0:
                break
            cand = int(cand)
            mb, _ = self._match_kfs(frame.desc, frame.valid, m.kf_desc[cand], m.kf_feat_valid[cand])
            mb = mb.cpu().numpy()
            lm_c = m.kf_lm_idx[cand].cpu().numpy()
            mbc = np.clip(mb, 0, None)
            lm_of_kp = np.where((mb >= 0) & (lm_c[mbc] >= 0), lm_c[mbc], -1).astype(np.int32)
            if (lm_of_kp >= 0).sum() < C.MIN_MATCHES_REF_KF:
                continue
            lm_t = torch.from_numpy(lm_of_kp).to(dev)
            has = (lm_t >= 0) & frame.valid
            xw = m.pt_pos[torch.clamp(lm_t, min=0).long()]
            # init-free pose: batched 3-point Horn RANSAC seeded from the
            # frame's own depth, scored by reprojection
            pnp = self._pnp(xw, frame.uvr[:, :2], frame.depth, inv_s2, has, tr.K)
            if not bool(pnp.ok):
                continue

            def solve(lm_ids: np.ndarray, T0):
                """Pose LM over the current landmark-per-keypoint binding ->
                (Tcw, surviving lm ids, inlier count)."""
                ids = torch.from_numpy(lm_ids).to(dev)
                hv = (ids >= 0) & frame.valid
                pts = PointObs(xw=m.pt_pos[torch.clamp(ids, min=0).long()], obs=frame.uvr, inv_sigma2=inv_s2,
                               is_stereo=frame.depth > 0, valid=hv)
                Tcw, inl, _ = pose_optimization(T0, pts, tr.K_host, tr.bf)
                keep = (inl & hv).cpu().numpy()
                return Tcw, np.where(keep, lm_ids, -1).astype(np.int32), int(keep.sum())

            Tcw, lm_cur, n = solve(lm_of_kp, pnp.Tcw)
            if n < 10:
                continue
            if n < C.MIN_INLIERS_AFTER_RELOC:
                # guided SearchByProjection top-up after a 10-49-inlier first
                # solve (the Tracking::Relocalization tail): a wide then a
                # narrow projection pass
                for radius, th_dist in ((10.0, float(C.TH_HIGH)), (3.0, 64.0)):
                    if n >= C.MIN_INLIERS_AFTER_RELOC:
                        break
                    lm_cur = self._topup(m, Tcw, cand, frame, lm_cur, radius, th_dist)
                    Tcw, lm_cur, n = solve(lm_cur, Tcw)
            if n >= C.MIN_INLIERS_AFTER_RELOC:
                full = lambda v, dt: torch.full((), v, dtype=dt, device=dev)  # noqa: E731
                state = state._replace(
                    status=full(1, torch.int32),
                    vel_ok=full(False, torch.bool),
                    ref_kf=full(cand, torch.int32),
                    last=state.last._replace(
                        uvr=frame.uvr, octave=frame.octave, angle=frame.angle,
                        desc=frame.desc, depth=frame.depth, valid=frame.valid,
                        lm_idx=torch.from_numpy(lm_cur).to(dev), Tcw=Tcw,
                    ),
                )
                return state, True
        return state, False

    def _topup(self, m: MapState, Tcw, cand: int, frame, lm_cur: np.ndarray, radius: float,
               th_dist: float) -> np.ndarray:
        """One guided-projection pass: bind the candidate KF's still-unbound
        landmarks to still-free keypoints through the current pose. ->
        the augmented landmark id per keypoint (host i32[N])."""
        dev = self.device
        row_np = m.kf_lm_idx[cand].cpu().numpy()
        lm_free = torch.from_numpy(~np.isin(row_np, lm_cur[lm_cur >= 0])).to(dev)
        kp_free = torch.from_numpy(lm_cur < 0).to(dev) & frame.valid
        match_kp, row = self._topup_match(m, Tcw, cand, frame.uvr[:, :2], frame.octave,
                                          brief.unpack_bits_pm1(frame.desc), kp_free, lm_free, radius, th_dist)
        match_kp = match_kp.cpu().numpy()
        row = row.cpu().numpy()
        out = lm_cur.copy()
        for j in np.where(match_kp >= 0)[0]:
            kp = int(match_kp[j])
            if out[kp] < 0 and row[j] >= 0:
                out[kp] = row[j]
        return out
