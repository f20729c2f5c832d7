"""Local bundle adjustment, plain: what the keyframe chain's local BA is
held to.

Frozen copy of the local mode of plslam_tpu_torch/solvers/local_ba.py
(`LocalBA.run`: window and fixed-ring selection, the batched
Schur-complement LM on the 5 + 10 iteration schedule with the chi2 gate
between the phases, the write-back and the erase sweep), with the helpers
it calls: `set_drop` and `take_row` of pipeline/tracking.py,
`observation_matrix` and `line_observation_matrix` of slammap/state.py
(the line incidence as a boolean scatter, the same booleans), `mm` of
utils/precision.py (a float32 `torch.matmul`; TF32 is off unless the
control turns it on). The global mode and the time-sliced runner are left
out: no cell runs them. The benchmark's reference imports nothing of the
port: it runs on the fields of the port's map that local BA reads
(`BAMap`), with the camera worked out again from the configuration's
settings (`Camera`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import constants as C
from portbench.reference import se3
from portbench.reference.select import topk_lower_index_first

_TAU = 1e-5

BA_FIELDS = ("kf_pose", "kf_valid", "kf_uv", "kf_octave", "kf_feat_valid", "kf_lm_idx", "kf_ln_obs", "kf_ln_idx",
             "kf_ln_valid", "pt_pos", "pt_valid", "ln_sw", "ln_ew", "ln_valid")


class BAMap(NamedTuple):
    """The fields of the port's BAMap that local BA reads or writes (same
    names, shapes and dtypes)."""

    kf_pose: torch.Tensor  # f32[K, 4, 4] Tcw
    kf_valid: torch.Tensor  # bool[K]
    kf_uv: torch.Tensor  # f32[K, F, 3] (u, v, u_r); u_r<0: mono
    kf_octave: torch.Tensor  # i32[K, F]
    kf_feat_valid: torch.Tensor  # bool[K, F]
    kf_lm_idx: torch.Tensor  # i32[K, F] map-point id or -1
    kf_ln_obs: torch.Tensor  # f32[K, L, 3]
    kf_ln_idx: torch.Tensor  # i32[K, L]
    kf_ln_valid: torch.Tensor  # bool[K, L]
    pt_pos: torch.Tensor  # f32[P, 3]
    pt_valid: torch.Tensor  # bool[P]
    ln_sw: torch.Tensor  # f32[Q, 3]
    ln_ew: torch.Tensor  # f32[Q, 3]
    ln_valid: torch.Tensor  # bool[Q]


class Camera:
    """What local BA reads of the tracker, from the configuration's settings
    and the map's capacities."""

    def __init__(self, settings: dict, m: BAMap):
        s = settings
        K = np.array([[s["fx"], 0.0, s["cx"]], [0.0, s["fy"], s["cy"]], [0.0, 0.0, 1.0]], np.float32)
        dev = m.kf_pose.device
        self.K = torch.from_numpy(K).to(dev)
        self.bf = float(s["bf"])
        self.n_levels = int(s["n_levels"])
        self.inv_sigma2 = torch.from_numpy(np.asarray(
            [1.0 / float(s["scale_factor"]) ** (2 * lv) for lv in range(self.n_levels)], np.float32)).to(dev)
        self.max_kf, self.max_pts, self.max_maplines = m.kf_pose.shape[0], m.pt_pos.shape[0], m.ln_sw.shape[0]


def mm(a, b):
    return torch.matmul(a, b)


def set_drop(dst, idx, val):
    """dst.at[idx].set(val, mode="drop"), functional. Among duplicate
    indices the last source row wins."""
    n = dst.shape[0]
    idx = idx.long()
    tgt = torch.where((idx >= 0) & (idx < n), idx, n)
    pos = torch.arange(tgt.shape[0], device=dst.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=dst.device).scatter_reduce(0, tgt, pos, reduce="amax")
    tgt = torch.where(last[tgt] == pos, tgt, n)
    if not torch.is_tensor(val):
        val = torch.full((), val, dtype=dst.dtype, device=dst.device)
    val = val.to(dst.dtype).expand((tgt.shape[0],) + dst.shape[1:])
    return torch.cat([dst, dst[:1]], 0).index_put((tgt,), val)[:n]


def take_row(a, k):
    if torch.is_tensor(k):
        return a.index_select(0, k.reshape(1).long())[0]
    return a[k]


def _incidence(ids, ok, n):
    """bool[K, n]: row k holds id p where ok."""
    cols = torch.where(ok, ids, n).long()
    return torch.zeros((ids.shape[0], n + 1), dtype=torch.bool, device=ok.device).scatter(1, cols, True)[:, :n]


def observation_matrix(m: BAMap):
    """bool[K, P] incidence: keyframe k observes map point p."""
    return _incidence(m.kf_lm_idx, (m.kf_lm_idx >= 0) & m.kf_feat_valid & m.kf_valid[:, None], m.pt_valid.shape[0])


def line_observation_matrix(m: BAMap):
    """bool[K, Q] incidence: keyframe k observes map line q."""
    return _incidence(m.kf_ln_idx, (m.kf_ln_idx >= 0) & m.kf_ln_valid & m.kf_valid[:, None], m.ln_valid.shape[0])


def _rot_cols(A, P):
    """A @ hat(P), elementwise."""
    Xc, Yc, Zc = P[..., 0], P[..., 1], P[..., 2]
    return torch.stack([A[..., 1] * Zc - A[..., 2] * Yc, -A[..., 0] * Zc + A[..., 2] * Xc,
                        A[..., 0] * Yc - A[..., 1] * Xc], -1)


def _times_R(A, Rp):
    """A @ R_pose, elementwise (Rp broadcastable [.., 3, 3])."""
    return torch.stack([A[..., 0] * Rp[..., 0, j] + A[..., 1] * Rp[..., 1, j] + A[..., 2] * Rp[..., 2, j]
                        for j in range(3)], -1)


def _transform_rows(Rp, tp, X):
    xx, yy, zz = X[..., 0], X[..., 1], X[..., 2]
    return torch.stack([Rp[..., i, 0] * xx + Rp[..., i, 1] * yy + Rp[..., i, 2] * zz + tp[..., i]
                        for i in range(3)], -1)


def _segments(drop, n):
    """Plan of a deterministic segment sum over the edges: their order
    sorted by segment (drop == n, the drop row, sorts last) and each of the
    n segments' [start, end) in that order."""
    drop = drop.reshape(-1)
    order = torch.argsort(drop, stable=True)
    cnt = torch.zeros(n + 1, dtype=torch.long, device=drop.device).scatter_add(0, drop, torch.ones_like(drop))[:n]
    end = torch.cumsum(cnt, 0)
    return order, end - cnt, end


def _segsum(vals, plan):
    """out[p] = sum of vals[e] over the edges of segment p. [E, V] -> [n, V].
    A float64 prefix sum in segment order, differenced at the segment
    bounds: no atomics, so the card gives the same sums on every run, and
    the sums are the exact ones rounded to float32 up to float64 rounding
    of the prefix (the reference's one-hot matmuls sum in float32)."""
    order, start, end = plan
    # the prefix runs along the contiguous axis: on the card a scan along
    # a strided axis is one sequential thread per column
    v = torch.nn.functional.pad(vals.reshape(order.shape[0], -1)[order].to(torch.float64).t(), (1, 0))
    c = torch.cumsum(v, 1)
    return (c[:, end] - c[:, start]).t().to(vals.dtype)


def _huber(chi2, delta2, robust: bool):
    """(IRLS weight factor, robust cost) of the Huber kernel at chi2."""
    if not robust:
        return torch.ones_like(chi2), chi2
    inside = chi2 <= delta2
    hub = torch.where(inside, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
    rho = torch.where(inside, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)
    return hub, rho


class LocalBA:
    def __init__(self, tracker: Camera, window: int = C.LOCAL_KFS, fixed: int = C.LOCAL_FIXED_KFS,
                 local_pts: int = 4096, local_lines: int = 256, iters1: int = C.LOCAL_BA_ITERS_1,
                 iters2: int = C.LOCAL_BA_ITERS_2):
        self.tracker = tracker
        self.W = min(window, tracker.max_kf)
        self.X = min(fixed, tracker.max_kf)
        self.Pl = min(local_pts, tracker.max_pts)
        self.Ql = min(local_lines, tracker.max_maplines)
        self.iters1, self.iters2 = iters1, iters2

    def run(self, m: BAMap, k) -> BAMap:
        """The full schedule around keyframe k (a Python int or a 0-dim
        index tensor), outlier observations erased."""
        return self._run(m, k, self.iters1, self.iters2, True)

    # ------------------------------------------------------------ build
    def _select(self, m: BAMap, k):
        """Window / fixed keyframes and local landmark slots around k."""
        tr = self.tracker
        Kc, P, Q, dev = tr.max_kf, tr.max_pts, tr.max_maplines, m.kf_valid.device
        k1 = k.reshape(1).long() if torch.is_tensor(k) else torch.full((1,), k, dtype=torch.long, device=dev)
        obs = observation_matrix(m)  # [K, P]
        obs_f = obs.to(torch.float32)
        covis_k = mm(obs_f, take_row(obs_f, k1[0])[:, None])[:, 0].to(torch.int32)  # shared with k
        covis_k = covis_k.index_fill(0, k1, 0)
        score = torch.where(m.kf_valid & (covis_k >= C.COVIS_TH), covis_k, -1)
        top_score, top = topk_lower_index_first(score, self.W - 1)
        win_valid = top_score > 0
        win_ids = torch.cat([k1, torch.where(win_valid, top, 0)])
        win_mask = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), win_valid])
        in_window = set_drop(torch.zeros(Kc, dtype=torch.bool, device=dev), torch.where(win_mask, win_ids, Kc), True)

        def pick(member, n, cap):
            """The first n member slots ascending, then non-members
            (jax.lax.top_k order) -> (ids, valid, slot per id or -1)."""
            _, ids = topk_lower_index_first(member.to(torch.int32), n)
            valid = member[ids]
            slot = set_drop(torch.full((cap,), -1, dtype=torch.int32, device=dev), torch.where(valid, ids, cap),
                            torch.arange(n, dtype=torch.int32, device=dev))
            return ids, valid, slot

        lm_local = torch.any(obs & in_window[:, None], 0) & m.pt_valid
        local_ids, local_valid, lm_slot = pick(lm_local, self.Pl, P)
        # fixed keyframes: see local landmarks, outside the window
        sees_local = torch.sum(obs & lm_local[None, :], 1).to(torch.int32)
        fscore = torch.where(m.kf_valid & ~in_window & (sees_local > 0), sees_local, -1)
        fix_score, ftop = topk_lower_index_first(fscore, self.X)
        fix_valid = fix_score > 0
        fix_ids = torch.where(fix_valid, ftop, 0)
        ln_local = torch.any(line_observation_matrix(m) & in_window[:, None], 0) & m.ln_valid
        ln_ids, ln_sel_valid, ln_slot = pick(ln_local, self.Ql, Q)
        return (win_ids, win_mask, fix_ids, fix_valid, local_ids, local_valid, lm_slot, ln_ids, ln_sel_valid,
                ln_slot)

    # ------------------------------------------------------------- core
    def _edge_terms(self, poses, pos_local, uv, oct_, lm_slot_row, feat_ok, is_stereo, robust: bool, jac=True):
        """Residuals and Jacobians of all [R, F] point edges -> (r, Jc, Jp,
        w, chi2, ok, cost); with jac=False only (chi2, ok, cost)."""
        tr = self.tracker
        K, bf = tr.K, tr.bf
        fx, fy = K[0, 0], K[1, 1]
        X = pos_local[torch.clamp(lm_slot_row, min=0).long()]  # [R, F, 3]
        Rp = poses[:, None, :3, :3]
        tp = poses[:, None, :3, 3]
        P = _transform_rows(Rp, tp, X)
        Z = P[..., 2]
        zok = Z > 1e-3
        ok = feat_ok & (lm_slot_row >= 0) & zok
        iz = 1.0 / torch.where(zok, Z, 1.0)
        iz2 = iz * iz
        u = fx * P[..., 0] * iz + K[0, 2]
        v = fy * P[..., 1] * iz + K[1, 2]
        ur = u - bf * iz
        r = uv - torch.stack([u, v, ur], -1)
        r = torch.cat([r[..., :2], torch.where(is_stereo, r[..., 2], 0.0)[..., None]], -1)
        inv_s2 = tr.inv_sigma2[torch.clamp(oct_, 0, tr.n_levels - 1).long()]
        chi2 = torch.sum(r * r, -1) * inv_s2
        delta2 = torch.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO)
        hub, rho = _huber(chi2, delta2, robust)
        cost = torch.sum(torch.where(ok, rho, 0.0)) + 1e7 * torch.sum(feat_ok & (lm_slot_row >= 0) & ~zok)
        if not jac:
            return chi2, ok, cost
        w = torch.where(ok, hub * inv_s2, 0.0)
        zero = torch.zeros_like(Z)
        du = torch.stack([fx * iz, zero, -fx * P[..., 0] * iz2], -1)
        dv = torch.stack([zero, fy * iz, -fy * P[..., 1] * iz2], -1)
        dur = du + torch.stack([zero, zero, bf * iz2], -1)
        Jc = torch.stack([torch.cat([-d, _rot_cols(d, P)], -1) for d in (du, dv, dur)], -2)  # [R, F, 3, 6]
        Jp = -torch.stack([_times_R(d, Rp) for d in (du, dv, dur)], -2)  # [R, F, 3, 3]
        # mono rows: no third residual
        row_ok = torch.cat([torch.ones_like(is_stereo[..., None]).expand(is_stereo.shape + (2,)),
                            is_stereo[..., None]], -1)[..., None]
        Jc = torch.where(row_ok, Jc, 0.0)
        Jp = torch.where(row_ok, Jp, 0.0)
        return r, Jc, Jp, w, chi2, ok, cost

    def _line_edge_terms(self, poses, sw, ew, lobs, ln_slot_row, ln_feat_ok, robust: bool, jac=True):
        """Scalar endpoint edges of all [R, L] line observations
        (EdgeLineProjectXYZ: r_e = l . pi(T X_e), l normalised) -> ((r, Jc,
        Jp) per endpoint, w, chi2, ok, cost); with jac=False only (chi2,
        ok, cost)."""
        K = self.tracker.K
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        slot = torch.clamp(ln_slot_row, min=0).long()
        Rp = poses[:, None, :3, :3]
        tp = poses[:, None, :3, 3]
        a, b, c = lobs[..., 0], lobs[..., 1], lobs[..., 2]

        def endpoint(Xw):
            P = _transform_rows(Rp, tp, Xw[slot])
            Z = P[..., 2]
            okz = Z > 1e-3
            iz = 1.0 / torch.where(okz, Z, 1.0)
            u = fx * P[..., 0] * iz + cx
            v = fy * P[..., 1] * iz + cy
            r = a * u + b * v + c  # point-to-line distance
            if not jac:
                return r, None, None, okz
            iz2 = iz * iz
            zero = torch.zeros_like(Z)
            du = torch.stack([fx * iz, zero, -fx * P[..., 0] * iz2], -1)
            dv = torch.stack([zero, fy * iz, -fy * P[..., 1] * iz2], -1)
            g = a[..., None] * du + b[..., None] * dv  # dr/dP_cam
            Jc = torch.cat([g, -_rot_cols(g, P)], -1)  # [R, L, 6]
            return r, Jc, _times_R(g, Rp), okz

        r1, Jc1, Jp1, okz1 = endpoint(sw)
        r2, Jc2, Jp2, okz2 = endpoint(ew)
        ok = ln_feat_ok & okz1 & okz2
        chi2 = r1 * r1 + r2 * r2  # line information = identity (2 dof)
        hub, rho = _huber(chi2, C.CHI2_MONO, robust)
        cost = torch.sum(torch.where(ok, rho, 0.0)) + 1e7 * torch.sum(ln_feat_ok & ~(okz1 & okz2))
        if not jac:
            return chi2, ok, cost
        w = torch.where(ok, hub, 0.0)
        return (r1, Jc1, Jp1), (r2, Jc2, Jp2), w, chi2, ok, cost

    def _run(self, m: BAMap, k, iters1: int, iters2: int, erase: bool) -> BAMap:
        tr = self.tracker
        (win_ids, win_mask, fix_ids, fix_valid, local_ids, local_valid,
         lm_slot, ln_ids, ln_sel_valid, ln_slot) = self._select(m, k)
        W, X, Pl, Ql = self.W, self.X, self.Pl, self.Ql
        Pt = Pl + 2 * Ql  # landmark axis: [points | line starts | line ends]
        dev = m.kf_valid.device

        rows_ids = torch.cat([win_ids, fix_ids])  # [W + X]
        rows_mask = torch.cat([win_mask, fix_valid])
        movable = win_mask & (win_ids != 0)  # gauge: keyframe 0 never moves
        mov = torch.cat([movable, torch.zeros(X, dtype=torch.bool, device=dev)])

        uv = m.kf_uv[rows_ids]  # [R, F, 3]
        oct_ = m.kf_octave[rows_ids]
        lm_idx_rows = m.kf_lm_idx[rows_ids]
        feat_ok = m.kf_feat_valid[rows_ids] & rows_mask[:, None] & (lm_idx_rows >= 0)
        lm_slot_row = torch.where(feat_ok, lm_slot[torch.clamp(lm_idx_rows, min=0).long()], -1)
        is_stereo = uv[..., 2] >= 0
        ln_obs_rows = m.kf_ln_obs[rows_ids]  # [R, L, 3]
        ln_idx_rows = m.kf_ln_idx[rows_ids]
        ln_feat_ok = m.kf_ln_valid[rows_ids] & rows_mask[:, None] & (ln_idx_rows >= 0)
        ln_slot_row = torch.where(ln_feat_ok, ln_slot[torch.clamp(ln_idx_rows, min=0).long()], -1)
        # landmark row of every edge (Pt drops), fixed for the whole solve
        drop = torch.where(lm_slot_row >= 0, lm_slot_row, Pt).long()
        drops_ln = [torch.where(ln_slot_row >= 0, off + ln_slot_row, Pt).long() for off in (Pl, Pl + Ql)]
        # the segment sums' plans: the landmark blocks over every edge, and
        # over the window's edges the Schur factor's rows (one per window
        # keyframe and landmark, Pt + 1 per keyframe) and the back-substitution
        plan_lm = _segments(torch.cat([drop.reshape(-1)] + [d.reshape(-1) for d in drops_ln]), Pt)
        drop_cat = torch.cat([drop[:W]] + [d[:W] for d in drops_ln], 1)  # [W, Nt]
        plan_rows = _segments((torch.arange(W, device=dev)[:, None] * (Pt + 1) + drop_cat), W * (Pt + 1))
        plan_bs = _segments(drop_cat, Pt)

        poses0 = m.kf_pose[rows_ids]
        pos_all0 = torch.cat([m.pt_pos[local_ids], m.ln_sw[ln_ids], m.ln_ew[ln_ids]], 0)  # [Pt, 3]
        valid_all = torch.cat([local_valid, ln_sel_valid, ln_sel_valid])

        def build(poses, pos_all, edge_active, ln_edge_active, robust):
            r, Jc, Jp, w, _, _, cost = self._edge_terms(
                poses, pos_all[:Pl], uv, oct_, lm_slot_row, feat_ok & edge_active, is_stereo, robust)
            w = torch.where(edge_active, w, 0.0)
            Jc = torch.where(mov[:, None, None, None], Jc, 0.0)  # fixed rows and the gauge keep still
            Jw = (Jc[:W] * w[:W, :, None, None]).reshape(W, -1, 6)
            Hcc = mm(Jw.transpose(1, 2), Jc[:W].reshape(W, -1, 6))  # [W, 6, 6]
            bc = -mm(Jw.transpose(1, 2), r[:W].reshape(W, -1, 1))[..., 0]  # [W, 6]
            Jpf = Jp.reshape(-1, 3, 3)
            wf = w.reshape(-1)
            hpp_e = torch.sum((wf[:, None, None, None] * Jpf[:, :, :, None]) * Jpf[:, :, None, :], 1)  # [E, 3, 3]
            bp_e = -torch.sum(wf[:, None, None] * Jpf * r.reshape(-1, 3)[:, :, None], 1)  # [E, 3]
            seg_vals = [torch.cat([hpp_e.reshape(-1, 9), bp_e], -1)]
            # camera-landmark coupling in edge-factor form: one [6, 3] block
            # per observation, summed into the Schur factor inside solve()
            hcp_e = torch.sum((w[:W, :, None, None, None] * Jc[:W, :, :, :, None]) * Jp[:W, :, :, None, :], 2)
            edge_factors = [(hcp_e, drop[:W])]

            e1, e2, wl, _, _, cost_ln = self._line_edge_terms(
                poses, pos_all[Pl:Pl + Ql], pos_all[Pl + Ql:], ln_obs_rows, ln_slot_row,
                ln_feat_ok & ln_edge_active, robust)
            wl = torch.where(ln_edge_active, wl, 0.0)
            for dropl, (rl, Jcl, Jpl) in zip(drops_ln, (e1, e2)):
                Jcl = torch.where(mov[:, None, None], Jcl, 0.0)
                Jwl = Jcl[:W] * wl[:W, :, None]
                Hcc = Hcc + mm(Jwl.transpose(1, 2), Jcl[:W])
                bc = bc - torch.sum(Jwl * rl[:W, :, None], 1)
                wlf, Jplf, rlf = wl.reshape(-1), Jpl.reshape(-1, 3), rl.reshape(-1)
                hpp_l = wlf[:, None, None] * Jplf[:, :, None] * Jplf[:, None, :]
                bp_l = -wlf[:, None] * Jplf * rlf[:, None]
                seg_vals.append(torch.cat([hpp_l.reshape(-1, 9), bp_l], -1))
                edge_factors.append((Jwl[..., :, None] * Jpl[:W, :, None, :], dropl[:W]))  # [W, L, 6, 3]

            acc = _segsum(torch.cat(seg_vals, 0), plan_lm)
            return Hcc, bc, acc[:, :9].reshape(Pt, 3, 3), acc[:, 9:], edge_factors, cost + cost_ln

        def cost_only(poses, pos_all, edge_active, ln_edge_active, robust):
            cost = self._edge_terms(poses, pos_all[:Pl], uv, oct_, lm_slot_row, feat_ok & edge_active, is_stereo,
                                    robust, jac=False)[2]
            cost_ln = self._line_edge_terms(poses, pos_all[Pl:Pl + Ql], pos_all[Pl + Ql:], ln_obs_rows, ln_slot_row,
                                            ln_feat_ok & ln_edge_active, robust, jac=False)[2]
            return cost + cost_ln

        def residuals(poses, pos_all):
            """chi2 and validity of every edge, all edges active."""
            chi2, ok, _ = self._edge_terms(poses, pos_all[:Pl], uv, oct_, lm_slot_row, feat_ok, is_stereo,
                                           False, jac=False)
            chi2_ln, ok_ln, _ = self._line_edge_terms(poses, pos_all[Pl:Pl + Ql], pos_all[Pl + Ql:], ln_obs_rows,
                                                      ln_slot_row, ln_feat_ok, False, jac=False)
            return chi2, ok, chi2_ln, ok_ln

        def solve(Hcc, bc, Hpp, bp, edge_factors, lam):
            """Schur complement from the per-edge factors: S = Hcc - M M^T
            with M[w] = [.., Hcp[w, p] L_p, ..], L_p the Cholesky factor of
            (Hpp_p + lam I)^-1."""
            a = Hpp + lam * torch.eye(3, device=dev)
            # closed-form adjugate inverse of the [Pt, 3, 3] blocks
            c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
            c01 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
            c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
            det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
            det_ok = det > 1e-12  # empty blocks (the damped block is PSD)
            idet = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
            c10 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
            c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
            c12 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
            c20 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
            c21 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
            c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
            G = torch.stack([torch.stack([c00, c10, c20], -1), torch.stack([c01, c11, c21], -1),
                             torch.stack([c02, c12, c22], -1)], -2) * idet[:, None, None]  # [Pt, 3, 3]
            # closed-form 3x3 Cholesky of G, elementwise
            eps = 1e-20
            g11, g21, g31 = G[:, 0, 0], G[:, 1, 0], G[:, 2, 0]
            g22, g32, g33 = G[:, 1, 1], G[:, 2, 1], G[:, 2, 2]
            l11 = torch.sqrt(torch.clamp(g11, min=0.0))
            i11 = torch.where(l11 > eps, 1.0 / torch.where(l11 > eps, l11, 1.0), 0.0)
            l21 = g21 * i11
            l31 = g31 * i11
            l22 = torch.sqrt(torch.clamp(g22 - l21 * l21, min=0.0))
            i22 = torch.where(l22 > eps, 1.0 / torch.where(l22 > eps, l22, 1.0), 0.0)
            l32 = (g32 - l31 * l21) * i22
            l33 = torch.sqrt(torch.clamp(g33 - l31 * l31 - l32 * l32, min=0.0))
            zero = torch.zeros_like(l11)
            Lc = torch.stack([torch.stack([l11, zero, zero], -1), torch.stack([l21, l22, zero], -1),
                              torch.stack([l31, l32, l33], -1)], -2)  # lower, Lc Lc^T = G

            g_bp = torch.sum(G * bp[:, None, :], -1)  # [Pt, 3] = G @ bp
            rhs = bc
            Ts = []
            for B, d in edge_factors:  # B [W, N, 6, 3], d [W, N]
                dc_ = torch.clamp(d, max=Pt - 1)
                Le = Lc[dc_]  # [W, N, 3, 3]
                Ts.append(torch.stack([B[..., 0] * Le[..., None, 0, j] + B[..., 1] * Le[..., None, 1, j]
                                       + B[..., 2] * Le[..., None, 2, j] for j in range(3)], -1))
                ge = g_bp[dc_] * (d < Pt)[..., None]
                rhs = rhs - torch.sum(torch.sum(B * ge[:, :, None, :], -1), 1)  # bc - sum_e B_e G_p bp_p
            T_cat = torch.cat(Ts, 1)  # [W, Nt, 6, 3]
            M4 = _segsum(T_cat.reshape(-1, 18), plan_rows).reshape(W, Pt + 1, 6, 3)[:, :Pt]
            M2 = M4.permute(0, 2, 1, 3).reshape(W * 6, Pt * 3)
            S = -mm(M2, M2.t())  # full float32 (TF32 is off package-wide)
            # the block diagonal [W, 6, W, 6] of the damped camera blocks
            diag = torch.eye(W, dtype=torch.bool, device=dev)[:, None, :, None]
            Hd = torch.where(diag, (Hcc + lam * torch.eye(6, device=dev))[:, :, None, :], 0.0)
            S = S + Hd.reshape(W * 6, W * 6)
            dc = torch.linalg.solve_ex(S + 1e-8 * torch.eye(W * 6, device=dev), rhs.reshape(-1)).result.reshape(W, 6)
            # back-substitute the landmarks: dp = G (bp - sum_e B_e^T dc_w)
            s_cat = torch.cat([torch.sum(B * dc[:, None, :, None], 2) for B, _ in edge_factors], 1)  # [W, Nt, 3]
            z = _segsum(s_cat.reshape(-1, 3), plan_bs)
            return dc, torch.sum(G * (bp - z)[:, None, :], -1)

        def lm_phase(poses, pos_all, edge_active, ln_edge_active, robust, iters):
            lin = build(poses, pos_all, edge_active, ln_edge_active, robust)
            Hcc, Hpp, cost = lin[0], lin[2], lin[5]
            lam = _TAU * torch.maximum(torch.max(torch.abs(torch.diagonal(Hcc, dim1=-2, dim2=-1))),
                                       torch.max(torch.abs(torch.diagonal(Hpp, dim1=-2, dim2=-1))))
            nu = torch.full((), 2.0, device=dev)
            for it in range(iters):
                if it > 0:  # iteration 0 linearises where the phase's first build did
                    lin = build(poses, pos_all, edge_active, ln_edge_active, robust)
                dc, dp = solve(*lin[:5], lam)
                d_full = torch.where(movable[:, None], dc, 0.0)
                poses_new = torch.cat([se3.compose(se3.exp(d_full), poses[:W]), poses[W:]], 0)
                pos_new = pos_all + torch.where(valid_all[:, None], dp, 0.0)
                new_cost = cost_only(poses_new, pos_new, edge_active, ln_edge_active, robust)
                finite = torch.isfinite(new_cost) & torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dp))
                accept = (new_cost < cost) & finite
                poses = torch.where(accept, poses_new, poses)
                pos_all = torch.where(accept, pos_new, pos_all)
                cost = torch.where(accept, new_cost, cost)
                lam = torch.where(accept, lam / 3.0, lam * nu)
                nu = torch.where(accept, 2.0, nu * 2.0)
            return poses, pos_all

        edge_active = torch.ones_like(feat_ok)
        ln_edge_active = torch.ones_like(ln_feat_ok)
        poses, pos = poses0, pos_all0
        delta2 = torch.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO)
        if iters1 > 0:
            poses, pos = lm_phase(poses, pos, edge_active, ln_edge_active, True, iters1)
        if iters2 > 0:
            # chi2 gate, then the second phase without the robust kernel
            chi2, ok, chi2_ln, ok_ln = residuals(poses, pos)
            edge_active = ok & (chi2 <= delta2)
            ln_edge_active = ok_ln & (chi2_ln <= C.CHI2_MONO)
            poses, pos = lm_phase(poses, pos, edge_active, ln_edge_active, False, iters2)

        # ---- write back
        ln_sid = torch.where(ln_sel_valid, ln_ids, tr.max_maplines)
        m = m._replace(
            kf_pose=set_drop(m.kf_pose, torch.where(win_mask, win_ids, tr.max_kf), poses[:W]),
            pt_pos=set_drop(m.pt_pos, torch.where(local_valid, local_ids, tr.max_pts), pos[:Pl]),
            ln_sw=set_drop(m.ln_sw, ln_sid, pos[Pl:Pl + Ql]),
            ln_ew=set_drop(m.ln_ew, ln_sid, pos[Pl + Ql:]),
        )
        if not erase:
            return m

        # final outliers -> erase the observations from the map, over every
        # edge of the optimisation (also those the chi2 gate excluded) and
        # no other: observations of non-local landmarks were never edges
        chi2, ok_all, chi2_ln, ok_ln_all = residuals(poses, pos)
        bad_edge = feat_ok & (lm_slot_row >= 0) & ((chi2 > delta2) | ~ok_all)
        bad_ln_edge = ln_feat_ok & (ln_slot_row >= 0) & ((chi2_ln > C.CHI2_MONO) | ~ok_ln_all)
        row_sel = torch.where(rows_mask, rows_ids, tr.max_kf)
        return m._replace(
            kf_lm_idx=set_drop(m.kf_lm_idx, row_sel, torch.where(bad_edge, -1, lm_idx_rows)),
            kf_ln_idx=set_drop(m.kf_ln_idx, row_sel, torch.where(bad_ln_edge, -1, ln_idx_rows)),
        )
