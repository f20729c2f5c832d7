"""System facade: frame in, trajectory out.

Port of plslam_tpu/system.py (System::System, TrackRGBD,
SaveTrajectoryTUM, ...) in its synchronous mode, with the local mapper and
loop closing:

    slam = System(settings)                        # every default, as the reference
    Tcw = slam.track_rgbd(rgb_or_gray, depth, t)   # f64[4, 4] or None
    slam.save_trajectory_tum("traj.txt")

Each `track_rgbd` builds the frame (`FrameBuilder`, kernels B1 and B2 on
the card), runs one `Tracker.step` (B3) and reads the step's packed
telemetry back once. A keyframe then runs the keyframe chain on the
device: the local mapper (`pipeline/mapping.py`: culling, triangulation,
fusion, local BA, keyframe culling), the tracking working set recomputed
around the reference keyframe, the keyframe's BoW row in the relocalizer's
database, the loop-detection gate (`pipeline/loopclosing.py`, with loop
closing on) and the rebase data of the keyframes the chain culled; the
host reads that one packed vector back, re-anchors the trajectory rows of
culled keyframes and, when the gate fired, tries the candidates
(`LoopCloser.close_loop`: Sim3 solve, essential graph, SearchAndFuse),
which queues a time-sliced global BA: one slice runs after each later
frame. Without mapper and loop closer a keyframe only adds its BoW row. A
LOST frame is relocalized by BoW + PnP (`pipeline/reloc.py`, B3 again)
before the call returns.

Not ported yet, and refused with NotImplementedError rather than run as a
subset: the pipelined modes (`pipeline_depth > 0`: ROADMAP A18), map
snapshots and debug images (`save_map`, `load_map`, `dump_debug_images`:
A19) and the host line detector (`line_backend: "host"`: A21).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.config import Settings, load_settings
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.geometry import se3
from plslam_tpu_torch.io import trajectory as traj_io
from plslam_tpu_torch.pipeline import tracking as T
from plslam_tpu_torch.pipeline.loopclosing import LoopCloser
from plslam_tpu_torch.pipeline.mapping import LocalMapper
from plslam_tpu_torch.pipeline.reloc import Relocalizer
from plslam_tpu_torch.utils.precision import mm

TRACKING_STATES = {0: "NOT_INITIALIZED", 1: "OK", 2: "LOST"}


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to plslam_tpu_torch yet (ROADMAP {item})")


def _rebase_aux(m, prev_valid):
    """Rebase data of the keyframes one chain culled, on the device: which
    slots it culled, each slot's nearest surviving keyframe by frame id,
    and the rebase transform M = Tcw_culled @ Twc_survivor (float32, as the
    reference computes it)."""
    cur_valid = m.kf_valid
    culled = prev_valid & ~cur_valid & torch.any(cur_valid)
    fid = m.kf_frame_id
    dist = torch.where(cur_valid[None, :], torch.abs(fid[:, None] - fid[None, :]), 1 << 30)
    p_of = torch.argmin(dist, 1).to(torch.int32)
    return culled, p_of, mm(m.kf_pose, se3.inverse(m.kf_pose[p_of.long()]))


class System:
    def __init__(
        self,
        settings: Settings | str | Path,
        sensor: str = "rgbd",
        use_local_mapping: bool = True,
        use_loop_closing: bool | None = None,
        max_kf: int = C.MAX_KF,
        max_pts: int = C.MAX_PTS,
        log_path: str | Path | None = None,
        pipeline_depth: int = 0,
        device="cuda",
    ):
        """The reference's signature and defaults, plus `device`.

        log_path: append one JSON line per frame (frame, t, state, inliers,
        matches, new_kf, kf_slot, n_kf, n_pt, n_ln, loops_closed,
        closure_ms, gba_pending, ms). `pipeline_depth > 0` is not ported
        and raises NotImplementedError."""
        if sensor.lower() != "rgbd":
            raise ValueError("only the RGB-D pipeline is supported (like the reference fork)")
        if not isinstance(settings, Settings):
            settings = load_settings(settings)
        self.settings = settings
        self.use_local_mapping = bool(use_local_mapping)
        self.use_loop_closing = bool(settings.use_loop_closing if use_loop_closing is None else use_loop_closing)
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth != 0:
            raise _not_ported(f"the pipelined mode (pipeline_depth={self.pipeline_depth})", "A18")

        self.builder = FrameBuilder(settings, device=device)  # raises for line_backend "host" (A21)
        self.device = self.builder.device
        # the keyframe chain recomputes the working set after the mapper or
        # loop closer changed the map, so the step's own refresh would be
        # overwritten; without either the step refreshes it on keyframe frames
        self.tracker = T.Tracker(settings, max_kf=max_kf, max_pts=max_pts,
                                 in_step_local_refresh=not (self.use_local_mapping or self.use_loop_closing),
                                 device=self.device)
        self.state = self.tracker.init_state()
        self._mapper = LocalMapper(self.tracker) if self.use_local_mapping else None
        # relocalization is part of tracking (Tracking::Relocalization),
        # available with or without loop closing; a LoopCloser is a Relocalizer
        self._loop = LoopCloser(self.tracker) if self.use_loop_closing else None
        self._reloc = self._loop if self._loop is not None else Relocalizer(self.tracker)
        self.localization_only = False
        self.n_loops_closed = 0
        self.last_frame_was_kf = False
        self.telemetry_reads = 0  # device->host telemetry copies (one per frame)
        self.aux_reads = 0  # device->host copies of keyframe-chain results (one per chain)
        # culled-keyframe substitutions for rows not yet appended:
        # slot -> (surviving slot, Tcw_culled @ Twc_survivor); an entry
        # expires when a new keyframe reuses the slot
        self._recent_rebase: dict[int, tuple[int, np.ndarray]] = {}
        self._last_status = 0
        self._last_frame = None
        self._chain_meta = (0, 0)  # (keyframe slot, keyframe count) of the last chain
        self._closure_ms_pending = 0.0  # wall time of closures in this call, for the JSONL
        self._log_fh = open(log_path, "a", buffering=1) if log_path is not None else None
        # per-frame replay data for save_trajectory_tum
        self._timestamps: list[float] = []
        self._kf_timestamps: dict[int, float] = {}
        self._rel_poses: list[np.ndarray] = []
        self._ref_ids: list[int] = []
        self._tracked: list[bool] = []

    # ---------------------------------------------------------------- track
    def _to_gray(self, rgb: np.ndarray) -> np.ndarray:
        if rgb.ndim != 3:
            return rgb
        w = np.array([0.299, 0.587, 0.114]) if self.settings.rgb else np.array([0.114, 0.587, 0.299])
        return (rgb.astype(np.float32) @ w).astype(np.float32)

    def _dispatch_single(self, gray, depth, timestamp, t_start):
        """Frame build + tracking step on the device, then the one
        device->host copy of the frame's packed telemetry."""
        frame = self.builder(gray, depth)
        self.state, out = self.tracker.step(self.state, frame)
        tel = out.telemetry.cpu().numpy()
        self.telemetry_reads += 1
        return tel, frame, float(timestamp), (time.perf_counter() - t_start) * 1e3

    def track_rgbd(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float):
        """rgb u8[H, W, 3] or gray [H, W]; depth f32[H, W] in metres ->
        this frame's Tcw f64[4, 4], or None if it was not tracked. A LOST
        frame is relocalized before returning (it still returns None; the
        next frame tracks from the recovered pose)."""
        t_start = time.perf_counter()
        ret = self._finalize_one(*self._dispatch_single(self._to_gray(rgb), depth, timestamp, t_start))
        if self._last_status == T.ST_LOST and self._last_frame is not None:
            self.state, recovered = self._reloc.relocalize(self.state, self._last_frame)
            if recovered:
                # the working set is stale wherever tracking was lost:
                # rebuild it around the keyframe relocalization snapped to
                self.state = self.tracker.refresh_local_set(self.state)
                self._last_status = T.ST_OK
        return ret

    def _kf_chain(self, ts, k: int, detect_on: bool = False):
        """The per-keyframe chain on the device: the local mapper, the
        working set around the reference keyframe (Tracking::UpdateLocalMap),
        keyframe k's BoW row (KeyFrameDatabase::add), with loop closing the
        loop-detection gate on the loop closer's consistency groups (off and
        the groups cleared unless `detect_on`), and the rebase data, packed
        as aux (K = max_kf):
          [0]                 gate fired
          [1, 1 + K)          culled-by-this-chain mask
          [1 + K, 1 + 2K)     nearest surviving keyframe per slot
          [1 + 2K, 1 + 18K)   rebase transforms, row-major 4x4 per slot
          [1 + 18K, 1 + 19K)  enough-consistent candidate mask
          [1 + 19K, 1 + 20K)  BoW scores (candidate order)
        Nothing is read back. -> (state, aux, the new groups or None)."""
        prev_valid = ts.m.kf_valid
        m = ts.m if self._mapper is None else self._mapper.process(ts.m, k)
        ts = ts._replace(m=m, local_set=self.tracker._compute_local_set(m, ts.ref_kf))
        self._reloc.observe_keyframe(m, k)
        K, dev = self.tracker.max_kf, self.device
        loop = self._loop
        if loop is not None:
            has_any, enough, scores, g_mask, g_consist = loop._detect_gate_impl(self._reloc.kf_bow, m, k, loop._g_mask,
                                                                                loop._g_consist)
            if not detect_on:  # within LOOP_MIN_KFS_SINCE_LAST of a closure: off, groups reset
                has_any, g_mask, g_consist = has_any & False, g_mask & False, torch.zeros_like(g_consist)
            groups = (g_mask, g_consist)
        else:
            groups = None
            has_any = torch.zeros((), dtype=torch.bool, device=dev)
            enough = torch.zeros(K, dtype=torch.bool, device=dev)
            scores = torch.zeros(K, dtype=torch.float32, device=dev)
        culled, p_of, M = _rebase_aux(m, prev_valid)
        aux = torch.cat([has_any.to(torch.float32)[None], culled.to(torch.float32), p_of.to(torch.float32),
                         M.reshape(-1), enough.to(torch.float32), scores])
        return ts, aux, groups

    def _dispatch_kf_chain(self, kf_id: int):
        """Run the keyframe chain after keyframe kf_id; -> its aux vector,
        still on the device."""
        loop = self._loop
        detect_on = loop.begin_keyframe() if loop is not None else False
        self._chain_meta = (kf_id, loop._kf_counter if loop is not None else 0)
        self.state, aux, groups = self._kf_chain(self.state, kf_id, detect_on)
        if loop is not None:
            loop._g_mask, loop._g_consist = groups
        return aux

    def _process_chain_results(self, aux):
        """Host tail of a keyframe chain: one read of its aux vector, the
        rebase of trajectory rows whose reference keyframe it culled, and
        when the loop gate fired the candidates, best score first, until
        one closes (then the working set is rebuilt on the corrected map)."""
        K = self.tracker.max_kf
        v = aux.cpu().numpy()
        self.aux_reads += 1
        culled = v[1:1 + K] > 0
        if culled.any():
            self._apply_rebase(culled, v[1 + K:1 + 2 * K].astype(np.int64),
                               v[1 + 2 * K:1 + 18 * K].reshape(K, 4, 4).astype(np.float64))
        loop = self._loop
        kf_id, counter = self._chain_meta
        if (loop is not None and v[0] > 0 and counter > loop.last_loop_kfn
                and bool(self.state.m.kf_valid[kf_id])):
            enough = v[1 + 18 * K:1 + 19 * K] > 0
            scores = v[1 + 19 * K:1 + 20 * K]
            cands = sorted(np.where(enough)[0].tolist(), key=lambda c: -scores[c])[: C.LOOP_MAX_CANDIDATES]
            self.state, closed = loop.try_candidates(self.state, kf_id, cands)
            if closed:
                self.n_loops_closed = loop.n_loops_closed
                self._closure_ms_pending += loop.last_closure_ms
                self.state = self.tracker.refresh_local_set(self.state)

    def _apply_rebase(self, culled, p_of, M):
        """Re-anchor replay rows whose reference keyframe was culled
        (SaveTrajectoryTUM follows a bad keyframe to its parent); the
        substitutions are kept in _recent_rebase for rows still to come."""
        ref_arr = np.asarray(self._ref_ids)
        for j in np.where(culled)[0]:
            p = int(p_of[j])
            Mj = M[j]
            for i in np.where(ref_arr == j)[0]:
                self._rel_poses[i] = self._rel_poses[i] @ Mj
                self._ref_ids[i] = p
            ref_arr[ref_arr == j] = p
            self._recent_rebase[int(j)] = (p, Mj)

    def _finalize_one(self, v, frame, timestamp, disp_ms):
        """Host side of a frame from its telemetry row: the keyframe chain
        (or, without mapper and loop closer, the BoW row) of a new keyframe,
        one pending global-BA slice, trajectory rows and the JSONL record.
        -> Tcw or None."""
        t0 = time.perf_counter()
        tracked = v[T.TEL_TRACKED] > 0
        new_kf = bool(v[T.TEL_NEW_KF] > 0)
        kf_id = int(v[T.TEL_KF_ID])
        ref_kf = int(v[T.TEL_REF_KF])
        status = int(v[T.TEL_STATUS])
        self.last_frame_was_kf = new_kf
        self._last_status = status
        self._last_frame = frame
        if new_kf:
            self._kf_timestamps[kf_id] = timestamp
            self._recent_rebase.pop(kf_id, None)  # the slot is reused: its substitution is stale
            if (self._mapper is not None or self._loop is not None) and not self.localization_only:
                self._process_chain_results(self._dispatch_kf_chain(kf_id))
            elif not self.localization_only:
                self._reloc.observe_keyframe(self.state.m, kf_id)
        loop = self._loop
        if loop is not None and loop.gba_queue and not self.localization_only:
            # the time-sliced global BA: one slice per frame, tracking goes on
            # on the partly optimised map (RunGlobalBundleAdjustment's thread)
            self.state = loop.pump_gba(self.state)
            if not loop.gba_queue:
                self.state = self.tracker.refresh_local_set(self.state)
        rel_pose = np.asarray(v[T.TEL_REL_POSE], np.float64).reshape(4, 4)
        if ref_kf in self._recent_rebase:
            # the frame's reference keyframe was culled: rebase the row as
            # _apply_rebase did the rows before it
            p, M = self._recent_rebase[ref_kf]
            rel_pose = rel_pose @ M
            ref_kf = p
        self._timestamps.append(timestamp)
        self._rel_poses.append(rel_pose)
        self._ref_ids.append(ref_kf)
        self._tracked.append(bool(tracked))
        if self._log_fh is not None:
            self._log_fh.write(json.dumps({
                "frame": len(self._timestamps) - 1,
                "t": timestamp,
                "state": TRACKING_STATES[status],
                "inliers": int(v[T.TEL_N_INLIERS]),
                "matches": int(v[T.TEL_N_MATCHES]),
                "new_kf": new_kf,
                "kf_slot": kf_id if new_kf else -1,
                "n_kf": int(v[T.TEL_N_KF]),
                "n_pt": int(v[T.TEL_N_PT]),
                "n_ln": int(v[T.TEL_N_LN]),
                "loops_closed": self.n_loops_closed,
                # wall time of closures made in this call (CorrectLoop, device work included)
                "closure_ms": round(self._closure_ms_pending, 1),
                # global-BA slices still pending after this frame
                "gba_pending": len(loop.gba_queue) if loop is not None else 0,
                "ms": round(disp_ms + (time.perf_counter() - t0) * 1e3, 2),
            }) + "\n")
        self._closure_ms_pending = 0.0
        if not tracked:
            return None
        return np.asarray(v[T.TEL_TCW], np.float64).reshape(4, 4)

    # ----------------------------------------------------------------- mode
    def activate_localization_mode(self):
        """Tracking-only replay: the step stops inserting keyframes and
        landmarks and leaves the map's counters alone (pending global-BA
        slices run first)."""
        self._flush_pending()
        self.localization_only = True
        self.state = self.state._replace(only_tracking=torch.ones((), dtype=torch.bool, device=self.device))

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.state = self.state._replace(only_tracking=torch.zeros((), dtype=torch.bool, device=self.device))

    def get_tracking_state(self) -> str:
        return TRACKING_STATES[int(self.state.status)]

    @property
    def tracked_flags(self) -> list:
        """Tracked flag of every frame so far, in frame order."""
        return list(self._tracked)

    def map_changed(self) -> bool:
        return bool(self.state.m.n_kf > 0)

    def get_tracked_map_points(self) -> np.ndarray:
        """World positions of the landmarks tracked in the current frame."""
        lm = self.state.last.lm_idx.cpu().numpy()
        return self.state.m.pt_pos.cpu().numpy()[lm[lm >= 0]]

    def _flush_pending(self):
        """Run every pending global-BA slice: saves and mode switches see the
        fully optimised map."""
        if self._loop is not None and self._loop.gba_queue:
            self.state = self._loop.flush_gba(self.state)

    def reset(self):
        self._recent_rebase = {}
        self._closure_ms_pending = 0.0
        self._last_status = 0
        self._last_frame = None
        self.state = self.tracker.init_state()
        self._timestamps, self._rel_poses = [], []
        self._ref_ids, self._tracked = [], []
        self._kf_timestamps = {}
        self._reloc.reset()  # stale BoW rows must not score against the new map
        self.n_loops_closed = 0

    def shutdown(self):
        self._flush_pending()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    # ----------------------------------------------------------------- save
    def save_trajectory_tum(self, path: str | Path):
        self._flush_pending()
        traj_io.save_trajectory_tum(path, self._timestamps, self._rel_poses, self._ref_ids,
                                    self.state.m.kf_pose.cpu().numpy(), tracked_mask=self._tracked)

    def save_keyframe_trajectory_tum(self, path: str | Path):
        self._flush_pending()  # both save paths write from the same map
        m = self.state.m
        n = m.kf_pose.shape[0]
        stamps = np.array([self._kf_timestamps.get(i, 0.0) for i in range(n)])
        traj_io.save_keyframe_trajectory_tum(path, stamps, m.kf_pose.cpu().numpy(), m.kf_valid.cpu().numpy())

    def save_map(self, path: str | Path):
        raise _not_ported("System.save_map", "A19")

    def load_map(self, path: str | Path):
        raise _not_ported("System.load_map", "A19")

    def dump_debug_images(self, out_dir: str | Path, gray=None):
        raise _not_ported("System.dump_debug_images", "A19")

    # ---------------------------------------------------------------- state
    @property
    def n_keyframes(self) -> int:
        return int(self.state.m.n_kf)

    @property
    def n_map_points(self) -> int:
        return int(self.state.m.pt_valid.sum())
