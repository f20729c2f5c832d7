"""System facade: frame in, trajectory out.

Port of plslam_tpu/system.py (System::System, TrackRGBD,
SaveTrajectoryTUM, ...) with the local mapper, loop closing, the pipelined
mode and map snapshots:

    slam = System(settings)                        # every default, as the reference
    Tcw = slam.track_rgbd(rgb_or_gray, depth, t)   # f64[4, 4] or None
    slam.save_trajectory_tum("traj.txt")
    slam.save_map("map.npz")                       # load_map, then activate_localization_mode

Each frame is built (`FrameBuilder`, kernels B1 and B2 on the card) and
tracked by one `Tracker.step` (B3); its packed telemetry comes back in one
device->host copy. A keyframe then runs the keyframe chain on the
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
LOST frame is relocalized by BoW + PnP (`pipeline/reloc.py`, B3 again).

`pipeline_depth=0` finalizes each frame before `track_rgbd` returns.
`pipeline_depth=K` buffers K frames, uploads them with one copy and runs
their K steps back to back, the state carried through (the frames stay
strictly sequential), and reads the K telemetry rows back with one
asynchronous copy; a frame's host side (keyframe chain, trajectory rows,
log) runs K frames later, and a chain's packed result is read back
asynchronously and taken up once it has arrived. Neither dispatch
synchronises with the device. Device->host copies go into pinned memory
with an event recorded after them, and only that event is waited on.

With `line_backend: "host"` each call runs the host LSD (ops/lsd.py) on the
frame's gray image before dispatch, and the endpoints travel with the
images: one pinned buffer per frame or chunk, one non-blocking copy.
`dump_debug_images` draws the frame and the map (io/viewer.py) and writes
them as PNG files (io/png.py).
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.config import Settings, load_settings
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.geometry import se3
from plslam_tpu_torch.io import trajectory as traj_io
from plslam_tpu_torch.io import viewer
from plslam_tpu_torch.io.png import write_png
from plslam_tpu_torch.io.snapshot import load_state, save_state
from plslam_tpu_torch.pipeline import tracking as T
from plslam_tpu_torch.pipeline.loopclosing import LoopCloser
from plslam_tpu_torch.pipeline.mapping import LocalMapper
from plslam_tpu_torch.pipeline.reloc import Relocalizer
from plslam_tpu_torch.utils.precision import mm

TRACKING_STATES = {0: "NOT_INITIALIZED", 1: "OK", 2: "LOST"}


def _to_host_async(t):
    """Start the device->host copy of t -> (numpy array, event). On the card
    the copy goes into pinned memory without blocking and the array is
    valid once the event has completed; on the CPU the event is None."""
    if t.device.type != "cuda":
        return t.detach().numpy(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host.numpy(), event  # the array keeps the pinned tensor alive


class _TelChunk:
    """One telemetry copy shared by the frames of a dispatch: [TEL] for a
    single frame, [K, TEL] for a chunk. row() waits on the copy's event,
    the first time only."""

    __slots__ = ("host", "event")

    def __init__(self, dev):
        self.host, self.event = _to_host_async(dev)

    def row(self, idx):
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host if idx is None else self.host[idx]


def _pack_frames(host, frames, H, W):
    """Write n frames into host f32[>= n, 2HW + 5L]: per row the gray and
    depth images, then with host lines each keyline as (sp, ep, valid)."""
    n_img = 2 * H * W
    for j, (gray, depth, lines) in enumerate(frames):
        host[j, :n_img] = np.stack([np.asarray(gray, np.float32), np.asarray(depth, np.float32)]).reshape(-1)
        if lines is not None:
            sp, ep, valid = lines
            host[j, n_img:] = np.concatenate([sp, ep, valid[:, None]], 1).reshape(-1)


def _unpack_frames(dev, H, W, L):
    """f32[n, 2HW + 5L] on the device -> (images f32[n, 2, H, W], keylines
    f32[n, L, 5] or None): views, no copy."""
    n_img = 2 * H * W
    return dev[:, :n_img].view(-1, 2, H, W), dev[:, n_img:].view(-1, L, 5) if L else None


class _Staging:
    """Upload of n <= K frames: their gray and depth images (and, with host
    lines, their keyline endpoints) packed into a pinned host buffer
    f32[K, 2HW + 5L], then one non-blocking copy to the card. Two buffers
    are used in turn, and a buffer is written again only once the event
    recorded after its last copy has completed (it has whenever the frames
    it carried have been finalized, so the wait is a safeguard that does
    not block in the pipelined loop)."""

    def __init__(self, K, H, W, L, device):
        self.shape, self.device = (H, W, L), device
        self.bufs = [torch.empty((K, 2 * H * W + 5 * L), dtype=torch.float32, pin_memory=True) for _ in range(2)]
        self.events = [None, None]
        self.turn = 0

    def upload(self, frames):
        i, self.turn = self.turn, 1 - self.turn
        if self.events[i] is not None and not self.events[i].query():
            self.events[i].synchronize()
        buf = self.bufs[i][: len(frames)]
        H, W, L = self.shape
        _pack_frames(buf.numpy(), frames, H, W)
        out = torch.empty(buf.shape, dtype=torch.float32, device=self.device)
        out.copy_(buf, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record(torch.cuda.current_stream(self.device))
        return _unpack_frames(out, H, W, L)


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
        closure_ms, gba_pending, ms).

        pipeline_depth: frames kept in flight before a frame's host side
        runs. 0: track_rgbd returns this frame's pose. K > 0: frames are
        dispatched K to a chunk, and each call returns the pose of the frame
        finalized during it (None for exactly the first K calls);
        `tracked_flags` and the saves cover finalized frames, and every save,
        mode switch and `shutdown` first finalizes whatever is in flight."""
        if sensor.lower() != "rgbd":
            raise ValueError("only the RGB-D pipeline is supported (like the reference fork)")
        if not isinstance(settings, Settings):
            settings = load_settings(settings)
        self.settings = settings
        self.use_local_mapping = bool(use_local_mapping)
        self.use_loop_closing = bool(settings.use_loop_closing if use_loop_closing is None else use_loop_closing)
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {self.pipeline_depth}")

        self.builder = FrameBuilder(settings, device=device)
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
        self.telemetry_reads = 0  # device->host telemetry copies (one per dispatch: a frame or a chunk)
        self.aux_reads = 0  # device->host copies of keyframe-chain results (one per chain)
        # in-flight frames, oldest first: (_TelChunk, row or None, frame
        # source, timestamp, dispatch ms); the source is ("dev", FrameData)
        # for a single dispatch and ("host", gray, depth, lines) for a chunk's
        # frame (lines: the host LSD's endpoint arrays, or None)
        self._inflight: deque = deque()
        self._buf: list = []  # pipelined: (gray, depth, lines, timestamp, t_start) awaiting a chunk
        # dispatched keyframe chains whose aux vector is not yet taken up:
        # dict(aux=host array, event, kf_id, counter)
        self._pending_chain: deque = deque()
        self._staging = None
        # what the host knows of the carried state's status, for the step's
        # init/track switch: False UNINIT, True initialised, None unknown
        self._initialised = False
        self._lost_pending = False
        # culled-keyframe substitutions for rows not yet appended:
        # slot -> (surviving slot, Tcw_culled @ Twc_survivor); an entry
        # expires when a new keyframe reuses the slot
        self._recent_rebase: dict[int, tuple[int, np.ndarray]] = {}
        self._last_status = 0
        self._last_frame = None
        self._chain_meta = (0, 0)  # (keyframe slot, keyframe count) of the last chain dispatched
        self._closure_ms_pending = 0.0  # wall time of closures in this finalize, for the JSONL
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

    def _host_lines(self, gray):
        """The host LSD's endpoint arrays for this frame, or None when the
        builder detects its lines on the device (or lines are off)."""
        return self.builder.detect_lines(gray) if self.builder.host_lines else None

    def _upload(self, frames):
        """(gray, depth, lines) host data of n frames -> (images f32[n, 2, H,
        W], keylines f32[n, L, 5] or None) on the device: one non-blocking
        copy from pinned memory on the card."""
        H, W = self.settings.height, self.settings.width
        L = self.builder.line_capacity if self.builder.host_lines else 0
        if self.device.type != "cuda":
            host = np.empty((len(frames), 2 * H * W + 5 * L), np.float32)
            _pack_frames(host, frames, H, W)
            return _unpack_frames(torch.from_numpy(host), H, W, L)
        if self._staging is None:
            self._staging = _Staging(max(self.pipeline_depth, 1), H, W, L, self.device)
        return self._staging.upload(frames)

    def _step(self, gray, depth, lines=None):
        """Build and track one uploaded frame (lines: its keylines f32[L, 5]
        with host lines), the init/track switch decided by what the host
        knows -> (FrameData, telemetry on the device)."""
        ln = () if lines is None else (lines[:, 0:2], lines[:, 2:4], lines[:, 4] > 0)
        frame = self.builder.build(gray, depth, *ln)
        known = self._initialised
        self.state, out = self.tracker.step(self.state, frame, initialised=known)
        self._initialised = True if known else None  # a failed init stays UNINIT
        return frame, out.telemetry

    def _dispatch_single(self, gray, depth, lines, timestamp, t_start):
        """One frame: upload, build, step and the start of its telemetry
        copy; the frame joins the in-flight queue."""
        imgs, lns = self._upload([(gray, depth, lines)])
        frame, tel = self._step(imgs[0, 0], imgs[0, 1], None if lns is None else lns[0])
        self.telemetry_reads += 1
        self._inflight.append((_TelChunk(tel), None, ("dev", frame), float(timestamp),
                               (time.perf_counter() - t_start) * 1e3))

    def _dispatch_chunk(self):
        """The K buffered frames: one upload, K builds and steps with the
        state carried through, and one copy of their stacked telemetry that
        serves all K finalizes. Nothing here waits for the device."""
        K = self.pipeline_depth
        t0 = time.perf_counter()
        imgs, lns = self._upload([b[:3] for b in self._buf])
        tels = [self._step(imgs[i, 0], imgs[i, 1], None if lns is None else lns[i])[1] for i in range(K)]
        tc = _TelChunk(torch.stack(tels))
        self.telemetry_reads += 1
        disp_ms = (time.perf_counter() - t0) * 1e3 / K
        for i, (gray, depth, lines, ts, _) in enumerate(self._buf):
            self._inflight.append((tc, i, ("host", gray, depth, lines), ts, disp_ms))
        self._buf.clear()

    def track_rgbd(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float):
        """rgb u8[H, W, 3] or gray [H, W]; depth f32[H, W] in metres -> the
        Tcw f64[4, 4] of the frame finalized during this call (this frame's
        with pipeline_depth=0), or None if it was not tracked or nothing was
        finalized. A LOST frame drains the pipeline; if the newest frame is
        still LOST it is relocalized before returning (it still returns
        None; the next frame tracks from the recovered pose)."""
        t_start = time.perf_counter()
        gray = self._to_gray(rgb)
        lines = self._host_lines(gray)
        K = self.pipeline_depth
        ret = None
        if K == 0:
            self._dispatch_single(gray, depth, lines, timestamp, t_start)
            while self._inflight:
                ret = self._finalize_one()
        else:
            self._buf.append((gray, depth, lines, float(timestamp), t_start))
            if len(self._buf) == K:
                self._dispatch_chunk()
            while self._inflight and len(self._buf) + len(self._inflight) > K:
                ret = self._finalize_one()
        if self._lost_pending:
            # later frames may have recovered in the step: finalize them all
            # and relocalize only if the newest is still LOST (Tracking::Track
            # relocalizes while mState == LOST)
            drained = self._drain_frames()
            ret = drained if drained is not None else ret
            self._lost_pending = False
            if self._last_status == T.ST_LOST and self._last_frame is not None:
                self.state, recovered = self._reloc.relocalize(self.state, self._materialize_frame(self._last_frame))
                if recovered:
                    # the working set is stale wherever tracking was lost:
                    # rebuild it around the keyframe relocalization snapped to
                    self.state = self.tracker.refresh_local_set(self.state)
                    self._last_status = T.ST_OK
        return ret

    def _drain_frames(self):
        """Dispatch the buffered frames one by one and finalize everything
        in flight -> the last finalized frame's Tcw or None."""
        ret = None
        for gray, depth, lines, ts, _ in self._buf:
            self._dispatch_single(gray, depth, lines, ts, time.perf_counter())
        self._buf.clear()
        while self._inflight:
            ret = self._finalize_one()
        return ret

    def _materialize_frame(self, fsrc):
        """FrameData of a finalized frame: a single dispatch kept it; a
        chunk's frame is rebuilt from its host images (only relocalization
        needs a past frame)."""
        if fsrc[0] == "dev":
            return fsrc[1]
        _, gray, depth, lines = fsrc
        return self.builder(gray, depth, *(lines if lines is not None else ()))

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
        """Run the keyframe chain after keyframe kf_id and start the copy of
        its aux vector; the host tail waits in `_pending_chain` for
        `_process_chain_results`. -> the aux vector, on the device."""
        loop = self._loop
        detect_on = loop.begin_keyframe() if loop is not None else False
        self._chain_meta = (kf_id, loop._kf_counter if loop is not None else 0)
        self.state, aux, groups = self._kf_chain(self.state, kf_id, detect_on)
        if loop is not None:
            loop._g_mask, loop._g_consist = groups
        host, event = _to_host_async(aux)
        self._pending_chain.append(dict(aux=host, event=event, kf_id=kf_id, counter=self._chain_meta[1]))
        return aux

    def _process_chain_results(self, block: bool = True):
        """Host tail of the dispatched keyframe chains, oldest first: one
        read of each aux vector, the rebase of trajectory rows whose
        reference keyframe it culled, and when the loop gate fired the
        candidates, best score first, until one closes (then the working set
        is rebuilt on the corrected map). With block=False only aux vectors
        whose copy has completed are taken up."""
        K = self.tracker.max_kf
        loop = self._loop
        while self._pending_chain:
            e = self._pending_chain[0]
            if not block and e["event"] is not None and not e["event"].query():
                return
            self._pending_chain.popleft()
            if e["event"] is not None:
                e["event"].synchronize()
            v = e["aux"]
            self.aux_reads += 1
            culled = v[1:1 + K] > 0
            if culled.any():
                self._apply_rebase(culled, v[1 + K:1 + 2 * K].astype(np.int64),
                                   v[1 + 2 * K:1 + 18 * K].reshape(K, 4, 4).astype(np.float64))
            kf_id = e["kf_id"]
            if (loop is not None and v[0] > 0 and e["counter"] > loop.last_loop_kfn
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

    def _finalize_one(self):
        """Host side of the oldest in-flight frame, from its telemetry row
        (the first frame of a chunk waits for the chunk's copy). -> Tcw or
        None."""
        telc, idx, fsrc, timestamp, disp_ms = self._inflight.popleft()
        t0 = time.perf_counter()
        return self._finalize_row(telc.row(idx), fsrc, timestamp, disp_ms, t0)

    def _finalize_row(self, v, fsrc, timestamp, disp_ms, t0=None):
        """Host side of a frame from its telemetry row v: the keyframe chain
        (or, without mapper and loop closer, the BoW row) of a new keyframe,
        the chains' host tails, one pending global-BA slice, trajectory rows
        and the JSONL record. -> Tcw or None."""
        t0 = time.perf_counter() if t0 is None else t0
        tracked = v[T.TEL_TRACKED] > 0
        new_kf = bool(v[T.TEL_NEW_KF] > 0)
        kf_id = int(v[T.TEL_KF_ID])
        ref_kf = int(v[T.TEL_REF_KF])
        status = int(v[T.TEL_STATUS])
        self.last_frame_was_kf = new_kf
        self._last_status = status
        self._last_frame = fsrc
        if status != T.ST_UNINIT:
            self._initialised = True  # and it stays so until reset or load_map
        elif not self._inflight:
            self._initialised = False  # the carried state is this frame's
        loc = self.localization_only
        if new_kf:
            # a pending chain may have culled this very slot: its rebase must
            # land while the slot still means the old keyframe
            self._process_chain_results(block=True)
            self._kf_timestamps[kf_id] = timestamp
            self._recent_rebase.pop(kf_id, None)  # the slot is reused: its substitution is stale
        else:
            self._process_chain_results(block=self.pipeline_depth == 0)
        if new_kf and not loc and (self._mapper is not None or self._loop is not None):
            self._dispatch_kf_chain(kf_id)
            if self.pipeline_depth == 0:
                # the chain, a closure included, settles before the call returns
                self._process_chain_results(block=True)
        elif new_kf and not loc:
            self._reloc.observe_keyframe(self.state.m, kf_id)
        loop = self._loop
        if loop is not None and loop.gba_queue and not loc:
            # the time-sliced global BA: one slice per frame, tracking goes on
            # on the partly optimised map (RunGlobalBundleAdjustment's thread)
            self.state = loop.pump_gba(self.state)
            if not loop.gba_queue:
                self.state = self.tracker.refresh_local_set(self.state)
        if status == T.ST_LOST:
            self._lost_pending = True  # relocalize once the pipeline has drained
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
                # wall time of closures made in this finalize (CorrectLoop, device work included)
                "closure_ms": round(self._closure_ms_pending, 1),
                # global-BA slices still pending after this frame
                "gba_pending": len(loop.gba_queue) if loop is not None else 0,
                # the frame's dispatch (a chunk's split over its K frames) plus its finalize
                "ms": round(disp_ms + (time.perf_counter() - t0) * 1e3, 2),
            }) + "\n")
        self._closure_ms_pending = 0.0
        if not tracked:
            return None
        return np.asarray(v[T.TEL_TCW], np.float64).reshape(4, 4)

    # ----------------------------------------------------------------- mode
    def activate_localization_mode(self):
        """Tracking-only replay: the step stops inserting keyframes and
        landmarks and leaves the map's counters alone (frames in flight and
        pending global-BA slices finish first)."""
        self._flush_pending()
        self.localization_only = True
        self.state = self.state._replace(only_tracking=torch.ones((), dtype=torch.bool, device=self.device))

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.state = self.state._replace(only_tracking=torch.zeros((), dtype=torch.bool, device=self.device))

    def get_tracking_state(self) -> str:
        """The state after the newest dispatched frame (reads it back)."""
        return TRACKING_STATES[int(self.state.status)]

    @property
    def tracked_flags(self) -> list:
        """Tracked flag of every finalized frame, in frame order."""
        return list(self._tracked)

    def map_changed(self) -> bool:
        return bool(self.state.m.n_kf > 0)

    def get_tracked_map_points(self) -> np.ndarray:
        """World positions of the landmarks tracked in the current frame."""
        lm = self.state.last.lm_idx.cpu().numpy()
        return self.state.m.pt_pos.cpu().numpy()[lm[lm >= 0]]

    def _flush_pending(self):
        """Dispatch the buffered frames, finalize every frame in flight, take
        up every pending chain result and run every pending global-BA
        slice: saves and mode switches see the fully optimised map and
        complete replay rows."""
        self._drain_frames()
        self._process_chain_results(block=True)
        if self._loop is not None and self._loop.gba_queue:
            self.state = self._loop.flush_gba(self.state)

    def reset(self):
        self._inflight.clear()
        self._buf.clear()
        self._pending_chain.clear()
        self._recent_rebase = {}
        self._lost_pending = False
        self._closure_ms_pending = 0.0
        self._last_status = 0
        self._last_frame = None
        self.state = self.tracker.init_state()
        self._initialised = False
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
        """Snapshot the whole state (map and tracking carry) to npz
        (io/snapshot.py), with the per-slot keyframe timestamps and the BoW
        rows beside it, after finalizing everything in flight."""
        self._flush_pending()
        n = self.tracker.max_kf
        kf_ts = np.zeros(n, np.float64)
        for slot, t in self._kf_timestamps.items():
            if 0 <= slot < n:
                kf_ts[slot] = t
        save_state(path, self.state, extra={"kf_timestamps": kf_ts, "kf_bow": self._reloc.kf_bow})

    def load_map(self, path: str | Path):
        """Restore a snapshot onto this System's device; with
        activate_localization_mode() it replays tracking against a prebuilt
        map. The live mode wins over the file's `only_tracking`."""
        self._flush_pending()  # rebase against the outgoing map's poses
        was_loc = self.localization_only
        self.state, extras = load_state(path, self.state, want_extra=True)
        (self.activate_localization_mode if was_loc else self.deactivate_localization_mode)()
        self._initialised = int(self.state.status) != T.ST_UNINIT
        kf_valid = self.state.m.kf_valid.cpu().numpy()
        if "kf_timestamps" in extras:
            ts = np.asarray(extras["kf_timestamps"], np.float64)
            self._kf_timestamps = {int(i): float(ts[i]) for i in np.where(kf_valid[: len(ts)])[0]}
        if "kf_bow" in extras and tuple(extras["kf_bow"].shape) == tuple(self._reloc.kf_bow.shape):
            self._reloc.load_database(extras["kf_bow"])
        else:
            # an older snapshot, or another vocabulary size: the rows follow
            # from kf_desc
            self._reloc.rebuild_database(self.state.m)
        # a snapshot older than the local_set field keeps the template's
        # empty set: rebuild it around the restored reference keyframe
        self.state = self.tracker.refresh_local_set(self.state)

    def dump_debug_images(self, out_dir: str | Path, gray=None):
        """The headless FrameDrawer / MapDrawer (io/viewer.py): writes
        frame.png (if gray is given) and map.png into out_dir, from the
        state after the newest dispatched frame."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        if gray is not None:
            write_png(out / "frame.png", viewer.draw_frame(np.asarray(gray), self.state))
        write_png(out / "map.png", viewer.draw_map(self.state))

    # ---------------------------------------------------------------- state
    @property
    def n_keyframes(self) -> int:
        return int(self.state.m.n_kf)

    @property
    def n_map_points(self) -> int:
        return int(self.state.m.pt_valid.sum())
