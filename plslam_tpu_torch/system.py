"""System facade: frame in, trajectory out.

Port of plslam_tpu/system.py (System::System, TrackRGBD,
SaveTrajectoryTUM, ...) in its synchronous, mapper-less mode:

    slam = System(settings, use_local_mapping=False, use_loop_closing=False)
    Tcw = slam.track_rgbd(rgb_or_gray, depth, t)   # f64[4, 4] or None
    slam.save_trajectory_tum("traj.txt")

Each `track_rgbd` builds the frame (`FrameBuilder`, kernels B1 and B2 on
the card), runs one `Tracker.step` (B3) and reads the step's packed
telemetry back once; keyframes add a row to the relocalizer's BoW database
on the device. A LOST frame is relocalized by BoW + PnP
(`pipeline/reloc.py`, B3 again) before the call returns.

Not ported yet, and refused with NotImplementedError rather than run as a
subset: local mapping (`use_local_mapping=True`, the reference's default:
ROADMAP A15), loop closing (`use_loop_closing=True`, or None with
`UseLoopClosing` on in the settings: A17), the pipelined modes
(`pipeline_depth > 0`: A18), map snapshots and debug images (`save_map`,
`load_map`, `dump_debug_images`: A19) and the host line detector
(`line_backend: "host"`: A21).
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
from plslam_tpu_torch.io import trajectory as traj_io
from plslam_tpu_torch.pipeline import tracking as T
from plslam_tpu_torch.pipeline.reloc import Relocalizer

TRACKING_STATES = {0: "NOT_INITIALIZED", 1: "OK", 2: "LOST"}


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to plslam_tpu_torch yet (ROADMAP {item})")


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
        closure_ms, gba_pending, ms). Only `use_local_mapping=False`,
        `use_loop_closing=False` and `pipeline_depth=0` are ported; the
        reference's defaults therefore raise NotImplementedError."""
        if sensor.lower() != "rgbd":
            raise ValueError("only the RGB-D pipeline is supported (like the reference fork)")
        if not isinstance(settings, Settings):
            settings = load_settings(settings)
        self.settings = settings
        self.use_local_mapping = bool(use_local_mapping)
        self.use_loop_closing = bool(settings.use_loop_closing if use_loop_closing is None else use_loop_closing)
        self.pipeline_depth = int(pipeline_depth)
        if self.use_local_mapping:
            raise _not_ported("local mapping (use_local_mapping=True)", "A15")
        if self.use_loop_closing:
            raise _not_ported("loop closing (use_loop_closing=True)", "A17")
        if self.pipeline_depth != 0:
            raise _not_ported(f"the pipelined mode (pipeline_depth={self.pipeline_depth})", "A18")

        self.builder = FrameBuilder(settings, device=device)  # raises for line_backend "host" (A21)
        self.device = self.builder.device
        # no mapper or loop closer changes the map after the step, so the
        # step refreshes its own working set on keyframe frames
        self.tracker = T.Tracker(settings, max_kf=max_kf, max_pts=max_pts, in_step_local_refresh=True,
                                 device=self.device)
        self.state = self.tracker.init_state()
        # relocalization is part of tracking (Tracking::Relocalization),
        # available with or without loop closing
        self._reloc = Relocalizer(self.tracker)
        self.localization_only = False
        self.n_loops_closed = 0
        self.last_frame_was_kf = False
        self.telemetry_reads = 0  # device->host telemetry copies (one per frame)
        self._last_status = 0
        self._last_frame = None
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

    def _finalize_one(self, v, frame, timestamp, disp_ms):
        """Host side of a frame from its telemetry row: the BoW row of a new
        keyframe, trajectory rows and the JSONL record. -> Tcw or None."""
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
            if not self.localization_only:
                self._reloc.observe_keyframe(self.state.m, kf_id)
        self._timestamps.append(timestamp)
        self._rel_poses.append(np.asarray(v[T.TEL_REL_POSE], np.float64).reshape(4, 4))
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
                "closure_ms": 0.0,  # no loop closer in this mode
                "gba_pending": 0,
                "ms": round(disp_ms + (time.perf_counter() - t0) * 1e3, 2),
            }) + "\n")
        if not tracked:
            return None
        return np.asarray(v[T.TEL_TCW], np.float64).reshape(4, 4)

    # ----------------------------------------------------------------- mode
    def activate_localization_mode(self):
        """Tracking-only replay: the step stops inserting keyframes and
        landmarks and leaves the map's counters alone."""
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

    def reset(self):
        self._last_status = 0
        self._last_frame = None
        self.state = self.tracker.init_state()
        self._timestamps, self._rel_poses = [], []
        self._ref_ids, self._tracked = [], []
        self._kf_timestamps = {}
        self._reloc.reset()  # stale BoW rows must not score against the new map
        self.n_loops_closed = 0

    def shutdown(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    # ----------------------------------------------------------------- save
    def save_trajectory_tum(self, path: str | Path):
        traj_io.save_trajectory_tum(path, self._timestamps, self._rel_poses, self._ref_ids,
                                    self.state.m.kf_pose.cpu().numpy(), tracked_mask=self._tracked)

    def save_keyframe_trajectory_tum(self, path: str | Path):
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
