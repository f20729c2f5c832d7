"""Entry "system": the port's public facade,
`plslam_tpu_torch.system.System(settings, pipeline_depth=K)`, one
`track_rgbd(gray, depth, t)` per frame.

Set-up: build the CUDA kernels (cached in `.torch_build/` of the
checkout), render the traffic's frames, warm up on a throwaway System
(init, tracked frames, keyframe chains, and the localization-mode step
where the traffic has one), then a fresh System for the window; with
"pingpong" traffic it maps the pass first and switches to localization
mode. Timestamps advance by 1/fps per call, whatever view is shown.

Configuration keys: settings (the port's `Settings` fields),
pipeline_depth, max_kf, max_pts, max_fps.
"""

from __future__ import annotations

import gc
import tempfile
from pathlib import Path

import numpy as np

from portbench import generator
from portbench.reference import ate, frontend


class Session:
    def __init__(self, cell, seed: int, seconds: float, device, log):
        from plslam_tpu_torch.config import Settings
        from plslam_tpu_torch.system import System

        cfg, tr = cell.config, cell.traffic
        clock = generator.StageClock(log)
        if device.type == "cuda":
            from plslam_tpu_torch import _build

            _build.library()
        clock("kernel library")
        self.cfg, self.traffic, self.device = cfg, tr, device
        self.settings = Settings(**cfg["settings"])
        self.fps = float(cfg["settings"]["fps"])
        self._System = System
        K = int(cfg["pipeline_depth"])
        self.plan = generator.plan(tr, cfg["max_fps"], seconds, extra=K + 1)
        sc = generator.scene(tr, cfg["settings"], seed)
        clock("scene")
        self.store = generator.FrameStore(sc, self.plan, device)
        clock(f"{len(self.store)} frames rendered")
        self.localize = bool(tr.get("localization", False))
        self.n_calls = 0  # calls over the session's life: a call's timestamp is n_calls / fps
        self.idx_of_call: list[int] = []

        # warm-up on a throwaway System: the same frames, then forgotten
        slam = self._new()
        warm = min(int(tr["warmup_frames"]), len(self.store))
        for i in range(warm):
            slam.track_rgbd(*self.store.frame(i), i / self.fps)
        if self.localize:
            slam.activate_localization_mode()
            for j, i in enumerate(range(warm - 2, max(warm - 2 - 2 * (K + 2), -1), -1)):
                slam.track_rgbd(*self.store.frame(i), (warm + j) / self.fps)
        slam.shutdown()
        log(f"warm-up: {warm} frames, {slam.n_keyframes} keyframes, tracked {sum(slam.tracked_flags)}"
            f"/{len(slam.tracked_flags)}")
        del slam
        gc.collect()
        clock("warm-up session")

        self.slam = self._new()
        if self.localize:
            for i in range(int(tr["map_frames"])):
                self._feed(i)
            self.slam.activate_localization_mode()  # finalizes the pass first
            log(f"map pass: {tr['map_frames']} frames, {self.slam.n_keyframes} keyframes, "
                f"{self.slam.n_map_points} points")
        self.first_window_call = self.n_calls
        self.order = generator.window_order(self.plan)
        clock("window session")

    def _new(self):
        c = self.cfg
        return self._System(self.settings, pipeline_depth=int(c["pipeline_depth"]), max_kf=int(c["max_kf"]),
                            max_pts=int(c["max_pts"]), device=self.device)

    def _feed(self, i: int):
        gray, depth = self.store.frame(i)
        self.slam.track_rgbd(gray, depth, self.n_calls / self.fps)
        self.idx_of_call.append(i)
        self.n_calls += 1

    # ------------------------------------------------------------ window
    def install(self, caps):
        from plslam_tpu_torch.solvers import pose

        caps.wrap_builder(self.slam.builder)
        caps.wrap_pose(pose, "pose_lm" if self.device.type == "cuda" else "pose_optimization_plain")
        caps.wrap_local_ba(self.slam._mapper._ba)

    def instrument(self, tracer):
        tracer.wrap(self.slam, "_dispatch_chunk" if int(self.cfg["pipeline_depth"]) else "_dispatch_single",
                    "dispatch")
        tracer.wrap(self.slam, "_dispatch_kf_chain", "chain")

    def call(self) -> int:
        self._feed(next(self.order))
        return 1

    # ------------------------------------------------------------ after it
    def window_frames(self):
        """(sequence, scene index) of each frame the window fed, in order."""
        return [(0, i) for i in self.idx_of_call[self.first_window_call:]]

    def finish(self) -> dict:
        """Drain the System; its trajectory and keyframe poses from its own
        TUM files, matched to scene frames by timestamp."""
        slam = self.slam
        with tempfile.TemporaryDirectory() as d:
            slam.save_trajectory_tum(Path(d) / "traj.txt")  # finalizes everything in flight
            slam.save_keyframe_trajectory_tum(Path(d) / "kf.txt")
            traj = ate.load_trajectory_tum(Path(d) / "traj.txt")
            kfs = ate.load_trajectory_tum(Path(d) / "kf.txt")
        w0 = self.first_window_call
        flags = slam.tracked_flags[w0:]

        def in_window(rows):
            out = []
            for t, Twc in rows:
                c = int(round(t * self.fps))
                if c >= w0:
                    out.append((0, self.idx_of_call[c], Twc))
            return out

        n_window = self.n_calls - w0
        return dict(
            untracked=n_window - int(sum(flags)),
            traj=in_window(traj), kf=in_window(kfs),
            info=dict(frames=n_window, tracked=int(sum(flags)), keyframes_in_map=int(slam.n_keyframes),
                      keyframes_in_window=len(in_window(kfs)), loops_closed=int(slam.n_loops_closed),
                      last_frame=int(self.idx_of_call[-1])),
        )

    def gt_pose(self, seq: int, i: int) -> np.ndarray:
        return self.store.gt_pose(i)

    def frame(self, seq: int, i: int):
        return self.store.frame(i)

    def release(self):
        self.slam = None
        gc.collect()

    def shapes(self) -> dict:
        s = self.cfg["settings"]
        per_level, level_shapes = frontend.level_budget(s)
        return dict(height=s["height"], width=s["width"], levels=s["n_levels"], level_shapes=level_shapes,
                    patches=sum(per_level))
