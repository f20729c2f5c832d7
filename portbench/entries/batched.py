"""Entry "batched": the port's batched multi-sequence path, driven as
`plslam_tpu_torch/examples/multi_sequence.py --map` drives it. Per call,
one frame of each of B sequences: `FrameBuilder` per sequence, one
`BatchedTracker.step` over the stacked frames, and, when any sequence made
a keyframe, one `BatchedMapper.process`; the step's telemetry is read back
once per call.

Set-up: build the CUDA kernels, render each sequence's frames (sequence b
is `generator.scene(..., index=b)`), warm up on a throwaway batched state (init, tracked
steps, batched chains), then a fresh state for the window.

Configuration keys: settings (the port's `Settings` fields), batch,
max_kf, max_pts, max_fps (per sequence).
"""

from __future__ import annotations

import gc
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import generator
from portbench.reference import frontend


def known_status(status: np.ndarray):
    """What the host knows of a batch's statuses for BatchedTracker.step:
    False when every sequence is UNINIT, True when none is, else None
    (copy of examples/multi_sequence.py's rule)."""
    uninit = status == 0
    if uninit.all():
        return False
    return True if not uninit.any() else None


class Session:
    def __init__(self, cell, seed: int, seconds: float, device, log):
        from plslam_tpu_torch.config import Settings
        from plslam_tpu_torch.features.frame import FrameBuilder
        from plslam_tpu_torch.parallel.batch import BatchedMapper, BatchedTracker, stack
        from plslam_tpu_torch.pipeline import tracking as T
        from plslam_tpu_torch.pipeline.mapping import LocalMapper

        cfg, tr = cell.config, cell.traffic
        clock = generator.StageClock(log)
        if device.type == "cuda":
            from plslam_tpu_torch import _build

            _build.library()
        clock("kernel library")
        self.cfg, self.device, self.T = cfg, device, T
        self.B = int(cfg["batch"])
        settings = Settings(**cfg["settings"])
        self.plan = generator.plan(tr, cfg["max_fps"], seconds, extra=1)
        n = len(self.plan.views)
        with ThreadPoolExecutor(self.B) as ex:  # the textures are numpy work, most of it outside the GIL
            scenes = list(ex.map(lambda b: generator.scene(tr, cfg["settings"], seed, index=b), range(self.B)))
        clock(f"{self.B} scenes")
        self.stores = [generator.FrameStore(sc, self.plan, device) for sc in scenes]
        clock(f"{self.B} x {n} frames rendered")
        self.fb = FrameBuilder(settings, device=device)
        tracker = T.Tracker(settings, max_pts=int(cfg["max_pts"]), max_kf=int(cfg["max_kf"]), device=device)
        self.bt = BatchedTracker(tracker, batch=self.B)
        self.bm = BatchedMapper(LocalMapper(tracker))
        self._stack = stack

        warm = min(int(tr["warmup_frames"]), n)
        self._start()
        for _ in range(warm):
            self.call()
        kf = int(sum(np.asarray(r[1]).sum() for r in self.log))
        log(f"warm-up: {warm} steps of {self.B} sequences, {kf} keyframes")
        clock("warm-up session")
        self._start()
        self.order = generator.window_order(self.plan)
        clock("window session")

    def _start(self):
        """A fresh batched state (every sequence UNINIT)."""
        self.state = self.bt.init_state()
        self.known = False
        self.log: list = []  # per call: (scene index, new_kf bool[B], telemetry f32[B, TEL])
        self.order = iter(range(10**12))
        gc.collect()

    # ------------------------------------------------------------ window
    def install(self, caps):
        from plslam_tpu_torch.solvers import pose

        caps.wrap_builder(self.fb)
        caps.wrap_pose(pose, "pose_lm" if self.device.type == "cuda" else "pose_optimization_plain")
        caps.wrap_local_ba(self.bm.mapper._ba, lambda: self.made)

    def instrument(self, tracer):
        self._build = tracer.span_fn(self._build, "dispatch")
        self._step = tracer.span_fn(self._step, "dispatch")
        self._map = tracer.span_fn(self._map, "chain")

    def _build(self, i: int):
        return self._stack([self.fb(*s.frame(i)) for s in self.stores])

    def _step(self, batch):
        return self.bt.step(self.state, batch, initialised=self.known)

    def _map(self, out):
        return self.state._replace(m=self.bm.process(self.state.m, out.kf_id, out.new_kf))

    def call(self) -> int:
        i = next(self.order)
        batch = self._build(i)
        self.state, out = self._step(batch)
        new_kf = out.new_kf.cpu().numpy()
        if new_kf.any():  # no sequence made a keyframe: nothing to map
            self.made = new_kf
            self.state = self._map(out)
        tel = out.telemetry.cpu().numpy()  # waits for the step's work
        self.known = known_status(tel[:, self.T.TEL_STATUS].astype(np.int64))
        self.log.append((i, new_kf, tel))
        return self.B

    # ------------------------------------------------------------ after it
    def window_frames(self):
        """(sequence, scene index) of each frame the window fed, in order."""
        return [(b, i) for i, _, _ in self.log for b in range(self.B)]

    def finish(self) -> dict:
        """Tracking poses from the telemetry (TEL_TCW), keyframe poses from
        the final map (kf_frame_id = the step that made the keyframe)."""
        T = self.T
        traj, untracked = [], 0
        for i, _, tel in self.log:
            for b in range(self.B):
                if tel[b, T.TEL_TRACKED] > 0:
                    traj.append((b, i, np.linalg.inv(tel[b, T.TEL_TCW].reshape(4, 4).astype(np.float64))))
                else:
                    untracked += 1
        m = self.state.m
        kf_pose = m.kf_pose.cpu().numpy().astype(np.float64)
        kf_valid = m.kf_valid.cpu().numpy()
        kf_fid = m.kf_frame_id.cpu().numpy()
        kf = [(b, self.log[int(kf_fid[b, k])][0], np.linalg.inv(kf_pose[b, k]))
              for b in range(self.B) for k in np.nonzero(kf_valid[b])[0] if 0 <= int(kf_fid[b, k]) < len(self.log)]
        n_kf = int(sum(r[1].sum() for r in self.log))
        return dict(untracked=untracked, traj=traj, kf=kf,
                    info=dict(steps=len(self.log), frames=len(self.log) * self.B, keyframes_made=n_kf,
                              chains=int(sum(bool(r[1].any()) for r in self.log)),
                              last_frame=int(self.log[-1][0])))

    def gt_pose(self, seq: int, i: int) -> np.ndarray:
        return self.stores[seq].gt_pose(i)

    def frame(self, seq: int, i: int):
        return self.stores[seq].frame(i)

    def release(self):
        self.state = None
        gc.collect()

    def shapes(self) -> dict:
        s = self.cfg["settings"]
        per_level, level_shapes = frontend.level_budget(s)
        return dict(height=s["height"], width=s["width"], levels=s["n_levels"], level_shapes=level_shapes,
                    patches=sum(per_level))
