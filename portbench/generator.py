"""The one traffic generator: a traffic file's parameters -> the frames a
run feeds, held on the host, and the order it feeds them in.

A traffic file (`portbench/traffic/<name>.json`) sets:
  motion_scale  amplitude of the fr1_xyz-style hand-held motion (1: fr1_xyz's)
  scene_seed    the scene (texture, foreground patches) of sequence b is
                scene_seed + b, the same in every run, and the run's seed
                draws the sensor noise alone: the texture and the layout
                set how often the port makes a keyframe, so with them fixed
                every seed asks the same work of it (absent: the seed draws
                the scene too)
  gray_noise    sigma in gray levels of per-pixel Gaussian sensor noise,
                drawn from the run's seed and the frame's place in the
                run, so that a view shown twice carries fresh noise
  replay        "forward": frames 0, 1, 2, ... in the window, never
                wrapping; "pingpong": set-up maps frames 0 .. map_frames-1,
                the window goes over the same views backward, forward, and
                so on
  map_frames    frames of the mapping pass ("pingpong" only)
  localization  the window runs in localization mode (after the pass)
  warmup_frames frames of the throwaway warm-up session
Scenes come from the seed (portbench/scene.py); the calibration and
`max_fps`, the highest rate per sequence a run of the configuration may
reach, from the configuration file: a run renders max_fps x seconds
frames for its window (after the mapping pass), and a run that would need
more stops with no result (it never wraps around). Frames are rendered on
the card and held on the host as track_rgbd takes them, as a camera gives
them: gray u8[H, W] (the rendering rounded) and depth f32[H, W] in metres.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import NamedTuple

import numpy as np

from portbench.errors import NoResult
from portbench.scene import SyntheticSequence

CALIB_KEYS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "width", "height", "fps")


def scene(traffic: dict, settings: dict, seed: int, index: int = 0) -> SyntheticSequence:
    """Sequence `index` of a run with `seed`, through the configuration's
    calibration: with `scene_seed` the scene is scene_seed + index and the
    run's seed draws the sensor noise; without it the seed draws both."""
    own = seed * 1009 + index  # this sequence's share of the run's seed
    fixed = traffic.get("scene_seed")
    return SyntheticSequence(
        seed=own if fixed is None else int(fixed) + index, calib={k: settings[k] for k in CALIB_KEYS},
        motion_scale=float(traffic.get("motion_scale", 1.0)), noise_seed=own,
        gray_noise=float(traffic.get("gray_noise", 0.0)),
    )


class Plan(NamedTuple):
    """What a run renders: the scene frame shown at each place of the run
    (set-up's frames first), and the place where the window starts."""

    views: list
    window_start: int


def plan(traffic: dict, max_fps: float, seconds: float, extra: int = 0) -> Plan:
    """The frames one sequence needs for a run of `seconds` at up to max_fps."""
    warm = int(traffic.get("warmup_frames", 0))
    window = math.ceil(float(max_fps) * seconds) + extra
    if traffic.get("replay", "forward") == "forward":
        return Plan(list(range(max(warm, window))), 0)
    n_map = int(traffic["map_frames"])
    # pingpong: the mapping pass ended on view n_map - 1; go on backward, then forward
    views, i, step = list(range(n_map)), n_map - 1, -1
    for _ in range(window):
        if not 0 <= i + step < n_map:
            step = -step
        i += step
        views.append(i)
    return Plan(views, n_map)


class FrameStore:
    """The frames of one scene that a plan shows, rendered on `device` and
    held on the host; frame j carries the sensor noise of place j."""

    def __init__(self, sc: SyntheticSequence, pl: Plan, device, block: int = 64):
        import torch

        H, W, n = sc.height, sc.width, len(pl.views)
        self.gray = np.empty((n, H, W), np.uint8)
        self.depth = np.empty((n, H, W), np.float32)
        for s in range(0, n, block):
            e = min(n, s + block)
            g, d = sc.render(pl.views[s:e], device, noise_keys=range(s, e))
            self.gray[s:e] = torch.clamp(torch.round(g), 0, 255).to(torch.uint8).cpu().numpy()
            self.depth[s:e] = d.cpu().numpy()
        self.scene, self.views = sc, pl.views

    def __len__(self):
        return self.gray.shape[0]

    def frame(self, j: int):
        if j >= len(self):
            raise NoResult(f"the window ran out of its {len(self)} frames: raise max_fps in the configuration file")
        return self.gray[j], self.depth[j]

    def gt_pose(self, j: int) -> np.ndarray:
        """Twc of the view shown at place j."""
        return self.scene.gt_pose_wc(self.views[j])


def window_order(pl: Plan):
    """The places the window feeds, in order."""
    return itertools.count(pl.window_start)


class StageClock:
    """Logs the seconds of each set-up stage since the previous one."""

    def __init__(self, log):
        self.log, self.t = log, time.perf_counter()

    def __call__(self, stage: str):
        now = time.perf_counter()
        self.log(f"set-up: {stage} {now - self.t:.2f} s")
        self.t = now
