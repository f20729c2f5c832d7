"""A run with the timed path broken underneath comes out not correct.

Each case drives a whole run of a cell on the CPU at 320x240 (no look for
a card), with one fault planted in the port for the window: the tracking step,
single or batched, returns its state unchanged (and the same answer every
frame); the keyframe chain's local BA, single or batched, returns its map
unchanged; half of the batch is left out of the batched step; an answer is
altered where it is produced (a descriptor bit, a keyline's endpoint,
kernel B3's pose).
The limits are the committed ones (portbench/limits/)."""

import json
from pathlib import Path

import pytest
import torch

from portbench import capture, harness

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(json.loads((ROOT / "portbench/configs/fr3_pl_system.json").read_text())["settings"],
             width=320, height=240, fx=267.7, fy=269.6, cx=160.1, cy=123.8)
# faster motion than the cells', so that a frozen pose is far off within a short window
TRAFFIC = dict(warmup_frames=4, map_frames=16, motion_scale=4.0)


def _run(cell_name, seconds=12.0, **cfg):
    torch.set_num_threads(2)
    cell = harness.Cell(cell_name, config_override={"settings": SMALL, "max_fps": 6.0, **cfg},
                        traffic_override=TRAFFIC)
    return harness.run_cell(cell, 2**31 + 99, seconds, False, device="cpu", log=lambda m: None)


@pytest.fixture()
def armed(monkeypatch):
    """A flag that turns on when the window starts (the captures go in)."""
    flag = {"on": False}
    orig = capture.Captures.wrap_builder

    def wrap_builder(self, builder):
        flag["on"] = True
        return orig(self, builder)

    monkeypatch.setattr(capture.Captures, "wrap_builder", wrap_builder)
    return flag


def _failed(res, number):
    v, lim = res["checks"][number]["value"], res["checks"][number]["limit"]
    assert v is None or v > lim, (number, v, lim)
    assert res["correct"] is False


BATCHED = dict(seconds=24.0, batch=2)


@pytest.mark.parametrize("cell,kw", [("fr3_pl_system.xyz", {}), ("fr3_pl_multiseq4.xyz", BATCHED)])
def test_sound_run_is_correct(cell, kw):
    res = _run(cell, **kw)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell", ["fr3_pl_system.xyz", "fr3_pl_system.localize"])
def test_step_returning_its_state_unchanged(monkeypatch, armed, cell):
    from plslam_tpu_torch.pipeline.tracking import Tracker

    orig = Tracker.step
    memo = {}

    def step(self, state, frame, initialised=None):
        new, out = orig(self, state, frame, initialised=initialised)
        if not armed["on"]:
            return new, out
        if "out" not in memo and not bool(out.new_kf):
            memo["out"] = out
        return state, memo.get("out", out)

    monkeypatch.setattr(Tracker, "step", step)
    _failed(_run(cell), "ate_m")


def test_batched_step_returning_its_state_unchanged(monkeypatch, armed):
    from plslam_tpu_torch.parallel.batch import BatchedTracker

    orig = BatchedTracker.step
    memo = {}

    def step(self, state, frames, initialised=None):
        new, out = orig(self, state, frames, initialised=initialised)
        if not armed["on"]:
            return new, out
        if "out" not in memo and not bool(out.new_kf.any()):
            memo["out"] = out
        return state, memo.get("out", out)

    monkeypatch.setattr(BatchedTracker, "step", step)
    _failed(_run("fr3_pl_multiseq4.xyz", **BATCHED), "ate_m")


def test_half_the_batch_left_out(monkeypatch, armed):
    from torch.utils import _pytree as pytree

    from plslam_tpu_torch.parallel.batch import BatchedTracker

    orig = BatchedTracker.step
    memo = {}

    def step(self, state, frames, initialised=None):
        new, out = orig(self, state, frames, initialised=initialised)
        if not armed["on"]:
            return new, out
        memo.setdefault("out", out)
        keep = torch.arange(self.batch) < self.batch // 2  # the first half is stepped, the rest left out

        def pick(a, b):
            return torch.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

        return pytree.tree_map(pick, new, state), pytree.tree_map(pick, out, memo["out"])

    monkeypatch.setattr(BatchedTracker, "step", step)
    _failed(_run("fr3_pl_multiseq4.xyz", **BATCHED), "ate_m")


@pytest.mark.parametrize("cell,kw", [("fr3_pl_system.xyz", {}), ("fr3_pl_multiseq4.xyz", BATCHED)])
def test_local_ba_returning_its_map_unchanged(monkeypatch, armed, cell, kw):
    from plslam_tpu_torch.solvers.local_ba import LocalBA

    orig = LocalBA.run

    def run(self, m, k):
        return m if armed["on"] else orig(self, m, k)

    monkeypatch.setattr(LocalBA, "run", run)
    res = _run(cell, **kw)
    assert res["checks"]["ate_kf_m"]["value"] < res["checks"]["ate_kf_m"]["limit"]  # ATE alone would not see it
    _failed(res, "ba_pose_gap")


@pytest.mark.parametrize("field", ["desc", "ln_sp"])
def test_frame_answer_altered(monkeypatch, armed, field):
    from plslam_tpu_torch.features.frame import FrameBuilder

    orig = FrameBuilder.build

    def build(self, *a, **k):
        f = orig(self, *a, **k)
        if not armed["on"]:
            return f
        if field == "desc":
            d = f.desc.clone()
            d[:, 0] ^= 1  # one bit of each descriptor
            return f._replace(desc=d)
        return f._replace(ln_sp=f.ln_sp + 0.5)  # each keyline's start half a pixel off

    monkeypatch.setattr(FrameBuilder, "build", build)
    _failed(_run("fr3_pl_system.xyz"), "frontend_bits")


def test_pose_answer_altered(monkeypatch, armed):
    from plslam_tpu_torch.solvers import pose

    orig = pose.pose_optimization_plain

    def solve(Tcw0, pts, K, bf, lines=None):
        T, pin, lin = orig(Tcw0, pts, K, bf, lines)
        if armed["on"]:
            T = T.clone()
            T[..., 0, 3] += 2e-3  # 2 mm along x
        return T, pin, lin

    monkeypatch.setattr(pose, "pose_optimization_plain", solve)
    _failed(_run("fr3_pl_system.xyz"), "pose_gap_p90")
