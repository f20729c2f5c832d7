"""Port parity, the System facade: the reference's mapper-less synchronous
`System` (JAX, CPU) against the port's (PyTorch, CPU) on one run, 320x240,
`SyntheticSequence(seed=3, motion_scale=3)` with lines off (the System
layer is the same with lines; the line path of the step is held to the
reference in tests/test_torch_slice_lines.py, and lines would add ~20 s
here): 8 frames 4 apart (0, 4, ..., 28; ~0.4 m of travel), a black frame
(tracking is lost), then the camera back at frames 0 and 4.
Returning to the start is what makes the relocalizer run: the step's own
recovery (the reference-keyframe fallback, solved from the last pose)
fails that far from the last pose, and BoW + PnP find keyframe 0. After a
blackout on ordinary consecutive frames the step recovers by itself and
the relocalizer is never reached.

Tolerances: per frame the tracking state, tracked flag, new-keyframe flag,
keyframe slot and map counts equal; returned poses within 1e-3 m (the two
front ends agree to float32 rounding, as in the slice tests); the same
relocalization frame and keyframe; the two TUM files with the same rows,
numbers within 1e-3; the JSONL logs with the same keys and integer fields
(on frames the step lost, its diverged solve's inlier count only below
the tracking gate of 30, its match count not compared).
From one shared state (`convert.system_from_numpy`) the relocalizing frame
gives the same outcome, keyframe and landmark bindings, pose to 1e-4; the
relocalizer's BoW database rows equal the reference's exactly; one
keyframe step with
`in_step_local_refresh=False` leaves the map and pose as the reference's
step did (pose to 1e-4) and the working set unchanged.

The reference's run is recorded: tests/data/system_reference.npz, written
by tests/data/make_system_reference.py from these frames (the fixture
checks their SHA-256 first; the live run, mostly XLA compile, took
~110 s of every suite run)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import reference_runs
from plslam_tpu_torch import convert
from plslam_tpu_torch.io import viewer
from plslam_tpu_torch.io.png import read_png
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.solvers.local_ba import LocalBA
from plslam_tpu_torch.system import System

torch.set_num_threads(2)

N_BEFORE, N_BLACK, N_AFTER, STRIDE, MOTION = 8, 1, 2, 4, 3.0
CAPS = dict(max_kf=32, max_pts=4096)
INT_FIELDS = ("frame", "inliers", "matches", "kf_slot", "n_kf", "n_pt", "n_ln", "loops_closed", "gba_pending")


def _sequence():
    return SyntheticSequence(n_frames=STRIDE * N_BEFORE, height=240, width=320, seed=3, motion_scale=MOTION)


def _inputs(seq):
    """(gray, depth, t) per call: real frames, a blackout, the first real
    frames again (later timestamps)."""
    out = [seq.frame(STRIDE * i) for i in range(N_BEFORE)]
    g, d, t = out[-1]
    out += [(np.zeros_like(g), d, t + 0.03 * (j + 1)) for j in range(N_BLACK)]
    out += [(g, d, t + 2.0) for g, d, t in (seq.frame(STRIDE * i) for i in range(N_AFTER))]
    return out


def _drive(slam, inputs, snapshot=None):
    rows = []
    for i, (g, d, t) in enumerate(inputs):
        if snapshot is not None:
            snapshot(i)
        Tcw = slam.track_rgbd(g, d, t)
        rows.append(dict(Tcw=Tcw, state=slam.get_tracking_state(), new_kf=slam.last_frame_was_kf,
                         ref_kf=int(slam.state.ref_kf)))
    return rows


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("system")
    seq = _sequence()
    inputs = _inputs(seq)
    settings = dataclasses.replace(seq.settings, use_lines=False)

    # the reference's run (tests/data/make_system_reference.py): what the
    # tests read per frame, its state and bookkeeping before the calls they
    # start from, its JSONL log and its two TUM files
    z = reference_runs.load("system", reference_runs.frames_sha256(inputs))
    ref_rows = reference_runs.rows(z, "rows")
    snaps = {int(i): reference_runs.system(z, f"snap{i}") for i in z["snap_calls"]}
    for key, name in (("jsonl", "ref.jsonl"), ("traj", "ref_traj.txt"), ("kf", "ref_kf.txt")):
        (tmp / name).write_bytes(z[key].tobytes())

    got = System(settings, use_local_mapping=False, use_loop_closing=False, log_path=tmp / "got.jsonl",
                 device="cpu", **CAPS)
    got_rows = _drive(got, inputs)
    got.save_trajectory_tum(tmp / "got_traj.txt")
    got.save_keyframe_trajectory_tum(tmp / "got_kf.txt")
    got.shutdown()
    return dict(tmp=tmp, settings=settings, inputs=inputs, ref=ref_rows, got=got_rows, snaps=snaps, got_sys=got)


def test_states_and_keyframes_per_frame(run):
    states = [r["state"] for r in run["ref"]]
    assert states[:N_BEFORE] == ["OK"] * N_BEFORE
    assert states[N_BEFORE:N_BEFORE + N_BLACK] == ["LOST"] * N_BLACK
    assert states[-1] == "OK"
    for i, (r, g) in enumerate(zip(run["ref"], run["got"])):
        assert g["state"] == r["state"], i
        assert (g["Tcw"] is None) == (r["Tcw"] is None), i
        assert g["new_kf"] == r["new_kf"], i
        assert g["ref_kf"] == r["ref_kf"], i
        if r["Tcw"] is not None:
            np.testing.assert_allclose(g["Tcw"], r["Tcw"], atol=1e-3, err_msg=f"frame {i}")


def test_relocalized_on_the_same_frame_and_keyframe(run):
    def reloc_frame(rows):
        return next(i for i in range(N_BEFORE + N_BLACK, len(rows))
                    if rows[i]["Tcw"] is None and rows[i]["state"] == "OK")

    i = reloc_frame(run["ref"])
    assert i == reloc_frame(run["got"]) == N_BEFORE + N_BLACK  # the first real frame
    assert run["got"][i]["ref_kf"] == run["ref"][i]["ref_kf"] == 0
    assert all(r["Tcw"] is not None for r in run["got"][i + 1:])


def test_jsonl_logs_match(run):
    ref = [json.loads(x) for x in (run["tmp"] / "ref.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in (run["tmp"] / "got.jsonl").read_text().splitlines()]
    assert len(got) == len(ref) == len(run["inputs"])
    for r, g in zip(ref, got):
        assert set(g) == set(r)
        assert g["t"] == r["t"]
        for k in INT_FIELDS + ("state", "new_kf"):
            if r["state"] == "LOST" and k in ("inliers", "matches"):
                # the step's failed solve, started ~0.4 m from the truth on
                # the revisit frame, diverges; float32 reduction order then
                # decides its counts: inliers only have to stay below the
                # tracking gate, matches are not compared
                assert k == "matches" or (g[k] < 30 and r[k] < 30), (r["frame"], k)
            else:
                assert g[k] == r[k], (r["frame"], k)


@pytest.mark.parametrize("name", ["traj", "kf"])
def test_tum_files_match(run, name):
    def rows(who):
        return np.array([[float(v) for v in ln.split()]
                         for ln in (run["tmp"] / f"{who}_{name}.txt").read_text().strip().splitlines()])

    ref, got = rows("ref"), rows("got")
    assert got.shape == ref.shape and got.shape[1] == 8
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    # a quaternion and its negative are one rotation
    sign = np.where(np.sum(got[:, 4:] * ref[:, 4:], 1) < 0, -1.0, 1.0)[:, None]
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(got[:, 4:] * sign, ref[:, 4:], atol=1e-3)
    if name == "traj":
        assert len(got) == sum(r["Tcw"] is not None for r in run["ref"])


def test_relocalization_from_one_shared_state(run):
    """The reference's state before its relocalizing call, loaded into a
    port System, relocalizes on the same frame onto the same keyframe."""
    i = next(i for i in range(N_BEFORE + N_BLACK, len(run["ref"]))
             if run["ref"][i]["Tcw"] is None and run["ref"][i]["state"] == "OK")
    snap = dict(run["snaps"][i])
    snap.pop("last_frame")
    slam = convert.system_from_numpy(System(run["settings"], use_local_mapping=False, use_loop_closing=False,
                                            device="cpu", **CAPS), **snap)
    assert slam.get_tracking_state() == "LOST"
    assert slam.track_rgbd(*run["inputs"][i]) is None
    assert slam.get_tracking_state() == "OK"
    after = run["snaps"][i + 1]["state"]
    assert int(slam.state.ref_kf) == int(after.ref_kf)
    np.testing.assert_allclose(slam.state.last.Tcw.numpy(), after.last.Tcw, atol=1e-4)
    np.testing.assert_array_equal(slam.state.last.lm_idx.numpy(), after.last.lm_idx)
    assert slam.tracked_flags == run["snaps"][i + 1]["tracked"]


def test_keyframe_step_without_in_step_refresh(run):
    """Tracker(in_step_local_refresh=False).step on a keyframe frame, from
    the reference's state before it: the map, the pose and the bindings as
    the reference's own step left them (its System refreshes in the step
    and changes nothing after it), the working set left as it was, and
    `refresh_local_set` then gives the reference's refreshed set."""
    i = next(i for i in range(1, N_BEFORE) if run["ref"][i]["new_kf"])
    before, after = run["snaps"][i]["state"], run["snaps"][i + 1]["state"]
    frame = run["snaps"][i + 1]["last_frame"]
    t = tracking.Tracker(run["settings"], in_step_local_refresh=False, device="cpu", **CAPS)
    st2, out = t.step(convert.track_state_from_numpy(before, "cpu"), convert.frame_from_numpy(frame, "cpu"))
    assert bool(out.new_kf) and bool(out.tracked)
    np.testing.assert_allclose(out.Tcw.numpy(), after.last.Tcw, atol=1e-4)
    np.testing.assert_allclose(st2.m.kf_pose.numpy(), after.m.kf_pose, atol=1e-4)
    assert int(st2.ref_kf) == int(after.ref_kf) and int(st2.status) == int(after.status)
    np.testing.assert_array_equal(st2.last.lm_idx.numpy(), after.last.lm_idx)
    for name in ("pt_valid", "kf_valid", "kf_lm_idx", "pt_nobs", "n_pt", "n_kf", "ln_valid"):
        np.testing.assert_array_equal(getattr(st2.m, name).numpy(), getattr(after.m, name), err_msg=name)
    np.testing.assert_array_equal(st2.local_set.numpy(), before.local_set)
    assert not np.array_equal(before.local_set, after.local_set)
    np.testing.assert_array_equal(t.refresh_local_set(st2).local_set.numpy(), after.local_set)


def test_bow_database_matches_reference(run):
    """Every keyframe's BoW row, as the port's System left its database."""
    ref = run["snaps"][len(run["inputs"])]["kf_bow"]
    got = run["got_sys"]._reloc.kf_bow.numpy()
    assert (ref.sum(1) > 0).sum() == run["got_sys"].n_keyframes
    np.testing.assert_array_equal(got, ref)


def test_options_outside_the_slice_raise(run, tmp_path):
    s = dataclasses.replace(run["settings"], use_lines=True)
    assert s.use_loop_closing
    # loop closing is ported: the reference's defaults construct, with and
    # without the mapper, and run a frame
    full = System(s, device="cpu", **CAPS)  # UseLoopClosing on in the settings
    assert full._loop is not None and full._reloc is full._loop and full._mapper is not None
    loop_only = System(s, use_local_mapping=False, use_loop_closing=True, device="cpu", **CAPS)
    assert loop_only._mapper is None and loop_only._loop is not None
    assert not loop_only.tracker.in_step_local_refresh  # the chain refreshes the working set
    g, d, t = run["inputs"][0]
    for slam in (full, loop_only):
        assert slam.track_rgbd(g, d, t) is not None and slam.aux_reads == 1 and slam._loop._kf_counter == 1
    mapped = System(s, use_loop_closing=False, device="cpu")  # local mapping on: constructs
    assert mapped._mapper is not None and mapped._loop is None and not mapped.tracker.in_step_local_refresh
    gba = LocalBA(mapped.tracker, global_mode=True)
    assert (gba.W, gba.Pl, gba.Ql) == (mapped.tracker.max_kf, mapped.tracker.max_pts, mapped.tracker.max_maplines)
    assert callable(gba.slice_runner(5, 0, False))
    # the pipelined mode and map snapshots are ported: a pipelined System
    # constructs, and a save / load round trip returns with the state intact
    piped = System(s, use_local_mapping=False, use_loop_closing=False, pipeline_depth=2, device="cpu")
    assert piped.pipeline_depth == 2 and piped.tracker.in_step_local_refresh
    # the host line backend and the debug images are ported: a host-lines
    # System constructs, and the run's System writes its two images
    hosted = System(dataclasses.replace(s, line_backend="host"), use_local_mapping=False, use_loop_closing=False,
                    device="cpu")
    assert hosted.builder.host_lines and hosted._host_lines(run["inputs"][0][0]) is not None
    slam = run["got_sys"]
    kept = slam.state
    assert slam.save_map(tmp_path / "m.npz") is None and slam.load_map(tmp_path / "m.npz") is None
    assert torch.equal(slam.state.m.kf_pose, kept.m.kf_pose) and torch.equal(slam.state.local_set, kept.local_set)
    slam.dump_debug_images(tmp_path / "dbg", gray=run["inputs"][0][0])
    for name, img in (("frame.png", viewer.draw_frame(run["inputs"][0][0], slam.state)),
                      ("map.png", viewer.draw_map(slam.state))):
        np.testing.assert_array_equal(read_png(tmp_path / "dbg" / name)[..., ::-1], img)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            System(s, use_local_mapping=False, use_loop_closing=False)
    assert slam.telemetry_reads == len(run["inputs"])
    assert slam.n_keyframes >= 1 and slam.n_map_points > 100


def test_config3_low_texture(tmp_path):
    """BASELINE.json config 3 on the port alone: System with every default (lines
    on, device LSD, mapper and loop closing on) on the reference test's
    low-texture fixture (tests/test_lines.py:15-16: 12 frames, 320x240,
    seed 5, max_pts 4096, max_kf 32), held to that test's four assertions
    (tests/test_lines.py:188-207)."""
    from plslam_tpu_torch.eval.ate import ate_rmse
    from plslam_tpu_torch.io.trajectory import load_trajectory_tum

    seq = SyntheticSequence(n_frames=12, height=240, width=320, seed=5, low_texture=True)
    slam = System(seq.settings, max_pts=4096, max_kf=32, device="cpu")
    ok = 0
    for i in range(seq.n_frames):
        g, d, t = seq.frame(i)
        ok += slam.track_rgbd(g, d, t) is not None
    assert ok == seq.n_frames
    m = slam.state.m
    assert int(m.ln_valid.sum()) > 10  # map lines created
    assert int((m.ln_nobs > 2).sum()) > 5  # lines re-observed
    slam.save_trajectory_tum(tmp_path / "traj.txt")
    rmse, _ = ate_rmse(load_trajectory_tum(tmp_path / "traj.txt"), seq.gt_trajectory())
    assert rmse < 0.02, f"ATE {rmse * 100:.2f} cm"
