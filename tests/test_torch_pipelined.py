"""Port parity, the pipelined System and map snapshots: the reference's
`System(pipeline_depth=4)` (JAX, CPU) against the port's (PyTorch, CPU)
on one run, 320x240, `SyntheticSequence(seed=3)` with lines on, every
System default (local mapper and loop closing on), caps `max_kf=32,
max_pts=4096`, 8 frames: keyframes on frames 0, 1 and 2, whose chains
are dispatched when those frames are finalized, 4 calls later, and on
frame 6, finalized by the closing save. Both systems get the port's frames
(`io/synthetic.py`).

The reference's run is recorded: tests/data/pipelined_reference.npz,
written by tests/data/make_pipelined_reference.py from these frames (the
fixture checks their SHA-256 first; its live compile and run took ~180 s
of every suite run). There the reference's chunk program is swapped, in
a generator-side subclass, for four calls of its own per-frame program
`_fused_step` with the state carried through (one compile of the chunk
program would take longer than the whole run), and the reference's
docstrings (plslam_tpu/system.py:92-95, :278-282) state that the chunk
gives results identical to per-frame dispatch. Everything around it, the
buffer, the in-flight queue, the lagged finalize and the chain tails, is
the reference's own code. Nothing in plslam_tpu/ changes.

Tolerances, for every finalized frame: the tracking state, tracked flag,
new-keyframe flag, keyframe slot, reference keyframe and keyframe count
equal; poses within 5e-3 m and point and map-line counts within 4. These
are PR 8's run tolerances (tests/test_torch_mapping.py): the keyframe
chains' local BA rounds in another order in each package, which moves
weakly constrained landmarks and, through the map lines of the joint pose
solve, later poses; the pipelined run has the same chains on the same
frames, run later, and the run is that sensitive to float32 rounding (the
reference alone, on its own frames instead of the port's, moves by
3.3e-3 m and 2 counts). Measured here: poses within 7.9e-4 m; point and
map-line counts equal through frame 5 and 1 apart from frame 6 on.

Snapshots are held without a new reference compile: the reference
writes one with `System.save_map` and reads one with `load_state`, both
plain numpy.

The file keeps more than 7 tests: pytest-xdist's loadfile schedule starts
files with more tests first, so its port runs do not compete for the
cores with tests/test_loop_e2e.py (7 tests), which alone sets the suite's
wall time."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax

import reference_runs
from plslam_tpu.io.snapshot import load_state as j_load_state
from plslam_tpu.io.synthetic import SyntheticSequence as JSyntheticSequence
from plslam_tpu.pipeline.tracking import Tracker as JTracker
from plslam_tpu_torch import convert
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io import snapshot
from plslam_tpu_torch.io.synthetic import SyntheticSequence
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.system import System

torch.set_num_threads(2)

N_FRAMES, K = 8, 4
CAPS = dict(max_kf=32, max_pts=4096)
TOL_POSE, TOL_COUNT = 5e-3, 4
EXACT = (tracking.TEL_STATUS, tracking.TEL_TRACKED, tracking.TEL_NEW_KF, tracking.TEL_REF_KF, tracking.TEL_N_KF)
# the blackout fixture (tests/test_torch_system.py's, lines off, no mapper):
# frames 4 apart at 3x the motion, a black frame, then the first frames
# again; with 9 frames before it the black frame is the second of a chunk
# of 2, so the relocalizer runs on a chunk's frame, rebuilt from its images
B_BEFORE, B_AFTER, B_STRIDE, B_MOTION, B_K = 9, 2, 4, 3.0, 2


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _leaves(ts, prefix=""):
    """{dotted path: numpy array} of a port TrackState."""
    return snapshot._flatten(prefix, ts)


def _sequence():
    """The run's sequence; its first N_FRAMES frames are the run, the next 3
    the localization replay's."""
    return SyntheticSequence(n_frames=N_FRAMES + 3, height=240, width=320, seed=3)


def _inputs(seq):
    return [seq.frame(i) for i in range(N_FRAMES)]


def _recorded(inputs, map_path):
    """The reference's run on `inputs` (tests/data/make_pipelined_reference.py),
    with the attributes of its System that the tests read; writes the
    snapshot its save_map wrote to map_path."""
    z = reference_runs.load("pipelined", reference_runs.frames_sha256(inputs))
    np.savez_compressed(map_path, **{k[len("snapshot."):]: v for k, v in z.items() if k.startswith("snapshot.")})
    return types.SimpleNamespace(
        rows=reference_runs.rows(z, "rows"), tracked_flags=z["tracked_flags"].tolist(),
        n_keyframes=int(z["n_keyframes"]), state=reference_runs.tree(z, "state"),
        _reloc=types.SimpleNamespace(kf_bow=z["kf_bow"]),
        _kf_timestamps=dict(zip(z["kf_timestamps.slot"].tolist(), z["kf_timestamps.t"].tolist())))


class _Pipelined(System):
    """The port's System, recording each finalized frame's telemetry row
    and the call that finalized it."""

    def _finalize_one(self):
        telc, idx = self._inflight[0][:2]
        row = np.array(telc.row(idx))
        ret = super()._finalize_one()
        self.rows.append(dict(call=self.call, t=self._timestamps[-1], v=row, ret=ret))
        return ret


def _drive(slam, inputs):
    slam.rows, rets = [], []
    for i, (g, d, t) in enumerate(inputs):
        slam.call = i
        rets.append(slam.track_rgbd(g, d, t))
    slam.call = None
    return rets


def _port_run(settings, inputs, tmp, tag):
    slam = _Pipelined(settings, pipeline_depth=K, device="cpu", **CAPS)
    rets = _drive(slam, inputs)
    slam.save_trajectory_tum(tmp / f"{tag}_traj.txt")
    return slam, rets


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipelined")
    seq = _sequence()
    jseq = JSyntheticSequence(n_frames=N_FRAMES, height=240, width=320, seed=3)
    assert seq.settings.use_lines and seq.settings.use_loop_closing
    inputs = _inputs(seq)
    ref = _recorded(inputs, tmp / "ref_map.npz")

    got, got_rets = _port_run(seq.settings, inputs, tmp, "got")
    got.save_map(tmp / "got_map.npz")
    return dict(tmp=tmp, seq=seq, settings=seq.settings, inputs=inputs, more=[seq.frame(i) for i in range(N_FRAMES, N_FRAMES + 3)],
                ref=ref, got=got, got_rets=got_rets, jsettings=jseq.settings)


def test_pipelined_run_matches_reference(run):
    """Every finalized frame of the port's pipelined run against the
    reference's (tolerances in the module docstring)."""
    ref, got = run["ref"].rows, run["got"].rows
    assert len(ref) == len(got) == N_FRAMES
    n_kf = 0
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g["t"] == r["t"] and g["call"] == r["call"], i
        for j in EXACT:
            assert g["v"][j] == r["v"][j], (i, j, g["v"][j], r["v"][j])
        if r["v"][tracking.TEL_NEW_KF] > 0:
            n_kf += 1
            assert g["v"][tracking.TEL_KF_ID] == r["v"][tracking.TEL_KF_ID], i
        for j in (tracking.TEL_N_PT, tracking.TEL_N_LN):
            assert abs(g["v"][j] - r["v"][j]) <= TOL_COUNT, (i, j, g["v"][j], r["v"][j])
        np.testing.assert_allclose(g["v"][tracking.TEL_TCW], r["v"][tracking.TEL_TCW], atol=TOL_POSE, err_msg=str(i))
        assert (g["ret"] is None) == (r["ret"] is None)
        if r["ret"] is not None:
            np.testing.assert_allclose(g["ret"], r["ret"], atol=TOL_POSE)
    assert n_kf >= 3
    assert run["got"].tracked_flags == run["ref"].tracked_flags == [True] * N_FRAMES
    assert run["got"].n_keyframes == run["ref"].n_keyframes


def test_chains_run_k_frames_after_their_keyframe(run):
    """Each keyframe's chain is dispatched when the keyframe is finalized,
    K calls after it was tracked, in both packages; one aux read per chain
    and one telemetry read per chunk (the 8 frames are two chunks)."""
    for slam in (run["ref"], run["got"]):
        kfs = [(i, r["call"]) for i, r in enumerate(slam.rows) if r["v"][tracking.TEL_NEW_KF] > 0]
        during = [(i, c) for i, c in kfs if c is not None]  # the rest are finalized by the closing save
        assert len(during) >= 2 and all(c == i + K for i, c in during)
    got = run["got"]
    assert got.telemetry_reads == N_FRAMES // K
    assert got.aux_reads == got._loop._kf_counter == len(kfs)
    assert not got._inflight and not got._buf and not got._pending_chain


def test_lag_contract(run):
    """tests/test_e2e.py's pipelined contract: the first K calls return
    None; call i finalizes exactly frame i - K (pinned by its timestamp)
    and returns its pose; save_trajectory_tum drains every row."""
    got, rets, seq = run["got"], run["got_rets"], run["seq"]
    assert all(p is None for p in rets[:K]) and all(p is not None for p in rets[K:])
    for r in got.rows:
        if r["call"] is not None:
            assert r["t"] == seq.timestamp(r["call"] - K)
    by_call = {r["call"]: r for r in got.rows if r["call"] is not None}
    assert sorted(by_call) == list(range(K, N_FRAMES))  # exactly one finalize per call from call K on
    for i in range(K, N_FRAMES):
        np.testing.assert_array_equal(rets[i], by_call[i]["ret"])
    rows = (run["tmp"] / "got_traj.txt").read_text().splitlines()
    assert len(rows) == N_FRAMES


def test_two_runs_write_byte_equal_trajectories(run):
    """The port's pipelined mode repeats itself: a second run writes the
    same trajectory file, byte for byte."""
    _port_run(run["settings"], run["inputs"], run["tmp"], "again")
    assert (run["tmp"] / "again_traj.txt").read_bytes() == (run["tmp"] / "got_traj.txt").read_bytes()


def test_blackout_recovery_pipelined():
    """LOST handling in pipelined mode (tests/test_e2e.py's blackout test):
    a LOST finalize drains the pipeline, the newest frame, still LOST and
    a chunk's frame, is rebuilt from its images and relocalized, and after
    the flush the state is OK."""
    seq = SyntheticSequence(n_frames=B_STRIDE * B_BEFORE, height=240, width=320, seed=3, motion_scale=B_MOTION)
    inputs = [seq.frame(B_STRIDE * i) for i in range(B_BEFORE)]
    g, d, t = inputs[-1]
    inputs.append((np.zeros_like(g), d, t + 0.03))
    inputs += [(g, d, t + 2.0) for g, d, t in (seq.frame(B_STRIDE * i) for i in range(B_AFTER))]
    slam = System(dataclasses.replace(seq.settings, use_lines=False), use_local_mapping=False,
                  use_loop_closing=False, pipeline_depth=B_K, device="cpu", **CAPS)
    reloc, calls = slam._reloc.relocalize, []

    def watched(state, frame):
        state, ok = reloc(state, frame)
        calls.append((slam._last_frame[0], ok))
        return state, ok

    slam._reloc.relocalize = watched
    for g, d, t in inputs:
        slam.track_rgbd(g, d, t)
    slam._flush_pending()
    assert slam.get_tracking_state() == "OK"
    assert calls == [("host", True)]
    flags = slam.tracked_flags
    assert len(flags) == len(inputs) and all(flags[:B_BEFORE]) and not flags[B_BEFORE]
    # the drain dispatched the buffered frame singly: one read per chunk and per single
    assert slam.telemetry_reads == (len(inputs) - 1) // B_K + 1


def test_depth_zero_unchanged():
    """pipeline_depth=0 gives what the synchronous System gave before the
    pipelined mode: each call finalizes its own frame, and the step's
    device-side switches give bit for bit the branch the host read from
    the state (the former `bool(is_init)` / `bool(did_insert)`): the
    mapper-less System, whose step also refreshes the working set, against
    that host-branch loop over the same frames, every state leaf equal; and
    the step with the status unknown (both branches, picked on the device)
    equal to the step told it."""
    seq = SyntheticSequence(n_frames=4, height=240, width=320, seed=3)
    s = dataclasses.replace(seq.settings, use_lines=False)
    slam = System(s, use_local_mapping=False, use_loop_closing=False, device="cpu", **CAPS)
    assert slam.tracker.in_step_local_refresh
    builder = FrameBuilder(s, device="cpu")
    tr = tracking.Tracker(s, device="cpu", **CAPS)
    st = tr.init_state()
    for i in range(seq.n_frames):
        g, d, t = seq.frame(i)
        n0 = len(slam._timestamps)
        Tcw = slam.track_rgbd(g, d, t)
        assert len(slam._timestamps) == n0 + 1 and not slam._inflight and slam.telemetry_reads == i + 1
        frame = builder(g, d)
        known = int(st.status) != tracking.ST_UNINIT  # what the host branch read
        blind, _ = tr.step(st, frame, initialised=None)
        st, out = tr.step(st, frame, initialised=known)
        for name, a in _leaves(blind).items():
            np.testing.assert_array_equal(a, _leaves(st)[name], err_msg=f"frame {i} {name}")
        np.testing.assert_array_equal(Tcw, out.telemetry[tracking.TEL_TCW].numpy().astype(np.float64).reshape(4, 4))
        for name, a in _leaves(slam.state).items():
            np.testing.assert_array_equal(a, _leaves(st)[name], err_msg=f"frame {i} {name}")


def test_snapshot_round_trip(run, tmp_path):
    """save_map then load_map in a fresh System: every leaf, the BoW rows
    and the keyframe timestamps bit for bit; the file also loads into a
    pipelined System of another depth."""
    got = run["got"]
    for depth in (0, 1):
        fresh = System(run["settings"], pipeline_depth=depth, device="cpu", **CAPS)
        fresh.load_map(run["tmp"] / "got_map.npz")
        want = _leaves(got.state)
        for name, a in _leaves(fresh.state).items():
            np.testing.assert_array_equal(a, want[name], err_msg=name)
        np.testing.assert_array_equal(fresh._reloc.kf_bow.numpy(), got._reloc.kf_bow.numpy())
        assert fresh._kf_timestamps == got._kf_timestamps and fresh._initialised is True


def test_reference_snapshot_loads_in_port(run):
    """A snapshot written by the reference's System.save_map, loaded by the
    port, equals convert.track_state_from_numpy of the reference's state
    leaf for leaf; System.load_map takes its BoW rows and timestamps."""
    ref = run["ref"]
    want = convert.track_state_from_numpy(_np(ref.state), "cpu")
    port = System(run["settings"], device="cpu", **CAPS)
    loaded = snapshot.load_state(run["tmp"] / "ref_map.npz", port.state)
    w = _leaves(want)
    for name, a in _leaves(loaded).items():
        assert a.dtype == w[name].dtype, name
        np.testing.assert_array_equal(a, w[name], err_msg=name)
    port.load_map(run["tmp"] / "ref_map.npz")
    np.testing.assert_array_equal(port._reloc.kf_bow.numpy(), np.asarray(ref._reloc.kf_bow))
    assert port._kf_timestamps == ref._kf_timestamps
    # the working set the port recomputes on the reference's map is the reference's
    np.testing.assert_array_equal(port.state.local_set.numpy(), np.asarray(ref.state.local_set))


def test_port_snapshot_loads_in_reference(run):
    """The port's snapshot read by the reference's load_state: every leaf
    equal to the port's state, in the reference's dtypes, and the extras."""
    got = run["got"]
    template = JTracker(run["jsettings"], **CAPS).init_state()
    tree, extras = j_load_state(run["tmp"] / "got_map.npz", template, want_extra=True)
    mine = _leaves(got.state)
    theirs = _ref_leaves(tree)
    assert set(theirs) == set(mine)
    for name, a in theirs.items():
        assert a.dtype == mine[name].dtype and a.shape == mine[name].shape, name
        np.testing.assert_array_equal(a, mine[name], err_msg=name)
    np.testing.assert_array_equal(extras["kf_bow"], got._reloc.kf_bow.numpy())
    assert extras["kf_timestamps"].shape == (CAPS["max_kf"],)


def _ref_leaves(tree, prefix=""):
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_ref_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_localization_replay_leaves_map_unchanged(run, depth):
    """load_map, activate_localization_mode and 3 tracked frames,
    pipelined: the map is bit for bit the loaded one."""
    slam = System(run["settings"], pipeline_depth=depth, device="cpu", **CAPS)
    slam.load_map(run["tmp"] / "got_map.npz")
    slam.activate_localization_mode()
    before = _leaves(slam.state.m)
    for g, d, t in run["more"]:
        slam.track_rgbd(g, d, t)
    slam._flush_pending()
    assert slam.tracked_flags == [True] * len(run["more"])
    for name, a in _leaves(slam.state.m).items():
        np.testing.assert_array_equal(a, before[name], err_msg=name)


def test_snapshot_missing_key_keeps_template(run, tmp_path):
    """A field the file lacks (an older schema) keeps the template's value;
    the rest load from the file."""
    with np.load(run["tmp"] / "got_map.npz") as f:
        data = {k: f[k] for k in f.files}
    del data["local_set"], data["m.pt_found"]
    np.savez_compressed(tmp_path / "old.npz", **data)
    template = tracking.Tracker(run["settings"], device="cpu", **CAPS).init_state()
    tree, extras = snapshot.load_state(tmp_path / "old.npz", template, want_extra=True)
    np.testing.assert_array_equal(tree.local_set.numpy(), template.local_set.numpy())
    np.testing.assert_array_equal(tree.m.pt_found.numpy(), template.m.pt_found.numpy())
    np.testing.assert_array_equal(tree.m.pt_pos.numpy(), data["m.pt_pos"])
    assert set(extras) == {"kf_timestamps", "kf_bow"}
