"""Port parity, the batched multi-sequence path (BASELINE.json config 5):
parallel/batch.py's BatchedTracker, BatchedMapper and BatchedLoopDetector
under torch.func.vmap, on the CPU.

Fixture: two distinct sequences (seeds 3 and 7), 192x256, n_features 120,
the capacities of tests/test_parallel.py (max_kf 8, max_pts 512, max_feat
128, max_lines 16, max_maplines 64); frames built per sequence by the
port's FrameBuilder.

Tolerances:
  * a batched row against the port's solo step on that sequence: flags
    equal, poses within 1e-4 m (observed: equal);
  * against the reference's BatchedTracker(mesh=None) (JAX, CPU) on the
    same gray and depth: flags equal, poses within 1e-3 m (the two front
    ends agree to float32 rounding, as in tests/test_torch_slice_lines.py);
    from the reference's batched state and frame carried across
    (`convert`), the next step within 1e-4 m. The reference's run is
    recorded: tests/data/parallel_reference.npz, written by
    tests/data/make_parallel_reference.py from these frames (the fixture
    checks their SHA-256 first; the live compile of the vmapped step took
    ~120 s of every suite run);
  * B3's vmap rule: exactly the per-problem calls;
  * the batched chain against the solo chain, open loop from the same two
    pre-chain maps: every index and flag equal, floats within rtol 1e-3 /
    atol 2e-3 (the reference test's tolerance, tests/test_parallel.py).
    The solo chain runs on one thread: a batched matrix product (bmm)
    computes each matrix on one thread, while a solo product on two
    threads splits the sum differently, and local BA's LM amplifies that
    rounding along weakly constrained directions (map-line endpoints move
    by ~0.1 m between a solo chain on one and on two threads);
  * a masked chain (do False) returns the map bit for bit;
  * the loop-detection gate, row by row against the solo gate: equal.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import reference_runs
from plslam_tpu_torch import convert
from plslam_tpu_torch.features.frame import FrameBuilder
from plslam_tpu_torch.io.synthetic import SyntheticSequence, pose_problem_pair
from plslam_tpu_torch.matching.lines import nanmedian
from plslam_tpu_torch.parallel.batch import BatchedLoopDetector, BatchedMapper, BatchedTracker, stack, unstack
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.pipeline.loopclosing import LoopCloser
from plslam_tpu_torch.pipeline.mapping import LocalMapper
from plslam_tpu_torch.solvers import pose

torch.set_num_threads(2)

SEEDS, H, W, N_FRAMES, N_STEP = (3, 7), 192, 256, 5, 3
CAPS = dict(max_kf=8, max_pts=512, max_feat=128, max_lines=16, max_maplines=64)
FALLBACK = "performance drop"  # torch.func.vmap's warning for an op it runs once per sample


def _settings(seq):
    return dataclasses.replace(seq.settings, n_features=120)


def _sequences():
    return [SyntheticSequence(n_frames=N_FRAMES, height=H, width=W, seed=s) for s in SEEDS]


def _inputs(seqs):
    """[frame][sequence] (gray, depth)."""
    return [[q.frame(i)[:2] for q in seqs] for i in range(N_FRAMES)]


def _solo(tracker, frames):
    st, outs = tracker.init_state(), []
    for f in frames:
        st, o = tracker.step(st, f, initialised=int(st.status) != tracking.ST_UNINIT)
        outs.append(o)
    return outs


def _batched(bt, frames, initialised):
    st, outs = bt.init_state(), []
    for i, fs in enumerate(frames):
        known = initialised(i, st)
        st, o = bt.step(st, stack(fs), initialised=known)
        outs.append(o)
    return st, outs


@pytest.fixture(scope="module")
def run():
    seqs = _sequences()
    s = _settings(seqs[0])
    inputs = _inputs(seqs)
    # the reference's BatchedTracker on the same gray and depth, its first
    # N_STEP steps (tests/data/make_parallel_reference.py): each step's
    # output, and its state and frame before step 2
    z = reference_runs.load("parallel", reference_runs.frames_sha256([gd for row in inputs[:N_STEP] for gd in row]))
    ref = [reference_runs.tree(z, f"out{i}") for i in range(N_STEP)]
    jstates, jframes = {2: reference_runs.tree(z, "state")}, {2: reference_runs.tree(z, "frame")}
    fb = FrameBuilder(s, capacity=128, line_capacity=16, device="cpu")
    tracker = tracking.Tracker(s, device="cpu", **CAPS)
    frames = [[fb(g, d) for g, d in row] for row in inputs]
    bt = BatchedTracker(tracker, batch=len(SEEDS))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solo = [_solo(tracker, [frames[i][b] for i in range(N_STEP)]) for b in range(len(SEEDS))]
        _, known = _batched(bt, frames[:N_STEP], lambda i, st: i > 0)
        _, unknown = _batched(bt, frames[:N_STEP], lambda i, st: None)
        # mixed statuses: sequence 1's first frame is black, so its init
        # fails while sequence 0 initialises; the next steps run both
        # branches and pick per sequence
        black = fb(np.zeros_like(inputs[0][1][0]), inputs[0][1][1])
        mixed_frames = [[frames[0][0], black]] + frames[1:N_STEP]
        mixed_solo = [solo[0], _solo(tracker, [mixed_frames[i][1] for i in range(N_STEP)])]
        _, mixed = _batched(bt, mixed_frames, lambda i, st: False if i == 0 else None)
    return dict(s=s, seqs=seqs, fb=fb, tracker=tracker, bt=bt, frames=frames, solo=solo, known=known,
                unknown=unknown, mixed=mixed, mixed_solo=mixed_solo, ref=ref, jstates=jstates, jframes=jframes,
                caught=caught)


def _rows_equal_solo(outs, solo, tol):
    for i, o in enumerate(outs):
        for b, sb in enumerate(solo):
            for f in ("tracked", "new_kf", "kf_id", "ref_kf", "n_inliers"):
                assert getattr(o, f)[b].item() == getattr(sb[i], f).item(), (i, b, f)
            assert int(o.telemetry[b, tracking.TEL_STATUS]) == int(sb[i].telemetry[tracking.TEL_STATUS])
            np.testing.assert_allclose(o.Tcw[b].numpy(), sb[i].Tcw.numpy(), atol=tol, err_msg=f"frame {i} seq {b}")


@pytest.mark.parametrize("mode", ["known", "unknown"])
def test_batched_step_equals_solo(run, mode):
    """Every row of the vmapped step equals the port's solo step on that
    sequence, with the status known to the host and with it unknown (both
    branches run and are picked on the device)."""
    _rows_equal_solo(run[mode], run["solo"], 1e-4)
    assert all(bool(o.tracked.all()) for o in run[mode])


def test_mixed_status_step_equals_solo(run):
    """A failed init in one sequence: the batch's statuses are mixed, the
    host passes initialised=None, and each row still equals its solo run."""
    assert int(run["mixed"][0].telemetry[1, tracking.TEL_STATUS]) == tracking.ST_UNINIT
    assert int(run["mixed"][0].telemetry[0, tracking.TEL_STATUS]) == tracking.ST_OK
    _rows_equal_solo(run["mixed"], run["mixed_solo"], 1e-4)


def test_batched_step_equals_reference(run):
    for i, (o, r) in enumerate(zip(run["known"], run["ref"])):
        for f in ("tracked", "new_kf", "kf_id", "ref_kf"):
            np.testing.assert_array_equal(getattr(o, f).numpy(), getattr(r, f), err_msg=f"frame {i} {f}")
        np.testing.assert_array_equal(o.telemetry[:, tracking.TEL_STATUS].numpy(), r.telemetry[:, tracking.TEL_STATUS])
        np.testing.assert_allclose(o.Tcw.numpy(), r.Tcw, atol=1e-3, err_msg=f"frame {i}")


def test_step_from_reference_batched_state(run):
    """The reference's batched state and frame after frame 1, carried across
    with `convert`: the port's batched step gives the reference's frame 2."""
    B = len(SEEDS)
    st = convert.batched_track_state_from_numpy(run["jstates"][2], B, device="cpu")
    assert st.m.pt_pos.shape == (B, CAPS["max_pts"], 3) and st.status.shape == (B,)
    frames = convert.frame_from_numpy(run["jframes"][2], device="cpu")
    _, o = run["bt"].step(st, frames, initialised=True)
    r = run["ref"][2]
    for f in ("tracked", "new_kf", "n_inliers", "n_matches"):
        np.testing.assert_array_equal(getattr(o, f).numpy(), getattr(r, f), err_msg=f)
    np.testing.assert_allclose(o.Tcw.numpy(), r.Tcw, atol=1e-4)
    with pytest.raises(ValueError):
        convert.batched_track_state_from_numpy(run["jstates"][2], B + 1, device="cpu")


def test_no_per_sample_fallback(run, chain):
    """No op of the step, the chain or the loop gate falls back to vmap's
    per-sample loop."""
    caught = run["caught"] + chain["caught"]
    assert not [w for w in caught if FALLBACK in str(w.message)]


@pytest.mark.parametrize("n_seq", [3, 5])
def test_b3_vmap_rule_equals_per_problem_calls(n_seq):
    """The custom op's vmap rule: n_seq sequences' stacked P = 2 problems
    (the tracker's layout, observations shared along P) solved as 2 n_seq
    problems, in chunks of at most 8, equal the per-sequence calls
    exactly."""
    rng = np.random.default_rng(0)
    prs = [pose_problem_pair(rng, n=128) for _ in range(n_seq)]
    K, bf = prs[0]["K"], prs[0]["bf"]
    T0 = torch.eye(4).expand(2, 4, 4)
    t = torch.from_numpy

    def obs(q):
        return pose.PointObs(t(q["xw"]), t(q["obs"]).expand(2, -1, -1), t(q["isig"]).expand(2, -1),
                             t(q["stereo"]).expand(2, -1), t(q["valid"]))

    want = [pose.pose_optimization(T0, obs(q), K, bf) for q in prs]
    stacked = pose.PointObs(*(torch.stack(f) for f in zip(*[obs(q) for q in prs])))
    got = torch.func.vmap(lambda p: pose.pose_optimization(T0, p, K, bf)[:2])(stacked)
    for b, w in enumerate(want):
        assert torch.equal(got[0][b], w[0]) and torch.equal(got[1][b], w[1])


@pytest.mark.parametrize("case", ["odd", "even", "all_nan", "random"])
def test_nanmedian_equals_nanquantile(case):
    g = torch.Generator().manual_seed(1)
    xs = {
        "odd": [torch.tensor([5.0, float("nan"), 1.0, 3.0, float("nan"), 2.0, 8.0])],
        "even": [torch.tensor([4.0, float("nan"), 1.0, 3.0, 2.5]), torch.tensor([7.0, 7.5])],
        "all_nan": [torch.full((6,), float("nan")), torch.tensor([float("nan")])],
        "random": [torch.where(torch.rand(n, generator=g) < 0.3, float("nan"), torch.randint(0, 90, (n,), generator=g)
                               .float() + 0.5 * torch.rand(n, generator=g)) for n in range(1, 40)],
    }[case]
    for x in xs:
        a, b = nanmedian(x), torch.nanquantile(x, 0.5)
        assert (bool(a.isnan()) and bool(b.isnan())) or torch.equal(a, b), (x, a, b)


@pytest.fixture(scope="module")
def chain(run):
    """Two distinct pre-chain maps (the last keyframe of 5 frames of solo
    tracking + mapping per sequence), the batched chain over both, the solo
    chains (one thread, see the module docstring) and the masked chain."""
    tracker = run["tracker"]
    mapper = LocalMapper(tracker)
    pend = []
    for b in range(len(SEEDS)):
        st, snap = tracker.init_state(), None
        for i in range(N_FRAMES):
            st, o = tracker.step(st, run["frames"][i][b], initialised=i > 0)
            if bool(o.new_kf):
                snap = (st.m, int(o.kf_id))
                st = st._replace(m=mapper.process(st.m, o.kf_id))
        assert snap is not None, "the fixture made no keyframe"
        pend.append(snap)
    bm = BatchedMapper(mapper)
    maps, k = stack([m for m, _ in pend]), torch.tensor([k for _, k in pend], dtype=torch.int32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = bm.process(maps, k, torch.tensor([True, True]))
        masked = bm.process(maps, k, torch.tensor([False, False]))
        bld = BatchedLoopDetector(LoopCloser(tracker))
        kf_bow = bld.observe(bld.init_bow(2), got, k)
        gate = bld.detect_gate(kf_bow, got, k, *bld.init_groups(2))
    torch.set_num_threads(1)
    try:
        want = [mapper.process(m, kk) for m, kk in pend]
    finally:
        torch.set_num_threads(2)
    return dict(maps=maps, k=k, got=got, want=want, masked=masked, bld=bld, kf_bow=kf_bow, gate=gate,
                caught=caught, tracker=tracker)


def test_batched_mapper_masked_is_identity(chain):
    for a, b in zip(chain["masked"], chain["maps"]):
        assert torch.equal(a, b)


def test_batched_mapper_equals_solo_chain(chain):
    for b, want in enumerate(chain["want"]):
        for name, g, w in zip(want._fields, unstack(chain["got"], b), want):
            if g.is_floating_point():
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=2e-3, err_msg=name)
            else:
                np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    # the chain did work: every sequence's map changed
    for b in range(2):
        assert not all(torch.equal(x, y) for x, y in zip(unstack(chain["got"], b), unstack(chain["maps"], b)))


def test_batched_loop_detector_equals_solo_gate(chain):
    """observe + detect_gate per row against the solo LoopCloser on that
    sequence's map: equal; the query keyframe scores itself 1 and the
    temporal gate rejects it."""
    loop = LoopCloser(chain["tracker"])
    has_any, enough, scores, g_mask, g_consist = chain["gate"]
    for b in range(2):
        m, k = unstack(chain["got"], b), int(chain["k"][b])
        loop.reset()
        loop.observe_keyframe(m, k)
        assert torch.equal(loop.kf_bow, chain["kf_bow"][b])
        want = loop._detect_gate_impl(loop.kf_bow, m, k, loop._g_mask, loop._g_consist)
        for x, y in zip(chain["gate"], want):
            assert torch.equal(x[b], y)
        np.testing.assert_allclose(float(scores[b, k]), 1.0, atol=1e-5)
    assert torch.isfinite(scores).all()
    assert not bool(has_any.any())


def test_init_state_is_stacked(run):
    st = run["bt"].init_state()
    one = run["tracker"].init_state()
    assert st.m.kf_pose.shape == (2,) + tuple(one.m.kf_pose.shape)
    assert (st.status == tracking.ST_UNINIT).all()
    for x, y in zip(unstack(st, 1).m, one.m):
        assert torch.equal(x, y)


def test_multi_sequence_example(tmp_path):
    """python -m plslam_tpu_torch.examples.multi_sequence on 2 sequences x 4
    frames at 192x256 on the CPU."""
    from plslam_tpu_torch.examples import multi_sequence

    res = multi_sequence.main(["--batch", "2", "--frames", "4", "--height", "192", "--width", "256", "--cpu",
                               "--out-prefix", str(tmp_path / "ms")])
    assert [r["tracked"] for r in res["sequences"]] == [4, 4]
    assert all(r["ate_m"] < 0.02 for r in res["sequences"])
    for b in range(2):
        assert len((tmp_path / f"ms_{b}.txt").read_text().splitlines()) == 4
