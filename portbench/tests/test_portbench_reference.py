"""The frozen reference against the port's plain paths it was copied from,
on the CPU where both are plain PyTorch: equal bit for bit. And the
comparisons of the check read 0 on equal outputs."""

import dataclasses

import numpy as np
import torch

from portbench import check
from portbench.reference import frontend
from portbench.reference.pose import LineObs, PointObs, pose_optimization_plain


def _settings(w=320, h=240):
    from plslam_tpu_torch import load_settings

    return dataclasses.replace(load_settings("configs/TUM3.yaml"), width=w, height=h, cx=w / 2, cy=h / 2)


def test_frontend_equals_the_frame_builder():
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.io.synthetic import SyntheticSequence

    s = _settings()
    g, d, _ = SyntheticSequence(n_frames=3, seed=3, settings=s).frame(1)
    f = FrameBuilder(s, device="cpu")(g, d)
    sd = dataclasses.asdict(s)
    ref = check.reference_frame(torch.from_numpy(g), sd)
    n = ref["uv_raw"].shape[0]
    for k in ("uv_raw", "octave", "angle", "desc", "valid"):
        assert torch.equal(getattr(f, k)[:n], ref[k]), k
    assert not bool(f.valid[n:].any())
    for k in ("ln_sp", "ln_ep", "ln_desc", "ln_valid"):
        assert torch.equal(getattr(f, k), ref[k]), k
    cand = {k: getattr(f, k) for k in ("uv_raw", "octave", "desc", "valid", "ln_sp", "ln_ep", "ln_desc", "ln_valid")}
    assert check.orb_bits(cand, ref)[0] == 0.0 and check.line_bits(cand, ref)[0] == 0.0
    # one bit of each descriptor flipped reads 1/256; a moved keyline, all its bits
    desc = cand["desc"].clone()
    desc[:, 0] ^= 1
    bad = dict(cand, desc=desc)
    b, t = check.orb_bits(bad, ref)
    assert b / t == 1 / 256
    moved = dict(cand, ln_sp=cand["ln_sp"] + 0.5)
    b, t = check.line_bits(moved, ref)
    assert b / t >= 1.0


def test_pose_equals_the_port_plain_solve():
    from plslam_tpu_torch.io.synthetic import pose_problem
    from plslam_tpu_torch.solvers import pose as port

    pb = pose_problem(np.random.default_rng(4))
    pts = [torch.from_numpy(np.asarray(a)) for a in pb["pts"]]
    lns = [torch.from_numpy(np.asarray(a)) for a in pb["lines"]]
    T0 = torch.eye(4)
    got = pose_optimization_plain(T0, PointObs(*pts), pb["K"], pb["bf"], LineObs(*lns))
    want = port.pose_optimization_plain(T0, port.PointObs(*pts), pb["K"], pb["bf"], port.LineObs(*lns))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_local_ba_equals_the_port():
    """The frozen local BA against the port's LocalBA, on a map the port
    made (320x240, 10 fast frames) around its newest keyframe: every field
    it writes equal bit for bit; and the poses under vmap over a batch of
    two, as check.py holds a batched call."""
    from plslam_tpu_torch.io.synthetic import SyntheticSequence
    from plslam_tpu_torch.system import System

    from portbench.reference.local_ba import BA_FIELDS, BAMap, Camera, LocalBA

    torch.set_num_threads(2)
    s = _settings()
    slam = System(s, max_kf=16, max_pts=4096, device="cpu")
    seq = SyntheticSequence(n_frames=10, seed=3, settings=s, motion_scale=4.0)
    for i in range(10):
        slam.track_rgbd(*seq.frame(i))
    m = slam.state.m
    k = torch.nonzero(m.kf_valid)[-1, 0]
    assert int(k) > 0
    want = slam._mapper._ba.run(m, k)
    bm = BAMap(**{f: getattr(m, f) for f in BA_FIELDS})
    got = LocalBA(Camera(dataclasses.asdict(s), bm)).run(bm, k)
    for f in ("kf_pose", "pt_pos", "ln_sw", "ln_ew", "kf_lm_idx", "kf_ln_idx"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(want.kf_pose, m.kf_pose)  # the solve moved something
    # under vmap, as the batched mapper runs it: the port's and the copy's alike
    kk = torch.stack([k, k - 1])
    port2 = torch.func.vmap(lambda mm, kb: slam._mapper._ba.run(type(m)(*mm), kb).kf_pose)(
        tuple(torch.stack([v, v]) for v in m), kk)
    ref2 = check.reference_ba(BAMap(*(torch.stack([v, v]) for v in bm)), kk, dataclasses.asdict(s), batched=True)
    assert torch.equal(ref2, port2)
