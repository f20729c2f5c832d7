"""The traffic generator: the torch renderer against the numpy copy, the
numpy copy against the port's synthetic sequence it was copied from, and
the window's frame order."""

import itertools

import numpy as np
import pytest
import torch

from portbench import generator
from portbench.errors import NoResult
from portbench.scene import SyntheticSequence


@pytest.mark.parametrize("kw", [dict(), dict(motion_scale=2.0, fps=15.0)])
def test_torch_render_equals_numpy_at_160x120(kw):
    sc = SyntheticSequence(height=120, width=160, seed=2**31 + 7, **kw)
    idx = [0, 5, 17, 39]
    g, d = sc.render(idx, "cpu", chunk=3)
    for j, i in enumerate(idx):
        gn, dn, t = sc.frame(i)
        assert t == i / sc.fps
        np.testing.assert_array_equal(g[j].numpy(), gn)
        np.testing.assert_array_equal(d[j].numpy(), dn)


def test_copy_equals_the_port_generator():
    from plslam_tpu_torch.io.synthetic import SyntheticSequence as Port

    for kw in (dict(), dict(motion_scale=2.0)):
        a = SyntheticSequence(height=120, width=160, seed=5, **kw)
        b = Port(n_frames=30, height=120, width=160, seed=5, **kw)
        for i in (0, 13, 29):
            for x, y in zip(a.frame(i)[:2], b.frame(i)[:2]):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a.gt_pose_wc(i), b.gt_pose_wc(i))


def test_fixed_scene_with_seeded_noise():
    settings = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=160,
                    height=120, fps=30.0)
    tr = dict(scene_seed=4, gray_noise=1.0)
    a, b, a2 = (generator.scene(tr, settings, s) for s in (7, 8, 7))
    np.testing.assert_array_equal(a.tex, b.tex)  # the scene is the traffic's, whatever the seed
    ga, gb, ga2 = (s.render([3, 5], "cpu")[0] for s in (a, b, a2))
    assert torch.equal(ga, ga2) and not torch.equal(ga, gb)  # the noise is the seed's
    noise = (ga - torch.from_numpy(np.stack([a.frame(3)[0], a.frame(5)[0]]))).numpy()
    assert 0.9 < noise.std() < 1.1 and abs(noise.mean()) < 0.02
    c = generator.scene(tr, settings, 7, index=1)  # the next sequence of a batched run: another scene
    assert not np.array_equal(a.tex, c.tex)
    np.testing.assert_array_equal(generator.scene(tr, settings, 7, index=1).tex, c.tex)


def test_seed_changes_the_scene_not_the_motion():
    a = SyntheticSequence(height=120, width=160, seed=1)
    b = SyntheticSequence(height=120, width=160, seed=2)
    assert not np.array_equal(a.frame(3)[0], b.frame(3)[0])
    np.testing.assert_array_equal(a.gt_pose_wc(3), b.gt_pose_wc(3))


def test_store_and_order():
    settings = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=160,
                    height=120, fps=30.0)
    tr = dict(warmup_frames=4, replay="forward")
    pl = generator.plan(tr, 3.0, 2.0, extra=2)
    assert pl == generator.Plan(list(range(8)), 0)
    store = generator.FrameStore(generator.scene(tr, settings, 9), pl, "cpu", block=3)
    assert len(store) == 8 and store.gray.dtype == np.uint8 and store.depth.dtype == np.float32
    g, d, _ = store.scene.frame(7)
    np.testing.assert_array_equal(store.frame(7)[0], np.clip(np.round(g), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(store.frame(7)[1], d)
    with pytest.raises(NoResult):
        store.frame(8)  # the window never wraps around
    assert list(itertools.islice(generator.window_order(pl), 5)) == [0, 1, 2, 3, 4]


def test_pingpong_shows_the_map_views_with_fresh_noise():
    settings = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=160,
                    height=120, fps=30.0)
    tr = dict(replay="pingpong", map_frames=4, gray_noise=1.0, scene_seed=2)
    pl = generator.plan(tr, 4.0, 2.0, extra=1)
    assert pl.window_start == 4 and pl.views == [0, 1, 2, 3] + [2, 1, 0, 1, 2, 3, 2, 1, 0]
    assert list(itertools.islice(generator.window_order(pl), 3)) == [4, 5, 6]
    store = generator.FrameStore(generator.scene(tr, settings, 2**31 + 3), pl, "cpu", block=5)
    # place 5 shows view 1 again: the same pose and depth, its own noise
    np.testing.assert_array_equal(store.gt_pose(5), store.gt_pose(1))
    np.testing.assert_array_equal(store.frame(5)[1], store.frame(1)[1])
    assert not np.array_equal(store.frame(5)[0], store.frame(1)[0])


def test_render_on_the_card_equals_numpy(card):
    sc = SyntheticSequence(seed=11)
    g, d = sc.render([0, 21], card)
    for j, i in enumerate((0, 21)):
        gn, dn, _ = sc.frame(i)
        assert float(np.abs(g[j].cpu().numpy() - gn).max()) < 1e-3
        assert float(np.abs(d[j].cpu().numpy() - dn).max()) < 1e-5
    torch.cuda.synchronize()
