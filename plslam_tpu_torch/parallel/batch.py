"""Batched multi-sequence tracking and mapping on one card.

Port of plslam_tpu/parallel/batch.py (BASELINE.json config 5: several RGB-D
sequences streamed together). Every per-sequence tensor of a TrackState,
MapState or FrameData gains a leading sequence axis B, and the tracking
step, the mapper chain and the loop-detection gate run under
`torch.func.vmap`: one dispatch of each op for the whole batch, no Python
loop over sequences.

What `vmap` needs of the code it runs (the solo paths keep their results
bit for bit):
  * no in-place write into an unbatched tensor from a batched one: indexed
    writes are out of place (`index_put`, `scatter`, `index_add`,
    `index_copy` without `_`);
  * no op without a batching rule (vmap would loop over the sequences with
    a "performance drop" warning): `torch.nanquantile` became
    `matching.lines.nanmedian`;
  * kernel B3 is the custom op `plslam::pose_solve`, whose vmap rule puts
    the B sequences' P problems on the problem axis: the tracker's stacked
    motion-model + fallback solve of 4 sequences is one launch of 8
    problems, its joint solve one launch of 4 (solvers/pose.py).

Frames are built per sequence by `FrameBuilder` (kernels B1 and B2 run once
per sequence per frame) and stacked with `stack`.

The reference also shards the batch over a device mesh (`make_mesh`,
`_spec_for`, `_state_sharding`); this port runs on one card and takes
`mesh=None` only.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.pipeline.tracking import take_row
from plslam_tpu_torch.slammap.state import MapState


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("parallel/batch.py runs on one card: a device mesh is not supported (mesh=None)")


def stack(items):
    """A list of B NamedTuples (TrackState, FrameData, ...) -> one with a
    leading sequence axis on every tensor."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *items)


def unstack(tree, b):
    """Row b of a batched NamedTuple."""
    return pytree.tree_map(lambda x: x[b], tree)


def _repeat(tree, batch):
    """Every tensor of an unbatched tree copied to a leading axis of `batch`."""
    return pytree.tree_map(lambda x: x.expand((batch,) + x.shape).clone(), tree)


class BatchedTracker:
    """`Tracker.step` under `torch.func.vmap` over a leading sequence axis."""

    def __init__(self, tracker, batch: int, mesh=None):
        _no_mesh(mesh)
        self.tracker = tracker
        self.batch = batch
        self.mesh = mesh

    def init_state(self):
        """B fresh TrackStates, stacked (all UNINIT)."""
        return _repeat(self.tracker.init_state(), self.batch)

    def step(self, state, frames, initialised: bool | None = None):
        """(stacked TrackState, stacked FrameData) -> (stacked TrackState,
        stacked StepOut). `initialised` is what the host knows of every
        sequence's status: False (all UNINIT, as after init_state), True
        (all initialised), or None when they are mixed (a failed init),
        where both branches run and each sequence's is picked on the
        device, as the reference's lax.cond under jax.vmap."""
        return torch.func.vmap(functools.partial(self.tracker.step, initialised=initialised))(state, frames)


class BatchedMapper:
    """`LocalMapper.process` (cull, triangulate, fuse, local BA, refresh,
    keyframe cull, eviction) under `torch.func.vmap`, masked per sequence:
    a sequence whose `do` is False gets its input map back bit for bit
    (torch.where picks the old tensor element by element), so sequences
    that insert keyframes at different frames share one dispatch."""

    def __init__(self, mapper, mesh=None):
        _no_mesh(mesh)
        self.mapper = mapper
        self.mesh = mesh
        self._vprocess = torch.func.vmap(self._masked)

    def _masked(self, m: MapState, k, do) -> MapState:
        m2 = self.mapper.process(m, k)
        return MapState(*(torch.where(do, a, b) for a, b in zip(m2, m)))

    def process(self, m: MapState, k, do) -> MapState:
        """m: stacked MapState, k: i32[B] keyframe slots, do: bool[B]."""
        return self._vprocess(m, k, do)


class BatchedLoopDetector:
    """The DetectLoop gate (TF-IDF scoring, min-score against the covisible
    neighbours, temporal and shared-word gates, group scores, consistency
    with groups carried on the device) under `torch.func.vmap`, on
    per-sequence BoW databases kf_bow f32[B, max_kf, W]."""

    def __init__(self, loop, mesh=None):
        _no_mesh(mesh)
        self.loop = loop
        self.mesh = mesh
        self._vobserve = torch.func.vmap(self._observe)
        self._vgate = torch.func.vmap(loop._detect_gate_impl)

    def init_groups(self, batch: int):
        """-> (g_mask bool[B, G, K], g_consist i32[B, G]), all empty."""
        K, dev = self.loop.tracker.max_kf, self.loop.device
        return (torch.zeros((batch, C.LOOP_MAX_GROUPS, K), dtype=torch.bool, device=dev),
                torch.zeros((batch, C.LOOP_MAX_GROUPS), dtype=torch.int32, device=dev))

    def init_bow(self, batch: int):
        return torch.zeros((batch, self.loop.tracker.max_kf, self.loop.vocab.n_words), dtype=torch.float32,
                           device=self.loop.device)

    def _observe(self, kf_bow, m: MapState, k):
        row = self.loop.vocab.bow(brief.unpack_bits_pm1(take_row(m.kf_desc, k)), take_row(m.kf_feat_valid, k))
        return kf_bow.index_copy(0, k.reshape(1).long(), row[None])

    def observe(self, kf_bow, m: MapState, k):
        """KeyFrameDatabase::add per sequence: kf_bow[b, k[b]] <- the BoW
        row of keyframe k[b]."""
        return self._vobserve(kf_bow, m, k)

    def detect_gate(self, kf_bow, m: MapState, k, g_mask, g_consist):
        """-> per sequence (any enough-consistent candidate bool[B],
        candidate mask bool[B, K], scores f32[B, K], new groups, their
        consistency). Nothing is read back."""
        return self._vgate(kf_bow, m, k, g_mask, g_consist)
