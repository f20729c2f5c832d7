"""Batched multi-sequence tracking and mapping, on one card or sharded over
a (seq, lm) device mesh.

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

The mesh (the reference's `make_mesh`, `_spec_for`, `_state_sharding`):
one process per device under `torch.distributed`, a `DeviceMesh` with dims
("seq", "lm") from `make_mesh`, and `DTensor` state placed by the
reference's rule (`placements`): a leaf whose path holds `.pt_` and whose
rank is >= 2 (the map's landmark arrays) is `(Shard(0), Shard(1))`, every
other leaf `(Shard(0), Replicate())`. `seq` is data parallelism: each rank
builds frames for and steps only the sequences its `seq` coordinate owns
(`local_batch`, `shard_frames`). `lm` shards the landmark axis: inside a
sharded call the local sequences run under `vmap` as on one card, with the
landmark arrays as `DTensor`s on the rank's `lm` sub-mesh, so an op on them
runs on the local landmark shard and DTensor gathers an operand over `lm`
only where an op needs the whole axis. Every decision (argmin, best-two,
gates, top-k) sees the unsharded values: a gather is a concatenation,
DTensor's argmin / argmax over a sharded axis keep the first minimum, and
the one reduction that crosses ranks is an integer count (`free_slots`'
free-slot count); no float sum over the landmark axis is split. The
state comes back in the same placements, so the landmark arrays stay
sharded between calls. One H100 holds the largest map (32,768 points)
whole: `lm` is there for parity with the reference, `seq` for capacity.
Kernel B3 meets DTensors as the custom op `plslam::pose_solve`, which
`register_sharding` lets run on each rank's own problems; an aten op that
some PyTorch release gives no DTensor strategy runs replicated over `lm`
(`_REPLICATED_OPS`). Backends: NCCL with one rank per card, gloo on the
CPU; ranks do not share a card (NCCL refuses it, and DTensor's collectives
crash over gloo on CUDA tensors in torch 2.11). Config 5 on a mesh:
`python -m torch.distributed.run --nproc-per-node N -m
plslam_tpu_torch.eval.dryrun_mesh [--cpu] [--config5]`.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.ops import brief
from plslam_tpu_torch.pipeline.tracking import take_row
from plslam_tpu_torch.slammap.state import MapState


def mesh_shape(n: int, seq: int | None = None) -> tuple[int, int]:
    """(seq, lm) for n devices, the reference's rule: seq = n for n <= 2,
    else max(2, n // 2); lm = n // seq."""
    if seq is None:
        seq = n if n <= 2 else max(2, n // 2)
    return seq, n // seq


def make_mesh(n_devices: int | None = None, seq: int | None = None, device: str = "cuda"):
    """A DeviceMesh with dims ("seq", "lm") over the process group already
    initialised (one process per device); n_devices defaults to its world
    size. Raises without a process group, when seq * lm is not the world
    size, and for device "cuda" without a card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    s, lm = mesh_shape(world if n_devices is None else n_devices, seq)
    if s * lm != world:
        raise ValueError(f"a ({s}, {lm}) mesh needs {s * lm} processes, the group has {world}")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') found no card; pass device='cpu' for a CPU mesh")
    return init_device_mesh(device_type, (s, lm), mesh_dim_names=("seq", "lm"))


def local_batch(mesh, batch: int) -> range:
    """The global indices of the sequences this rank's `seq` coordinate
    owns (all of them without a mesh)."""
    return range(batch) if mesh is None else _Mesh(mesh).local_batch(batch)


def _is_lm(path) -> bool:
    return ".pt_" in pytree.keystr(path)


def placements(tree):
    """The reference's _state_sharding rule on a stacked tree: a leaf whose
    path holds `.pt_` and whose rank is >= 2 -> (Shard(0), Shard(1)), every
    other tensor -> (Shard(0), Replicate()); anything else -> None."""
    from torch.distributed.tensor import Replicate, Shard

    def rule(path, x):
        if not torch.is_tensor(x):
            return None
        return (Shard(0), Shard(1)) if _is_lm(path) and x.ndim >= 2 else (Shard(0), Replicate())

    return pytree.tree_map_with_path(rule, tree)


# aten ops the step, the chain or the gate reach with a DTensor operand and
# for which some PyTorch release has no DTensor sharding strategy
# (scatter_reduce in 2.11 and 2.13, the others in 2.11): where the running
# release has none, each runs on every lm rank with its DTensor operands
# gathered whole over lm (Replicate)
_REPLICATED_OPS = ("scatter_reduce.two", "ne.Tensor", "index_fill_.int_Scalar", "linalg_cross.default",
                   "_linalg_solve_ex.default")


def _replicate_all(op):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpStrategy
    from torch.distributed.tensor.experimental import register_sharding

    n_out = len(op._schema.returns)

    def strategy(*args, **kwargs):
        ins = [Replicate() if isinstance(x, (DTensorSpec, OpStrategy)) else None
               for x in pytree.tree_leaves((args, kwargs))]
        return [([Replicate()] * n_out, ins)]

    register_sharding(op)(strategy)


def _pose_solve_strategy(*args):
    """Kernel B3 (plslam::pose_solve) on DTensors: its problems are
    independent, so problem axis sharded in -> sharded out, or everything
    replicated; each rank launches B3 on its local problems."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    is_t = [isinstance(x, DTensorSpec) for x in args]
    return [([p] * 3, [p if t else None for t in is_t]) for p in (Replicate(), Shard(0))]


def _has_strategy(op) -> bool:
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, table, {}) for table in
               ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"))


@functools.cache
def _register_strategies():
    from torch.distributed.tensor.experimental import register_sharding

    import plslam_tpu_torch.solvers.pose  # noqa: F401  (defines plslam::pose_solve)

    register_sharding(torch.ops.plslam.pose_solve.default)(_pose_solve_strategy)
    for name in _REPLICATED_OPS:
        packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)
        if not _has_strategy(op):
            _replicate_all(op)


class _Mesh:
    """The (seq, lm) mesh of one batched class: where this rank sits, the
    sequences it owns, and the conversion of trees between whole tensors,
    mesh DTensors and the local tensors a sharded call runs on."""

    def __init__(self, mesh):
        if tuple(mesh.mesh_dim_names or ()) != ("seq", "lm"):
            raise ValueError(f"the mesh needs dims ('seq', 'lm'), got {mesh.mesh_dim_names}")
        self.mesh = mesh
        self.n_seq, self.n_lm = mesh.size(0), mesh.size(1)
        self.seq_rank, self.lm_rank = mesh.get_local_rank("seq"), mesh.get_local_rank("lm")
        self.lm_mesh = mesh["lm"]
        _register_strategies()

    def check(self, batch: int, n_landmarks: int | None = None):
        if batch % self.n_seq:
            raise ValueError(f"a batch of {batch} does not divide over seq = {self.n_seq}")
        if n_landmarks is not None and n_landmarks % self.n_lm:
            raise ValueError(f"{n_landmarks} landmarks do not divide over lm = {self.n_lm}")

    def local_batch(self, batch: int) -> range:
        """The global sequence indices this rank's seq coordinate owns."""
        self.check(batch)
        b = batch // self.n_seq
        return range(self.seq_rank * b, (self.seq_rank + 1) * b)

    def _local_chunk(self, x, pl):
        """This rank's block of a whole tensor placed by pl."""
        from torch.distributed.tensor import Shard

        for dim, (p, n, r) in enumerate(zip(pl, (self.n_seq, self.n_lm), (self.seq_rank, self.lm_rank))):
            if isinstance(p, Shard):
                if x.shape[p.dim] % n:
                    raise ValueError(f"axis {p.dim} of {tuple(x.shape)} does not divide over {n} ranks")
                x = x.tensor_split(n, p.dim)[r]
        return x

    def from_local(self, tree, whole: bool = False):
        """Local blocks (or, whole=True, whole tensors every rank holds) ->
        mesh DTensors by the placement rule."""
        from torch.distributed.tensor import DTensor

        def one(x, pl):
            if pl is None:
                return x
            if whole:
                x = self._local_chunk(x, pl)
            return DTensor.from_local(x.contiguous(), self.mesh, pl, run_check=False)

        return pytree.tree_map(one, tree, placements(tree))

    def run(self, fn, *args):
        """fn(*args) on this rank's blocks: every mesh DTensor is taken to
        its local block (seq: this rank's sequences), the landmark blocks
        become DTensors on the lm sub-mesh so that DTensor runs each op on
        the local shard or gathers its operand over lm, and the results
        come back as mesh DTensors by the placement rule."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import implicit_replication

        lm = self.lm_mesh

        def enter(path, x, want):
            if not torch.is_tensor(x):
                return x
            if not isinstance(x, DTensor) or x.device_mesh != self.mesh:
                raise ValueError(f"input {pytree.keystr(path)}: a sharded call takes DTensors on its mesh")
            loc = x.redistribute(self.mesh, want).to_local()  # no-op when placed by the rule
            if _is_lm(path) and x.ndim >= 2:
                return DTensor.from_local(loc, lm, (Shard(1),), run_check=False)
            return loc

        def leave(path, x):
            if not torch.is_tensor(x):
                return x
            if _is_lm(path) and x.ndim >= 2:
                if isinstance(x, DTensor):
                    return x.redistribute(lm, (Shard(1),)).to_local()
                return x.tensor_split(self.n_lm, 1)[self.lm_rank]
            if isinstance(x, DTensor):
                return x.redistribute(lm, (Replicate(),)).to_local()
            return x

        local = pytree.tree_map_with_path(enter, args, placements(args))
        with implicit_replication():
            out = fn(*local)
        return self.from_local(pytree.tree_map_with_path(leave, out))


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
    """`Tracker.step` under `torch.func.vmap` over a leading sequence axis;
    with a (seq, lm) `mesh` the batch is sharded over it."""

    def __init__(self, tracker, batch: int, mesh=None):
        self.tracker = tracker
        self.batch = batch
        self.mesh = mesh
        self._mesh = None if mesh is None else _Mesh(mesh)
        if self._mesh is not None:
            self._mesh.check(batch, tracker.max_pts)

    def local_batch(self) -> range:
        """The global indices of the sequences this rank steps."""
        return local_batch(self.mesh, self.batch)

    def init_state(self):
        """B fresh TrackStates, stacked (all UNINIT); on a mesh, distributed
        by `placements`."""
        if self._mesh is None:
            return _repeat(self.tracker.init_state(), self.batch)
        local = _repeat(self.tracker.init_state(), len(self.local_batch()))
        return self._mesh.from_local(pytree.tree_map_with_path(
            lambda p, x: x.tensor_split(self._mesh.n_lm, 1)[self._mesh.lm_rank] if _is_lm(p) and x.ndim >= 2 else x,
            local))

    def shard_state(self, state):
        """A stacked state built whole (the same on every rank, e.g. carried
        in by convert.batched_track_state_from_numpy) -> distributed by
        `placements`."""
        self._need_mesh()
        return self._mesh.from_local(state, whole=True)

    def shard_frames(self, local_frames):
        """The stacked FrameData of this rank's own sequences
        (`local_batch`) -> one DTensor per field, (Shard(0), Replicate())."""
        self._need_mesh()
        if local_frames.valid.shape[0] != len(self.local_batch()):
            raise ValueError(f"frames for {local_frames.valid.shape[0]} sequences, this rank owns "
                             f"{len(self.local_batch())}")
        return self._mesh.from_local(local_frames)

    def _need_mesh(self):
        if self._mesh is None:
            raise ValueError("this BatchedTracker has no mesh")

    def step(self, state, frames, initialised: bool | None = None):
        """(stacked TrackState, stacked FrameData) -> (stacked TrackState,
        stacked StepOut). `initialised` is what the host knows of every
        sequence's status: False (all UNINIT, as after init_state), True
        (all initialised), or None when they are mixed (a failed init),
        where both branches run and each sequence's is picked on the
        device, as the reference's lax.cond under jax.vmap. On a mesh the
        inputs are DTensors (init_state / shard_state, shard_frames) and
        the results come back in the same placements."""
        vstep = torch.func.vmap(functools.partial(self.tracker.step, initialised=initialised))
        return vstep(state, frames) if self._mesh is None else self._mesh.run(vstep, state, frames)


class BatchedMapper:
    """`LocalMapper.process` (cull, triangulate, fuse, local BA, refresh,
    keyframe cull, eviction) under `torch.func.vmap`, masked per sequence:
    a sequence whose `do` is False gets its input map back bit for bit
    (torch.where picks the old tensor element by element), so sequences
    that insert keyframes at different frames share one dispatch. On a
    mesh the map and the result are placed by `placements`."""

    def __init__(self, mapper, mesh=None):
        self.mapper = mapper
        self.mesh = mesh
        self._mesh = None if mesh is None else _Mesh(mesh)
        self._vprocess = torch.func.vmap(self._masked)

    def _masked(self, m: MapState, k, do) -> MapState:
        m2 = self.mapper.process(m, k)
        return MapState(*(torch.where(do, a, b) for a, b in zip(m2, m)))

    def process(self, m: MapState, k, do) -> MapState:
        """m: stacked MapState, k: i32[B] keyframe slots, do: bool[B]."""
        if self._mesh is None:
            return self._vprocess(m, k, do)
        self._mesh.check(m.pt_valid.shape[0], m.pt_valid.shape[1])
        return self._mesh.run(self._vprocess, m, k, do)


class BatchedLoopDetector:
    """The DetectLoop gate (TF-IDF scoring, min-score against the covisible
    neighbours, temporal and shared-word gates, group scores, consistency
    with groups carried on the device) under `torch.func.vmap`, on
    per-sequence BoW databases kf_bow f32[B, max_kf, W]. On a mesh the
    databases and groups are (Shard(0), Replicate()), the reference's
    P("seq")."""

    def __init__(self, loop, mesh=None):
        self.loop = loop
        self.mesh = mesh
        self._mesh = None if mesh is None else _Mesh(mesh)
        self._vobserve = torch.func.vmap(self._observe)
        self._vgate = torch.func.vmap(loop._detect_gate_impl)

    def _zeros(self, batch, shape, dtype):
        """Zeros [batch, *shape]; on a mesh this rank's sequences, placed."""
        x = torch.zeros((len(local_batch(self.mesh, batch)),) + shape, dtype=dtype, device=self.loop.device)
        return x if self._mesh is None else self._mesh.from_local(x)

    def init_groups(self, batch: int):
        """-> (g_mask bool[B, G, K], g_consist i32[B, G]), all empty."""
        G, K = C.LOOP_MAX_GROUPS, self.loop.tracker.max_kf
        return self._zeros(batch, (G, K), torch.bool), self._zeros(batch, (G,), torch.int32)

    def init_bow(self, batch: int):
        return self._zeros(batch, (self.loop.tracker.max_kf, self.loop.vocab.n_words), torch.float32)

    def _observe(self, kf_bow, m: MapState, k):
        row = self.loop.vocab.bow(brief.unpack_bits_pm1(take_row(m.kf_desc, k)), take_row(m.kf_feat_valid, k))
        return kf_bow.index_copy(0, k.reshape(1).long(), row[None])

    def _call(self, f, *args):
        return f(*args) if self._mesh is None else self._mesh.run(f, *args)

    def observe(self, kf_bow, m: MapState, k):
        """KeyFrameDatabase::add per sequence: kf_bow[b, k[b]] <- the BoW
        row of keyframe k[b]."""
        return self._call(self._vobserve, kf_bow, m, k)

    def detect_gate(self, kf_bow, m: MapState, k, g_mask, g_consist):
        """-> per sequence (any enough-consistent candidate bool[B],
        candidate mask bool[B, K], scores f32[B, K], new groups, their
        consistency). Nothing is read back."""
        return self._call(self._vgate, kf_bow, m, k, g_mask, g_consist)
