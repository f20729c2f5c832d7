"""The batched path sharded over a (seq, lm) device mesh, end to end.

Port of __graft_entry__.py's dryrun_multichip: on a mesh from
`parallel.batch.make_mesh` (one process per device), a first batched
tracking step, the mapper chain with local BA, a second tracked step
against the refined map and the self-revisit loop-detection gate, which
must reject. Each rank builds frames only for the sequences its `seq`
coordinate owns (kernels B1 and B2 once per local sequence) and steps them;
the map's landmark arrays stay sharded over `lm`.

    python -m torch.distributed.run --nproc-per-node N -m plslam_tpu_torch.eval.dryrun_mesh [--cpu]
    python -m torch.distributed.run --nproc-per-node N -m plslam_tpu_torch.eval.dryrun_mesh --config5 [--frames F]

Default shapes are the reference dryrun's: 192x256, n_features 120,
capacity 128, line capacity 16, max_kf 8, max_pts 512, max_maplines 64,
batch = 2 seq. `--config5` runs config 5 (BASELINE.json) at full width
instead: 640x480, the 4 sequences of seeds 1, 12, 23, 34, max_pts 8192, max_kf 64,
F frames stepped and the mapper chain once on frame 0's map (not fed
back: each compares with its unsharded counterpart). `--compare` then
reruns each seq group's sequences unsharded on its own first rank's
device and prints how many result arrays are not bit for bit equal.
The backend is gloo on the CPU and NCCL on cards, one rank per card
(NCCL refuses two ranks on one card, and DTensor's collectives crash
over gloo on CUDA tensors with torch 2.11).

`spawn(n, device, store_path, out_path)` starts the n ranks from Python
(torch.multiprocessing, a FileStore rendezvous: no TCP port); rank 0
writes every result's `full_tensor()` and every state leaf's placements to
`out_path` (.npz).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

SMALL = dict(height=192, width=256, n_features=120, capacity=128, line_capacity=16,
             caps=dict(max_kf=8, max_pts=512, max_feat=128, max_lines=16, max_maplines=64))
CONFIG5 = dict(height=480, width=640, seeds=(1, 12, 23, 34), caps=dict(max_pts=8192, max_kf=64))
# the device kernels of B1, B2 and B3 as the profiler names them
KERNELS = {"fast_blur_stack": "fast_kernel<true", "gather_patches": "gather_patches_kernel",
           "pose_lm": "pose_lm_kernel"}


def _known(status):
    """What the host knows of a batch's statuses (examples/multi_sequence.py)."""
    from plslam_tpu_torch.examples.multi_sequence import known_status

    return known_status(status)


def _launch_counts():
    from plslam_tpu_torch.ops import fast_cuda, patches
    from plslam_tpu_torch.solvers import pose

    return {w.__name__: w.launches for w in (fast_cuda.fast_blur_stack, patches.gather_patches, pose.pose_lm)}


@functools.lru_cache(maxsize=None)
def sequence(seed: int, n_frames: int, config5: bool = False):
    """The synthetic sequence of one seed at the dry run's size (cached:
    its texture takes a second to make)."""
    from plslam_tpu_torch.io.synthetic import SyntheticSequence

    cfg = CONFIG5 if config5 else SMALL
    return SyntheticSequence(n_frames=n_frames, height=cfg["height"], width=cfg["width"], seed=seed)


def _setup(config5, device, seeds, n_frames):
    """-> ({index: sequence} for the given {index: seed}, FrameBuilder, Tracker)."""
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.pipeline.tracking import Tracker

    cfg = CONFIG5 if config5 else SMALL
    seqs = {b: sequence(s, n_frames, config5) for b, s in seeds.items()}
    settings = next(iter(seqs.values())).settings
    if "n_features" in cfg:
        settings = dataclasses.replace(settings, n_features=cfg["n_features"])
    fb_kw = {k: cfg[k] for k in ("capacity", "line_capacity") if k in cfg}
    builder = FrameBuilder(settings, device=device, **fb_kw)
    return seqs, builder, Tracker(settings, device=device, **cfg["caps"])


def _full(x):
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _np(x):
    return _full(x).cpu().numpy()


def run(mesh, device, seeds=None, config5=False, n_frames=2, carry=None, profile_frame=None, log=print):
    """The dry run on `mesh` (every rank calls it; mesh None: the same run
    unsharded on one device, for comparison) -> {name: result}, and the
    Tracker it built under "tracker".

    Frame 0 initialises every sequence, the mapper chain runs on its
    keyframes ("chain0") and, as in the reference's dry run, frame 1 tracks
    against the refined map. config5: config 5 (BASELINE.json) at full width, its
    n_frames steps without the chain's result fed back (the chain runs
    once, on frame 0's map), so that the steps and the chain each compare
    with an unsharded run of their own.

    seeds: one per sequence (default: the reference's one sequence, seed 0,
    for every sequence; config5: its four). carry: the reference's batched
    state after frame 0 and its frame 1 (dicts of numpy arrays, keys
    "state" and "frame"): the run then also steps frame 1 from the state
    after frame 0 without the chain ("unmapped1"), and frame 1 from the
    carried state ("carried"). profile_frame: that frame's build and step
    run under torch.profiler, and "kernels_seen" counts the B1-B3 kernels
    it saw on the card. On a card every step and chain runs under CUDA's
    sync debug mode "error": a host synchronisation inside raises."""
    from plslam_tpu_torch.parallel.batch import BatchedLoopDetector, BatchedMapper, BatchedTracker, local_batch, stack
    from plslam_tpu_torch.pipeline import tracking as T
    from plslam_tpu_torch.pipeline.loopclosing import LoopCloser
    from plslam_tpu_torch.pipeline.mapping import LocalMapper

    cfg = CONFIG5 if config5 else SMALL
    n_seq = 1 if mesh is None else mesh.size(0)
    batch = len(cfg["seeds"]) if config5 else 2 * n_seq
    seeds = tuple(seeds or cfg.get("seeds") or (0,) * batch)
    batch = len(seeds)
    mine = local_batch(mesh, batch)  # each rank makes only its own sequences
    seqs, builder, tracker = _setup(config5, device, {b: seeds[b] for b in mine}, n_frames)
    bt = BatchedTracker(tracker, batch=batch, mesh=mesh)
    bm = BatchedMapper(LocalMapper(tracker), mesh=mesh)
    shape = {"seq": 1, "lm": 1} if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
    res, ms_step, ms_chain = {}, [], []

    def frames(i):
        f = stack([builder(*seqs[b].frame(i)[:2]) for b in mine])
        return f if mesh is None else bt.shard_frames(f)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def no_host_sync():
        if device == "cpu":
            yield
            return
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    state, known = bt.init_state(), False
    for i in range(n_frames):
        with _profiler(i == profile_frame) as prof:
            f = frames(i)
            sync()
            t0 = time.perf_counter()
            with no_host_sync():
                state, out = bt.step(state, f, initialised=known)
            sync()
            ms_step.append((time.perf_counter() - t0) * 1e3)
        if i == profile_frame:
            on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            res["kernels_seen"] = {k: sum(v in name for name in on_card) for k, v in KERNELS.items()}
        res[f"out{i}"] = out
        new_kf = _np(out.new_kf)
        if i == 0:
            tracked = _np(out.tracked)
            if not tracked.all():
                raise RuntimeError(f"mesh dry run: tracking failed {tracked.tolist()}")
            log(f"dryrun_mesh OK: mesh={shape} batch={batch} tracked={tracked.tolist()}")
            if not new_kf.all():
                raise RuntimeError("mesh dry run: initialisation must insert a keyframe")
        if i == 1 and carry is not None:
            res["unmapped1"] = bt.step(res["state0"], f, initialised=True)[1]
        res[f"state{i}"] = state
        if i == 0:
            sync()
            t0 = time.perf_counter()
            with no_host_sync():
                chained = bm.process(state.m, out.kf_id, out.new_kf)
            sync()
            ms_chain.append((time.perf_counter() - t0) * 1e3)
            res["chain0"] = chained
            n_pt = _np(chained.n_pt)
            if not (n_pt > 0).all():
                raise RuntimeError("mesh dry run: the mapper chain produced empty maps")
            log(f"dryrun_mesh mapper chain OK: sharded LocalMapper (incl. local BA) ran on mesh={shape}; "
                f"per-seq map points={n_pt.tolist()}")
            if not config5:
                # the reference's order: later frames track on the refined
                # map; and do False everywhere hands the map back unchanged
                state = state._replace(m=chained)
                res["masked"] = bm.process(res["state0"].m, out.kf_id, torch.zeros_like(out.new_kf))
        if i == 1:
            tracked = _np(out.tracked)
            if not tracked.all():
                raise RuntimeError(f"mesh dry run: tracking failed on frame 1 {tracked.tolist()}")
            log(f"dryrun_mesh OK: tracked{'' if config5 else ' post-mapper'}={tracked.tolist()}")
        known = _known(_np(out.telemetry)[:, T.TEL_STATUS].astype(np.int64))
    res["state"] = state
    res["ms_step"], res["ms_chain"] = ms_step, ms_chain
    res["tracker"] = tracker

    # each sequence observes its first keyframe and queries with it: a
    # self-revisit, which the temporal gate must reject
    bld = BatchedLoopDetector(LoopCloser(tracker), mesh=mesh)
    kf0 = torch.zeros_like(res["out0"].kf_id)
    kf_bow = bld.observe(bld.init_bow(batch), state.m, kf0)
    gate = bld.detect_gate(kf_bow, state.m, kf0, *bld.init_groups(batch))
    res["kf_bow"], res["gate"] = kf_bow, gate
    scores = _np(gate[2])
    if not np.isfinite(scores).all():
        raise RuntimeError("mesh dry run: non-finite loop scores")
    if _np(gate[0]).any():
        raise RuntimeError("mesh dry run: a self-revisit on a 2-keyframe map passed the temporal gate")
    log(f"dryrun_mesh loop-detect OK: sharded DetectLoop gate ran on mesh={shape}; self-score per seq="
        f"{np.round(scores[:, 0], 3).tolist()} (gate correctly rejected)")

    if carry is not None:
        from plslam_tpu_torch import convert

        st = convert.batched_track_state_from_numpy(carry["state"], batch, device=device)
        fr = pytree.tree_map(lambda x: x[mine.start:mine.stop], convert.frame_from_numpy(carry["frame"], device=device))
        if mesh is not None:
            st, fr = bt.shard_state(st), bt.shard_frames(fr)
        res["carried"] = bt.step(st, fr, initialised=True)[1]
    return res


def compare_unsharded(mesh, device, res, config5, n_frames):
    """On the first lm rank of each seq group (every rank calls it): the
    group's sequences rerun unsharded on this rank's device, every result
    array of the sharded run (its rows of the group) against the unsharded
    one -> a line of text (None on the other ranks)."""
    from plslam_tpu_torch.parallel.batch import local_batch

    keep = _keep(config5)
    arrays, _ = flat(res, keep)  # gathers: every rank takes part
    if mesh.get_local_rank("lm") != 0:
        return None
    cfg = CONFIG5 if config5 else SMALL
    batch = len(cfg["seeds"]) if config5 else 2 * mesh.size(0)
    seeds = cfg.get("seeds") or (0,) * batch
    mine = local_batch(mesh, batch)
    with torch.no_grad():
        rerun = run(None, device, seeds=[seeds[b] for b in mine], config5=config5, n_frames=n_frames,
                    log=lambda *_: None)
        rerun.pop("tracker")
        plain, _ = flat(rerun, keep)
    names = [k for k in plain if not k.startswith("['ms_")]
    differ = [k for k in names if not np.array_equal(arrays[k][mine.start:mine.stop], plain[k],
                                                     equal_nan=plain[k].dtype.kind == "f")]
    return (f"sequences {mine.start}-{mine.stop - 1}: {len(names)} result arrays against the same sequences "
            f"unsharded on one device, {len(differ)} not bit for bit {differ[:8]}; unsharded ms per step "
            f"{[round(t, 3) for t in _ms(plain, 'step')]}, per chain {[round(t, 3) for t in _ms(plain, 'chain')]}")


def _ms(arrays, what):
    return [float(v) for k, v in arrays.items() if k.startswith(f"['ms_{what}']")]


def uneven_errors(mesh, tracker):
    """The errors a mesh raises for a batch that does not divide over seq
    and a landmark axis that does not divide over lm (None where it did
    not raise); `tracker` gives the settings and capacities."""
    from plslam_tpu_torch.parallel.batch import BatchedTracker
    from plslam_tpu_torch.pipeline.tracking import Tracker

    odd = Tracker(tracker.s, device=tracker.device, max_kf=tracker.max_kf, max_pts=tracker.max_pts + 1,
                  max_feat=tracker.max_feat, max_lines=tracker.max_lines, max_maplines=tracker.max_maplines)
    errors = []
    for tr, batch in ((tracker, 2 * mesh.size(0) + 1), (odd, 2 * mesh.size(0))):
        try:
            BatchedTracker(tr, batch=batch, mesh=mesh)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


def flat(res, keep=lambda name: True):
    """The results as {name: numpy} (whole values; only the names `keep`
    accepts) and {name: placements} (DTensors). Every rank calls it: the
    whole values are gathers."""
    from torch.distributed.tensor import DTensor

    arrays, places = {}, {}
    for path, x in pytree.tree_flatten_with_path(res)[0]:
        name = pytree.keystr(path)
        if isinstance(x, DTensor):
            places[name] = ",".join(repr(p) for p in x.placements)
        if keep(name):
            arrays[name] = _np(x) if torch.is_tensor(x) else np.asarray(x)
    return arrays, places


def _keep(config5):
    """Config 5's states after each frame are large: its outputs, chains
    and final state only."""
    return (lambda name: not name.startswith("['state") or name.startswith("['state']")) if config5 else (
        lambda name: True)


def _save(res, out_path, rank, extra=None, keep=lambda name: True):
    arrays, places = flat(res, keep)
    if rank == 0:
        np.savez(out_path, **arrays, **{"placement" + k: np.asarray(v) for k, v in places.items()},
                 **(extra or {}))


def load_carry(path):
    """An .npz of flat keys "state.<field>[.<field>]" and "frame.<field>"
    (tests/data/make_mesh_reference.py) -> run()'s carry: {"state": nested
    dicts, "frame": dict} of numpy arrays."""
    carry = {"state": {}, "frame": {}}
    with np.load(path) as z:
        for key in z.files:
            top, *path_, leaf = key.split(".")
            if top in carry:
                node = carry[top]
                for name in path_:
                    node = node.setdefault(name, {})
                node[leaf] = z[key]
    return carry


def _backend(device):
    """gloo on the CPU, NCCL on cards (one rank per card)."""
    return "gloo" if device == "cpu" else "nccl"


def _profiler(on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _rank_entry(rank, n, device, store_path, out_path, opts):
    import torch.distributed as dist

    from plslam_tpu_torch.parallel.batch import make_mesh

    torch.set_num_threads(1)  # the ranks share the host's cores
    backend = _backend(device)
    small_after = opts.pop("small_after", False)
    if device != "cpu":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank, world_size=n)
    try:
        with torch.no_grad():
            mesh = make_mesh(device=device)
            carry = opts.pop("carry", None)
            carry = None if carry is None else load_carry(carry)
            log = print if rank == 0 else (lambda *_: None)
            before = _launch_counts()
            res = run(mesh, device, carry=carry, log=log, **opts)
            after = _launch_counts()
            counts = {k: after[k] - before[k] for k in after}
            seen = res.pop("kernels_seen", dict.fromkeys(counts, -1))
            errors = uneven_errors(mesh, res.pop("tracker"))
            if small_after:  # the reference dryrun's shapes too, printed only
                run(mesh, device, log=log)
            every = [None] * n
            dist.all_gather_object(every, (counts, seen))
            names = sorted(counts)
            _save(res, out_path, rank, keep=_keep(opts.get("config5")), extra={
                "launches": np.asarray([[c[k] for k in names] for c, _ in every]),
                "kernels_seen": np.asarray([[s[k] for k in names] for _, s in every]),
                "launch_names": np.asarray(names), "mesh_shape": np.asarray(mesh.shape), "backend": np.asarray(backend),
                "uneven_errors": np.asarray([str(e) for e in errors])})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(n: int, device: str, store_path: str, out_path: str, **opts):
    """Start n ranks (torch.multiprocessing.spawn, FileStore rendezvous at
    store_path, which must not exist yet) and run the dry run; rank 0
    writes the results to out_path, with every rank's wrapper launches
    during the run ("launches", by "launch_names") and the B1-B3 kernels
    the profiler saw on its card during frame `profile_frame`
    ("kernels_seen", -1 without). opts: run()'s seeds, config5, n_frames,
    carry (an .npz path, `load_carry`) and profile_frame; small_after: then the dry run at the
    reference's shapes, printed only. One thread per rank."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_entry, args=(n, device, store_path, out_path, opts), nprocs=n, join=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="a CPU mesh over gloo (the kernels' plain twins)")
    ap.add_argument("--config5", action="store_true", help="config 5 (BASELINE.json) at full width")
    ap.add_argument("--frames", type=int, default=None, help="frames per sequence (default 2; config5: 5)")
    ap.add_argument("--out", default=None, help="rank 0 writes the results here (.npz)")
    ap.add_argument("--compare", action="store_true",
                    help="rerun each seq group's sequences unsharded on one rank and compare bit for bit")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from plslam_tpu_torch.parallel.batch import make_mesh

    device = "cpu" if args.cpu else "cuda"
    rank = int(os.environ.get("RANK", 0))
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % max(torch.cuda.device_count(), 1))
    dist.init_process_group(_backend(device))
    try:
        with torch.no_grad():
            mesh = make_mesh(device=device)
            frames = args.frames or (5 if args.config5 else 2)
            res = run(mesh, device, config5=args.config5, n_frames=frames, log=print if rank == 0 else (lambda *_: None))
            res.pop("tracker")
            if rank == 0:
                print(f"ms per sharded step {[round(t, 3) for t in res['ms_step']]}, per chain "
                      f"{[round(t, 3) for t in res['ms_chain']]}")
            if args.out:
                _save(res, args.out, rank, keep=_keep(args.config5))
            if args.compare:
                report = compare_unsharded(mesh, device, res, args.config5, frames)
                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, report)
                for line in every:
                    if line and rank == 0:
                        print(line)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
