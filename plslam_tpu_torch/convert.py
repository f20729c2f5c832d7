"""Carry the reference's state across to the port.

This system has no weights; what crosses over is state. The reference's
`TrackState` / `MapState` / `FrameData` pytrees, handed over as nested
mappings (or NamedTuples) of numpy arrays, become the port's NamedTuples
of tensors on `device`, field by field. bf16 arrays (the reference's +-1
descriptor bits) become float32; everything else keeps its dtype. The
relocalizer's BoW database, a loop closer's detection and closure state
and a `System`'s host-side bookkeeping cross over as numpy arrays and
lists.
"""

from __future__ import annotations

import numpy as np
import torch

from plslam_tpu_torch.features.frame import FrameData
from plslam_tpu_torch.pipeline.tracking import LastFrame, TrackState
from plslam_tpu_torch.slammap.state import MapState
from plslam_tpu_torch.utils.device import resolve_device


def _fields(d):
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a writable copy; keeps 0-d


def _convert(cls, d, device, nested=None):
    f = _fields(d)
    missing = set(cls._fields) - set(f)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    nested = nested or {}
    return cls(**{
        k: (nested[k](f[k]) if k in nested else _tensor(f[k], device)) for k in cls._fields
    })


def map_state_from_numpy(d, device="cuda") -> MapState:
    return _convert(MapState, d, resolve_device(device))


def track_state_from_numpy(d, device="cuda") -> TrackState:
    """Reference TrackState (numpy leaves) -> the port's TrackState."""
    dev = resolve_device(device)
    return _convert(TrackState, d, dev, nested={
        "m": lambda x: map_state_from_numpy(x, dev),
        "last": lambda x: _convert(LastFrame, x, dev),
    })


def frame_from_numpy(d, device="cuda") -> FrameData:
    """Reference FrameData (numpy leaves) -> the port's FrameData."""
    return _convert(FrameData, d, resolve_device(device))


def loop_closer_from_numpy(loop, g_mask, g_consist, loop_edges, kf_counter, last_loop_kfn, n_loops_closed,
                           gba_queue, gba_k):
    """Load a reference `LoopCloser`'s state into the port's: the
    consistency groups (`_g_mask` bool[G, K], `_g_consist` i32[G]), the
    accepted loop edges, the keyframe counter, the keyframe count at the
    last closure, the closures so far and the pending global-BA slices with
    their keyframe (`gba_queue`, `_gba_k`). The BoW rows cross with
    `system_from_numpy` (a LoopCloser is the System's relocalizer)."""
    loop._g_mask = _tensor(g_mask, loop.device).to(torch.bool)
    loop._g_consist = _tensor(g_consist, loop.device).to(torch.int32)
    loop._loop_edges = [(int(a), int(b)) for a, b in loop_edges]
    loop._kf_counter = int(kf_counter)
    loop.last_loop_kfn = int(last_loop_kfn)
    loop.n_loops_closed = int(n_loops_closed)
    loop.gba_queue = [(int(i1), int(i2), bool(e)) for i1, i2, e in gba_queue]
    loop._gba_k = int(gba_k)
    return loop


def system_from_numpy(system, state, kf_bow, timestamps, rel_poses, ref_ids, tracked, kf_timestamps,
                      last_status, recent_rebase=None, loop=None):
    """Load a reference `System`'s state into a port `System`: its
    TrackState (numpy leaves), its relocalizer's BoW rows (`kf_bow`,
    f32[max_kf, W]) and its host bookkeeping (`_timestamps`, `_rel_poses`,
    `_ref_ids`, `_tracked`, `_kf_timestamps`, `_last_status`, and the
    culled-keyframe substitutions `_recent_rebase`: slot -> (surviving
    slot, 4x4 rebase transform)), and with loop closing on the loop
    closer's state (`loop`: the keyword arguments of
    `loop_closer_from_numpy`), so that both continue from one state. The
    port's System has no past frame to relocalize until its next
    track_rgbd."""
    system.state = track_state_from_numpy(state, system.device)
    system._reloc.load_database(np.asarray(kf_bow, np.float32))
    system._timestamps = [float(t) for t in timestamps]
    system._rel_poses = [np.asarray(T, np.float64).reshape(4, 4) for T in rel_poses]
    system._ref_ids = [int(r) for r in ref_ids]
    system._tracked = [bool(f) for f in tracked]
    system._kf_timestamps = {int(k): float(t) for k, t in dict(kf_timestamps).items()}
    system._last_status = int(last_status)
    system._recent_rebase = {int(j): (int(p), np.asarray(M, np.float64).reshape(4, 4))
                             for j, (p, M) in dict(recent_rebase or {}).items()}
    system._last_frame = None
    # what the System knows of the status picks the step's init/track branch
    system._initialised = int(np.asarray(_fields(state)["status"])) != 0
    system.localization_only = bool(np.asarray(_fields(state)["only_tracking"]))
    if loop is not None:
        loop_closer_from_numpy(system._loop, **loop)
        system.n_loops_closed = system._loop.n_loops_closed
    return system
