"""Carry the reference's state across to the port.

This system has no weights; what crosses over is state. The reference's
`TrackState` / `MapState` / `FrameData` pytrees, handed over as nested
mappings (or NamedTuples) of numpy arrays, become the port's NamedTuples
of tensors on `device`, field by field. bf16 arrays (the reference's +-1
descriptor bits) become float32; everything else keeps its dtype.
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
