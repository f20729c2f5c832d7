"""Map-state snapshots: the whole TrackState in one npz file.

Port of plslam_tpu/io/snapshot.py. The keys are the reference's dotted
field paths (`m.kf_pose`, `last.lm_idx`, `status`, ...) and host-side
arrays stored beside the state go under `extra.` (System stores the
per-slot keyframe timestamps and the BoW rows there). Every leaf is
written in the reference's dtype and shape, so a snapshot written by
either package loads in the other; the file holds numpy arrays only, so
it does not depend on the device it was written from or is loaded onto.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# torch dtype -> the dtype the reference keeps the field in. The port keeps
# every TrackState field in the reference's dtype; a field it ever keeps
# otherwise gets its conversion here, at the file boundary.
_FILE_DTYPE = {
    torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32, torch.int64: np.int64,
    torch.uint8: np.uint8, torch.bool: np.bool_,
}


def _flatten(prefix: str, tree) -> dict:
    """NamedTuple tree -> {dotted path: numpy array in the file's dtype}."""
    out = {}
    if hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            out.update(_flatten(f"{prefix}{k}.", v))
    elif torch.is_tensor(tree):
        out[prefix[:-1]] = tree.detach().cpu().numpy().astype(_FILE_DTYPE[tree.dtype], copy=False)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_state(path: str | Path, state, extra: dict | None = None) -> None:
    """TrackState (or any NamedTuple tree of tensors) -> npz; `extra`: host
    arrays stored beside it under an `extra.` prefix."""
    flat = _flatten("", state)
    for k, v in (extra or {}).items():
        flat[f"extra.{k}"] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    np.savez_compressed(path, **flat)


def load_state(path: str | Path, template, want_extra: bool = False):
    """npz -> a tree shaped like `template` (a live TrackState: it gives the
    structure, the dtypes and the device). A field the file lacks (a
    snapshot from an older schema) keeps the template's value.

    want_extra=True -> (tree, extras): every `extra.`-prefixed array of the
    file, numpy, without the prefix (empty for older snapshots)."""
    with np.load(path) as data:
        files = set(data.files)

        def rebuild(prefix: str, node):
            if hasattr(node, "_asdict"):
                return type(node)(**{k: rebuild(f"{prefix}{k}.", v) for k, v in node._asdict().items()})
            key = prefix[:-1]
            if key not in files:
                return node.clone()
            a = np.asarray(data[key])
            if tuple(a.shape) != tuple(node.shape):
                raise ValueError(f"snapshot field {key}: shape {a.shape}, the live state has {tuple(node.shape)}")
            return torch.from_numpy(np.array(a, order="C")).to(node.device, node.dtype)

        tree = rebuild("", template)
        if not want_extra:
            return tree
        extras = {k[len("extra."):]: np.array(data[k]) for k in files if k.startswith("extra.")}
    return tree, extras
