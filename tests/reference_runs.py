"""Recorded reference runs for the port's parity tests.

A live run of the JAX reference's `System`, `Tracker`, `BatchedTracker` or
`LoopCloser` inside a test fixture costs minutes of XLA compile on every
run of the suite. Instead, `tests/data/make_<name>_reference.py` runs the
reference once, on the inputs the fixture builds, and writes
`tests/data/<name>_reference.npz` with `save`: the arrays the tests read
or carry across to the port, and the SHA-256 of the inputs (the gray and
depth frames and their timestamps, or a constructed map) they were made
from. The
fixture builds the same inputs from the port's `io/synthetic.py` (or its
own constructed maps) and `load` holds them to that hash before it hands
the arrays back: if the inputs change, the test fails and names the
generator to rerun, instead of comparing with a run on other inputs.
The port's side of every comparison still runs live.

tests/test_torch_references.py (marked slow) reruns each generator and
holds every array to the committed file bit for bit.
"""

from __future__ import annotations

import hashlib
import os
from collections import namedtuple
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
HASH_KEY = "inputs_sha256"
ORDER_KEY, SAME_KEY = "recording.order", "recording.same_as"


def cpu_jax_like_the_tests():
    """The JAX set-up of tests/conftest.py (8 virtual CPU devices, 32-bit),
    for a generator that runs outside pytest. Call before importing JAX."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")
    import jax

    jax.config.update("jax_platforms", "cpu")


def path(name: str) -> Path:
    return DATA / f"{name}_reference.npz"


def inputs_sha256(*arrays) -> str:
    """SHA-256 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def frames_sha256(frames) -> str:
    """inputs_sha256 of a run's inputs: a sequence of tuples of arrays or
    numbers, such as (gray, depth, timestamp)."""
    return inputs_sha256(*(np.asarray(a) for f in frames for a in f))


def flat(prefix: str, tree) -> dict:
    """{"prefix.field.sub": numpy array} of a NamedTuple / mapping tree;
    bf16 leaves (the reference's +-1 descriptor bits) as float32."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(f"{prefix}.{k}", v))
        return out
    a = np.asarray(tree)
    return {prefix: a.astype(np.float32) if a.dtype.name == "bfloat16" else a}


def tree(arrays: dict, prefix: str):
    """What `flat(prefix, ...)` wrote, back as nested NamedTuples of numpy
    arrays, fields in their recorded order."""
    if prefix in arrays:
        return arrays[prefix]
    head = prefix + "."
    names = list(dict.fromkeys(k[len(head):].split(".")[0] for k in arrays if k.startswith(head)))
    if not names:
        raise KeyError(prefix)
    return namedtuple("Recorded", names)(*(tree(arrays, head + n) for n in names))


def flat_rows(prefix: str, rows: list) -> dict:
    """A list of dicts with the same keys (numbers, strings, arrays; None
    where a value is missing) as one array per key, with a ".present" mask
    beside a key that has a None."""
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        if any(v is None for v in vals):
            out[f"{prefix}.{k}.present"] = np.array([v is not None for v in vals])
            fill = np.zeros_like(next((v for v in vals if v is not None), 0))
            vals = [fill if v is None else v for v in vals]
        out[f"{prefix}.{k}"] = np.array(vals)
    return out


def rows(arrays: dict, prefix: str) -> list:
    """What `flat_rows(prefix, ...)` wrote, back as a list of dicts of Python
    numbers, strings and numpy arrays."""
    head = prefix + "."
    keys = [k[len(head):] for k in arrays if k.startswith(head) and not k.endswith(".present")]
    present = {k: arrays.get(f"{head}{k}.present") for k in keys}

    def value(k, i):
        if present[k] is not None and not present[k][i]:
            return None
        v = arrays[head + k][i]
        return v.item() if v.ndim == 0 else v

    return [{k: value(k, i) for k in keys} for i in range(len(arrays[head + keys[0]]))]


def flat_system(prefix: str, snap: dict) -> dict:
    """A System's state and host bookkeeping, as convert.system_from_numpy
    takes them (with `recent_rebase` and `last_frame`, a FrameData or None,
    where present), as flat arrays."""
    out = flat(f"{prefix}.state", snap["state"])
    out[f"{prefix}.kf_bow"] = np.asarray(snap["kf_bow"])
    out[f"{prefix}.timestamps"] = np.array(snap["timestamps"], np.float64)
    out[f"{prefix}.rel_poses"] = np.array(snap["rel_poses"], np.float64).reshape(-1, 4, 4)
    out[f"{prefix}.ref_ids"] = np.array(snap["ref_ids"], np.int64)
    out[f"{prefix}.tracked"] = np.array(snap["tracked"], bool)
    out[f"{prefix}.kf_timestamps.slot"] = np.array(list(snap["kf_timestamps"]), np.int64)
    out[f"{prefix}.kf_timestamps.t"] = np.array(list(snap["kf_timestamps"].values()), np.float64)
    out[f"{prefix}.last_status"] = np.array(snap["last_status"])
    if "recent_rebase" in snap:
        rb = snap["recent_rebase"]
        out[f"{prefix}.recent_rebase.slot"] = np.array(list(rb), np.int64)
        out[f"{prefix}.recent_rebase.to"] = np.array([p for p, _ in rb.values()], np.int64)
        out[f"{prefix}.recent_rebase.M"] = np.array([M for _, M in rb.values()], np.float64).reshape(-1, 4, 4)
    if "last_frame" in snap:
        out[f"{prefix}.has_last_frame"] = np.array(snap["last_frame"] is not None)
        if snap["last_frame"] is not None:
            out.update(flat(f"{prefix}.last_frame", snap["last_frame"]))
    return out


def system(arrays: dict, prefix: str) -> dict:
    """What `flat_system(prefix, ...)` wrote, back in the types the System
    keeps (lists, dicts, Python numbers; the state as NamedTuples)."""
    a = {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + ".")}
    snap = dict(state=tree(arrays, f"{prefix}.state"), kf_bow=a["kf_bow"], timestamps=a["timestamps"].tolist(),
                rel_poses=list(a["rel_poses"]), ref_ids=a["ref_ids"].tolist(), tracked=a["tracked"].tolist(),
                kf_timestamps=dict(zip(a["kf_timestamps.slot"].tolist(), a["kf_timestamps.t"].tolist())),
                last_status=int(a["last_status"]))
    if "recent_rebase.slot" in a:
        snap["recent_rebase"] = {int(j): (int(p), M) for j, p, M in
                                 zip(a["recent_rebase.slot"], a["recent_rebase.to"], a["recent_rebase.M"])}
    if "has_last_frame" in a:
        snap["last_frame"] = tree(arrays, f"{prefix}.last_frame") if a["has_last_frame"] else None
    return snap


def flat_call(name: str, inputs: dict, out) -> dict:
    """A reference call's output under "name.out", and the hash of its
    inputs (a mapping of trees) under "name.inputs_sha256"."""
    return {f"{name}.{HASH_KEY}": np.array(inputs_sha256(*flat("in", inputs).values())), **flat(f"{name}.out", out)}


def call(arrays: dict, name: str, inputs: dict):
    """The recorded output of the reference call `name`, after checking that
    it was made from these inputs."""
    made_from = str(arrays[f"{name}.{HASH_KEY}"])
    assert made_from == inputs_sha256(*flat("in", inputs).values()), (
        f"the inputs of the recorded call {name} changed: rerun its tests/data/make_*_reference.py")
    return tree(arrays, f"{name}.out")


def text(s: str) -> np.ndarray:
    """A text file's contents as uint8, for `save`."""
    return np.frombuffer(s.encode(), np.uint8)


def save(out: Path, inputs_hash: str, arrays: dict) -> None:
    """np.savez_compressed of the arrays and the inputs' hash. An array
    equal to an earlier one (dtype, shape and bytes) is stored once: the
    snapshots of one run share most of their fields."""
    stored, same_as, first = {}, [], {}
    for k, a in arrays.items():
        a = np.asarray(a)
        key = (a.dtype.str, a.shape, hashlib.sha256(a.tobytes()).digest())
        if key in first:
            same_as.append((k, first[key]))
        else:
            first[key], stored[k] = k, a
    np.savez_compressed(out, **{HASH_KEY: np.array(inputs_hash), ORDER_KEY: np.array(list(arrays)),
                                SAME_KEY: np.array(same_as, str).reshape(-1, 2)}, **stored)
    print(f"wrote {out} ({out.stat().st_size} bytes, {len(arrays)} arrays, {len(stored)} stored)")


def read(file: Path) -> dict:
    """Every array `save` wrote, in its order, the inputs' hash first."""
    with np.load(file) as z:
        stored = dict(z)
    same_as = dict(stored.pop(SAME_KEY).tolist())
    order = stored.pop(ORDER_KEY).tolist()
    return {HASH_KEY: stored[HASH_KEY], **{k: stored[same_as[k]].copy() if k in same_as else stored[k] for k in order}}


def load(name: str, inputs_hash: str) -> dict:
    """The recorded arrays of `name`, after checking that they were made
    from inputs with this hash."""
    arrays = read(path(name))
    made_from = str(arrays.pop(HASH_KEY))
    assert made_from == inputs_hash, (
        f"{path(name).name} was recorded on other inputs (sha256 {made_from}, these {inputs_hash}): "
        f"rerun python tests/data/make_{name}_reference.py")
    return arrays
