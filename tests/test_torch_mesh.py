"""Port parity, the (seq, lm) device mesh of parallel/batch.py on the CPU.

One module-scoped run of eval/dryrun_mesh.py on a 2x2 gloo mesh (4 ranks
started by `dryrun_mesh.spawn`, one thread each; seq 2, lm 2, batch 4,
sequences of seeds 3, 7, 11, 5) at the reference dryrun's shapes (192x256,
n_features 120, capacity 128, line capacity 16, max_kf 8, max_pts 512,
max_maplines 64): a first step, the mapper chain, a second step, the
self-revisit loop gate, and two more steps from the state after frame 0:
on the port's frame 1 without the chain, and on the reference's state and
frame 1 carried across (`convert`, `BatchedTracker.shard_state`). Beside
it the same run unsharded (`dryrun_mesh.run(None, ...)`, one thread). The
reference's sharded step on the same gray and depth (its BatchedTracker
on `make_mesh(4)` over 8 virtual CPU devices: frames 0 and 1, its state
after frame 0 and its frame 1) is tests/data/mesh_reference.npz, written
by tests/data/make_mesh_reference.py: tracing and compiling it takes ~20 s
of the suite's time on every run, which the JAX cache does not save.

Tolerances:
  * sharded against unsharded: every flag, index and count equal, every
    float bit for bit (no float sum crosses ranks: DTensor gathers the
    landmark blocks whole and its argmin/argmax pick the first minimum);
  * against the reference's sharded step on the port's frames: flags
    equal, poses within 1e-3 m (the two front ends agree to float32
    rounding, as tests/test_torch_parallel.py states);
  * from the reference's state and frame carried across: within 1e-4 m.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from plslam_tpu.parallel import batch as jbatch
from plslam_tpu_torch.eval import dryrun_mesh
from plslam_tpu_torch.parallel.batch import make_mesh, mesh_shape
from plslam_tpu_torch.pipeline import tracking
from plslam_tpu_torch.slammap.state import MapState

torch.set_num_threads(2)

SEEDS = (3, 7, 11, 5)  # tests/data/make_mesh_reference.py's
REFERENCE = Path(__file__).resolve().parent / "data" / "mesh_reference.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    with np.load(REFERENCE) as z:
        ref = [{k[len(f"out{i}."):]: z[k] for k in z.files if k.startswith(f"out{i}.")} for i in range(2)]
    out = os.path.join(tmp, "mesh.npz")
    dryrun_mesh.spawn(4, "cpu", os.path.join(tmp, "store"), out, seeds=SEEDS, carry=str(REFERENCE))
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            plain = dryrun_mesh.run(None, "cpu", seeds=SEEDS, carry=dryrun_mesh.load_carry(REFERENCE),
                                    log=lambda *_: None)
            plain.pop("tracker")
            plain_arrays, _ = dryrun_mesh.flat(plain)
    finally:
        torch.set_num_threads(2)
    with np.load(out) as z:
        mesh = dict(z)
    return dict(mesh=mesh, plain=plain_arrays, ref=ref)


def _group(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def test_mesh_shape_rule():
    """mesh_shape gives the reference make_mesh's (seq, lm) for n devices;
    make_mesh itself needs a process group."""
    for n in (1, 2, 4, 8):
        ref = jbatch.make_mesh(n)
        assert mesh_shape(n) == (ref.shape["seq"], ref.shape["lm"]), n
    with pytest.raises(RuntimeError):
        make_mesh(4, device="cpu")


def test_sharded_equals_unsharded(runs):
    """Steps 0 and 1, the step without the chain and the carried step: the
    sharded run's outputs equal the unsharded run's exactly, and the state
    rests in the reference's placements."""
    mesh, plain = runs["mesh"], runs["plain"]
    for name in ("['out0']", "['out1']", "['unmapped1']", "['carried']"):
        got, want = _group(mesh, name), _group(plain, name)
        assert got.keys() == want.keys() and got, name
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name + k)
    assert np.asarray(mesh["['out0'].tracked"]).all() and np.asarray(mesh["['out1'].tracked"]).all()
    places = {k[len("placement['state']"):]: str(v) for k, v in mesh.items() if k.startswith("placement['state']")}
    assert len(places) == len(tracking.TrackState._fields) - 2 + len(MapState._fields) + len(tracking.LastFrame._fields)
    for leaf, p in places.items():
        lm = ".m.pt_" in leaf and mesh["['state']" + leaf].ndim >= 2
        assert p == ("Shard(dim=0),Shard(dim=1)" if lm else "Shard(dim=0),Replicate()"), leaf


def test_sharded_step_equals_reference(runs):
    """Frames 0 and 1 (without the chain) against the reference's
    BatchedTracker on make_mesh(4)."""
    mesh, ref = runs["mesh"], runs["ref"]
    for name, r in (("['out0']", ref[0]), ("['unmapped1']", ref[1])):
        for f in ("tracked", "new_kf", "kf_id", "ref_kf"):
            np.testing.assert_array_equal(mesh[f"{name}.{f}"], r[f], err_msg=name + f)
        np.testing.assert_array_equal(mesh[f"{name}.telemetry"][:, tracking.TEL_STATUS],
                                      r["telemetry"][:, tracking.TEL_STATUS])
        np.testing.assert_allclose(mesh[f"{name}.Tcw"], r["Tcw"], atol=1e-3, err_msg=name)


def test_carried_reference_state_step(runs):
    """The reference's sharded state after frame 0 and its frame 1, carried
    across and sharded with shard_state / shard_frames: the port's sharded
    step gives the reference's frame 1."""
    mesh, r = runs["mesh"], runs["ref"][1]
    for f in ("tracked", "new_kf", "n_inliers", "n_matches"):
        np.testing.assert_array_equal(mesh[f"['carried'].{f}"], r[f], err_msg=f)
    np.testing.assert_allclose(mesh["['carried'].Tcw"], r["Tcw"], atol=1e-4)


def test_sharded_chain_and_gate_equal_unsharded(runs):
    """The mapper chain, the masked chain (do False: the input map bit for
    bit), the BoW rows and the loop gate, sharded against unsharded; the
    self-revisit gate rejects."""
    mesh, plain = runs["mesh"], runs["plain"]
    for name in ("['chain0']", "['masked']", "['kf_bow']", "['gate']", "['state']"):
        got, want = _group(mesh, name), _group(plain, name)
        assert got.keys() == want.keys() and got, name
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name + k)
    pre = _group(mesh, "['state0'].m")
    for k, v in _group(mesh, "['masked']").items():
        np.testing.assert_array_equal(v, pre[k], err_msg=k)
    assert any(not np.array_equal(v, pre[k]) for k, v in _group(mesh, "['chain0']").items())
    assert not mesh["['gate'][0]"].any()
    np.testing.assert_allclose(mesh["['gate'][2]"][:, 0], 1.0, atol=1e-5)


def test_uneven_mesh_raises(runs):
    """A batch that does not divide over seq, and a landmark axis that does
    not divide over lm: ValueError on the ranks."""
    errors = [str(e) for e in runs["mesh"]["uneven_errors"]]
    assert len(errors) == 2 and all(e != "None" for e in errors), errors
    assert "seq" in errors[0] and "lm" in errors[1]
