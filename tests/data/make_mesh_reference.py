"""Write tests/data/mesh_reference.npz: the reference's sharded batched
step on the port's synthetic frames, for tests/test_torch_mesh.py.

The reference's `BatchedTracker` on `make_mesh(4)` (seq 2, lm 2; 8
virtual CPU devices, as tests/conftest.py provisions them) at
`__graft_entry__.dryrun_multichip`'s shapes, on the gray and depth of
frames 0 and 1 of the port's `SyntheticSequence` for seeds 3, 7, 11, 5
(`plslam_tpu_torch.eval.dryrun_mesh.sequence`, 192x256). Keys: "out0.*"
and "out1.*", the StepOut of each frame; "state.*" (nested fields joined
by "."), the state after frame 0; "frame.*", the FrameData of frame 1
(bf16 fields as float32). The port's test carries the last two across.

    python tests/data/make_mesh_reference.py      # ~40 s on a CPU
"""

import dataclasses
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

jax.config.update("jax_platforms", "cpu")

from plslam_tpu.config import Settings  # noqa: E402
from plslam_tpu.features.frame import FrameBuilder  # noqa: E402
from plslam_tpu.parallel import batch  # noqa: E402
from plslam_tpu.pipeline.tracking import Tracker  # noqa: E402
from plslam_tpu_torch.eval import dryrun_mesh  # noqa: E402

OUT = Path(__file__).resolve().parent / "mesh_reference.npz"
SEEDS = (3, 7, 11, 5)


def _flat(prefix, tree):
    if hasattr(tree, "_asdict"):
        out = {}
        for k, v in tree._asdict().items():
            out.update(_flat(f"{prefix}.{k}", v))
        return out
    a = np.asarray(tree)
    return {prefix: a.astype(np.float32) if a.dtype.name == "bfloat16" else a}


def main():
    seqs = [dryrun_mesh.sequence(s, 2) for s in SEEDS]
    small = dryrun_mesh.SMALL
    js = Settings(**dataclasses.asdict(dataclasses.replace(seqs[0].settings, n_features=small["n_features"])))
    jb = FrameBuilder(js, capacity=small["capacity"], line_capacity=small["line_capacity"])
    mesh = batch.make_mesh(4)
    bt = batch.BatchedTracker(Tracker(js, **small["caps"]), batch=len(SEEDS), mesh=mesh)
    seq_spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("seq"))
    st, out = bt.init_state(), {}
    for i in range(2):
        f = jax.tree.map(lambda *xs: jnp.stack(xs), *[jb(jnp.asarray(g), jnp.asarray(d))
                                                     for g, d, _ in (q.frame(i) for q in seqs)])
        if i == 1:
            out.update(_flat("state", st))
            out.update(_flat("frame", f))
        st, o = bt.step(st, jax.device_put(f, seq_spec))
        out.update(_flat(f"out{i}", o))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    main()
