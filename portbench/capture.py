"""What the correctness check reads from the timed path: a sample, drawn
from the seed, of the frames the window built, of the pose problems
kernel B3 solved in it, and of the local bundle adjustments its keyframe
chains ran.

The entry points the captures at the program's own objects: the
`FrameBuilder.build` of the builder the window drives, the port's pose
solve (`plslam_tpu_torch.solvers.pose.pose_lm`, kernel B3, on the card;
`pose_optimization_plain`, its plain twin, on the CPU), and the `run` of
the local mapper's `LocalBA`. Each is wrapped for the window and
unwrapped after it. A reservoir keeps a uniform sample of k calls over
the whole window; a kept call's inputs and outputs are cloned on the
device (the program's later steps do not touch them). The batched mapper
runs local BA under `torch.func.vmap`: there a kept call holds the whole
batch, read from the physical tensors under vmap's wrappers, and the
entry says which sequences made a keyframe in it.
"""

from __future__ import annotations

import functools

from portbench.reference.local_ba import BA_FIELDS

FRAME_FIELDS = ("uv_raw", "octave", "angle", "desc", "valid", "ln_sp", "ln_ep", "ln_desc", "ln_valid")


class Reservoir:
    """Uniform sample of k of the calls offered, from a numpy Generator."""

    def __init__(self, rng, k: int):
        self.rng, self.k, self.n = rng, k, 0
        self.items: list = []

    def slot(self):
        """The slot the current call goes into, or None to skip it."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.n))
        return j if j < self.k else None


def _clone(x):
    return None if x is None else x.clone()


def _physical(x):
    """(clone of x's values, batched): under vmap the batched tensor's
    values with the batch first, else x itself."""
    from torch._C import _functorch

    if _functorch.is_batchedtensor(x):
        return _functorch.get_unwrapped(x).movedim(_functorch.maybe_get_bdim(x), 0).clone(), True
    return x.clone(), False


class Captures:
    """The window's sampled frame builds and pose solves."""

    def __init__(self, rng, n_frames: int, n_pose: int, n_ba: int):
        self.frames = Reservoir(rng, n_frames)
        self.poses = Reservoir(rng, n_pose)
        self.ba = Reservoir(rng, n_ba)
        self._undo: list = []

    def wrap_builder(self, builder):
        """Keep (build index, gray clone, frame fields) of sampled builds."""
        orig = builder.build
        res = self.frames
        count = [0]

        def build(gray, depth, *args, **kwargs):
            out = orig(gray, depth, *args, **kwargs)
            i = count[0]
            count[0] += 1
            s = res.slot()
            if s is not None:
                res.items[s] = (i, gray.clone(), {f: getattr(out, f).clone() for f in FRAME_FIELDS})
            return out

        builder.build = build
        self._undo.append(lambda: delattr(builder, "build"))

    def wrap_pose(self, module, name: str):
        """Keep (inputs, outputs) of sampled calls of module.<name>, a pose
        solve with pose_lm's signature (Tcw0, pts, K, bf, lines)."""
        orig = getattr(module, name)
        res = self.poses

        def solve(Tcw0, pts, K, bf, lines=None):
            out = orig(Tcw0, pts, K, bf, lines)
            s = res.slot()
            if s is not None:
                res.items[s] = dict(
                    Tcw0=Tcw0.clone(), pts=tuple(f.clone() for f in pts),
                    lines=None if lines is None else tuple(f.clone() for f in lines),
                    K=[[float(v) for v in row] for row in (K.tolist() if hasattr(K, "tolist") else K)],
                    bf=float(bf), Tcw=out[0].clone(), pin=out[1].clone(), lin=_clone(out[2]))
            return out

        functools.update_wrapper(solve, orig)  # its attributes too: pose_lm counts its launches on itself
        setattr(module, name, solve)
        self._undo.append(lambda: setattr(module, name, orig))

    def wrap_local_ba(self, ba, made_keyframe=None):
        """Keep (the BA_FIELDS of the map given, k, kf_pose returned) of
        sampled calls of ba.run; under vmap each with its batch axis first,
        and made_keyframe() (bool[B], asked at the call) says which
        sequences' results count."""
        orig = ba.run
        res = self.ba

        def run(m, k):
            s = res.slot()
            if s is None:
                return orig(m, k)
            inp = {f: _physical(getattr(m, f)) for f in BA_FIELDS}
            k_in = _physical(k) if hasattr(k, "shape") else (k, False)
            out = orig(m, k)
            res.items[s] = dict(inp=inp, k=k_in, kf_pose=_physical(out.kf_pose),
                                made=None if made_keyframe is None else made_keyframe())
            return out

        ba.run = run
        self._undo.append(lambda: delattr(ba, "run"))

    def uninstall(self):
        while self._undo:
            self._undo.pop()()
