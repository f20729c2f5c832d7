"""The import guard: a run fails if JAX or the JAX package got loaded.

The port (`plslam_tpu_torch`) and this benchmark use PyTorch only. The
check compares the top-level name of every entry of `sys.modules` (the
part before the first dot) whole with the forbidden names, so
`plslam_tpu_torch` is not taken for `plslam_tpu`.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "plslam_tpu"})


class Loaded(Exception):
    """A forbidden module is loaded in this process."""


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names found in `modules` (default:
    sys.modules), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def require_clean(when: str, modules=None):
    """Raise `Loaded`, naming what was found, if a forbidden module is loaded."""
    found = loaded(modules)
    if found:
        raise Loaded(f"{', '.join(found)} loaded {when}; the benchmark runs the PyTorch port only")
