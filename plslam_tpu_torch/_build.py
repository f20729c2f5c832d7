"""Build and load the port's CUDA kernels.

All `csrc/*.cu` sources go through ONE nvcc call into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so the
build takes seconds). The library lands in `.torch_build/` beside the
package, named by a hash of the sources and flags, and is built at first
use; a process builds it at most once. Every C entry returns
`cudaGetLastError()` after its launch and `check` raises on a non-zero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".torch_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
last_build = {}  # what the last build in this process did: seconds, path, ptxas report

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
_SIGNATURES = {
    # stack, hi, lo, blur, L, H, W, th_hi, th_lo, live_h*, live_w*, gauss7*, stream
    "plslam_fast_blur_stack": [P, P, P, P, I, I, I, F, F, P, P, P, P],
    # img, yx, out, H, W, K, size, stream
    "plslam_gather_patches": [P, P, P, I, I, I, I, P],
    # Tcw0, xw, obs, isig, stereo, valid, N, sw, ew, l2d, isig_l, lvalid, L,
    # fx, fy, cx, cy, bf, rounds, sched*, Tcw_out, pin, lin, stream
    "plslam_pose_lm": [P, P, P, P, P, P, I, P, P, P, P, P, I, F, F, F, F, F, I, P, P, P, P, P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if no build of these exact sources exists."""
    import time

    out = BUILD_DIR / f"libplslam_kernels_{_digest()}.so"
    if out.exists():
        last_build.update(seconds=0.0, path=str(out), cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    last_build.update(seconds=time.perf_counter() - t0, path=str(out), cached=False,
                      log=proc.stdout + proc.stderr)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.plslam_error_string.argtypes = [ctypes.c_int]
            lib.plslam_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str):
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = _lib.plslam_error_string(rc).decode() if _lib is not None else "?"
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
