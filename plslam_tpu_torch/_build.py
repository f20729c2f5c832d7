"""Build and load the port's CUDA kernels and the host line detector.

Each `csrc/*.cu` source is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library lands in `.torch_build/` beside the package, named
by a hash of the sources and flags, and is built at first use; a process
builds it at most once. Every C entry returns
`cudaGetLastError()` after its launch and `check` raises on a non-zero
code.

The host LSD (`native/lsd.cpp`, the reference's native line detector,
read and never edited) is built by g++ with native/Makefile's flags into
`.torch_build/liblsd_<hash>.so` at first use, beside the CUDA library and
never into `native/build/`.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LSD_SOURCE = _PKG.parent / "native" / "lsd.cpp"
LSD_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]  # native/Makefile's CXXFLAGS

_lock = threading.Lock()
_lib = None
_lsd = None
last_build = {}  # what the last build in this process did: seconds, path, ptxas report

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
_SIGNATURES = {
    # stack, hi, lo, blur, L, H, W, th_hi, th_lo, live_h*, live_w*, gauss7*, stream
    "plslam_fast_blur_stack": [P, P, P, P, I, I, I, F, F, P, P, P, P],
    # img, hi, lo, H, W, th_hi, th_lo, stream
    "plslam_fast_scores": [P, P, P, I, I, F, F, P],
    # img, yx, out, H, W, K, size, stream
    "plslam_gather_patches": [P, P, P, I, I, I, I, P],
    # Tcw0, xw, obs, isig, stereo, valid, N, sw, ew, l2d, isig_l, lvalid, L,
    # problems, strides*, fx, fy, cx, cy, bf, rounds, sched*, Tcw_out, pin, lin, stream
    "plslam_pose_lm": [P, P, P, P, P, P, I, P, P, P, P, P, I, I, P, F, F, F, F, F, I, P, P, P, P, P],
    # out: the most row bytes one pose_lm problem may stage
    "plslam_pose_lm_smem_limit": [P],
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
    report = out.with_suffix(".log")  # the build's nvcc / ptxas output, kept beside it
    if out.exists():
        last_build.update(seconds=0.0, path=str(out), cached=True,
                          log=report.read_text() if report.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        # one nvcc per source, all at once; then one link
        jobs = []
        for src in sources():
            obj = Path(work) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                    text=True)))
        log, failed = "", []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = Path(work) / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        report.write_text(log)  # before the library: a cached library always has its report
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    last_build.update(seconds=time.perf_counter() - t0, path=str(out), cached=False, log=log)
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


def build_lsd() -> Path:
    """Compile native/lsd.cpp if no build of this source with these flags
    exists. Raises if there is no compiler or the build fails."""
    digest = hashlib.sha256((" ".join(LSD_FLAGS) + "\n").encode() + LSD_SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"liblsd_{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host LSD (native/lsd.cpp) needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / out.name
        cmd = [cxx, *LSD_FLAGS, "-o", str(tmp), str(LSD_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def lsd_library():
    """The loaded host LSD (built on first use); `lsd_detect` as
    native/lsd.cpp declares it."""
    global _lsd
    with _lock:
        if _lsd is None:
            lib = ctypes.CDLL(str(build_lsd()))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.lsd_detect.restype = ctypes.c_int
            lib.lsd_detect.argtypes = [fp, I, I, fp, I, F, F, F, F]
            _lsd = lib
        return _lsd
