"""plslam_tpu_torch — the PyTorch + CUDA port of plslam_tpu for one NVIDIA H100.

The JAX package `plslam_tpu` is the reference; this package reproduces its
behaviour with the same fixed-capacity masked state and the same thresholds.
It imports torch and numpy only (never JAX, never `plslam_tpu`). Every Pallas
kernel on the ported path is a hand-written CUDA kernel under `csrc/`, built
by `_build.py` with one `nvcc` call and bound with ctypes; each kernel has a
plain PyTorch twin that is the only path for CPU tensors.

Ported so far (the point-only tracking step, configs/TUM1.yaml):
    from plslam_tpu_torch import load_settings
    from plslam_tpu_torch.features.frame import FrameBuilder
    from plslam_tpu_torch.pipeline.tracking import Tracker
    builder = FrameBuilder(settings)            # device="cuda" by default
    tracker = Tracker(settings)
    state = tracker.init_state()
    state, out = tracker.step(state, builder(gray, depth))
"""

import torch

from plslam_tpu_torch.config import Settings, load_settings  # noqa: F401

# The reference pins full-f32 products for geometry and image resampling
# (plslam_tpu/utils/precision.py, ops/pyramid.py); TF32 keeps ~10 mantissa
# bits and would move keypoints and pose solves.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
__all__ = ["Settings", "load_settings", "__version__"]
