"""Precision helper.

`mm` is the port of plslam_tpu/utils/precision.py: a float32 product with
TF32 off (the package disables TF32 on import), so small rotation algebra
and LM systems keep full single precision.
"""

import torch


def mm(a, b):
    """float32 matmul at full precision (TF32 is off package-wide)."""
    return torch.matmul(a, b)
