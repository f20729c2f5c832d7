"""The benchmark's CPU tests: `python -m pytest -q -p no:cacheprovider portbench/tests`
from the repository's root (tests marked `cuda` need the card and skip
without one)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture()
def card():
    """The card, or a skip where there is none (decided in the test, never
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels and TF32 exist only there)")
    return torch.device("cuda")
