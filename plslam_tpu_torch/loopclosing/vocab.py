"""Bag-of-words vocabulary: a flat binary codebook, BoW vectors and the
DBoW2 L1 score.

Port of plslam_tpu/loopclosing/vocab.py. The reference replaces DBoW2's
vocabulary tree by a flat codebook of W binary words: a descriptor's word
is its Hamming-nearest codeword (one [N, 256] x [W, 256] product of +-1
bits, `matching/points.py hamming_matrix`, exact in float32), ties to the
lowest word index as `argmin` keeps them; a BoW vector is the normalised
word histogram.

The codebook is the reference's trained asset, of which the port keeps its
own byte-equal copy (`plslam_tpu_torch/assets/orbvoc_tpu.npz`); without
it, the reference's seeded LSH codebook is drawn instead.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from plslam_tpu_torch.matching.points import hamming_matrix
from plslam_tpu_torch.ops import brief

ASSET = Path(__file__).resolve().parent.parent / "assets" / "orbvoc_tpu.npz"
_VOCAB_SEED = 0xB0C4B


def _lsh_words(n_words: int) -> np.ndarray:
    rs = np.random.RandomState(_VOCAB_SEED)
    return rs.randint(0, 256, (n_words, 32)).astype(np.uint8)


class Vocabulary:
    def __init__(self, n_words: int = 4096, words: np.ndarray | None = None, device="cpu"):
        if words is None:
            words = trained_words()  # the trained k-medians asset
        if words is None:  # no asset: seeded LSH codebook
            words = _lsh_words(n_words)
        self.words = words
        self.n_words = words.shape[0]
        self.device = torch.device(device)
        self._pm1 = brief.unpack_bits_pm1(torch.from_numpy(np.ascontiguousarray(words))).to(self.device)

    def to(self, device) -> "Vocabulary":
        """The same codebook with its +-1 bits on `device`."""
        return Vocabulary(words=self.words, device=device)

    def quantize(self, desc_pm1, valid):
        """[N, 256] +-1 descriptors -> word ids i32[N] (-1 for invalid)."""
        D = hamming_matrix(desc_pm1, self._pm1)  # [N, W]
        wid = torch.argmin(D, 1).to(torch.int32)  # the first minimum, as jnp.argmin
        return torch.where(valid, wid, -1)

    def bow(self, desc_pm1, valid):
        """-> L1-normalised BoW vector f32[W]."""
        wid = self.quantize(desc_pm1, valid)
        hist = torch.zeros(self.n_words + 1, dtype=torch.float32, device=wid.device)
        hist.index_add_(0, torch.where(wid >= 0, wid, self.n_words).long(),
                        torch.ones(wid.shape[0], dtype=torch.float32, device=wid.device))
        hist = hist[: self.n_words]
        return hist / torch.clamp(torch.sum(hist), min=1.0)


@functools.lru_cache(maxsize=1)
def trained_words() -> np.ndarray | None:
    """The trained codebook (the reference's equivalent of ORBvoc.txt), or
    None if the asset is absent."""
    if not ASSET.exists():
        return None
    return np.load(ASSET)["words"]


def random_vocabulary(n_words: int = 4096) -> Vocabulary:
    """The untrained seeded-LSH baseline (for A/B tests)."""
    return Vocabulary(words=_lsh_words(n_words))


def l1_score(bow_a, bow_b):
    """DBoW2 L1 similarity s = 1 - 0.5 |u - v|_1 in [0, 1]; bow_a, bow_b
    f32[W] or [K, W], broadcast."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_a - bow_b), -1)
