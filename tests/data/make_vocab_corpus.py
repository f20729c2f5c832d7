"""Write tests/data/vocab_corpus_ref.npz: the reference's vocabulary
training corpus, the descriptors `plslam_tpu.loopclosing.train_vocab.
harvest_descriptors()` gives at its defaults (16 scenes x 8 frames,
320x240; JAX on the CPU), with the count of each frame's descriptors.
The shipped codebook is `train_tree` of exactly these descriptors.
chip_smoke.py's vocab phase holds the port's harvest on the card to it.

    python tests/data/make_vocab_corpus.py      # ~40 s on a CPU
"""

import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

jax.config.update("jax_platforms", "cpu")

from plslam_tpu.features import orb  # noqa: E402
from plslam_tpu.loopclosing import train_vocab  # noqa: E402

OUT = Path(__file__).resolve().parent / "vocab_corpus_ref.npz"


def main():
    per_frame, call = [], orb.ORBExtractor.__call__

    def counting(self, gray):
        fs = call(self, gray)
        per_frame.append(int(np.asarray(fs.valid).sum()))
        return fs

    orb.ORBExtractor.__call__ = counting
    try:
        desc = train_vocab.harvest_descriptors()
    finally:
        orb.ORBExtractor.__call__ = call
    assert sum(per_frame) == len(desc)
    words = np.load(train_vocab.ASSET)["words"]
    assert np.array_equal(train_vocab.train_tree(desc), words), "the corpus does not give the shipped codebook"
    np.savez_compressed(OUT, desc=desc, per_frame=np.asarray(per_frame, np.int32))
    print(f"{len(desc)} descriptors from {len(per_frame)} frames -> {OUT}")


if __name__ == "__main__":
    main()
