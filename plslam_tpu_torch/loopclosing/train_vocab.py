"""Vocabulary training: hierarchical k-medians over binary descriptors.

Port of plslam_tpu/loopclosing/train_vocab.py. The vocabulary asset is a
flat codebook: the leaves of a hierarchical k-medians tree (k = C.VOCAB_K,
depth = C.VOCAB_L) over ORB descriptors harvested from rendered synthetic
scenes (and, given a folder of TUM RGB-D sequences, from their frames).
Binary k-medians: a centre is the per-bit majority vote (the median in
Hamming space), a descriptor goes to its Hamming-nearest centre, an empty
cluster is reseeded from the farthest point. The clustering is numpy, as
in the reference, and gives its codebook bit for bit from the same
descriptors; the harvest runs the port's ORB extractor (kernels B1 and B2
on the card).

    python -m plslam_tpu_torch.loopclosing.train_vocab [--tum DIR] [--out FILE] [--cpu]

writes the port's own asset, plslam_tpu_torch/assets/orbvoc_tpu.npz, by
default (`loopclosing/vocab.py` loads it).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from plslam_tpu_torch import constants as C
from plslam_tpu_torch.loopclosing.vocab import ASSET
from plslam_tpu_torch.utils.device import resolve_device


def _unpack(desc_u8: np.ndarray) -> np.ndarray:
    """u8[N, 32] -> u8[N, 256] bits (LSB-first per byte, as ops/brief.py
    packs them)."""
    bits = (desc_u8[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    return bits.reshape(desc_u8.shape[0], -1)


def _pack(bits: np.ndarray) -> np.ndarray:
    """u8[K, 256] bits -> u8[K, 32]."""
    b = bits.reshape(bits.shape[0], 32, 8).astype(np.uint16)
    return (b << np.arange(8, dtype=np.uint16)).sum(-1).astype(np.uint8)


def _hamming(b, centers):
    """Hamming distances i32[N, k] from 0/1 bit rows, as dot products."""
    c = centers.astype(np.int32)
    return b @ (1 - 2 * c).T + c.sum(1)[None, :]


def kmedians(bits: np.ndarray, k: int, rng, n_iter: int = 8):
    """Binary k-medians on u8[N, 256] bit rows -> (centers u8[k, 256],
    assign i64[N])."""
    N = bits.shape[0]
    k = min(k, N)
    centers = bits[rng.choice(N, k, replace=False)].astype(np.uint8)
    b = bits.astype(np.int32)
    for _ in range(n_iter):
        d = _hamming(b, centers)
        assign = d.argmin(1)
        new = np.zeros_like(centers)
        for j in range(k):
            sel = bits[assign == j]
            if len(sel) == 0:  # reseed from the farthest point
                new[j] = bits[d.min(1).argmax()]
            else:
                new[j] = (sel.mean(0) >= 0.5).astype(np.uint8)
        if (new == centers).all():
            break
        centers = new
    return centers, _hamming(b, centers).argmin(1)


def train_tree(desc_u8: np.ndarray, k: int = C.VOCAB_K, depth: int = C.VOCAB_L,
               seed: int = 0, min_node: int = 20) -> np.ndarray:
    """Descriptors u8[N, 32] -> leaf centres u8[W, 32] (the flat codebook)."""
    rng = np.random.default_rng(seed)
    bits = _unpack(desc_u8)
    leaves: list[np.ndarray] = []

    def split(rows: np.ndarray, level: int):
        if level == depth or len(rows) < max(min_node, k):
            leaves.append((bits[rows].mean(0) >= 0.5).astype(np.uint8))
            return
        centers, assign = kmedians(bits[rows], k, rng)
        for j in range(centers.shape[0]):
            sub = rows[assign == j]
            if len(sub):
                split(sub, level + 1)

    split(np.arange(len(bits)), 0)
    return _pack(np.stack(leaves))


def _descriptors(ext, gray: np.ndarray, device) -> np.ndarray:
    """The valid ORB descriptors u8[n, 32] of one f32 image."""
    fs = ext(torch.from_numpy(np.ascontiguousarray(gray, np.float32)).to(device))
    return fs.desc[fs.valid].cpu().numpy()


def harvest_descriptors(n_seeds: int = 16, frames_per_seed: int = 8, height: int = 240, width: int = 320,
                        seed_base: int = 100, device="cuda") -> np.ndarray:
    """ORB descriptors of rendered synthetic scenes, the training corpus:
    n_seeds scenes (seeds from seed_base, mixing the "xyz" and "loop"
    trajectories, every third low-texture), each frame photometrically
    augmented (gamma 0.6 / 1.0 / 1.6 and gain 0.7 / 1.0 / 1.25, cycling),
    as the reference harvests them. -> u8[N, 32]."""
    from plslam_tpu_torch.features.orb import ORBExtractor
    from plslam_tpu_torch.io.synthetic import SyntheticSequence

    dev = resolve_device(device)
    ext = ORBExtractor(height, width, n_features=500)
    gammas = (0.6, 1.0, 1.6)
    gains = (0.7, 1.0, 1.25)
    out = []
    for si in range(n_seeds):
        seq = SyntheticSequence(n_frames=frames_per_seed, height=height, width=width, seed=seed_base + si,
                                low_texture=bool(si % 3 == 2), trajectory="loop" if si % 2 else "xyz")
        for i in range(frames_per_seed):
            g = np.asarray(seq.frame(i)[0], np.float32)
            gamma = gammas[(si + i) % len(gammas)]
            gain = gains[(si * 2 + i) % len(gains)]
            g = np.clip(255.0 * gain * (g / 255.0) ** gamma, 0, 255)
            out.append(_descriptors(ext, g, dev))
    return np.concatenate(out, 0)


def harvest_descriptors_tum(tum_dir: str | Path, max_frames: int = 120, device="cuda") -> np.ndarray:
    """ORB descriptors of the TUM RGB-D sequences under tum_dir (each a
    folder holding rgb.txt): up to about max_frames evenly spaced frames of
    each, read as gray through io/png.py (cv2.imread's gray rule); a file
    listed but missing is skipped, as the reference skips what cv2.imread
    cannot read. -> u8[N, 32]."""
    from plslam_tpu_torch.features.orb import ORBExtractor
    from plslam_tpu_torch.io.png import read_png, to_gray

    tum_dir = Path(tum_dir)
    seqs = sorted(p.parent for p in tum_dir.glob("*/rgb.txt"))
    if not seqs:
        raise FileNotFoundError(f"no TUM sequences (rgb.txt) under {tum_dir}")
    dev = resolve_device(device)
    ext = None
    out = []
    for seq in seqs:
        rels = [ln.split()[1] for ln in (seq / "rgb.txt").read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
        step = max(1, len(rels) // max_frames)
        for rel in rels[::step]:
            path = seq / rel
            if not path.exists():
                continue
            img = to_gray(read_png(path))
            if ext is None:
                ext = ORBExtractor(img.shape[0], img.shape[1], n_features=500)
            out.append(_descriptors(ext, img.astype(np.float32), dev))
    return np.concatenate(out, 0)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tum", default=None, metavar="DIR",
                    help="also harvest from the TUM sequences under DIR")
    ap.add_argument("--out", default=str(ASSET), metavar="FILE", help="where to write the codebook")
    ap.add_argument("--cpu", action="store_true", help="harvest on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    print("harvesting descriptors from synthetic scenes ...")
    desc = harvest_descriptors(device=device)
    if args.tum:
        print(f"harvesting descriptors from TUM data under {args.tum} ...")
        desc = np.concatenate([desc, harvest_descriptors_tum(args.tum, device=device)], 0)
    print(f"training on {len(desc)} descriptors (k={C.VOCAB_K}, L={C.VOCAB_L}) ...")
    words = train_tree(desc)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, words=words, k=C.VOCAB_K, depth=C.VOCAB_L, n_train=len(desc))
    print(f"wrote {words.shape[0]} words -> {out}")


if __name__ == "__main__":
    main()
