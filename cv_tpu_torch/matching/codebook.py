"""Training of the bag-of-features codebook of the LSH sketches.

Port of ``cv_tpu/matching/codebook.py``.  The reference seeds its
``HammingHasher`` with 4,096 trained codewords shipped as static data
(cv-sfm/src/lib.rs:210-220, codewords.rs); the sketch of :mod:`.lsh` has
one bit a codeword, so the table has 512 entries, trained here by k-means
in Hamming space: k-means++ seeding, per-bit majority-vote centroids, empty
clusters reseeded from the descriptors farthest from their centers.

The random draws and the centroid votes are NumPy on the host, as in
``cv_tpu``; the distance tables, the assignments and the per-cluster bit
sums run on ``device`` over packed words (:func:`.hamming.distance_matrix`,
integer arithmetic), so a table trained on the card equals one trained on
the CPU and ``cv_tpu``'s on the same descriptors and seed.  It is an
offline tool: :func:`main` writes ``codebook.npy`` beside this module,
which :func:`.lsh.codewords` loads.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.fixtures import fixture_path
from .hamming import DESCRIPTOR_BITS, DESCRIPTOR_WORDS, distance_matrix
from .lsh import CODEBOOK_PATH


def unpack(words: np.ndarray) -> np.ndarray:
    """(N, 16) uint32 -> (N, 486) uint8 of {0,1}, little-endian bit order."""
    words = np.ascontiguousarray(words, np.uint32)
    bits = np.unpackbits(words.view(np.uint8).reshape(len(words), -1), axis=1, bitorder="little")
    return bits[:, :DESCRIPTOR_BITS]


def pack(bits: np.ndarray) -> np.ndarray:
    """(N, 486) {0,1} -> (N, 16) uint32 (padding bits past 486 zero)."""
    padded = np.zeros((len(bits), DESCRIPTOR_WORDS * 32), np.uint8)
    padded[:, :DESCRIPTOR_BITS] = bits
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(np.uint32)


def _device_words(bits: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(pack(bits).view(np.int32), device=device)


def train_codebook(
    descriptors: np.ndarray,
    n_codewords: int = 512,
    iters: int = 25,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Hamming k-means over packed descriptors.

    ``descriptors``: (N, 16) uint32 packed 486-bit M-LDB words.  Returns
    (n_codewords, 16) uint32 packed centroids, deterministic in ``seed`` and
    the same on every device.
    """
    rng = np.random.default_rng(seed)
    bits = unpack(np.unique(descriptors, axis=0))
    n = len(bits)
    if n < n_codewords:
        raise ValueError(f"need >= {n_codewords} distinct descriptors, got {n}")
    words = _device_words(bits, device)

    def distances_to(center_bits):
        return distance_matrix(words, _device_words(center_bits, device))

    # k-means++ seeding: each next seed drawn with probability proportional
    # to its distance to the nearest seed so far.
    centers = np.empty((n_codewords, DESCRIPTOR_BITS), np.uint8)
    centers[0] = bits[rng.integers(n)]
    d_near = distances_to(centers[:1])[:, 0]
    for i in range(1, n_codewords):
        p = d_near.cpu().numpy().astype(np.float64)
        total = p.sum()
        if total <= 0:
            centers[i:] = bits[rng.choice(n, n_codewords - i, replace=False)]
            break
        centers[i] = bits[rng.choice(n, p=p / total)]
        d_near = torch.minimum(d_near, distances_to(centers[i : i + 1])[:, 0])

    bits_dev = torch.as_tensor(bits, dtype=torch.int64, device=device)
    assign = None
    for _ in range(iters):
        d = distances_to(centers)
        new_assign = torch.argmin(d, dim=1)  # the first of equal distances, as np.argmin
        if assign is not None and torch.equal(new_assign, assign):
            break
        assign = new_assign
        d_own = d.gather(1, assign[:, None])[:, 0].cpu().numpy()
        counts = torch.bincount(assign, minlength=n_codewords).cpu().numpy()
        # Per-bit majority vote within each cluster (ties -> 1, the >=
        # rounding of mean >= 0.5); integer sums, exact in any order.
        sums = torch.zeros((n_codewords, DESCRIPTOR_BITS), dtype=torch.int64, device=device)
        sums = sums.index_add_(0, assign, bits_dev).cpu().numpy()
        nonempty = counts > 0
        centers[nonempty] = (2 * sums[nonempty] >= counts[nonempty, None]).astype(np.uint8)
        # Reseed empty clusters from the descriptors farthest from their
        # centers (the farthest-point repair).
        empty = np.nonzero(~nonempty)[0]
        if len(empty):
            far = np.argsort(d_own)[::-1][: len(empty)]
            centers[empty] = bits[far]
    return pack(centers)


def training_descriptors(max_per_frame: int = 4096, device="cuda") -> np.ndarray:
    """The training set: the exact extractor's words on the KITTI pair and
    on rendered star-field sequences (seeds 0-2, every other of 8 frames,
    512x640) at the default threshold."""
    from ..akaze import Akaze, AkazeExtractor, load_gray, to_gray_f32
    from ..apps.synth import render_sequence

    ex = AkazeExtractor(Akaze(maximum_features=max_per_frame), device=device)
    frames = [to_gray_f32(load_gray(fixture_path(name))) for name in ("0000000000.png", "0000000014.png")]
    for seed in (0, 1, 2):
        images, _, _ = render_sequence(n_frames=8, height=512, width=640, n_points=900, seed=seed)
        frames.extend(to_gray_f32(img) for img in images[::2])
    return np.concatenate([np.asarray(ex.extract(img)[1], np.uint32) for img in frames], axis=0)


def main(argv=None, device="cuda"):
    """Train the codebook on ``device`` and write it to this package's
    ``codebook.npy`` (an offline tool)."""
    parser = argparse.ArgumentParser(description="Train the LSH codebook and write cv_tpu_torch's codebook.npy.")
    parser.add_argument("--device", default=device)
    args = parser.parse_args(argv)
    desc = training_descriptors(device=args.device)
    print(f"training on {len(desc)} descriptors")
    cb = train_codebook(desc, device=args.device)
    np.save(CODEBOOK_PATH, cb)
    print(f"wrote {CODEBOOK_PATH}: {cb.shape} {cb.dtype}")
    return cb


if __name__ == "__main__":
    main()
