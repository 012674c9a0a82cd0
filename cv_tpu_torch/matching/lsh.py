"""Frame-level bag-of-features LSH for retrieval.

Port of ``cv_tpu/matching/lsh.py`` (reference cv-sfm/src/lib.rs:205-220):
descriptors in, a 512-bit frame sketch out, Hamming retrieval over
sketches.  Sketch bit ``i`` records whether some descriptor of the frame
lies unusually close to codeword ``i``: the per-codeword min-distance
profile binarized at its own 0.4-quantile.

The 512 codewords are read from the package's trained codebook,
``cv_tpu_torch/matching/codebook.npy`` (byte-equal to the JAX package's
table; :mod:`.codebook` trains it), with the same seeded fallback when it
is absent.  Words are int32 bit patterns on the device, as in
:mod:`.hamming`.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from .hamming import DESCRIPTOR_WORDS, distance_matrix, popcount32

SKETCH_BITS = 512
SKETCH_WORDS = SKETCH_BITS // 32
# Bits set in a sketch: the 0.4 quantile of 512 profile entries.
QUANTILE_INDEX = 204
CODEBOOK_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "codebook.npy")


@lru_cache(maxsize=None)
def codewords() -> np.ndarray:
    """(512, 16) uint32 codewords: the trained codebook, else the seeded
    fallback."""
    if os.path.exists(CODEBOOK_PATH):
        cw = np.load(CODEBOOK_PATH).astype(np.uint32)
        if cw.shape != (SKETCH_BITS, DESCRIPTOR_WORDS):
            raise ValueError(f"{CODEBOOK_PATH}: shape {cw.shape}, expected {(SKETCH_BITS, DESCRIPTOR_WORDS)}")
        return cw
    return random_codewords()


@lru_cache(maxsize=None)
def random_codewords() -> np.ndarray:
    """(512, 16) uint32 deterministic seeded codewords (the fallback)."""
    rng = np.random.default_rng(0x5F3C)
    words = rng.integers(0, 2**32, size=(SKETCH_BITS, DESCRIPTOR_WORDS), dtype=np.uint64).astype(np.uint32)
    # Zero the 26 padding bits past 486 so codewords live in descriptor space.
    words[:, -1] &= np.uint32((1 << (486 - 15 * 32)) - 1)
    return words


@lru_cache(maxsize=None)
def _codewords_device(device) -> torch.Tensor:
    return torch.as_tensor(codewords().view(np.int32), device=device)


def sketch_from_distances(d: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 512) descriptor-to-codeword distances -> (16,) int32 bit patterns
    of the uint32 sketch words.  ``valid`` masks padded descriptor rows."""
    if valid is not None:
        d = torch.where(valid[:, None], d, 1 << 30)
    prof = d.min(dim=0).values  # (512,) min distance per codeword
    t = torch.sort(prof).values[QUANTILE_INDEX]
    bits = (prof <= t).to(torch.int64).reshape(SKETCH_WORDS, 32)
    shifts = torch.arange(32, device=d.device, dtype=torch.int64)
    words = (bits << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def hash_bag(words: torch.Tensor, cw: torch.Tensor | None = None) -> torch.Tensor:
    """Hash a frame's descriptors ((N, 16) int32 words) into its (16,) int32
    sketch.  ``cw`` overrides the codeword table."""
    cw = _codewords_device(words.device) if cw is None else cw
    return sketch_from_distances(distance_matrix(words, cw))


def sketch_distances(query: torch.Tensor, sketches: torch.Tensor) -> torch.Tensor:
    """Hamming distances between one sketch (16,) and many (M, 16)."""
    return popcount32(query[None, :] ^ sketches).sum(dim=-1).to(torch.int32)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def descriptor_rerank_score(query_words: np.ndarray, cand_words: np.ndarray, sub: int = 64) -> float:
    """Frame-similarity score for reranking sketch candidates (lower = more
    similar): the mean, over the query's strongest ``sub`` descriptors, of
    the min Hamming distance to the candidate's strongest ``sub``.  Host
    NumPy on uint32 words, as in the reference."""
    q = np.ascontiguousarray(query_words[:sub], np.uint32)
    c = np.ascontiguousarray(cand_words[:sub], np.uint32)
    if len(q) == 0 or len(c) == 0:
        return float("inf")
    x = (q[:, None, :] ^ c[None, :, :]).view(np.uint8)
    d = _POPCOUNT8[x].sum(axis=2, dtype=np.int32)
    return float(d.min(axis=1).mean())
