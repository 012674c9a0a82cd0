"""Bit-packed Hamming descriptor matching.

Port of ``cv_tpu/matching/hamming.py`` (reference ``space::LinearKnn`` in
akaze/tests/estimate_pose.rs:78-97).  Descriptor words are 16 x 32-bit
words carried as int32 bit patterns (torch has few ``uint32`` ops); torch
has no popcount, so each word's XOR is counted with a SWAR bit count on
int64.  All integer arithmetic, so the results equal the reference's.
``distance_matrix_mxu`` is the reference's other form, ``w(a) + w(b) -
2 a.b`` over unpacked {0,1} bits (an int8 matrix-unit product on the TPU),
here a plain tensor product.
"""

from __future__ import annotations

import numpy as np
import torch

DESCRIPTOR_BITS = 486
DESCRIPTOR_WORDS = 16
# Distance sentinel for masked/padded rows: any value > DESCRIPTOR_BITS can
# never win a nearest-neighbor comparison or pass a margin test.
PAD_DISTANCE = 10_000


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (int32 or int64 input) as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances of packed descriptors.

    ``a``: (..., N, W), ``b``: (..., M, W) int32 words -> (..., N, M) int32,
    summed word by word as in the reference.  On a CPU the same integers
    come from one float32 product of the unpacked bits, ``w(a) + w(b) - 2
    a.b`` (exact: every sum is an integer of at most 32 W), which the CPU's
    matrix product runs many times faster than the word-by-word bit counts.
    """
    if a.device.type == "cpu":
        ab, bb = _bits_f32(a), _bits_f32(b)
        dots = torch.matmul(ab, bb.transpose(-1, -2))
        return (ab.sum(dim=-1)[..., :, None] + bb.sum(dim=-1)[..., None, :] - 2 * dots).to(torch.int32)
    acc = None
    for w in range(a.shape[-1]):
        t = popcount32(a[..., :, None, w] ^ b[..., None, :, w])
        acc = t if acc is None else acc + t
    return acc.to(torch.int32)


def _bits_f32(words: torch.Tensor) -> torch.Tensor:
    """(..., N, W) int32 words -> (..., N, 32 W) float32 of {0, 1}, every
    bit of every word."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words[..., None] >> shifts) & 1).reshape(words.shape[:-1] + (-1,)).to(torch.float32)


def unpack_bits(words: torch.Tensor, n_bits: int = DESCRIPTOR_BITS) -> torch.Tensor:
    """(N, W) int32 words -> (N, n_bits) int8 of {0,1} (little-endian bit
    order)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n_bits].to(torch.int8)


def distance_matrix_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances as ``w(a) + w(b) - 2 a.b`` over the unpacked bits:
    (N, W) x (M, W) int32 words -> (N, M) int32, equal to
    :func:`distance_matrix`.  The product runs in float32 (CUDA has no
    integer matmul): the factors are 0 and 1 and every partial sum an
    integer of at most 486, so it is exact, TF32 or not."""
    ab = unpack_bits(a).to(torch.float32)
    bb = unpack_bits(b).to(torch.float32)
    dots = (ab @ bb.T).to(torch.int32)
    wa = ab.sum(dim=-1).to(torch.int32)
    wb = bb.sum(dim=-1).to(torch.int32)
    return wa[:, None] + wb[None, :] - 2 * dots


def knn2(dist: torch.Tensor):
    """Two nearest neighbors per row: (indices (..., N, 2), distances
    (..., N, 2)).  Ties resolve to the lower index (a stable sort, not
    ``torch.topk``), matching a linear scan that replaces only on strict
    improvement."""
    d, idx = torch.sort(dist, dim=-1, stable=True)
    return idx[..., :2], d[..., :2]


def lowes_ratio_matches(a_words: torch.Tensor, b_words: torch.Tensor, ratio: float = 0.5):
    """Brute-force 2-NN + Lowes ratio test (estimate_pose.rs:78-97).

    Returns ``(b_index (..., N), keep (..., N) bool)``: for each descriptor
    in ``a``, its best match in ``b`` and whether ``d0 < d1 * ratio``
    (computed in f32, matching the reference).
    """
    idx, d = knn2(distance_matrix(a_words, b_words))
    keep = d[..., 0].to(torch.float32) < d[..., 1].to(torch.float32) * ratio
    return idx[..., 0], keep


def knn(dist: torch.Tensor, k: int):
    """``k`` nearest neighbours per row: ``(distances (..., N, k), indices
    (..., N, k))``, ties to the lower index as in :func:`knn2` (the
    engine's 3-NN, engine.py:498-513, where ``jax.lax.top_k`` keeps the
    lower index first)."""
    d, idx = torch.sort(dist, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def _best2_margin(dist: torch.Tensor, better_by: int):
    """Best match per row iff best + better_by <= second best
    (cv-sfm/src/lib.rs:3097-3114)."""
    idx, d = knn2(dist)
    return idx[..., 0], d[..., 0] + better_by <= d[..., 1]


def symmetric_matches(a_words, b_words, better_by: int = 24, n_valid_a=None, n_valid_b=None):
    """Mutual-best matching with a distance margin (lib.rs:3116-3133).

    Returns ``(b_index (N,), keep (N,) bool)``: ``keep[i]`` when feature
    ``i`` of ``a`` and ``b_index[i]`` of ``b`` are each other's best match
    and both margins hold.  ``n_valid_a``/``n_valid_b``: real row counts of
    bucket-padded word arrays (padding rows get a sentinel distance and
    never match).
    """
    dist = distance_matrix(a_words, b_words)
    if n_valid_a is not None:
        va = torch.arange(a_words.shape[0], device=dist.device) < n_valid_a
        vb = torch.arange(b_words.shape[0], device=dist.device) < n_valid_b
        dist = torch.where(va[:, None] & vb[None, :], dist, PAD_DISTANCE)
    fwd_idx, fwd_ok = _best2_margin(dist, better_by)
    rev_idx, rev_ok = _best2_margin(dist.T, better_by)
    mutual = rev_idx[fwd_idx] == torch.arange(a_words.shape[0], device=dist.device)
    return fwd_idx, fwd_ok & rev_ok[fwd_idx] & mutual


def match_descriptors(a_words: np.ndarray, b_words: np.ndarray, ratio: float = 0.5, device="cuda"):
    """Host convenience: ``(ix_a, ix_b)`` arrays of the Lowes-ratio matches of
    (N, 16) and (M, 16) uint32 words, computed on ``device``."""
    a = torch.as_tensor(np.ascontiguousarray(a_words, np.uint32).view(np.int32), device=device)
    b = torch.as_tensor(np.ascontiguousarray(b_words, np.uint32).view(np.int32), device=device)
    idx, keep = lowes_ratio_matches(a, b, ratio)
    keep = keep.cpu().numpy()
    ix_a = np.nonzero(keep)[0]
    return ix_a, idx.cpu().numpy()[ix_a]
