"""Descriptor matching: brute-force Hamming k-NN, mutual-best matching, and
the frame-level LSH sketches for retrieval."""

from .hamming import (
    PAD_DISTANCE,
    distance_matrix,
    knn,
    knn2,
    lowes_ratio_matches,
    symmetric_matches,
)

__all__ = [
    "PAD_DISTANCE",
    "distance_matrix",
    "knn",
    "knn2",
    "lowes_ratio_matches",
    "symmetric_matches",
]
