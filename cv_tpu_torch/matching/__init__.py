"""Descriptor matching: brute-force Hamming k-NN, mutual-best matching, and
the frame-level LSH sketches for retrieval."""

from .hamming import (
    PAD_DISTANCE,
    distance_matrix,
    distance_matrix_mxu,
    knn,
    knn2,
    lowes_ratio_matches,
    match_descriptors,
    symmetric_matches,
    unpack_bits,
)

__all__ = [
    "PAD_DISTANCE",
    "distance_matrix",
    "distance_matrix_mxu",
    "knn",
    "knn2",
    "lowes_ratio_matches",
    "match_descriptors",
    "symmetric_matches",
    "unpack_bits",
]
