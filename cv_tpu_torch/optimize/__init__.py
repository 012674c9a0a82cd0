"""Pose optimizers: the plain loops and their CUDA kernels, and general
Levenberg-Marquardt least squares."""

from .lm import LMResult, levenberg_marquardt
from .optimizers import (
    PATIENCE,
    landmark_deltas,
    single_view_simple_optimize_l1,
    single_view_simple_optimize_l2,
    three_view_adaptive_optimize_l2,
    three_view_simple_optimize_l1,
    three_view_simple_optimize_l2,
)
from .resident import single_view_l2, three_view_adaptive, three_view_l2

__all__ = [
    "LMResult",
    "PATIENCE",
    "landmark_deltas",
    "levenberg_marquardt",
    "single_view_simple_optimize_l1",
    "single_view_simple_optimize_l2",
    "three_view_simple_optimize_l1",
    "three_view_simple_optimize_l2",
    "three_view_adaptive_optimize_l2",
    "single_view_l2",
    "three_view_l2",
    "three_view_adaptive",
]
