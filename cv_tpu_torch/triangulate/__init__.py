"""Triangulators (cv-geom): Linear-Eigen, Sine-L1, relative DLT, mean-mean,
angular L1 / L-infinity."""

from .linear_eigen import triangulate_observations, triangulate_relative
from .more import angular_l1, angular_linf, mean_mean, relative_dlt, sine_l1

__all__ = [
    "triangulate_observations",
    "triangulate_relative",
    "sine_l1",
    "relative_dlt",
    "mean_mean",
    "angular_l1",
    "angular_linf",
]
