"""Triangulation: Linear-Eigen over any number of observations."""

from .linear_eigen import triangulate_observations, triangulate_relative

__all__ = ["triangulate_observations", "triangulate_relative"]
