"""Epipolar geometry: the optimizers' gradients and losses."""

from . import epipolar

__all__ = ["epipolar"]
