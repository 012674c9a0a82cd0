"""Core geometric types: poses, projective points, the so(3) maps."""

from . import lie, projective
from .pose import (
    CameraToCamera,
    Isometry3,
    WorldToCamera,
    camera_to_camera_residual,
    world_to_camera_residual,
)

__all__ = [
    "lie",
    "projective",
    "Isometry3",
    "CameraToCamera",
    "WorldToCamera",
    "camera_to_camera_residual",
    "world_to_camera_residual",
]
