"""Core geometric types: poses, projective points, the so(3) maps."""

from . import lie, projective
from .pose import (
    CameraToCamera,
    CameraToWorld,
    Isometry3,
    WorldToCamera,
    WorldToWorld,
    camera_to_camera_residual,
    world_to_camera_residual,
)

__all__ = [
    "lie",
    "projective",
    "Isometry3",
    "CameraToCamera",
    "CameraToWorld",
    "WorldToCamera",
    "WorldToWorld",
    "camera_to_camera_residual",
    "world_to_camera_residual",
]
