"""Pinhole camera intrinsics (port of ``cv_tpu/camera/pinhole.py``):
``calibrate`` maps pixel keypoints ``(..., 2)`` to unit bearings ``(..., 3)``
(reference cv-pinhole/src/lib.rs:108-116), ``uncalibrate`` maps bearings
back to pixels, and ``pose_reprojection_error`` scores a match under a
relative pose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Focals / principal point / skew (lib.rs:32-84)."""

    focals: torch.Tensor  # (..., 2)
    principal_point: torch.Tensor  # (..., 2)
    skew: torch.Tensor  # (...,)

    @classmethod
    def from_values(cls, fx, fy, cx, cy, skew=0.0, dtype=torch.float64, device=None):
        return cls(
            focals=torch.tensor([fx, fy], dtype=dtype, device=device),
            principal_point=torch.tensor([cx, cy], dtype=dtype, device=device),
            skew=torch.tensor(skew, dtype=dtype, device=device),
        )

    @classmethod
    def from_numpy(cls, focals, principal_point, skew, device=None):
        """From NumPy arrays (copied), keeping their dtype."""
        return cls(
            focals=torch.tensor(np.asarray(focals), device=device),
            principal_point=torch.tensor(np.asarray(principal_point), device=device),
            skew=torch.tensor(np.asarray(skew), device=device),
        )

    def to_numpy(self):
        """``(focals, principal_point, skew)`` as NumPy arrays."""
        return tuple(
            t.cpu().numpy() for t in (self.focals, self.principal_point, self.skew)
        )

    def calibrate(self, point: torch.Tensor) -> torch.Tensor:
        """Pixel ``(..., 2)`` -> unit bearing ``(..., 3)`` (lib.rs:108-116)."""
        centered = point - self.principal_point
        y = centered[..., 1] / self.focals[..., 1]
        x = (centered[..., 0] - self.skew * y) / self.focals[..., 0]
        return _normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))

    def uncalibrate(self, bearing: torch.Tensor):
        """Bearing -> (pixel ``(..., 2)``, valid mask) (lib.rs:134-141)."""
        valid = bearing[..., 2] > 0
        z = torch.where(bearing[..., 2] == 0, torch.ones_like(bearing[..., 2]), bearing[..., 2])
        px = bearing[..., 0] / z
        py = bearing[..., 1] / z
        y = py * self.focals[..., 1]
        x = px * self.focals[..., 0] + self.skew * py
        return torch.stack([x, y], dim=-1) + self.principal_point, valid


@dataclasses.dataclass(frozen=True)
class CameraIntrinsicsK1Distortion:
    """Pinhole + one radial distortion coefficient K1 (lib.rs:150-240)."""

    simple_intrinsics: CameraIntrinsics
    k1: torch.Tensor  # (...,)

    @classmethod
    def new(cls, simple_intrinsics: CameraIntrinsics, k1):
        return cls(
            simple_intrinsics=simple_intrinsics,
            k1=torch.as_tensor(
                k1, dtype=simple_intrinsics.focals.dtype, device=simple_intrinsics.focals.device
            ),
        )

    def calibrate(self, point: torch.Tensor) -> torch.Tensor:
        """Undistort ``p' = p / (1 + k1 r^2)`` then normalize (lib.rs:191-202)."""
        si = self.simple_intrinsics
        centered = point - si.principal_point
        y = centered[..., 1] / si.focals[..., 1]
        x = (centered[..., 0] - si.skew * y) / si.focals[..., 0]
        f = 1.0 + self.k1 * (x * x + y * y)
        return _normalize(torch.stack([x / f, y / f, torch.ones_like(x)], dim=-1))

    def uncalibrate(self, bearing: torch.Tensor):
        """Closed-form quadratic re-distortion (lib.rs:224-239): (pixel
        ``(..., 2)``, valid mask)."""
        si = self.simple_intrinsics
        valid = bearing[..., 2] > 0
        z = torch.where(bearing[..., 2] == 0, torch.ones_like(bearing[..., 2]), bearing[..., 2])
        ux = bearing[..., 0] / z
        uy = bearing[..., 1] / z
        u2 = ux * ux + uy * uy
        k1 = self.k1
        denom = 2.0 * k1 * u2
        denom = torch.where(denom == 0, torch.ones_like(denom), denom)
        r2_mul_k1 = -(2.0 * k1 * u2 + torch.sqrt(1.0 - 4.0 * k1 * u2) - 1.0) / denom
        r2_mul_k1 = torch.where(k1 * u2 == 0, torch.zeros_like(r2_mul_k1), r2_mul_k1)
        scale = 1.0 + r2_mul_k1
        dx, dy = ux * scale, uy * scale
        y = dy * si.focals[..., 1]
        x = dx * si.focals[..., 0] + si.skew * dy
        return torch.stack([x, y], dim=-1) + si.principal_point, valid


def pose_reprojection_error(pose, a: torch.Tensor, b: torch.Tensor):
    """Reprojection error (in focal lengths) of a match under a relative pose
    (cv-pinhole/src/lib.rs:314-346).

    ``pose``: CameraToCamera A->B (Isometry3); ``a``/``b``: unit bearings.
    Triangulates with Linear-Eigen and returns ``(errors (..., 2, 2), ok)``:
    ``errors[..., 0, :]`` / ``[..., 1, :]`` are the residuals in cameras A
    and B, and ``ok`` masks cheirality and triangulation failures.
    """
    from ..triangulate import triangulate_relative

    point, ok = triangulate_relative(pose, a, b)
    a_norm = a[..., :2] / a[..., 2:3]
    b_norm = b[..., :2] / b[..., 2:3]
    bearing_a = point[..., :3]
    ok = ok & (bearing_a[..., 2] > 0)
    za = torch.where(bearing_a[..., 2] == 0, torch.ones_like(bearing_a[..., 2]), bearing_a[..., 2])
    reproject_a = bearing_a[..., :2] / za[..., None]
    bearing_b = pose.transform(point)[..., :3]
    ok = ok & (bearing_b[..., 2] > 0)
    zb = torch.where(bearing_b[..., 2] == 0, torch.ones_like(bearing_b[..., 2]), bearing_b[..., 2])
    reproject_b = bearing_b[..., :2] / zb[..., None]
    return torch.stack([a_norm - reproject_a, b_norm - reproject_b], dim=-2), ok


def average_pose_reprojection_error(pose, a: torch.Tensor, b: torch.Tensor):
    """Mean of the two reprojection error norms (lib.rs:348-372): ``(avg
    (...,), ok)``."""
    errors, ok = pose_reprojection_error(pose, a, b)
    return 0.5 * torch.linalg.vector_norm(errors, dim=-1).sum(dim=-1), ok


@dataclasses.dataclass(frozen=True)
class CameraSpecification:
    """Manufacturer-style sensor spec -> intrinsics helper (lib.rs:250-284)."""

    pixels: torch.Tensor  # (..., 2)
    pixel_dimensions: torch.Tensor  # (..., 2)

    @classmethod
    def from_sensor(cls, pixels, sensor_dimensions):
        pixels = torch.as_tensor(pixels)
        sensor_dimensions = torch.as_tensor(sensor_dimensions)
        return cls(pixels=pixels, pixel_dimensions=sensor_dimensions / pixels)

    @classmethod
    def from_sensor_square(cls, pixels, sensor_width):
        pixels = torch.as_tensor(pixels)
        pw = sensor_width / pixels[..., 0]
        return cls(pixels=pixels, pixel_dimensions=torch.stack([pw, pw], dim=-1))

    def intrinsics_centered(self, focal) -> CameraIntrinsics:
        # As the reference (lib.rs:278-284), which centers on
        # pixel_dimensions rather than the pixel count (the principal point
        # would be pixels / 2 - 0.5); kept so both packages agree.
        pp = self.pixel_dimensions / 2.0 - 0.5
        focal = torch.as_tensor(focal, dtype=pp.dtype, device=pp.device)
        return CameraIntrinsics(
            focals=torch.stack([focal, focal], dim=-1),
            principal_point=pp,
            skew=torch.zeros_like(focal),
        )
