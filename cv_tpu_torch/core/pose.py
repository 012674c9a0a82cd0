"""SE(3) poses as plain dataclasses of tensors.

Port of ``cv_tpu/core/pose.py`` (reference cv-core/src/pose.rs): one
:class:`Isometry3` holds a batch of rigid transforms as ``rotation
(..., 3, 3)`` + ``translation (..., 3)``; the subclasses keep the
reference's frame vocabulary (:class:`WorldToCamera`,
:class:`CameraToWorld`, :class:`CameraToCamera`, :class:`WorldToWorld`).  Small products are plain float matmuls: with
TF32 off they run in full precision on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import projective
from .lie import so3_exp, so3_hat, so3_log


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for ``(..., i, j) x (..., j) -> (..., i)``, broadcasting."""
    return (m * v[..., None, :]).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class Isometry3:
    """A rigid transform ``y = R x + t`` (batched)."""

    rotation: torch.Tensor  # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)

    @classmethod
    def identity(cls, batch_shape: tuple = (), dtype=torch.float64, device=None):
        eye = torch.eye(3, dtype=dtype, device=device)
        return cls(
            rotation=eye.expand(tuple(batch_shape) + (3, 3)),
            translation=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
        )

    @classmethod
    def from_numpy(cls, rotation: np.ndarray, translation: np.ndarray, device=None):
        """From NumPy arrays (copied), keeping their dtype."""
        return cls(
            rotation=torch.tensor(np.asarray(rotation), device=device),
            translation=torch.tensor(np.asarray(translation), device=device),
        )

    @classmethod
    def from_tangent(cls, translation: torch.Tensor, rotation: torch.Tensor):
        """``Se3TangentSpace.isometry`` convention: ``(R, R @ translation)``."""
        r = so3_exp(rotation)
        return cls(rotation=r, translation=_mv(r, translation))

    def to_numpy(self):
        """``(rotation, translation)`` as NumPy arrays."""
        return self.rotation.cpu().numpy(), self.translation.cpu().numpy()

    @property
    def batch_shape(self):
        return self.translation.shape[:-1]

    @property
    def dtype(self):
        return self.translation.dtype

    def inverse(self) -> "Isometry3":
        rt = self.rotation.transpose(-1, -2)
        return type(self)(rotation=rt, translation=-_mv(rt, self.translation))

    def compose(self, other: "Isometry3") -> "Isometry3":
        """self after other: (self @ other)(x) = self(other(x))."""
        return Isometry3(
            rotation=self.rotation @ other.rotation,
            translation=_mv(self.rotation, other.translation) + self.translation,
        )

    def scale(self, scale) -> "Isometry3":
        """Scale the translation component (pose.rs:35-41)."""
        return type(self)(rotation=self.rotation, translation=self.translation * scale)

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Transform euclidean 3-points ``(..., 3)``."""
        return _mv(self.rotation, p) + self.translation

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        """Rotate vectors/bearings (no translation)."""
        return _mv(self.rotation, v)

    def matrix3x4(self) -> torch.Tensor:
        return torch.cat([self.rotation, self.translation[..., :, None]], dim=-1)

    def homogeneous(self) -> torch.Tensor:
        """4x4 homogeneous matrix (pose.rs:50-52)."""
        bottom = torch.cat([torch.zeros_like(self.translation), torch.ones_like(self.translation[..., :1])], dim=-1)
        return torch.cat([self.matrix3x4(), bottom[..., None, :]], dim=-2)

    def se3(self) -> torch.Tensor:
        """The reference's se(3) vector ``[t, log R]`` (pose.rs:55-60)."""
        return torch.cat([self.translation, so3_log(self.rotation)], dim=-1)

    def transform(self, hp: torch.Tensor) -> torch.Tensor:
        """Transform projective points ``(..., 4)``, renormalized
        (pose.rs:120-122)."""
        return projective.from_homogeneous(self.transform_unnormalized(hp))

    def transform_unnormalized(self, hp: torch.Tensor) -> torch.Tensor:
        xyz = _mv(self.rotation, hp[..., :3]) + self.translation * hp[..., 3:4]
        w = hp[..., 3:4].expand(xyz.shape[:-1] + (1,))
        return torch.cat([xyz, w], dim=-1)

    def transform_jacobians(self, hp: torch.Tensor):
        """Transform + Jacobians w.r.t. the input point and the pose
        (pose.rs:70-90): ``(output, d_output/d_input (..., 4, 4),
        d_output/d_[t, w] (..., 4, 6))``, the output renormalized and the
        Jacobians of the raw homogeneous product (pose.rs:131-174), the pose
        block a right-perturbation of translation and rotation output."""
        output = self.transform_unnormalized(hp)
        jac_input = self.homogeneous()
        w = hp[..., 3:4]
        eye4 = torch.eye(4, dtype=hp.dtype, device=hp.device).expand(output.shape[:-1] + (4, 4))
        dp_dt = eye4 * w[..., None]
        eye3 = torch.eye(3, dtype=hp.dtype, device=hp.device).expand(self.rotation.shape)
        t_h = Isometry3(rotation=eye3, translation=self.translation).homogeneous()
        hat_rot = so3_hat(_mv(self.rotation, hp[..., :3]))  # (..., 3, 3)
        hat_h = torch.zeros(hat_rot.shape[:-2] + (4, 4), dtype=hp.dtype, device=hp.device)
        hat_h[..., :3, :3] = hat_rot
        hat_h[..., 3, 3] = 1.0
        dp_ds = t_h @ hat_h
        # The reference packs [dp_dt rows 0..3; dp_ds rows 0..3] as a 6x4
        # and transposes it (pose.rs:157-173).
        stacked = torch.cat([dp_dt[..., :3, :], dp_ds[..., :3, :]], dim=-2)
        return projective.from_homogeneous(output), jac_input, stacked.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class WorldToCamera(Isometry3):
    """Pose of the world relative to a camera: WorldPoint -> CameraPoint."""


@dataclasses.dataclass(frozen=True)
class CameraToWorld(Isometry3):
    """Camera extrinsics: CameraPoint -> WorldPoint."""


@dataclasses.dataclass(frozen=True)
class CameraToCamera(Isometry3):
    """Relative pose: CameraPoint of A -> CameraPoint of B."""


@dataclasses.dataclass(frozen=True)
class WorldToWorld(Isometry3):
    """Relative transform between two reconstructions' world frames."""

    @classmethod
    def from_camera_poses(cls, a_pose: Isometry3, b_pose: Isometry3) -> "WorldToWorld":
        """From one camera's pose in both reconstructions (pose.rs:322-324)."""
        iso = b_pose.inverse().compose(a_pose)
        return cls(rotation=iso.rotation, translation=iso.translation)


def world_to_camera_residual(pose: Isometry3, bearing: torch.Tensor, world_point: torch.Tensor):
    """``Model<FeatureWorldMatch>::residual`` (pose.rs:194-202):
    ``1 - bearing . bearing(pose @ world_point)``, broadcasting poses
    against matches."""
    obs = projective.bearing(pose.transform(world_point))
    return 1.0 - (bearing * obs).sum(dim=-1)


def camera_to_camera_residual(pose: Isometry3, a: torch.Tensor, b: torch.Tensor):
    """``Model<FeatureMatch>::residual`` for a relative pose (pose.rs:249-296).

    Triangulates via the symmetric 4x4 DLT (smallest eigenvector of the
    accumulated design matrix) and scores cheirality + cosine distance; any
    non-finite result maps to 2.0 exactly like the reference.  Broadcasts
    the pose batch against the match batch.
    """
    from ..ops.eigen import eigh4

    dtype = a.dtype
    eye_pose = Isometry3.identity(dtype=dtype, device=a.device)
    shape = torch.broadcast_shapes(a.shape[:-1], pose.batch_shape) + (4, 4)
    design = torch.zeros(shape, dtype=dtype, device=a.device)
    for p, bearing_vec in ((eye_pose, a), (pose, b)):
        pm = p.matrix3x4()  # (..., 3, 4)
        # b (b^T pm) == (b b^T) pm; kept in the reference's elementwise form.
        s = (bearing_vec[..., :, None] * pm).sum(dim=-2)  # (..., 4)
        term = pm - bearing_vec[..., :, None] * s[..., None, :]  # (..., 3, 4)
        for k in range(3):
            tk = term[..., k, :]
            design = design + tk[..., :, None] * tk[..., None, :]
    eigvals, eigvecs = eigh4(design)
    # ascending eigenvalues; the reference picks min |eigenvalue|.
    idx = torch.argmin(eigvals.abs(), dim=-1)
    v = torch.gather(eigvecs, -1, idx[..., None, None].expand(eigvecs.shape[:-1] + (1,)))[..., 0]
    pt = projective.from_homogeneous(v)
    finite = projective.is_finite(pt)
    bearing_a = projective.bearing(pt)
    bearing_b = projective.bearing(pose.transform(pt))
    res = 0.5 * (
        1.0 - (a * bearing_a).sum(dim=-1) + 1.0 - (b * bearing_b).sum(dim=-1)
    )
    return torch.where(finite & torch.isfinite(res), res, torch.full_like(res, 2.0))
