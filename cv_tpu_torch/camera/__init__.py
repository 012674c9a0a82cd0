"""Camera models: pinhole intrinsics (plain and with K1 distortion) and the
essential matrix."""

from .pinhole import CameraIntrinsics, CameraIntrinsicsK1Distortion, CameraSpecification

__all__ = ["CameraIntrinsics", "CameraIntrinsicsK1Distortion", "CameraSpecification"]
