"""Fixture paths and the standard-library PNG reader and writer."""

from .fixtures import KITTI_INTRINSICS, fixture_path, kitti_pair
from .png import read_png, write_png

__all__ = ["KITTI_INTRINSICS", "fixture_path", "kitti_pair", "read_png", "write_png"]
