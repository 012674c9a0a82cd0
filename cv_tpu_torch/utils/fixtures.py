"""Locate the KITTI test fixtures committed under ``tests/fixtures/``.

The reference pins its golden counts on two KITTI frames (reference
akaze/tests/estimate_pose.rs:30-42); the same pair lives in this repo with
a provenance note (``tests/fixtures/source.txt``).
"""

import os

_REPO_FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests",
    "fixtures",
)

KITTI_FRAME_0 = "0000000000.png"
KITTI_FRAME_14 = "0000000014.png"
KITTI_CALIB = "calib_cam_to_cam.txt"

# KITTI cam 00 intrinsics (fx, fy, cx, cy): the K_00 line of
# calib_cam_to_cam.txt, as the reference's chapter-5 tutorial uses them.
KITTI_INTRINSICS = (9.842439e2, 9.808141e2, 6.9e2, 2.331966e2)


def fixture_path(name):
    """Absolute path of a named fixture in the repo's ``tests/fixtures``."""
    path = os.path.join(_REPO_FIXTURES, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"fixture {name!r} not found in {_REPO_FIXTURES}")
    return path


def kitti_pair():
    """Paths of the two golden KITTI frames (399/343 keypoints)."""
    return fixture_path(KITTI_FRAME_0), fixture_path(KITTI_FRAME_14)
