"""cv_tpu_torch — the PyTorch/CUDA port of :mod:`cv_tpu`.

The package mirrors ``cv_tpu``'s layout and names module by module
(``cv_tpu_torch/akaze/fast.py`` is the counterpart of
``cv_tpu/akaze/fast.py``), so a reader finds each piece's reference.  It
imports ``torch`` and never ``jax`` or ``cv_tpu``.

Ported so far: the two-frame KITTI path — batched AKAZE extraction
(:mod:`cv_tpu_torch.akaze.fast`), Lowes-ratio Hamming matching
(:mod:`cv_tpu_torch.matching`), eight-point batched consensus
(:mod:`cv_tpu_torch.consensus`, :mod:`cv_tpu_torch.solvers`) — the exact
AKAZE extractor (:mod:`cv_tpu_torch.akaze.extract`, the engine's default),
the SfM engine's frame-by-frame path (:mod:`cv_tpu_torch.sfm`) with its
checkpoints and PLY export, and the apps ``vslam-sandbox``, ``kpdraw`` and
the tutorials (:mod:`cv_tpu_torch.apps`).  The hand-written kernels
(``csrc/``) are the describe stage's selects (:mod:`cv_tpu_torch.akaze.select`,
:mod:`cv_tpu_torch.akaze.fused`), the dedup scan
(:mod:`cv_tpu_torch.akaze.extrema`) and the three pose-optimizer loops
(:mod:`cv_tpu_torch.optimize.resident`).
"""

__version__ = "0.1.0"

# The eager top-level names of cv_tpu/__init__.py.  cv_tpu's lazy
# ``parallel`` is not ported yet.
from .camera import (  # noqa: E402,F401
    CameraIntrinsics,
    CameraIntrinsicsK1Distortion,
    CameraSpecification,
)
from .core import (  # noqa: E402,F401
    CameraToCamera,
    CameraToWorld,
    Isometry3,
    WorldToCamera,
    WorldToWorld,
    camera_to_camera_residual,
    world_to_camera_residual,
)


def __getattr__(name):
    # Lazy subpackage access, as in cv_tpu/__init__.py.
    import importlib

    if name in (
        "akaze",
        "apps",
        "camera",
        "consensus",
        "core",
        "geom",
        "matching",
        "ops",
        "optimize",
        "sfm",
        "solvers",
        "triangulate",
        "utils",
        "video",
    ):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
