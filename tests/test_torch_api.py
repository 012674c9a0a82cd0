"""cv_tpu_torch's top-level names, the frame and camera-spec classes behind
them, and the entry points' device default, against cv_tpu.

* The eager top-level names (public attributes that are not modules) equal
  cv_tpu's; every cv_tpu subpackage and top-level module resolves lazily on
  the port (``NOT_PORTED`` is empty).
* Every public name that a cv_tpu module defines (its functions, classes
  and constants, not what it imports; loggers aside) resolves on the port's
  counterpart module, except in the modules of ``TPU_WORKAROUNDS``, each
  named with its reason.
* ``CameraSpecification`` and ``WorldToWorld.from_camera_poses`` on seeded
  float64 inputs, within 1e-12 of cv_tpu's.
* ``DeviceExtractor``, ``FastAkazeExtractor``, ``AkazeExtractor``,
  ``BatchConsensus`` and ``VSlam`` run on the CUDA card unless the caller
  asks for the CPU: built without ``device`` the extractors and the
  consensus hold ``torch.device("cuda")`` (their construction allocates
  nothing, so this runs without a card), and ``VSlam()`` and an
  ``AkazeExtractor()`` extract without a card raise instead of running on
  the CPU.
* ``VSlam``'s extractor is cv_tpu's default, the exact ``AkazeExtractor``,
  on the engine's device; an ``extractor_cls`` that takes ``device`` is
  built there too, one that does not (a factory) is called with the config.
* ``cv_tpu_torch.akaze`` exports every name of ``cv_tpu.akaze``.
"""

import importlib
import inspect
import logging
import pathlib
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cv_tpu
import cv_tpu_torch
from cv_tpu.core.lie import so3_exp as ref_so3_exp
from cv_tpu_torch.akaze import AkazeExtractor, DeviceExtractor, FastAkazeExtractor
from cv_tpu_torch.consensus import BatchConsensus
from cv_tpu_torch.sfm import VSlam

NOT_PORTED = set()
# cv_tpu modules with no counterpart module of the same name in the port.
TPU_WORKAROUNDS = {
    "cv_tpu.akaze.pallas_mldb": "its Pallas kernels are ported under other names: akaze/select.py, akaze/fused.py "
                                "and csrc/select_*.cu",
    "cv_tpu.optimize.pallas_loop": "its Pallas kernels are ported as optimize/resident.py and csrc/single_view_l2.cu, "
                                   "three_view_l2.cu and three_view_adaptive.cu",
    "cv_tpu.core.smallmat": "elementwise contractions that keep float32 products off the TPU's bf16 matrix unit; "
                            "the port's products run at full precision (ops/precision.py)",
    "cv_tpu.ops.dw": "double-word arithmetic for the TPU's slow float64; the card computes in native float64",
    "cv_tpu.utils.pytree": "registers JAX pytrees; the port's types are plain dataclasses",
    "cv_tpu.utils.native_loader": "replaced by utils/loader.py's thread pool",
}


def _eager_names(pkg):
    return {n for n, v in vars(pkg).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_eager_top_level_names_equal_cv_tpu():
    assert _eager_names(cv_tpu_torch) == _eager_names(cv_tpu)
    for name in _eager_names(cv_tpu):
        assert getattr(cv_tpu_torch, name).__name__ == getattr(cv_tpu, name).__name__


def test_lazy_subpackages_resolve_except_the_unported():
    root = pathlib.Path(cv_tpu.__file__).parent
    ref = {p.name for p in root.iterdir() if p.is_dir() and (p / "__init__.py").exists()}
    ref |= {p.stem for p in root.glob("*.py") if p.stem != "__init__"}
    assert NOT_PORTED <= ref
    for name in sorted(ref - NOT_PORTED):
        assert isinstance(getattr(cv_tpu_torch, name), types.ModuleType), name
    for name in sorted(NOT_PORTED):
        with pytest.raises(AttributeError):
            getattr(cv_tpu_torch, name)


def _defined_names(mod):
    """Public names that ``mod`` defines: functions and classes whose
    ``__module__`` is ``mod``, and other non-module values (constants);
    loggers are not API."""
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, (types.ModuleType, logging.Logger)):
            continue
        if (callable(value) or isinstance(value, type)) and getattr(value, "__module__", None) != mod.__name__:
            continue
        out.add(name)
    return out


def _cv_tpu_modules():
    return sorted(info.name for info in pkgutil.walk_packages(cv_tpu.__path__, "cv_tpu."))


def test_workaround_exceptions_are_cv_tpu_modules_without_a_counterpart():
    modules = set(_cv_tpu_modules())
    for name in TPU_WORKAROUNDS:
        assert name in modules, name
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module("cv_tpu_torch" + name[len("cv_tpu"):])


@pytest.mark.parametrize("name", [n for n in _cv_tpu_modules() if n not in TPU_WORKAROUNDS])
def test_every_public_name_resolves_on_the_port(name):
    ref = importlib.import_module(name)
    port = importlib.import_module("cv_tpu_torch" + name[len("cv_tpu"):])
    missing = sorted(n for n in _defined_names(ref) if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_camera_specification_matches_cv_tpu():
    rng = np.random.default_rng(4)
    pixels = rng.integers(200, 4000, 2).astype(np.float64)
    sensor = rng.uniform(2.0, 40.0, 2)
    width, focal = float(rng.uniform(2.0, 40.0)), float(rng.uniform(100.0, 3000.0))
    cases = (
        (cv_tpu.CameraSpecification.from_sensor(jnp.asarray(pixels), jnp.asarray(sensor)),
         cv_tpu_torch.CameraSpecification.from_sensor(torch.tensor(pixels), torch.tensor(sensor))),
        (cv_tpu.CameraSpecification.from_sensor_square(jnp.asarray(pixels), width),
         cv_tpu_torch.CameraSpecification.from_sensor_square(torch.tensor(pixels), width)),
    )
    for ref, port in cases:
        np.testing.assert_allclose(port.pixel_dimensions.numpy(), np.asarray(ref.pixel_dimensions), atol=1e-12, rtol=0)
        ri, pi = ref.intrinsics_centered(focal), port.intrinsics_centered(focal)
        assert isinstance(pi, cv_tpu_torch.CameraIntrinsics) and pi.focals.dtype == torch.float64
        for a, b in ((pi.focals, ri.focals), (pi.principal_point, ri.principal_point), (pi.skew, ri.skew)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)


def test_world_to_world_from_camera_poses_matches_cv_tpu():
    rng = np.random.default_rng(5)
    rot = [np.asarray(ref_so3_exp(jnp.asarray(rng.normal(0.0, 0.7, 3)))) for _ in range(2)]
    trans = [rng.normal(0.0, 2.0, 3) for _ in range(2)]
    ref = cv_tpu.WorldToWorld.from_camera_poses(
        *(cv_tpu.WorldToCamera(rotation=jnp.asarray(r), translation=jnp.asarray(t)) for r, t in zip(rot, trans)))
    port = cv_tpu_torch.WorldToWorld.from_camera_poses(
        *(cv_tpu_torch.WorldToCamera(rotation=torch.tensor(r), translation=torch.tensor(t)) for r, t in zip(rot, trans)))
    assert type(port) is cv_tpu_torch.WorldToWorld and port.dtype == torch.float64
    np.testing.assert_allclose(port.rotation.numpy(), np.asarray(ref.rotation), atol=1e-12, rtol=0)
    np.testing.assert_allclose(port.translation.numpy(), np.asarray(ref.translation), atol=1e-12, rtol=0)
    assert issubclass(cv_tpu_torch.CameraToWorld, cv_tpu_torch.Isometry3)


@pytest.mark.parametrize("build", [
    lambda: DeviceExtractor(),
    lambda: FastAkazeExtractor(),
    lambda: AkazeExtractor(),
    lambda: BatchConsensus(threshold=0.1),
], ids=["DeviceExtractor", "FastAkazeExtractor", "AkazeExtractor", "BatchConsensus"])
def test_entry_points_default_to_the_card(build):
    assert torch.device(build().device) == torch.device("cuda")


def test_vslam_defaults_to_the_card():
    assert inspect.signature(VSlam.__init__).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: VSlam() would run on it")
    with pytest.raises(RuntimeError):
        VSlam()


def test_akaze_names_include_cv_tpu_s():
    import cv_tpu.akaze
    import cv_tpu_torch.akaze

    assert "AkazeExtractor" in cv_tpu_torch.akaze.__all__
    assert set(cv_tpu.akaze.__all__) <= set(cv_tpu_torch.akaze.__all__)
    assert cv_tpu_torch.akaze.AkazeExtractor.__name__ == cv_tpu.akaze.AkazeExtractor.__name__


def test_akaze_extractor_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the extract would run on it")
    with pytest.raises((RuntimeError, AssertionError)):
        AkazeExtractor().extract(np.zeros((64, 96), np.uint8))


def test_vslam_default_extractor_is_the_exact_one_on_its_device():
    engine = VSlam(device="cpu")
    assert type(engine._extractor) is AkazeExtractor
    assert engine._extractor.device == torch.device("cpu")
    assert inspect.signature(VSlam.__init__).parameters["extractor_cls"].default is AkazeExtractor


def test_vslam_builds_an_injected_extractor_on_its_device():
    engine = VSlam(extractor_cls=FastAkazeExtractor, device="cpu")
    assert type(engine._extractor) is FastAkazeExtractor and engine._extractor.device == torch.device("cpu")
    assert engine._extractor._dev.max_features == engine.settings.tracking_features
    built = []

    def factory(config):  # bench.py's form: a callable of the config alone
        built.append(config)
        return FastAkazeExtractor(config, max_features=512, device="cpu")

    engine = VSlam(extractor_cls=factory, device="cpu")
    assert len(built) == 1 and engine._extractor._dev.max_features == 512
