"""cv_tpu_torch's image stencils and scale space against cv_tpu's.

Tolerance: max |port - reference| <= 1e-5 * max |reference| per plane.
The two are not bit-equal even on plain code: XLA:CPU does not evaluate
``_conv1d``'s tap chain, ``half_size``'s mean or ``fed_step``'s flow sums
in source order, while the port does.  Measured worst case on these
inputs (2x97x131 and 1x192x256, every evolution and plane): 1.8e-6 of
the plane's max |x| (Ly of the scale space; Ldet 1.1e-6, Lt 3.1e-7,
``half_size`` 6.3e-8).  The single blur and Scharr passes and
``compute_contrast_factor`` came out bitwise equal on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze import extrema as jextrema
from cv_tpu.akaze.config import allocate_evolutions as j_alloc
from cv_tpu.akaze.scale_space import build_scale_space as j_build
from cv_tpu.akaze.scale_space import compute_contrast_factor as j_contrast
from cv_tpu.ops import image as jops
from cv_tpu_torch.akaze import extrema as textrema
from cv_tpu_torch.akaze.config import allocate_evolutions as t_alloc
from cv_tpu_torch.akaze.config import from_numpy_config
from cv_tpu_torch.akaze.scale_space import build_scale_space as t_build
from cv_tpu_torch.akaze.scale_space import compute_contrast_factor as t_contrast
from cv_tpu_torch.ops import image as tops
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

REL = 1e-5
SHAPES = [(2, 97, 131), (1, 192, 256)]


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


def _assert_close(port, ref, what):
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(port.astype(np.float64) - ref).max())
    assert err <= REL * scale, f"{what}: max |err| {err:.3e} > {REL} * {scale:.3e}"


def _both(fn_t, fn_j, *arrays, **kw):
    port = fn_t(*(torch.as_tensor(a) for a in arrays), **kw).numpy()
    ref = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    return port, ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [1.0, 1.6, 2.3])
def test_gaussian_blur(shape, sigma):
    img = _image(shape)
    _assert_close(*_both(tops.gaussian_blur, jops.gaussian_blur, img, sigma=sigma), "blur")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma_size", [1, 2, 4])
def test_scharr(shape, sigma_size):
    img = _image(shape, seed=1)
    for tf, jf in (
        (tops.scharr_horizontal, jops.scharr_horizontal),
        (tops.scharr_vertical, jops.scharr_vertical),
    ):
        _assert_close(*_both(tf, jf, img, sigma_size=sigma_size), tf.__name__)


@pytest.mark.parametrize("shape", SHAPES + [(1, 96, 130), (3, 33, 32)])
def test_half_size(shape):
    img = _image(shape, seed=2)
    _assert_close(*_both(tops.half_size, jops.half_size, img), "half_size")


@pytest.mark.parametrize("shape", SHAPES)
def test_pm_g2_and_fed_step(shape):
    rng = np.random.default_rng(4)
    lx, ly, lt = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    k = rng.uniform(0.01, 0.1, shape[:1]).astype(np.float32)
    flow_t = tops.pm_g2(torch.as_tensor(lx), torch.as_tensor(ly), torch.as_tensor(k))
    flow_j = jops.pm_g2(jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(k))
    _assert_close(flow_t.numpy(), flow_j, "pm_g2")
    for tau in (0.25, 1.7321):
        _assert_close(
            tops.fed_step(torch.as_tensor(lt), flow_t, tau).numpy(),
            jops.fed_step(jnp.asarray(lt), flow_j, jnp.asarray(tau, jnp.float32)),
            f"fed_step tau={tau}",
        )


@pytest.mark.parametrize("shape", SHAPES)
def test_contrast_factor(shape):
    img = _image(shape, seed=5)
    port = t_contrast(torch.as_tensor(img), 0.7, 1.0, 300).numpy()
    ref = np.asarray(j_contrast(jnp.asarray(img), 0.7, 1.0, 300))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_scale_space_planes(shape):
    img = _image(shape, seed=6)
    b, h, w = shape
    jcfg = JAkaze(detector_threshold=0.001)
    tcfg = from_numpy_config(jcfg)
    ref = j_build(jcfg, j_alloc(jcfg, w, h), jnp.asarray(img))
    port = t_build(tcfg, t_alloc(tcfg, w, h), torch.as_tensor(img))
    assert len(port) == len(ref) > 1
    for e, (p, r) in enumerate(zip(port, ref)):
        for name in ("lt", "lsmooth", "lx", "ly", "ldet"):
            _assert_close(getattr(p, name).numpy(), getattr(r, name), f"evolution {e} {name}")


@pytest.mark.parametrize("threshold", [0.0, 1e-3])
def test_candidate_mask_exact(threshold):
    """Comparisons only: bitwise equal on the same plane."""
    rng = np.random.default_rng(8)
    ldet = rng.normal(size=(2, 3, 40, 57)).astype(np.float32) * 1e-3
    ldet[0, 0, 10, 10:14] = 5e-3  # plateau: strict max must reject all four
    port = textrema.candidate_mask(torch.as_tensor(ldet), threshold).numpy()
    ref = np.asarray(jextrema.candidate_mask(jnp.asarray(ldet), threshold))
    assert ref.any()
    np.testing.assert_array_equal(port, ref)
