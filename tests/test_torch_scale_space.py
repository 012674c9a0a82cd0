"""The scale space's fused steps (``ops/image.py``: ``sep_filter``,
``evolution_flow``, ``fed_cycle`` and ``fed_update``, ``detector`` and their
plain versions) and ``build_scale_space`` through them.

On the CPU:

* the two new plain compositions, ``evolution_flow_plain`` (blur, Scharr
  pair, ``pm_g2``) and ``detector_plain`` (the multiscale Scharr pair, the
  second derivatives and the Hessian determinant), against cv_tpu's own
  composition of its ops (``cv_tpu/ops/image.py``; the detector body of
  ``cv_tpu/akaze/scale_space.py:156-163``) within 1e-5 of the reference's
  max |x| per plane, ``tests/test_torch_image_ops.py``'s tolerance:
  XLA:CPU reorders the tap chains, so the two are not bitwise;
* ``build_scale_space`` and ``compute_contrast_factor`` bitwise to the
  composition they had before the dispatchers, rebuilt here from
  ``ops.gaussian_blur``, ``scharr_*``, ``pm_g2`` and ``fed_step``, at every
  plane of every evolution;
* ``fed_cycle_plain`` bitwise to cv_tpu's own chain of ``ops.fed_step``
  (eager JAX on the CPU, an op at a time, in source order) over every
  evolution's taus of the KITTI allocation;
* ``fed_update`` and ``fed_cycle`` on planes with -0 at the borders and
  ``evolution_flow`` at a contrast near 0, bitwise to those ops;
* the dispatchers run their plain versions on CPU tensors without counting
  a launch, and the kernel wrappers refuse CPU tensors; the taps and half
  steps the wrappers hand the kernels are the plain chain's.

The ``cuda`` tests hold each entry of ``csrc/scale_space.cu`` bitwise to its
plain version on the card, at odd sizes and planes narrower than a tile
(the FED cycle at every count of steps a launch, the detector at every
scale from 1 to 16), and a whole ``build_scale_space`` on the card bitwise
to its CPU run.  This
module imports cv_tpu (and so JAX) only inside the CPU tests that compare
with it, so the card runs the ``cuda`` tests with ``python3 -m pytest
--noconftest -k cuda tests/test_torch_scale_space.py``.
"""

import numpy as np
import pytest
import torch

from cv_tpu_torch.akaze import Akaze
from cv_tpu_torch.akaze import scale_space as ss
from cv_tpu_torch.akaze.config import allocate_evolutions
from cv_tpu_torch.ops import image as ops
from cv_tpu_torch.ops import trig
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

REL = 1e-5
SHAPES = [(2, 97, 131), (1, 192, 256), (3, 33, 32)]
# Frames at least 40 pixels on a side (allocate_evolutions' first octave).
BUILD_SHAPES = [(2, 97, 131), (1, 81, 95), (1, 161, 203), (3, 80, 174)]
CARD_SHAPES = [(3, 33, 32), (2, 97, 131), (1, 64, 174), (1, 1, 7), (2, 5, 1), (1, 17, 33)]
ENTRIES = ["sep_filter", "evolution_flow", "fed_update", "fed_cycle", "detector"]
# The wrappers' launch counters (fed_update launches a cycle of one step).
COUNTERS = ["sep_filter", "evolution_flow", "fed_cycle", "detector"]
# An evolution's taus: KITTI's allocation runs cycles of 3 to 17 steps.
KITTI_SPECS = allocate_evolutions(Akaze.sparse(), 1392, 512)


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


def _signed_zeros(shape, seed):
    """Seeded planes in [-1, 1) with scattered +0 and -0 and a block of -0
    at each corner."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    x[rng.uniform(size=shape) < 0.2] = 0.0
    x[rng.uniform(size=shape) < 0.2] = -0.0
    h, w = max(shape[-2] // 3, 1), max(shape[-1] // 3, 1)
    for rows in (slice(0, h), slice(shape[-2] - h, None)):
        for cols in (slice(0, w), slice(shape[-1] - w, None)):
            x[..., rows, cols] = -0.0
    return x


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _assert_bitwise(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}[{i}]"
        differ = int((_bits(g) != _bits(w)).sum())
        assert differ == 0, f"{what}[{i}]: {differ} of {g.numel()} values differ"


def _assert_close(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(port.astype(np.float64) - ref).max())
    assert err <= REL * scale, f"{what}: max |err| {err:.3e} > {REL} * {scale:.3e}"


def _pre_pr_contrast(image, percentile, gradient_histogram_scale, num_bins):
    """``compute_contrast_factor`` as it was composed before the
    dispatchers: the blur and the Scharr pair as separate ops."""
    g = ops.gaussian_blur(image, gradient_histogram_scale)
    lx = ops.scharr_horizontal(g, 1)
    ly = ops.scharr_vertical(g, 1)
    mag2 = (lx * lx + ly * ly)[..., 1:-1, 1:-1]
    batch = mag2.shape[:-2]
    m2 = mag2.reshape(-1, mag2.shape[-2] * mag2.shape[-1]).to(torch.float64)
    hmax = trig.sqrt(m2.max(dim=1).values)
    modg = trig.sqrt(m2)
    nonzero = modg != 0.0
    num_points = nonzero.sum(dim=1)
    threshold = torch.floor(num_points.to(torch.float64) * percentile).to(torch.int64)
    safe_hmax = torch.where(hmax == 0, torch.ones_like(hmax), hmax)
    bin_idx = torch.clamp(torch.floor(num_bins * (modg / safe_hmax[:, None])).to(torch.int64), max=num_bins - 1)
    hist = torch.zeros((m2.shape[0], num_bins), dtype=torch.int64)
    hist.scatter_add_(1, bin_idx, nonzero.to(torch.int64))
    cum = hist.cumsum(dim=1)
    j = torch.clamp((cum < threshold[:, None]).sum(dim=1), max=num_bins - 1)
    k = torch.where(threshold > 0, j + 1, torch.zeros_like(j))
    result = hmax * k.to(torch.float64) / num_bins
    result = torch.where(num_points >= threshold, result, torch.full_like(result, 0.03))
    return result.reshape(batch).to(image.dtype)


def _pre_pr_build(config, specs, image):
    """``build_scale_space`` as it was composed before the dispatchers."""
    contrast = _pre_pr_contrast(image, config.contrast_percentile, 1.0, config.contrast_factor_num_bins)
    lts, lsmooths = [], []
    lt = ops.gaussian_blur(image, config.base_scale_offset)
    lts.append(lt)
    lsmooths.append(lt)
    for i in range(1, len(specs)):
        if specs[i].octave > specs[i - 1].octave:
            lt = ops.half_size(lt)
            contrast = contrast * 0.75
        lsmooth = ops.gaussian_blur(lt, 1.0)
        lx = ops.scharr_horizontal(lsmooth, 1)
        ly = ops.scharr_vertical(lsmooth, 1)
        flow = ops.pm_g2(lx, ly, contrast)
        for tau in specs[i].fed_tau_steps:
            lt = ops.fed_step(lt, flow, tau)
        lts.append(lt)
        lsmooths.append(lsmooth)
    out = []
    for spec, lt_i, lsm_i in zip(specs, lts, lsmooths):
        s = int(round(spec.esigma * config.derivative_factor / spec.ratio))
        lx = ops.scharr_horizontal(lsm_i, s)
        ly = ops.scharr_vertical(lsm_i, s)
        lxx = ops.scharr_horizontal(lx, s)
        lyy = ops.scharr_vertical(ly, s)
        lxy = ops.scharr_vertical(lx, s)
        out.append((lt_i, lsm_i, lx, ly, (lxx * lyy - lxy * lxy) * float(s) ** 4))
    return out


def _assert_planes(got, want, what):
    assert len(got) == len(want) > 1, what
    for e, (g, w) in enumerate(zip(got, want)):
        _assert_bitwise((g.lt, g.lsmooth, g.lx, g.ly, g.ldet), w, f"{what}, evolution {e} (lt, lsmooth, lx, ly, ldet)")


# -- the plain compositions against cv_tpu's ---------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_evolution_flow_plain_near_cv_tpu(shape):
    import jax.numpy as jnp

    from cv_tpu.ops import image as jops

    lt = _image(shape, seed=11)
    k = np.random.default_rng(12).uniform(0.01, 0.1, shape[:1]).astype(np.float32)
    lsmooth, flow = ops.evolution_flow_plain(torch.as_tensor(lt), torch.as_tensor(k))
    ref_ls = jops.gaussian_blur(jnp.asarray(lt), 1.0)
    ref_flow = jops.pm_g2(jops.scharr_horizontal(ref_ls, 1), jops.scharr_vertical(ref_ls, 1), jnp.asarray(k))
    _assert_close(lsmooth.numpy(), ref_ls, "lsmooth")
    _assert_close(flow.numpy(), ref_flow, "flow")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma_size", [2, 3, 4])
def test_detector_plain_near_cv_tpu(shape, sigma_size):
    import jax.numpy as jnp

    from cv_tpu.ops import image as jops

    lsm = _image(shape, seed=13)
    lx, ly, ldet = ops.detector_plain(torch.as_tensor(lsm), sigma_size)
    j = jnp.asarray(lsm)
    jlx = jops.scharr_horizontal(j, sigma_size)
    jly = jops.scharr_vertical(j, sigma_size)
    jlxx = jops.scharr_horizontal(jlx, sigma_size)
    jlyy = jops.scharr_vertical(jly, sigma_size)
    jlxy = jops.scharr_vertical(jlx, sigma_size)
    jdet = (jlxx * jlyy - jlxy * jlxy) * jnp.float32(float(sigma_size) ** 4)
    for name, port, ref in (("lx", lx, jlx), ("ly", ly, jly), ("ldet", ldet, jdet)):
        _assert_close(port.numpy(), ref, name)


# -- the refactored scale space, bitwise to the composition before it --------


@pytest.mark.parametrize("shape", BUILD_SHAPES)
@pytest.mark.parametrize("config", [Akaze(), Akaze(num_sublevels=2, max_octave_evolution=3)], ids=["default", "cut"])
def test_build_scale_space_bitwise_to_pre_pr_chain(shape, config):
    img = torch.as_tensor(_image(shape, seed=14))
    specs = allocate_evolutions(config, shape[2], shape[1])
    _assert_planes(ss.build_scale_space(config, specs, img), _pre_pr_build(config, specs, img), f"{shape}")


@pytest.mark.parametrize("shape", BUILD_SHAPES)
def test_contrast_factor_bitwise_to_pre_pr_chain(shape):
    img = torch.as_tensor(_image(shape, seed=15))
    got = ss.compute_contrast_factor(img, 0.7, 1.0, 300)
    _assert_bitwise(got, _pre_pr_contrast(img, 0.7, 1.0, 300), "contrast")
    # The dispatched blur and Scharr pair are the separate ops' planes.
    blur = ops.gaussian_blur_kernel(1.0)
    g = ops.sep_filter(img, blur, blur)
    _assert_bitwise(g, ops.gaussian_blur(img, 1.0), "blur")
    main, off = ops.scharr_main_kernel(1), ops.scharr_off_kernel(1)
    _assert_bitwise(ops.sep_filter(g, main, off, off, main),
                    (ops.scharr_horizontal(g, 1), ops.scharr_vertical(g, 1)), "Scharr pair")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("signed", [False, True], ids=["conductivity", "either-sign"])
def test_fed_update_signed_zero_borders(shape, signed):
    lt = torch.as_tensor(_signed_zeros(shape, 16))
    c = _signed_zeros(shape, 17)
    c = torch.as_tensor(c if signed else np.abs(c))
    for tau in (0.25, 1.7321, 3.3):
        _assert_bitwise(ops.fed_update(lt, c, tau), ops.fed_step(lt, c, tau), f"tau {tau}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("signed", [False, True], ids=["conductivity", "either-sign"])
def test_fed_cycle_signed_zero_borders(shape, signed):
    lt = torch.as_tensor(_signed_zeros(shape, 26))
    c = _signed_zeros(shape, 27)
    c = torch.as_tensor(c if signed else np.abs(c))
    for spec in KITTI_SPECS[1::4]:
        want = lt
        for tau in spec.fed_tau_steps:
            want = ops.fed_step(want, c, tau)
        _assert_bitwise(ops.fed_cycle(lt, c, spec.fed_tau_steps), want, f"{len(spec.fed_tau_steps)} steps")
    assert ops.fed_cycle(lt, c, ()) is lt


@pytest.mark.parametrize("shape", [(2, 33, 47), (1, 64, 174)])
def test_fed_cycle_plain_bitwise_to_cv_tpu_chain(shape):
    import jax.numpy as jnp

    from cv_tpu.ops import image as jops

    lt = _image(shape, seed=28)
    c = np.random.default_rng(29).uniform(0.0, 1.0, shape).astype(np.float32)
    for e, spec in enumerate(KITTI_SPECS[1:], start=1):
        want = jnp.asarray(lt)
        for tau in spec.fed_tau_steps:
            want = jops.fed_step(want, jnp.asarray(c), jnp.asarray(tau, jnp.float32))
        got = ops.fed_cycle_plain(torch.as_tensor(lt), torch.as_tensor(c), spec.fed_tau_steps)
        _assert_bitwise(got, torch.from_numpy(np.array(want)), f"evolution {e}, {len(spec.fed_tau_steps)} steps")


def test_kernel_arguments_are_the_plain_chain():
    """The taps and half steps the wrappers hand ``csrc/scale_space.cu``:
    the Scharr kernels' nonzero taps at -s, 0, +s for every scale the
    detector takes, 0.5 tau rounded as ``fed_step`` rounds it, and the FED
    cycle's steps a launch."""
    for s in range(1, 17):
        main, off = ops.scharr_main_kernel(s), ops.scharr_off_kernel(s)
        want = (main[0], main[2 * s], off[0], off[s])
        got = ops._scharr_taps(s)
        assert [np.float32(v) for v in got] == list(want), s
        assert np.count_nonzero(main) == 2 and np.count_nonzero(off) == 3 and off[2 * s] == off[0], s
    taus = KITTI_SPECS[-1].fed_tau_steps
    half = ops._half_steps(tuple(taus))
    assert [np.float32(half[i]) for i in range(len(taus))] == [np.float32(0.5) * np.float32(t) for t in taus]
    for n in (1, 3, 17, 29, 32, 33, 100):
        k = ops.fed_block_steps(n, 64, 174)
        assert 1 <= k <= ops.FED_MAX_STEPS and k <= n


@pytest.mark.parametrize("k", [1e-19, 3e-20, 1e-30], ids=["1e-19", "3e-20", "1e-30"])
def test_evolution_flow_contrast_near_zero(k):
    lt = torch.as_tensor(_signed_zeros((2, 33, 47), 18))
    kk = torch.full((2,), k, dtype=torch.float32)
    ls, flow = ops.evolution_flow(lt, kk)
    want_ls = ops.gaussian_blur(lt, 1.0)
    want = ops.pm_g2(ops.scharr_horizontal(want_ls, 1), ops.scharr_vertical(want_ls, 1), kk)
    _assert_bitwise((ls, flow), (want_ls, want), f"k {k}")


# -- dispatch on the CPU -----------------------------------------------------


def _entry_args(name, device="cpu", shape=(2, 33, 47)):
    x = torch.as_tensor(_image(shape, seed=19), device=device)
    if name == "sep_filter":
        return (x, ops.gaussian_blur_kernel(1.6), ops.gaussian_blur_kernel(1.6))
    if name == "evolution_flow":
        return (x, torch.full(shape[:1], 0.05, dtype=torch.float32, device=device))
    if name == "fed_update":
        return (x, torch.as_tensor(_image(shape, seed=20), device=device), 1.25)
    if name == "fed_cycle":
        return (x, torch.as_tensor(_image(shape, seed=20), device=device), KITTI_SPECS[5].fed_tau_steps)
    return (x, 3)


def _plain(name):
    return {"sep_filter": ops.sep_filter_plain, "evolution_flow": ops.evolution_flow_plain,
            "fed_update": ops.fed_step, "fed_cycle": ops.fed_cycle_plain, "detector": ops.detector_plain}[name]


def _fed_update_kernel(lt, conductivity, step_size):
    return ops.fed_cycle_kernel(lt, conductivity, (step_size,))


def _kernel(name):
    return {"sep_filter": ops.sep_filter_kernel, "evolution_flow": ops.evolution_flow_kernel,
            "fed_update": _fed_update_kernel, "fed_cycle": ops.fed_cycle_kernel,
            "detector": ops.detector_kernel}[name]


def _counter(name):
    """The wrapper that counts ``name``'s launches."""
    return ops.fed_cycle if name == "fed_update" else getattr(ops, name)


@pytest.mark.parametrize("name", ENTRIES)
def test_dispatch_runs_plain_on_cpu_and_kernels_refuse_it(name):
    dispatch = getattr(ops, name)
    args = _entry_args(name)
    before = _counter(name).launches
    _assert_bitwise(dispatch(*args), _plain(name)(*args), name)
    assert _counter(name).launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _kernel(name)(*args)


# -- on the card ---------------------------------------------------------------


def _card_args(name, shape, seed):
    """CPU arguments of one entry at ``shape``: signed zeros in the planes."""
    x = torch.as_tensor(_signed_zeros(shape, seed))
    if name == "sep_filter":
        return (x, ops.scharr_main_kernel(1), ops.scharr_off_kernel(1), ops.scharr_off_kernel(1),
                ops.scharr_main_kernel(1))
    if name == "evolution_flow":
        return (x, torch.as_tensor(np.random.default_rng(seed).uniform(0.01, 0.1, shape[:1]).astype(np.float32)))
    if name == "fed_update":
        return (x, torch.as_tensor(np.abs(_signed_zeros(shape, seed + 1))), 1.7321)
    if name == "fed_cycle":
        return (x, torch.as_tensor(_signed_zeros(shape, seed + 1)), KITTI_SPECS[4 + seed].fed_tau_steps)
    return (x, 1 + seed % 4)


def _cuda(args):
    return tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("name", ENTRIES)
def test_cuda_entry_bitwise_to_plain(name, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/scale_space.cu runs only there")
    for seed in range(4):
        args = _cuda(_card_args(name, shape, seed))
        dispatch = getattr(ops, name)
        before = _counter(name).launches
        got = dispatch(*args)
        n = len(args[2]) if name == "fed_cycle" else 1
        assert _counter(name).launches == before + -(-n // ops.fed_block_steps(n, *shape[-2:]))
        _assert_bitwise(got, _plain(name)(*args), f"{name} {shape} seed {seed}")
    if name == "sep_filter":  # one pair, the base blur's 9 taps
        x, blur = args[0], ops.gaussian_blur_kernel(1.6)
        _assert_bitwise(ops.sep_filter(x, blur, blur), ops.sep_filter_plain(x, blur, blur), f"blur {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 97, 131), (1, 161, 203)])
def test_cuda_build_scale_space_bitwise_to_the_cpu(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/scale_space.cu runs only there")
    config = Akaze()
    img = torch.as_tensor(_image(shape, seed=21))
    specs = allocate_evolutions(config, shape[2], shape[1])
    counts = {name: getattr(ops, name).launches for name in COUNTERS}
    got = ss.build_scale_space(config, specs, img.cuda())
    torch.cuda.synchronize()
    launched = {name: getattr(ops, name).launches - counts[name] for name in COUNTERS}
    fed = 0
    for spec in specs[1:]:  # the plane halves with each octave
        n, h, w = len(spec.fed_tau_steps), shape[1] >> spec.octave, shape[2] >> spec.octave
        fed += -(-n // ops.fed_block_steps(n, h, w))
    assert launched == {"sep_filter": 3, "evolution_flow": len(specs) - 1, "fed_cycle": fed, "detector": len(specs)}
    want = ss.build_scale_space(config, specs, img)
    assert len(got) == len(want) > 1
    for e, (g, w) in enumerate(zip(got, want)):
        _assert_bitwise((g.lt, g.lsmooth, g.lx, g.ly, g.ldet), (w.lt, w.lsmooth, w.lx, w.ly, w.ldet),
                        f"evolution {e}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 7), (2, 5, 1), (1, 17, 33), (1, 64, 174)])
def test_cuda_fed_cycle_every_block_steps(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/scale_space.cu runs only there")
    lt = torch.as_tensor(_signed_zeros(shape, 30)).cuda()
    taus = tuple(0.25 + 0.37 * i for i in range(33))
    for signed in (False, True):
        c = _signed_zeros(shape, 31)
        c = torch.as_tensor(c if signed else np.abs(c)).cuda()
        want = ops.fed_cycle_plain(lt, c, taus)
        for k in range(1, ops.FED_MAX_STEPS + 1):
            before = ops.fed_cycle.launches
            got = ops.fed_cycle_kernel(lt, c, taus, block_steps=k)
            assert ops.fed_cycle.launches == before + -(-len(taus) // k)
            _assert_bitwise(got, want, f"{shape}, {k} steps a launch, signed {signed}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 7), (2, 5, 1), (1, 17, 33), (2, 97, 131)])
def test_cuda_detector_every_scale(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/scale_space.cu runs only there")
    x = torch.as_tensor(_signed_zeros(shape, 32)).cuda()
    for s in range(1, 17):
        _assert_bitwise(ops.detector_kernel(x, s), ops.detector_plain(x, s), f"{shape} s {s}")
    for s in (0, 17):
        with pytest.raises(ValueError, match="sigma_size"):
            ops.detector_kernel(x, s)
