"""cv_tpu_torch's static host data against cv_tpu's: the AKAZE config, the
evolution specs with their FED tau schedules, the filter kernels and the
descriptor tables must be bitwise equal (they are copied NumPy code)."""

import dataclasses

import numpy as np
import pytest

from cv_tpu.akaze import config as jcfg
from cv_tpu.akaze import descriptors as jdesc
from cv_tpu.akaze import fast as jfast
from cv_tpu.ops import image as jimage
from cv_tpu_torch.akaze import config as tcfg
from cv_tpu_torch.akaze import descriptors as tdesc
from cv_tpu_torch.akaze import fast as tfast
from cv_tpu_torch.ops import image as timage
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

CONFIGS = {
    "default": lambda m: m.Akaze(),
    "sparse": lambda m: m.Akaze.sparse(),
    "dense": lambda m: m.Akaze.dense(),
    "custom": lambda m: m.Akaze(num_sublevels=3, max_octave_evolution=5, base_scale_offset=1.2),
}
SHAPES = [(512, 1392), (192, 256), (97, 131), (256, 384)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_numpy_config_keeps_every_field(name):
    ref = CONFIGS[name](jcfg)
    port = tcfg.from_numpy_config(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port == CONFIGS[name](tcfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("shape", SHAPES)
def test_evolution_specs_bitwise(name, shape):
    h, w = shape
    ref = jcfg.allocate_evolutions(CONFIGS[name](jcfg), w, h)
    port = tcfg.allocate_evolutions(tcfg.from_numpy_config(CONFIGS[name](jcfg)), w, h)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        # FED taus bitwise, not just equal as floats.
        np.testing.assert_array_equal(
            np.asarray(a.fed_tau_steps, np.float64).view(np.uint64),
            np.asarray(b.fed_tau_steps, np.float64).view(np.uint64),
        )


@pytest.mark.parametrize("t", [0.3, 1.7, 5.12, 20.48])
@pytest.mark.parametrize("reordering", [False, True])
def test_fed_tau_bitwise(t, reordering):
    np.testing.assert_array_equal(
        tcfg.fed_tau_by_process_time(t, 1, 0.25, reordering).view(np.uint64),
        jcfg.fed_tau_by_process_time(t, 1, 0.25, reordering).view(np.uint64),
    )


def test_filter_kernels_bitwise():
    for sigma in (1.0, 1.6, 2.5):
        np.testing.assert_array_equal(
            timage.gaussian_blur_kernel(sigma), jimage.gaussian_blur_kernel(sigma)
        )
    for s in (1, 2, 3, 5, 9):
        np.testing.assert_array_equal(timage.scharr_main_kernel(s), jimage.scharr_main_kernel(s))
        np.testing.assert_array_equal(timage.scharr_off_kernel(s), jimage.scharr_off_kernel(s))


@pytest.mark.parametrize(
    "table", ["orientation_table", "orientation_windows", "mldb_tables", "mldb_unique_tables"]
)
def test_descriptor_tables_bitwise(table):
    port, ref = getattr(tdesc, table)(), getattr(jdesc, table)()
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdesc.GAUSS25, jdesc.GAUSS25)


@pytest.mark.parametrize("shape", SHAPES)
def test_slot_tables_bitwise(shape):
    h, w = shape
    specs = jcfg.allocate_evolutions(jcfg.Akaze.sparse(), w, h)
    ref = jfast.slot_tables(jcfg.Akaze.sparse(), specs, 256)
    port = tfast.slot_tables(tcfg.Akaze.sparse(), specs, 256)
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(port[key], ref[key])
