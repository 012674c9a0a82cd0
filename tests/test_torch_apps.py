"""cv_tpu_torch's apps ``kpdraw`` and ``tutorials`` against cv_tpu's, on the
CPU.

* ``render_crosses``: bitwise equal to cv_tpu's on grayscale and RGB
  canvases, with crosses at the borders and off the image.
* Tutorial chapter 2: the PNG the port writes decodes to the pixels cv_tpu's
  chapter writes (through PIL) for the same random points.
* ``kpdraw.main`` on a 256x384 KITTI crop at threshold 0.01 with
  ``device="cpu"``: the PNG decodes (with the port's reader and with PIL) to
  the crosses drawn at the exact extractor's points, and equals the image
  cv_tpu's ``kpdraw`` writes for the same file.
"""

import numpy as np
import pytest
from PIL import Image

from cv_tpu.apps import kpdraw as ref_kpdraw
from cv_tpu.apps import tutorials as ref_tutorials
from cv_tpu.utils.fixtures import fixture_path
from cv_tpu_torch.akaze import load_gray
from cv_tpu_torch.apps import kpdraw, tutorials
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.utils import read_png, write_png
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


@pytest.fixture(autouse=True, scope="module")
def _cheap_consensus():
    """On a CPU the exact forms of this module's consensus runs and solver
    batches cost tens of times the cheap ones (``scripts/cpu_costs.py``):
    the module opts into the cheap CPU forms (``ops.eigen.cheap_on_cpu``,
    within a few ulps of cv_tpu's bits), which every CPU caller took before
    the exact forms became the default."""
    with eigen.cheap_on_cpu():
        yield


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_render_crosses_bitwise(rgb):
    rng = np.random.default_rng(21)
    shape = (40, 56, 3) if rgb else (40, 56)
    canvas = rng.integers(0, 256, shape).astype(np.uint8)
    before = canvas.copy()
    points = np.concatenate([rng.uniform(-4, 60, (30, 2)), [[0, 0], [55.5, 39.49], [-3.6, 20], [28, 43.2]]])
    got = kpdraw.render_crosses(canvas, points)
    want = ref_kpdraw.render_crosses(canvas, points)
    assert got.shape == (40, 56, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(canvas, before)  # drawn on a copy


def test_chapter2_pixels_equal_cv_tpu(tmp_path):
    got = tutorials.chapter2_random_draw(str(tmp_path / "port.png"))
    ref_tutorials.chapter2_random_draw(str(tmp_path / "ref.png"))
    want = np.asarray(Image.open(tmp_path / "ref.png"))
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"), want)
    np.testing.assert_array_equal(got, want)
    assert (want == [255, 0, 255]).all(axis=-1).sum() > 50 * 10


def test_kpdraw_main_on_a_crop(tmp_path):
    crop = load_gray(fixture_path("0000000000.png"))[128:384, 400:784]
    write_png(tmp_path / "crop.png", crop)
    kp = kpdraw.main(["--threshold", "0.01", str(tmp_path / "crop.png"), str(tmp_path / "port.png")], device="cpu")
    ref_kpdraw.main(["--threshold", "0.01", str(tmp_path / "crop.png"), str(tmp_path / "ref.png")])
    drawn = read_png(tmp_path / "port.png")
    assert len(kp["response"]) > 20
    np.testing.assert_array_equal(drawn, kpdraw.render_crosses(crop, kp["point"]))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), drawn)
    np.testing.assert_array_equal(drawn, np.asarray(Image.open(tmp_path / "ref.png")))
