"""The four tutorial programs (reference ``tutorial-code/chapter{2..5}``)
as runnable functions, sharing the KITTI fixtures.

Port of ``cv_tpu/apps/tutorials.py``: the exact extractor, the matching and
the consensus run on the CUDA card unless a chapter is given
``device="cpu"``; images are written with the port's PNG encoder.

Run all:  python -m cv_tpu_torch.apps.tutorials [chapter]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..utils.fixtures import KITTI_INTRINSICS, fixture_path
from ..utils.png import write_png

KITTI0 = fixture_path("0000000000.png")
KITTI14 = fixture_path("0000000014.png")


def chapter2_random_draw(output="chapter2.png"):
    """Random cross rendering (chapter2-first-program/src/main.rs)."""
    from .kpdraw import render_crosses

    rng = np.random.default_rng(0)
    canvas = np.zeros((512, 512), np.uint8)
    pts = rng.uniform(0, 512, (50, 2))
    out = render_crosses(canvas, pts)
    write_png(output, out)
    print(f"chapter 2: drew 50 random crosses -> {output}")
    return out


def chapter3_akaze_extraction(output="chapter3.png", device="cuda"):
    """AKAZE extraction + keypoint render
    (chapter3-akaze-feature-extraction/src/main.rs:17)."""
    from ..akaze import Akaze, AkazeExtractor, load_gray
    from .kpdraw import render_crosses

    image = load_gray(KITTI0)
    kp, _ = AkazeExtractor(Akaze.new(0.001), device=device).extract(image)
    print(f"chapter 3: extracted {len(kp['response'])} keypoints")
    write_png(output, render_crosses(image, kp["point"]))
    return kp


def _symmetric(w_a, w_b, device):
    """Symmetric matches (better by 48) of two uint32 word arrays:
    ``(ia, ib)`` host index arrays."""
    from ..matching import symmetric_matches

    def words(w):
        return torch.as_tensor(np.ascontiguousarray(w, np.uint32).view(np.int32), device=device)

    idx, keep = symmetric_matches(words(w_a), words(w_b), better_by=48)
    ia = np.nonzero(keep.cpu().numpy())[0]
    return ia, idx.cpu().numpy()[ia]


def chapter4_feature_matching(output="chapter4.png", device="cuda"):
    """Symmetric matching + side-by-side match render
    (chapter4-feature-matching/src/main.rs:91-137)."""
    from ..akaze import Akaze, AkazeExtractor, load_gray

    ex = AkazeExtractor(Akaze.new(0.001), device=device)
    img_a, img_b = load_gray(KITTI0), load_gray(KITTI14)
    kp_a, w_a = ex.extract(img_a)
    kp_b, w_b = ex.extract(img_b)
    ia, ib = _symmetric(w_a, w_b, device)
    matches = [(int(i), int(j)) for i, j in zip(ia, ib)]
    print(f"chapter 4: {len(matches)} symmetric matches")

    h, w = img_a.shape
    canvas = np.zeros((2 * h, w, 3), np.uint8)
    canvas[:h] = img_a[:, :, None]
    canvas[h:] = img_b[:, :, None]
    rng = np.random.default_rng(0)
    for i, j in matches:
        xa, ya = kp_a["point"][i]
        xb, yb = kp_b["point"][j]
        color = rng.integers(64, 255, 3)
        _draw_line(canvas, (xa, ya), (xb, yb + h), color)
    write_png(output, canvas)
    return matches


def _draw_line(canvas, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def chapter5_geometric_verification(device="cuda", seed=0):
    """Batched consensus + eight-point geometric verification with
    camera-motion printout (chapter5-geometric-verification/src/main.rs:36-82).
    Returns ``(model, inliers, matches)``."""
    from ..akaze import Akaze, AkazeExtractor, load_gray
    from ..camera import CameraIntrinsics
    from ..consensus import BatchConsensus, Estimator
    from ..core import Isometry3, camera_to_camera_residual, lie
    from ..core import pose as pose_mod
    from ..solvers import eight_point

    ex = AkazeExtractor(Akaze.new(0.001), device=device)
    kp_a, w_a = ex.extract(load_gray(KITTI0))
    kp_b, w_b = ex.extract(load_gray(KITTI14))
    ia, ib = _symmetric(w_a, w_b, device)
    print(f"chapter 5: {len(ia)} symmetric matches")

    intr = CameraIntrinsics.from_values(*KITTI_INTRINSICS, device=device)
    a = intr.calibrate(torch.as_tensor(kp_a["point"][ia], dtype=torch.float64, device=device))
    b = intr.calibrate(torch.as_tensor(kp_b["point"][ib], dtype=torch.float64, device=device))
    est = Estimator(
        min_samples=8,
        models_per_sample=4,
        estimate=lambda s: eight_point.estimate(s[0], s[1]),
        residual=lambda m, d: camera_to_camera_residual(
            Isometry3(rotation=m.rotation[..., None, :, :], translation=m.translation[..., None, :]), d[0], d[1]
        ),
        score=lambda m, d, valid, threshold: pose_mod.c2c_score(
            Isometry3(rotation=m.rotation[..., None, :, :], translation=m.translation[..., None, :]), d[0], d[1],
            valid, threshold,
        ),
    )
    cons = BatchConsensus(threshold=1e-7, hypotheses=2048, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    model, _, count = cons.model_inliers(generator, est, (a, b))
    print(f"chapter 5: {int(count)} inliers of {len(ia)} matches")
    t = model.translation.cpu().numpy()
    t = t / np.linalg.norm(t)
    w = lie.so3_log(model.rotation).cpu().numpy()
    print(f"camera motion (unscaled translation direction): {t.round(4)}")
    print(f"camera rotation (scaled axis, rad): {w.round(5)}")
    return model, int(count), len(ia)


CHAPTERS = {
    "2": chapter2_random_draw,
    "3": chapter3_akaze_extraction,
    "4": chapter4_feature_matching,
    "5": chapter5_geometric_verification,
}


def main(argv=None, *, device="cuda"):
    """Run one chapter (``argv[0]`` in 2-5) or all of them, the device work
    on ``device``."""
    args = argv if argv is not None else sys.argv[1:]
    chosen = [CHAPTERS[args[0]]] if args and args[0] in CHAPTERS else list(CHAPTERS.values())
    return [fn() if fn is chapter2_random_draw else fn(device=device) for fn in chosen]


if __name__ == "__main__":
    main()
