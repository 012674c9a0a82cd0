"""Synthetic rendered image sequences for end-to-end SfM benchmarks/tests.

The reference ships only a two-frame KITTI pair (res/source.txt), which
cannot exercise a multi-frame vslam-sandbox run.  This module renders a
"star field": random 3-D points splatted as Gaussian blobs through a pinhole
camera along a smooth trajectory.  The blobs are real image structure — the
full AKAZE frontend (scale space, extrema, M-LDB) and the engine's matching /
consensus / BA all run unmodified on the rendered frames.

Purely host-side NumPy; rendering is not part of any benchmark timing.
Carried over unchanged from ``cv_tpu/apps/synth.py``.
"""

from __future__ import annotations

import numpy as np


def render_sequence(
    n_frames: int = 24,
    height: int = 512,
    width: int = 640,
    n_points: int = 900,
    seed: int = 0,
    fx: float = 520.0,
    fy: float = 520.0,
):
    """Render a star-field sequence.

    Returns ``(images, intrinsics_values, poses)`` where ``images`` is a
    list of (H, W) uint8 frames, ``intrinsics_values`` is ``(fx, fy, cx,
    cy)`` and ``poses`` the ground-truth (R, t) world->camera pairs.
    """
    rng = np.random.default_rng(seed)
    cx, cy = width / 2.0, height / 2.0
    # Points in a slab in front of the trajectory.
    # A modest depth slab keeps blob scale stable across the trajectory so
    # M-LDB descriptors stay matchable several frames apart.
    # Points on a smoothly undulating surface (not a random depth slab):
    # like real scenes, nearby features share depth, so local neighborhoods
    # shift coherently under parallax and descriptors stay matchable across
    # wide baselines, while the global depth variation still provides the
    # parallax the engine's robustness predicates need.
    px = rng.uniform(-7.0, 7.0, n_points)
    py = rng.uniform(-5.0, 5.0, n_points)
    pz = (
        12.0
        + 2.2 * np.sin(px / 2.8) * np.cos(py / 2.2)
        + 0.8 * np.sin(py / 1.1)
        + rng.normal(0.0, 0.12, n_points)
    )
    points = np.stack([px, py, pz], axis=-1)
    amps = rng.uniform(0.45, 1.0, n_points)
    sigmas = rng.uniform(1.3, 2.4, n_points)
    # Anisotropic, individually-shaped blobs: the M-LDB descriptor then
    # encodes each blob's own gradient profile instead of the (parallax-
    # sensitive) constellation of its neighbors.
    elong = rng.uniform(1.0, 2.6, n_points)
    phi = rng.uniform(0.0, np.pi, n_points)
    lobes = rng.uniform(-0.45, 0.45, (n_points, 2))

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    poses = []
    for i in range(n_frames):
        r = rot_y(0.005 * i)
        # Lateral motion sized so frames >= 2 apart clear the engine's
        # robust-incidence floor (1e-3 cosine distance ~ 2.6 deg: baseline
        # 0.7 at mean depth 12.5 ~ 3.2 deg).
        center = np.array([0.35 * i, 0.02 * i, 0.1 * i])  # camera center
        t = -r @ center
        poses.append((r, t))

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    images = []
    for r, t in poses:
        cam = points @ r.T + t
        vis = cam[:, 2] > 1e-3
        u = fx * cam[:, 0] / cam[:, 2] + cx
        v = fy * cam[:, 1] / cam[:, 2] + cy
        # Perspective-correct blob size.
        s = sigmas * 10.0 / cam[:, 2]
        img = np.zeros((height, width), np.float32)
        margin = 8.0
        for j in np.nonzero(
            vis & (u > -margin) & (u < width + margin) & (v > -margin) & (v < height + margin)
        )[0]:
            sj = max(float(s[j]), 0.8)
            r0 = int(max(0, v[j] - 4 * sj))
            r1 = int(min(height, v[j] + 4 * sj + 1))
            c0 = int(max(0, u[j] - 4 * sj))
            c1 = int(min(width, u[j] + 4 * sj + 1))
            if r0 >= r1 or c0 >= c1:
                continue
            dy = yy[r0:r1, c0:c1] - v[j]
            dx = xx[r0:r1, c0:c1] - u[j]
            cph, sph = np.cos(phi[j]), np.sin(phi[j])
            du = cph * dx + sph * dy
            dv = -sph * dx + cph * dy
            body = np.exp(
                -(du * du * elong[j] + dv * dv / elong[j]) / (2.0 * sj * sj)
            )
            # A dimmer offset side-lobe gives each blob a unique asymmetric
            # gradient signature.
            lu = du - lobes[j, 0] * sj * 2.0
            lv = dv - lobes[j, 1] * sj * 2.0
            lobe = 0.55 * np.exp(-(lu * lu + lv * lv) / (1.2 * sj * sj))
            img[r0:r1, c0:c1] += amps[j] * (body + lobe)
        img = np.clip(img, 0.0, 1.0)
        images.append((img * 255.0).astype(np.uint8))
    return images, (fx, fy, cx, cy), poses
