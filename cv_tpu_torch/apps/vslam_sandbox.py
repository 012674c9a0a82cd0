"""vslam-sandbox: end-to-end SfM over an image list with save/restore.

Port of ``cv_tpu/apps/vslam_sandbox.py`` (reference
vslam-sandbox/src/main.rs): the same flags, defaults (Zurich MAV dataset
intrinsics), persistence (``vslam.cvr``, the npz checkpoint that ``cv_tpu``
reads too), settings JSON, per-reconstruction normalization and PLY export.
The engine runs on the CUDA card; :func:`main` takes ``device`` as a
keyword for callers that want the CPU.

Usage:
    python -m cv_tpu_torch.apps.vslam_sandbox [options] IMAGES...
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(
        prog="vslam-sandbox", description="A tool for testing vslam algorithms"
    )
    p.add_argument("-d", "--data", default="vslam.cvr", type=Path)
    p.add_argument("-s", "--settings", default="vslam-settings.json", type=Path)
    p.add_argument("--export-maximum-cosine-distance", type=float, default=1e-6)
    p.add_argument("--export-robust-minimum-observations", type=int, default=3)
    p.add_argument("--x-focal", type=float, default=893.39010814)
    p.add_argument("--y-focal", type=float, default=898.32648616)
    p.add_argument("--x-center", type=float, default=951.1310043)
    p.add_argument("--y-center", type=float, default=555.13350077)
    p.add_argument("--skew", type=float, default=0.0)
    p.add_argument("--radial-distortion", type=float, default=-0.28052513)
    p.add_argument("--no-camera-faces", action="store_true")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument(
        "--video",
        type=Path,
        default=None,
        help="decode frames from a video file instead of image paths "
        "(cv_tpu_torch.video.VideoFileSource)",
    )
    p.add_argument(
        "--video-step", type=int, default=1, help="use every Nth video frame"
    )
    p.add_argument(
        "--video-limit", type=int, default=None, help="cap decoded video frames"
    )
    p.add_argument("images", nargs="*", type=Path)
    return p


def main(argv=None, *, device="cuda"):
    """Run the sandbox on ``argv`` with the engine on ``device``; returns
    the engine, its map saved."""
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    opt = build_parser().parse_args(argv)

    import torch

    from ..camera import CameraIntrinsics, CameraIntrinsicsK1Distortion
    from ..consensus import BatchConsensus
    from ..sfm import VSlam, VSlamData, VSlamSettings
    from ..utils.loader import PrefetchLoader

    device = torch.device(device)
    intrinsics = CameraIntrinsicsK1Distortion.new(
        CameraIntrinsics.from_values(
            opt.x_focal, opt.y_focal, opt.x_center, opt.y_center, skew=opt.skew, device=device
        ),
        opt.radial_distortion,
    )

    data = None
    if opt.data.exists():
        data = VSlamData.load(opt.data, device=device)
        logging.info("loaded existing reconstruction")
    settings = VSlamSettings()
    if opt.settings.exists():
        settings = VSlamSettings.from_json(opt.settings.read_text())
        logging.info("loaded existing settings")

    # Reference consensus budgets (vslam-sandbox/src/main.rs:105-117):
    # Arrsac initialization_hypotheses 16384 (single-view) / 8192 (two-view)
    # with 1024 candidate hypotheses; the batched analog runs the full
    # hypothesis budget up front plus inlier-refit rounds standing in for
    # ARRSAC's block-based refinement.
    vslam = VSlam(
        data=data,
        settings=settings,
        seed=0,
        single_view_consensus=BatchConsensus(
            threshold=settings.single_view_consensus_threshold,
            hypotheses=16384,
            refit_rounds=2,
            refit_hypotheses=1024,
            device=device,
        ),
        two_view_consensus=BatchConsensus(
            threshold=settings.two_view_consensus_threshold,
            hypotheses=8192,
            refit_rounds=2,
            refit_hypotheses=1024,
            device=device,
        ),
        device=device,
    )
    feed = vslam.add_feed(intrinsics)

    normalized = set()
    loader = None
    if opt.video is not None:
        # Decode frames from a video container (cv_tpu_torch.video).
        from ..video import VideoFileSource

        frames_iter = enumerate(
            VideoFileSource(opt.video, step=opt.video_step, limit=opt.video_limit)
        )

        def get_image(i, item):
            logging.info("video frame %d", i)
            return item
    else:
        # Prefetching loader: decode overlaps the engine's work.  On the
        # card's machine (which has nvcc) the row filters run compiled.
        loader = PrefetchLoader(opt.images, threads=4, compiled=device.type == "cuda")
        frames_iter = enumerate(opt.images)

        def get_image(i, item):
            logging.info("loading image %s", item)
            return loader.get(i)

    try:
        for i, item in frames_iter:
            image = get_image(i, item)
            frame = vslam.add_frame(feed, image)
            view = vslam.data.frames[frame].view
            if view is not None:
                reconstruction, _ = view
                if reconstruction not in normalized:
                    normalized.add(reconstruction)
                    logging.info("new reconstruction; normalizing")
                    vslam.normalize_reconstruction(reconstruction)
                if opt.output is not None:
                    if not opt.output.is_dir():
                        logging.warning("output path must be a directory; skipping export")
                    else:
                        # Export with temporarily tightened thresholds
                        # (main.rs:139-160).
                        old = vslam.settings
                        vslam.settings = old.replace(
                            maximum_cosine_distance=opt.export_maximum_cosine_distance,
                            robust_minimum_observations=opt.export_robust_minimum_observations,
                        )
                        out = opt.output / f"reconstruction-{reconstruction}.ply"
                        vslam.export_reconstruction(
                            reconstruction, out, camera_faces=not opt.no_camera_faces
                        )
                        vslam.settings = old
    finally:
        if loader is not None:
            loader.close()

    vslam.flush_pending()
    vslam.data.save(opt.data)
    logging.info("saved reconstruction data to %s", opt.data)

    for rec in list(vslam.data.reconstructions):
        views = len(vslam.data.reconstructions[rec].views)
        landmarks = len(vslam.data.reconstructions[rec].landmarks)
        print(f"reconstruction {rec}: {views} views, {landmarks} landmarks")
    return vslam


if __name__ == "__main__":
    main()
