"""Multi-device scaling: data-parallel extraction and hypothesis-sharded
consensus over a mesh of devices.

Port of ``cv_tpu/parallel/__init__.py``.  The reference pipeline is one CPU
process; its two natural scaling axes are frames (extraction is
embarrassingly data-parallel) and consensus hypotheses (each minimal set
is solved and scored on its own, and only the final lexicographic best
reduces across devices).  ``cv_tpu`` shards over a ``jax.sharding.Mesh``;
here a mesh is a tuple of ``torch.device``s, the visible CUDA devices by
default.  A mesh may name one device more than once: that runs the split
and the join on one card (or on the CPU) and gives the same answers.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

__all__ = [
    "make_mesh",
    "sharded_extract",
    "sharded_consensus",
]


def make_mesh(n_devices: int | None = None) -> tuple:
    """A 1-D mesh over the first ``n_devices`` visible CUDA devices (all of
    them by default)."""
    available = torch.cuda.device_count()
    if available == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass a tuple of devices instead")
    if n_devices is not None and n_devices > available:
        raise ValueError(f"requested a {n_devices}-device mesh but only {available} devices are available")
    return tuple(torch.device("cuda", i) for i in range(available if n_devices is None else n_devices))


def sharded_extract(extractor, images, mesh):
    """``DeviceExtractor.extract`` data-parallel over ``mesh``.

    ``images``: (B, H, W) with B divisible by the mesh size.  Device ``i``
    extracts the ``i``-th contiguous share of the frames with a copy of
    ``extractor`` placed on it; the shares' FeatureSets are concatenated on
    the extractor's own device, in frame order.  The host drives the shares
    one after another.
    """
    from ..akaze.fast import FeatureSet

    n = len(mesh)
    if images.shape[0] % n:
        raise ValueError(
            f"batch of {images.shape[0]} frames does not divide over the {n}-device mesh; "
            "pad the batch to a multiple"
        )
    share = images.shape[0] // n
    parts = []
    for i, device in enumerate(mesh):
        local = copy.copy(extractor)
        local.device = torch.device(device)
        fs = local.extract(images[i * share : (i + 1) * share])
        parts.append({f.name: getattr(fs, f.name).to(extractor.device) for f in dataclasses.fields(fs)})
    return FeatureSet(**{name: torch.cat([p[name] for p in parts]) for name in parts[0]})


def sharded_consensus(consensus, mesh):
    """A copy of ``consensus`` whose hypotheses are solved and scored over
    ``mesh`` (``BatchConsensus.hypothesis_sharding``): each device takes a
    contiguous share, and the best-model selection runs on the consensus's
    own device.  It draws the same minimal sets for the same generator as
    the original, so the answers are the unsharded run's."""
    return dataclasses.replace(consensus, hypothesis_sharding=tuple(torch.device(d) for d in mesh))
