"""AKAZE feature extraction: nonlinear scale space + M-LDB descriptors."""

from .config import Akaze, allocate_evolutions, from_numpy_config
from .extract import AkazeExtractor, load_gray, to_gray_f32
from .fast import DeviceExtractor, FastAkazeExtractor, FeatureSet

__all__ = [
    "Akaze",
    "AkazeExtractor",
    "DeviceExtractor",
    "FastAkazeExtractor",
    "FeatureSet",
    "allocate_evolutions",
    "from_numpy_config",
    "load_gray",
    "to_gray_f32",
]
