"""The incremental vSLAM/SfM reconstruction engine (cv-sfm)."""

from .data import VSlamData
from .engine import VSlam
from .settings import VSlamSettings

__all__ = ["VSlam", "VSlamData", "VSlamSettings"]
