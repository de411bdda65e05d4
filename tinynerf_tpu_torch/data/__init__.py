from .formats import Intrinsics, NerfData, pinhole_rays
from .parsers import parse_nerf_synthetic
from .pipeline import PoseSet

__all__ = ["Intrinsics", "NerfData", "pinhole_rays", "parse_nerf_synthetic", "PoseSet"]
