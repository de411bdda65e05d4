from .formats import Intrinsics, NerfData, pinhole_rays
from .parsers import parse_nerf_synthetic, parse_nerfstudio
from .pipeline import PoseSet, RayPool, sample_ray_batch

__all__ = [
    "Intrinsics", "NerfData", "pinhole_rays", "parse_nerf_synthetic", "parse_nerfstudio", "PoseSet",
    "RayPool", "sample_ray_batch",
]
