from .contraction import ContractionAABB
from .marching import RayMarcherAABB
from .occupancy import OccupancyGrid, OccupancyState
from .renderer import NerfRenderer, RenderOutput

__all__ = [
    "ContractionAABB",
    "RayMarcherAABB",
    "OccupancyGrid",
    "OccupancyState",
    "NerfRenderer",
    "RenderOutput",
]
