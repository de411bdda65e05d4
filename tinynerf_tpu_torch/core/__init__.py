from .contraction import ContractionAABB
from .marching import RayMarcherAABB
from .occupancy import OccupancyGrid, OccupancyState
from .renderer import NerfRenderer, RenderOutput
from .skipmarch import make_skip_grid, skip_march

__all__ = [
    "ContractionAABB",
    "RayMarcherAABB",
    "OccupancyGrid",
    "OccupancyState",
    "NerfRenderer",
    "RenderOutput",
    "make_skip_grid",
    "skip_march",
]
