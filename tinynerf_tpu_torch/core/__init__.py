from .contraction import ContractionAABB, ContractionMip360
from .marching import RayMarcherAABB, RayMarcherUnbounded
from .occupancy import OccupancyGrid, OccupancyState
from .renderer import NerfRenderer, RenderOutput
from .skipmarch import make_skip_grid, make_skip_grid_iso, skip_march, skip_march_unbounded

__all__ = [
    "ContractionAABB",
    "ContractionMip360",
    "RayMarcherAABB",
    "RayMarcherUnbounded",
    "OccupancyGrid",
    "OccupancyState",
    "NerfRenderer",
    "RenderOutput",
    "make_skip_grid",
    "make_skip_grid_iso",
    "skip_march",
    "skip_march_unbounded",
]
