from .fixtures import make_shell_occupancy, make_spheres_pose_set
from .image import save_png, write_png

__all__ = ["make_shell_occupancy", "make_spheres_pose_set", "save_png", "write_png"]
