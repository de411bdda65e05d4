from .fixtures import make_shell_occupancy, make_spheres_data, make_spheres_pose_set, make_synthetic_scene
from .image import save_png, write_png

__all__ = [
    "make_shell_occupancy", "make_spheres_data", "make_spheres_pose_set", "make_synthetic_scene", "save_png",
    "write_png",
]
