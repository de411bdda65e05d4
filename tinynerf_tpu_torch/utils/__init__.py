import importlib

# loaded at first use, so that the ops and core modules can import
# `utils.trace` while `fixtures` imports them
_EXPORTS = {
    "make_shell_occupancy": "fixtures", "make_spheres_data": "fixtures", "make_spheres_pose_set": "fixtures",
    "make_synthetic_scene": "fixtures", "save_png": "image", "write_png": "image",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
