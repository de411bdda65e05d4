"""Carry parameters and occupancy state between the JAX package and the port.

The JAX renderer's parameters are a pytree

    {"field": {"planes": [[plane [r, r, F] per projection] per scale]},
     "sigma": {"mlp": [{"w": [in, out], "b": [out]}, ...]},
     "rgb":   {"mlp": [...]}}

of arrays; the port keeps the same tensors, in the same layouts, in the
renderer's field and decoder modules.  Both directions go through numpy
(the form checkpoints hold), so this module imports neither jax nor optax.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.occupancy import OccupancyState
from .core.renderer import NerfRenderer


def _copy_into(dst: torch.nn.Parameter, src, name: str) -> None:
    src = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(dst.shape) != src.shape:
        raise ValueError(f"{name}: shape {src.shape} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(src))


def _mlp_into(mlp, layers, name: str) -> None:
    if len(layers) != len(mlp.w):
        raise ValueError(f"{name}: {len(layers)} layers do not fit {len(mlp.w)}")
    for i, (layer, w, b) in enumerate(zip(layers, mlp.w, mlp.b)):
        _copy_into(w, layer["w"], f"{name}[{i}].w")
        _copy_into(b, layer["b"], f"{name}[{i}].b")


def load_params(renderer: NerfRenderer, params: dict) -> None:
    """Copy a JAX-layout parameter pytree (numpy or array leaves) into the
    renderer's modules, in place."""
    planes = params["field"]["planes"]
    if len(planes) != len(renderer.field.planes):
        raise ValueError(f"{len(planes)} scales do not fit {len(renderer.field.planes)}")
    for s, (src_scale, dst_scale) in enumerate(zip(planes, renderer.field.planes)):
        for p, (src, dst) in enumerate(zip(src_scale, dst_scale)):
            _copy_into(dst, src, f"planes[{s}][{p}]")
    _mlp_into(renderer.sigma_decoder.mlp, params["sigma"]["mlp"], "sigma")
    _mlp_into(renderer.rgb_decoder.mlp, params["rgb"]["mlp"], "rgb")


def params_to_numpy(renderer: NerfRenderer) -> dict:
    """The renderer's parameters as the JAX package's pytree of numpy arrays."""
    arr = lambda t: t.detach().cpu().numpy().copy()
    mlp = lambda m: [{"w": arr(w), "b": arr(b)} for w, b in zip(m.w, m.b)]
    return {
        "field": {"planes": [[arr(p) for p in scale] for scale in renderer.field.planes]},
        "sigma": {"mlp": mlp(renderer.sigma_decoder.mlp)},
        "rgb": {"mlp": mlp(renderer.rgb_decoder.mlp)},
    }


def occ_state_to_torch(state, device=None) -> OccupancyState:
    """Any (grid, mean) state, JAX or numpy leaves -> torch tensors."""
    grid = np.asarray(state.grid, dtype=np.float32)
    return OccupancyState(
        grid=torch.from_numpy(grid.copy()).to(device),
        mean=torch.tensor(float(np.asarray(state.mean)), dtype=torch.float32, device=device),
    )


def occ_state_to_numpy(state: OccupancyState) -> OccupancyState:
    """Torch (grid, mean) -> numpy leaves, as checkpoints hold them."""
    return OccupancyState(
        grid=state.grid.detach().cpu().numpy().copy(),
        mean=np.asarray(state.mean.detach().cpu().numpy(), dtype=np.float32),
    )
