"""Carry parameters and occupancy state between the JAX package and the port.

The JAX renderer's parameters are a pytree

    {"field": {"planes": [[plane [r, r, F] per projection] per scale]},
     "sigma": {"mlp": [{"w": [in, out], "b": [out]}, ...]},
     "rgb":   {"mlp": [...]}}

for K-Planes, with the field {"basis": [grid [r, r, r, C] per level],
"coef": [R, R, R, L], "mlp": [...]} for Cobafa and {"mlp": [...]} for the
vanilla field, of arrays (the port's Instant-NGP field, which the JAX
package lacks, is {"tables": [rows, 2]}); the port keeps
the same tensors, in the same layouts, in the renderer's field and decoder
modules (a K-Planes explicit opacity decoder holds {"linear": {"w", "b"}}
where an MLP decoder holds {"mlp": [...]}) (`param_tree` lists them in that layout, which the optimizer state
of a checkpoint shares).  Both directions
go through numpy (the form checkpoints hold), so this module imports
neither jax nor optax.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.occupancy import OccupancyState
from .core.renderer import NerfRenderer
from .models.cobafa import CobafaFeatureField
from .models.hashgrid import HashGridFeatureField
from .models.kplanes import KPlanesExplicitOpacityDecoder
from .models.vanilla import VanillaFeatureField


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


def _field_into(field, src: dict) -> None:
    if isinstance(field, VanillaFeatureField):
        _mlp_into(field.mlp, src["mlp"], "field mlp")
        return
    if isinstance(field, CobafaFeatureField):
        if len(src["basis"]) != len(field.basis):
            raise ValueError(f"{len(src['basis'])} basis levels do not fit {len(field.basis)}")
        for i, (a, dst) in enumerate(zip(src["basis"], field.basis)):
            _copy_into(dst, a, f"basis[{i}]")
        _copy_into(field.coef, src["coef"], "coef")
        _mlp_into(field.mlp, src["mlp"], "field mlp")
        return
    if isinstance(field, HashGridFeatureField):
        _copy_into(field.tables, src["tables"], "tables")
        return
    planes = src["planes"]
    if len(planes) != len(field.planes):
        raise ValueError(f"{len(planes)} scales do not fit {len(field.planes)}")
    for s, (src_scale, dst_scale) in enumerate(zip(planes, field.planes)):
        for p, (a, dst) in enumerate(zip(src_scale, dst_scale)):
            _copy_into(dst, a, f"planes[{s}][{p}]")


def decoder_into(decoder, src: dict, name: str) -> None:
    """Copy a decoder's JAX-layout parameters into the module, in place."""
    if isinstance(decoder, KPlanesExplicitOpacityDecoder):
        _copy_into(decoder.w, src["linear"]["w"], f"{name}.linear.w")
        _copy_into(decoder.b, src["linear"]["b"], f"{name}.linear.b")
    else:
        _mlp_into(decoder.mlp, src["mlp"], name)


def load_params(renderer: NerfRenderer, params: dict) -> None:
    """Copy a JAX-layout parameter pytree (numpy or array leaves) into the
    renderer's modules, in place."""
    _field_into(renderer.field, params["field"])
    decoder_into(renderer.sigma_decoder, params["sigma"], "sigma")
    decoder_into(renderer.rgb_decoder, params["rgb"], "rgb")


def _mlp_tree(m) -> list:
    return [{"w": w, "b": b} for w, b in zip(m.w, m.b)]


def decoder_tree(decoder) -> dict:
    """A decoder's parameters (the module tensors) in the JAX layout."""
    if isinstance(decoder, KPlanesExplicitOpacityDecoder):
        return {"linear": {"w": decoder.w, "b": decoder.b}}
    return {"mlp": _mlp_tree(decoder.mlp)}


def param_tree(renderer: NerfRenderer) -> dict:
    """The renderer's parameters (the module tensors themselves) in the JAX
    package's pytree layout."""
    field = renderer.field
    if isinstance(field, VanillaFeatureField):
        field_tree = {"mlp": _mlp_tree(field.mlp)}
    elif isinstance(field, CobafaFeatureField):
        field_tree = {"basis": list(field.basis), "coef": field.coef, "mlp": _mlp_tree(field.mlp)}
    elif isinstance(field, HashGridFeatureField):
        field_tree = {"tables": field.tables}
    else:
        field_tree = {"planes": [list(scale) for scale in field.planes]}
    return {
        "field": field_tree,
        "sigma": decoder_tree(renderer.sigma_decoder),
        "rgb": decoder_tree(renderer.rgb_decoder),
    }


def tree_leaves_with_path(tree, path=()):
    """(path, leaf) pairs in jax.tree_util's order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_map_with_path(fn, tree, path=()):
    """fn(path, leaf) applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_map(fn, tree):
    """`fn` applied to every leaf of a tree of dicts and lists."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def params_to_numpy(renderer: NerfRenderer) -> dict:
    """The renderer's parameters as the JAX package's pytree of numpy arrays."""
    return tree_map(to_numpy, param_tree(renderer))


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
