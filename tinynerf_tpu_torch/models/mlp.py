"""Plain ReLU MLP: an `nn.Module` holding the weights, and functional applies.

Counterpart of `tinynerf_tpu/models/mlp.py`: in -> hidden x (1 +
hidden_layers) -> out, ReLU between layers, none on the output.  Weights
are stored `[in, out]` (activations @ W), the JAX package's layout, so
parameters carry across unchanged (`convert.py`).  Init is torch.nn.Linear's
default, U(+-1/sqrt(fan_in)) for weights and biases, drawn from an explicit
`torch.Generator`.

`compute_dtype`: parameters stay f32 masters and are cast per matmul.  The
split first layers accumulate their per-piece products in f32 (bf16 inputs,
f32 sums), as the JAX package's `preferred_element_type=float32` does; the
other layers output `compute_dtype`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        hidden_layers: int,
        out_features: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        out_features = out_features if out_features is not None else hidden_features
        dims = [in_features] + [hidden_features] * (1 + hidden_layers) + [out_features]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            bound = 1.0 / math.sqrt(d_in)
            u = lambda *shape: torch.empty(shape).uniform_(-bound, bound, generator=generator)
            self.w.append(nn.Parameter(u(d_in, d_out).to(device)))
            self.b.append(nn.Parameter(u(d_out).to(device)))

    def layers(self) -> List[dict]:
        """The JAX package's layer list: [{"w": [in, out], "b": [out]}, ...]."""
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]


def linear_apply(params: dict, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    w = params["w"].to(compute_dtype)
    b = params["b"].to(compute_dtype)
    return x.to(compute_dtype) @ w + b


def mlp_apply(params: List[dict], x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """ReLU between layers, identity on the output layer."""
    for layer in params[:-1]:
        x = torch.relu(linear_apply(layer, x, compute_dtype))
    return linear_apply(params[-1], x, compute_dtype)


def _dot_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x @ w with inputs rounded to `compute_dtype` and an f32 result.

    A product of two bf16 values is exact in f32, so an f32 matmul of the
    rounded inputs is a bf16 matmul with f32 accumulation."""
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def _tail(params: List[dict], acc: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = (acc + params[0]["b"].float()).to(compute_dtype)
    if len(params) == 1:
        return x
    x = torch.relu(x)
    for layer in params[1:-1]:
        x = torch.relu(linear_apply(layer, x, compute_dtype))
    return linear_apply(params[-1], x, compute_dtype)


def _first_layer_pieces(first: dict, pieces: Sequence[torch.Tensor], off: int,
                        acc: Optional[torch.Tensor], compute_dtype):
    for p in pieces:
        term = _dot_f32(p, first["w"][off : off + p.shape[-1]], compute_dtype)
        acc = term if acc is None else acc + term
        off += p.shape[-1]
    return acc, off


def mlp_apply_split(params: List[dict], pieces, compute_dtype=torch.float32) -> torch.Tensor:
    """mlp_apply(params, cat(pieces, -1)) with the first layer split into one
    product per piece against row slices of W, summed in f32."""
    first = params[0]
    acc, off = _first_layer_pieces(first, pieces, 0, None, compute_dtype)
    if off != first["w"].shape[0]:
        raise ValueError(f"pieces cover {off} inputs, first layer has {first['w'].shape[0]}")
    return _tail(params, acc, compute_dtype)


def mlp_apply_split_per_ray(
    params: List[dict], ray_pieces, seg: torch.Tensor, pieces,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """`mlp_apply_split` where the LEADING first-layer pieces are constant per
    ray: their f32 partial product is computed once per ray ([n_rays, d_i]
    pieces) and row-gathered to the samples through `seg`; `pieces` are the
    remaining per-sample pieces.  Forward-only (serving)."""
    first = params[0]
    acc_ray, off = _first_layer_pieces(first, ray_pieces, 0, None, compute_dtype)
    acc, off = _first_layer_pieces(first, pieces, off, acc_ray[seg], compute_dtype)
    if off != first["w"].shape[0]:
        raise ValueError(f"pieces cover {off} inputs, first layer has {first['w'].shape[0]}")
    return _tail(params, acc, compute_dtype)
