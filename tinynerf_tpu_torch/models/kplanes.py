"""K-Planes feature field (arXiv 2301.10241).

Counterpart of `KPlanesFeatureField` in `tinynerf_tpu/models/kplanes.py`:
n_scales x 3 axis-aligned planes (xy, xz, yz), feature-last `[r, r, F]`,
init U(lo, hi) (`init_range`, U(0, 1) by default); per scale the feature is
the PRODUCT of the three bilinear lookups, in projection order.  The JAX
field's lookup options, with its defaults (`ops/interp.py` has each
lookup):

  * `lookup_mode` "fused" (the default): all lookups under one autograd
    Function (`multiscale_lookup_multiproj`), whose backward takes every
    table gradient on the finest grid through the sorted-window pipeline
    (on a CUDA device; how, by `bwd_impl`) or a scatter (on the CPU); with
    `shard_bwd_group` set (the data-parallel step sets it under
    `shard_bwd`) that backward splits its pullback over the group's ranks.
    Its forward by `fwd_mode`: "perscale" (the default) builds each plane's
    quad table (`build_quad`, a CUDA kernel on the card: nine builds per
    field call) and gathers one 4F row per sample; "fusedfine" builds one
    fused fine table per projection (three builds per field call) and
    gathers one [4 x n_scales F] row;
  * "quad": one quad table and one 4F row gather per plane, each plane's
    gradient through the cell route (`bilinear_lookup_quad`);
  * "mixed": four corner-row gathers per plane from the plane rounded to
    `gather_dtype`, the gradient summed in f32 and, with `scatter_dtype`
    "bfloat16", rounded once to bf16 (`bilinear_lookup_mixed`);
  * "plain": f32 corner gathers (`bilinear_lookup`; `gather_dtype` unused).

`gather_dtype` is "bfloat16" (the default), "float8" for float8_e4m3fn or
"float32"; the lerps are f32.  Every table gradient sums in a fixed order
on the card.  The TV and L1 regularizers are here, and their
row-partitioned partials, whose sum over blocks is the full loss (the
sharded-table step gives each rank one block).  The explicit
(bilinear-form) opacity and color decoders are here for parity with the
JAX package; `train()` wires the vanilla decoders.  Unlike the JAX field,
which takes any other name for f32 or its default, an unknown option
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.interp import (
    FWD_IMPLS, bilinear_lookup, bilinear_lookup_mixed, bilinear_lookup_quad, multiscale_lookup_multiproj,
)
from ..ops.trunc_exp import truncated_exp
from .encodings import posenc_dim, positional_encoding
from .mlp import MLP, linear_apply, mlp_apply_split, mlp_apply_split_per_ray

# coordinate pairs used per plane, in order: (x,y), (x,z), (y,z)
DIMENSION_PAIRS: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 2))

# the JAX field's default gather_dtype: tables round to bf16 before the lerp
GATHER_DTYPE = torch.bfloat16
# the field's gather_dtype names, as `tinynerf_tpu/models/kplanes.py` maps
# them (any other name is f32 there; here it raises)
GATHER_DTYPES = {"bfloat16": GATHER_DTYPE, "float8": torch.float8_e4m3fn, "float32": torch.float32}
LOOKUP_MODES = ("fused", "quad", "mixed", "plain")
SCATTER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_option(name: str, value: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {sorted(allowed)}, got {value!r}")


class KPlanesFeatureField(nn.Module):
    # optimizer groups (train/loop.py `_decay_mask`): the planes are tables
    table_keys = frozenset({"planes"})
    mlp_keys = frozenset()

    def __init__(
        self,
        feature_dim_per_plane: int = 32,
        resolutions: Tuple[int, ...] = (129, 257, 513),
        init_range: Tuple[float, float] = (0.0, 1.0),
        gather_dtype: str = "bfloat16",
        lookup_mode: str = "fused",
        scatter_dtype: str = "float32",
        fwd_mode: str = "perscale",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.feature_dim_per_plane = feature_dim_per_plane
        self.resolutions = tuple(resolutions)
        self.init_range = tuple(init_range)
        self.gather_dtype = gather_dtype
        self.lookup_mode = lookup_mode
        self.scatter_dtype = scatter_dtype  # "mixed" only
        self.fwd_mode = fwd_mode  # "fused" only
        self._check_options()
        lo, hi = self.init_range
        # planes[s][p]: scale s, projection p (DIMENSION_PAIRS order)
        self.planes = nn.ModuleList()
        for res in self.resolutions:
            scale = nn.ParameterList()
            for _ in DIMENSION_PAIRS:
                t = torch.empty(res, res, feature_dim_per_plane)
                t.uniform_(lo, hi, generator=generator)
                scale.append(nn.Parameter(t.to(device)))
            self.planes.append(scale)
        # a `parallel.DataGroup` while a data-parallel step splits the fused
        # backward's pullback over its ranks (the JAX `shard_bwd_axis`; the
        # other modes' gradients need no split)
        self.shard_bwd_group = None
        # how the fused backward accumulates the table gradient (the JAX
        # `bwd_mode`, `ops/interp.py` `_resolve_bwd_impl`): "auto" is the
        # sorted windows with the bf16 payload on a CUDA device, "sorted"
        # the same with the f32 payload, and "scatter" JAX's f32 scatter
        # values (on a CUDA device the f32 payload's pipeline)
        self.bwd_impl = "auto"

    @property
    def feature_dim(self) -> int:
        return self.feature_dim_per_plane * len(self.resolutions)

    def _check_options(self) -> None:
        check_option("gather_dtype", self.gather_dtype, GATHER_DTYPES)
        check_option("lookup_mode", self.lookup_mode, LOOKUP_MODES)
        check_option("scatter_dtype", self.scatter_dtype, SCATTER_DTYPES)
        check_option("fwd_mode", self.fwd_mode, FWD_IMPLS)

    def apply_pieces(self, x: torch.Tensor, compute_dtype=torch.float32) -> tuple:
        """x: [..., 3] in [-1, 1] -> per-scale features ([..., F] x n_scales),
        not concatenated: the decoders' split first layers take them as is."""
        self._check_options()
        gd = GATHER_DTYPES[self.gather_dtype]
        # each pair copied by a stack: list indexing would copy its index
        # list to the card at every call
        coords = [torch.stack((x[..., i], x[..., j]), dim=-1) for (i, j) in DIMENSION_PAIRS]
        if self.lookup_mode == "fused":
            n_scales = len(self.resolutions)
            per_proj = multiscale_lookup_multiproj(
                [[self.planes[s][p] for s in range(n_scales)] for p in range(len(DIMENSION_PAIRS))],
                coords, gd, bwd_impl=self.bwd_impl, shard_group=self.shard_bwd_group, fwd_impl=self.fwd_mode,
            )
            by_scale = [[pieces[s] for pieces in per_proj] for s in range(n_scales)]
        else:
            if self.lookup_mode == "quad":
                lookup = lambda p, c: bilinear_lookup_quad(p, c, gd)
            elif self.lookup_mode == "mixed":
                lookup = lambda p, c: bilinear_lookup_mixed(p, c, gd, SCATTER_DTYPES[self.scatter_dtype])
            else:
                lookup = bilinear_lookup
            by_scale = [[lookup(plane, c) for plane, c in zip(scale, coords)] for scale in self.planes]
        features = []
        for values in by_scale:
            acc = None
            for v in values:
                acc = v if acc is None else acc * v
            features.append(acc.to(compute_dtype))
        return tuple(features)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """x: [..., 3] -> [..., feature_dim] (the concatenated form)."""
        return torch.cat(self.apply_pieces(x, compute_dtype), dim=-1)

    def _planes(self):
        return (plane for scale_planes in self.planes for plane in scale_planes)

    def loss_tv(self) -> torch.Tensor:
        """Total-variation penalty averaged over all planes: the mean squared
        difference of neighbours along each plane axis (on the [r, r*F]
        view, as the JAX package computes it)."""
        total, count = 0.0, 0
        for plane in self._planes():
            r0, r1, f = plane.shape
            v = plane.reshape(r0, r1 * f)
            tv0 = torch.mean((v[1:, :] - v[:-1, :]) ** 2)
            tv1 = torch.mean((v[:, f:] - v[:, :-f]) ** 2)
            total = total + tv0 + tv1
            count += 1
        return total / count

    def loss_l1(self) -> torch.Tensor:
        """Mean |plane| averaged over all planes."""
        total, count = 0.0, 0
        for plane in self._planes():
            total = total + torch.mean(torch.abs(plane))
            count += 1
        return total / count

    # -- row-partitioned partials (the sharded-table step): the sum over
    # block_idx in [0, n_blocks) is the full loss, and so the sum of their
    # gradients the full gradient, while each block reads ~1/n_blocks of
    # every plane's rows (contiguous blocks, a one-row halo for the
    # cross-row differences), as `tinynerf_tpu/models/kplanes.py:
    # loss_tv_partial` blocks them

    def loss_tv_partial(self, block_idx: int, n_blocks: int) -> torch.Tensor:
        total, count = 0.0, 0
        for plane in self._planes():
            r0, r1, f = plane.shape
            w = r1 * f
            v = plane.reshape(r0, w)
            # cross-row pairs i in [0, r0 - 2], blocked by pair index
            q0 = -(-(r0 - 1) // n_blocks)
            lo, hi = block_idx * q0, min((block_idx + 1) * q0, r0 - 1)
            rows = v[lo : max(hi, lo) + 1]
            tv0 = torch.sum((rows[1:] - rows[:-1]) ** 2) / ((r0 - 1) * w)
            # within-row pairs, blocked by row
            q1 = min(-(-r0 // n_blocks), r0)
            rows = v[block_idx * q1 : min((block_idx + 1) * q1, r0)]
            tv1 = torch.sum((rows[:, f:] - rows[:, :-f]) ** 2) / (r0 * (w - f))
            total = total + tv0 + tv1
            count += 1
        return total / count

    def loss_l1_partial(self, block_idx: int, n_blocks: int) -> torch.Tensor:
        total, count = 0.0, 0
        for plane in self._planes():
            r0 = plane.shape[0]
            q = min(-(-r0 // n_blocks), r0)
            rows = plane[block_idx * q : min((block_idx + 1) * q, r0)]
            total = total + torch.sum(torch.abs(rows)) / plane.numel()
            count += 1
        return total / count


def _full(features) -> torch.Tensor:
    """The feature vector: the pieces' concat (a bilinear form needs it)."""
    return torch.cat(tuple(features), dim=-1) if isinstance(features, (tuple, list)) else features


class KPlanesExplicitOpacityDecoder(nn.Module):
    """sigma = truncated_exp(<f, W f + b> - 1): a learned bilinear form
    (`tinynerf_tpu/models/kplanes.py:KPlanesExplicitOpacityDecoder`; its
    parameters are {"linear": {"w": [F, F], "b": [F]}})."""

    def __init__(self, feature_dim: int, fwd_clamp: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.feature_dim = feature_dim
        self.fwd_clamp = fwd_clamp
        bound = 1.0 / feature_dim**0.5  # torch.nn.Linear's default init
        u = lambda *shape: torch.empty(shape).uniform_(-bound, bound, generator=generator).to(device)
        self.w = nn.Parameter(u(feature_dim, feature_dim))
        self.b = nn.Parameter(u(feature_dim))

    def forward(self, features, compute_dtype=torch.float32) -> torch.Tensor:
        features = _full(features)
        y = linear_apply({"w": self.w, "b": self.b}, features, compute_dtype)
        x = torch.sum(features.to(compute_dtype) * y, dim=-1)
        return truncated_exp(x.float() - 1.0, self.fwd_clamp)


class KPlanesExplicitColorDecoder(nn.Module):
    """rgb = sigmoid(<f, basis(d, f)>): an MLP of [posenc(d) | d | f] gives a
    [3, F] basis per sample (`tinynerf_tpu/models/kplanes.py:
    KPlanesExplicitColorDecoder`)."""

    def __init__(self, feature_dim: int, n_freqs: int = 8, hidden_dim: int = 128,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.feature_dim = feature_dim
        self.n_freqs = n_freqs
        in_dim = feature_dim + posenc_dim(3, n_freqs) + 3
        self.mlp = MLP(in_dim, hidden_dim, 3, 3 * feature_dim, generator, device)

    def _combine(self, features: torch.Tensor, basis: torch.Tensor, compute_dtype) -> torch.Tensor:
        basis = basis.reshape(*features.shape[:-1], 3, self.feature_dim)
        out = torch.sum(features[..., None, :].to(compute_dtype) * basis, dim=-1)
        return torch.sigmoid(out.float())

    def forward(self, features, rays_d: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        features = _full(features)
        pieces = (positional_encoding(rays_d, self.n_freqs), rays_d, features)
        return self._combine(features, mlp_apply_split(self.mlp.layers(), pieces, compute_dtype), compute_dtype)

    def apply_per_ray(self, features, d_ray: torch.Tensor, seg: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
        """Serving variant: the direction branch once per ray (d_ray [n_rays,
        3]), gathered to the samples through `seg`."""
        features = _full(features)
        ray_pieces = (positional_encoding(d_ray, self.n_freqs), d_ray)
        basis = mlp_apply_split_per_ray(self.mlp.layers(), ray_pieces, seg, (features,), compute_dtype)
        return self._combine(features, basis, compute_dtype)
