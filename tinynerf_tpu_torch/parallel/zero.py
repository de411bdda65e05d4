"""ZeRO-1 partitioning of the feature tables' optimizer state.

Counterpart of `tinynerf_tpu/parallel/zero.py`, with its names.  In the
replicated data-parallel step every rank holds every Adam moment and
updates every table; with `shard_tables` the table gradients ride one
reduce-scatter of their flat views instead of an all-reduce, each rank
keeps and updates only its 1/N slice of each table's moments, and the
updated slices are all-gathered back into full tables.

Tables are the leaves the field DECLARES (`field.table_keys`), found by
path in any tree that embeds the parameter tree (the parameters, the
gradients, Adam's mu / nu), never by shape.  A table leaf of L elements is
viewed as a zero-padded flat f32 vector of Lp = ceil(L / N) * N elements:
the global view holds all Lp, rank r's local view elements [r Lp / N,
(r + 1) Lp / N).  Zero padding is a fixed point of Adam with weight decay
(gradient 0 and parameter 0 give update 0), so the pads stay 0.

Trees are the JAX layout of `convert.py` (dicts and lists); paths are the
key tuples of `convert.tree_leaves_with_path`.  The collectives are the
group's (`parallel/mesh.py`).
"""

from __future__ import annotations

import math
from typing import FrozenSet

import torch

from ..convert import tree_leaves_with_path, tree_map_with_path
from .mesh import DataGroup


def path_is_table(path, table_keys: FrozenSet[str]) -> bool:
    """True iff `path` addresses a declared table: a "field" component
    followed somewhere by a declared table key (so a prefix such as Adam's
    "mu" does not matter)."""
    if "field" not in path:
        return False
    i = path.index("field")
    return any(k in table_keys for k in path[i + 1 :])


def table_mask_tree(tree, table_keys: FrozenSet[str]):
    """Tree of bools over `tree`: True = sharded table leaf."""
    return tree_map_with_path(lambda path, _: path_is_table(path, table_keys), tree)


def has_tables(params, table_keys: FrozenSet[str]) -> bool:
    return any(path_is_table(path, table_keys) for path, _ in tree_leaves_with_path(params))


def padded_len(n: int, shards: int) -> int:
    return math.ceil(n / shards) * shards


def flat_view(t: torch.Tensor, shards: int) -> torch.Tensor:
    """A table leaf as its zero-padded flat [Lp] vector."""
    flat = t.reshape(-1)
    lp = padded_len(flat.shape[0], shards)
    return torch.cat([flat, flat.new_zeros(lp - flat.shape[0])]) if lp > flat.shape[0] else flat


def local_slice(t: torch.Tensor, shards: int, idx: int) -> torch.Tensor:
    """Slice `idx` [Lp / shards] of a table leaf's flat view (a copy)."""
    flat = t.reshape(-1)
    lp = padded_len(flat.shape[0], shards)
    n = lp // shards
    out = flat.new_zeros(n)
    lo, hi = idx * n, min((idx + 1) * n, flat.shape[0])
    if hi > lo:
        out[: hi - lo] = flat[lo:hi]
    return out


def global_view(tree, table_keys: FrozenSet[str], n_shards: int):
    """Each table leaf replaced by its flat [Lp] view; the structure (and so
    every path-based mask) is unchanged."""
    return tree_map_with_path(
        lambda path, leaf: flat_view(leaf, n_shards) if path_is_table(path, table_keys) else leaf, tree)


def local_view(tree, table_keys: FrozenSet[str], n_shards: int, shard_idx: int):
    """Each table leaf replaced by slice `shard_idx` [Lp / n] of its flat
    view; other leaves untouched."""
    return tree_map_with_path(
        lambda path, leaf: (local_slice(leaf, n_shards, shard_idx)
                            if path_is_table(path, table_keys) else leaf), tree)


def reduce_grads(grads, table_keys: FrozenSet[str], group: DataGroup):
    """The gradient view: table leaves reduce-scattered to this rank's flat
    slice of the sum over ranks, other leaves all-reduced (summed)."""

    def go(path, g):
        if path_is_table(path, table_keys):
            return group.reduce_scatter_sum(flat_view(g, group.world))
        return group.all_reduce_sum(g)

    return tree_map_with_path(go, grads)


def unview(view_tree, like_tree, table_keys: FrozenSet[str], group: DataGroup):
    """Each local table slice all-gathered back to its leaf's full shape in
    `like_tree`; other leaves pass through."""
    like = dict(tree_leaves_with_path(like_tree))

    def go(path, v):
        if not path_is_table(path, table_keys):
            return v
        full = group.all_gather(v)
        shape = like[path].shape
        return full[: math.prod(shape)].reshape(shape)

    return tree_map_with_path(go, view_tree)
