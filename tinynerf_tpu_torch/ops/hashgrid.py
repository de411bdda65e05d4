"""Instant-NGP's multiresolution hash encoding (Mueller et al. 2022,
arXiv:2201.05989, section 3) and its table gradient, summed in a fixed order.

This field has no counterpart in the JAX package.  A `HashLayout` holds
L levels of resolution N_l over one flat table of rows of F = 2 features:
a level whose (N_l + 1)^3 vertices fit T = 2^log2_size rows is a dense
grid (row (x (N_l + 1) + y) (N_l + 1) + z, the port's [r, r, r, F]
layout), any finer level a table of T rows indexed by the spatial hash
(x * 1 ^ y * 2654435761 ^ z * 805459861) mod T in uint32 arithmetic.  A
position p in [-1, 1]^3 is x = (p + 1) / 2 in [0, 1]^3 at vertex
coordinate x N_l, clamped to [0, N_l]; the cell origin is its floor clipped
to [0, N_l - 1], so x = 1 interpolates inside the last cell with t = 1 (as
`ops/interp.py` `_cell_3d`).  Corners come in `CORNERS_3D` order, a
corner's weight is (wx wy) wz, and the lerp adds the corners in that order
in f32.

Four steps of kernels (`csrc/hashgrid.cu`), each with a plain PyTorch
version that the CPU runs and that the kernels repeat bit for bit:

  * `hash_encode`: the features [n, L F] f32 of n positions, every level's
    eight corner rows gathered from a bf16 copy of the table;
  * `hash_terms`: for each (sample, level, corner) its row as a sort key,
    its term index as the value, and the product w * g of its weight and
    the level's cotangent; a (sample, level) whose cotangent is all zero
    (the packed buffer's pad samples) gets the key `n_rows`, past every
    row, so that its terms are sorted last and dropped;
  * `hash_group`: the terms grouped by row, each row's in term order (the
    stable sort of the keys with the term indices as values), an LSD radix
    sort whose passes each read the pairs once; no library sort;
  * `hash_accumulate`: the sorted terms summed per row, each thread over a
    chunk of ACC_CHUNK of them in order, the runs that cross a chunk's end
    completed by a second kernel that adds the following chunks' partial
    sums in chunk order.  No float atomics.

The table gradient (`hash_table_grad`) is `hash_terms`, `hash_group`, then
`hash_accumulate`: each row's terms summed in term order, so a step
repeats itself bit for bit.  `hash_lookup` is the autograd Function of the
field; it saves only the positions, and its backward runs under the span
`field.table_grad`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from . import cuda_lib
from .bitonic import sort_pairs_i32_plain
from .octbuild import CORNERS_3D
from ..utils.trace import span

# the spatial hash's factor per axis (arXiv:2201.05989, eq. 4)
PRIMES = (1, 2654435761, 805459861)
FEATURES = 2  # per level: a row is one bf16 pair, 4 bytes, in the kernels
MAX_LEVELS = 32
# sorted terms summed in order by one thread of the accumulation kernel
ACC_CHUNK = 16
# terms a block of the grouping's passes moves (`csrc/hashgrid.cu` kTile)
GROUP_TILE = 4096


def level_resolutions(n_min: int, n_max: int, n_levels: int) -> Tuple[int, ...]:
    """N_l = floor(N_min b^l), b = exp((ln N_max - ln N_min) / (L - 1)), in
    float64 (in float32 the last of the published levels reads 2047)."""
    b = math.exp((math.log(n_max) - math.log(n_min)) / (n_levels - 1))
    return tuple(int(math.floor(n_min * b**level)) for level in range(n_levels))


@dataclass(frozen=True)
class HashLayout:
    """The levels of one table: resolutions N_l and T = 2^log2_size rows a
    hashed level; `offsets`, `hashed` and `rows` follow from them."""

    resolutions: Tuple[int, ...]
    log2_size: int

    def __post_init__(self):
        if not 1 <= len(self.resolutions) <= MAX_LEVELS or min(self.resolutions) < 1:
            raise ValueError(f"1 to {MAX_LEVELS} levels of resolution >= 1, got {self.resolutions}")
        if not 1 <= self.log2_size <= 30 or self.rows >= 2**31 - 1:
            raise ValueError(f"T = 2^{self.log2_size} rows a level ({self.rows} in all) do not fit int32")

    @property
    def size(self) -> int:
        return 1 << self.log2_size

    @property
    def hashed(self) -> Tuple[bool, ...]:
        return tuple((r + 1) ** 3 > self.size for r in self.resolutions)

    @property
    def level_rows(self) -> Tuple[int, ...]:
        return tuple(min((r + 1) ** 3, self.size) for r in self.resolutions)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(sum(self.level_rows[:level]) for level in range(len(self.resolutions)))

    @property
    def rows(self) -> int:
        return sum(self.level_rows)


@functools.lru_cache(maxsize=None)
def _levels_arg(layout: HashLayout):
    """The kernels' level table, [L, T - 1, N_l..., offset_l..., hashed_l...]
    int32 on the host (copied into each launch's parameters), kept alive here."""
    values = [len(layout.resolutions), layout.size - 1, *layout.resolutions, *layout.offsets,
              *(int(h) for h in layout.hashed)]
    return (ctypes.c_int * len(values))(*values)


def _levels_ptr(layout: HashLayout) -> int:
    return ctypes.addressof(_levels_arg(layout))


# ------------------------------------------------------------------ corners


def level_corners(pos: torch.Tensor, layout: HashLayout, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [n, 8] int64 of the flat table, weights [n, 8] f32) of level
    `level` at positions pos [n, 3] in [-1, 1], corners in `CORNERS_3D`
    order."""
    res = layout.resolutions[level]
    v = torch.clamp((pos.float() + 1.0) * 0.5 * float(res), 0.0, float(res))
    o = torch.clamp(torch.floor(v), 0.0, float(res - 1))
    t = v - o
    oi = o.long()
    wt = [(1.0 - t[:, a], t[:, a]) for a in range(3)]
    w = torch.stack([wt[0][dx] * wt[1][dy] * wt[2][dz] for dx, dy, dz in CORNERS_3D], dim=-1)
    ix, iy, iz = ([oi[:, a] + d for d in (0, 1)] for a in range(3))
    if layout.hashed[level]:
        local = [(ix[dx] * PRIMES[0]) ^ (iy[dy] * PRIMES[1]) ^ (iz[dz] * PRIMES[2]) for dx, dy, dz in CORNERS_3D]
        local = torch.stack(local, dim=-1) & (layout.size - 1)
    else:
        r1 = res + 1
        local = torch.stack([(ix[dx] * r1 + iy[dy]) * r1 + iz[dz] for dx, dy, dz in CORNERS_3D], dim=-1)
    return local + layout.offsets[level], w


# ------------------------------------------------------------------ forward


def hash_encode_plain(pos: torch.Tensor, table16: torch.Tensor, layout: HashLayout) -> torch.Tensor:
    """Plain PyTorch `hash_encode`: per level the eight corner rows, the
    corners weighted and added in order in f32."""
    table = table16.float()
    out = []
    for level in range(len(layout.resolutions)):
        rows, w = level_corners(pos, layout, level)
        vals = table[rows]  # [n, 8, F]
        acc = vals[:, 0] * w[:, 0:1]
        for c in range(1, 8):
            acc = acc + vals[:, c] * w[:, c : c + 1]
        out.append(acc)
    return torch.cat(out, dim=-1)


def hash_encode(pos: torch.Tensor, table16: torch.Tensor, layout: HashLayout) -> torch.Tensor:
    """The features [n, L F] f32 of positions pos [n, 3] f32 from the bf16
    table [rows, F]: on CUDA tensors `csrc/hashgrid.cu` `hash_encode_kernel`
    (a thread per (sample, level)), on CPU tensors its plain version."""
    if cuda_lib.runs_plain("hash_encode", pos, table16):
        return hash_encode_plain(pos, table16, layout)
    n = pos.shape[0]
    cuda_lib.check_cuda_inputs("hash_encode", torch.float32, (n, 3), pos)
    cuda_lib.check_cuda_inputs("hash_encode", torch.bfloat16, (layout.rows, FEATURES), table16)
    out = torch.empty(n, len(layout.resolutions) * FEATURES, dtype=torch.float32, device=pos.device)
    if n:
        cuda_lib.library().call("tn_hash_encode", pos.data_ptr(), table16.data_ptr(), _levels_ptr(layout), n,
                                out.data_ptr(), cuda_lib.stream_of(pos))
        hash_encode.launches += 1
    return out


hash_encode.launches = 0


# ------------------------------------------------------------------ backward


def _check_terms(n: int, layout: HashLayout) -> int:
    n_terms = n * len(layout.resolutions) * 8
    if n_terms >= 2**31:
        raise ValueError(f"hash_terms: {n} samples x {len(layout.resolutions)} levels x 8 corners pass int32")
    return n_terms


def hash_terms_plain(pos: torch.Tensor, g: torch.Tensor, layout: HashLayout):
    """Plain PyTorch `hash_terms`: (keys [T] int32, values [T] int32, products
    [T, F] f32), term (i L + l) 8 + c."""
    n, n_levels = pos.shape[0], len(layout.resolutions)
    _check_terms(n, layout)
    keys, prods = [], []
    for level in range(n_levels):
        rows, w = level_corners(pos, layout, level)
        gl = g[:, level * FEATURES : (level + 1) * FEATURES].float()
        zero = torch.all(gl == 0.0, dim=-1, keepdim=True)
        keys.append(torch.where(zero, layout.rows, rows))
        prods.append(w[:, :, None] * gl[:, None, :])
    keys = torch.stack(keys, dim=1).reshape(-1).to(torch.int32)
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=pos.device)
    return keys, vals, torch.stack(prods, dim=1).reshape(-1, FEATURES)


def hash_terms(pos: torch.Tensor, g: torch.Tensor, layout: HashLayout):
    """The terms of the table gradient for the cotangent g [n, L F] f32 at
    positions pos [n, 3]: on CUDA tensors `hash_terms_kernel`, on CPU
    tensors its plain version."""
    if cuda_lib.runs_plain("hash_terms", pos, g):
        return hash_terms_plain(pos, g, layout)
    n = pos.shape[0]
    n_terms = _check_terms(n, layout)
    cuda_lib.check_cuda_inputs("hash_terms", torch.float32, (n, 3), pos)
    cuda_lib.check_cuda_inputs("hash_terms", torch.float32, (n, len(layout.resolutions) * FEATURES), g)
    keys = torch.empty(n_terms, dtype=torch.int32, device=pos.device)
    vals = torch.empty_like(keys)
    prods = torch.empty(n_terms, FEATURES, dtype=torch.float32, device=pos.device)
    if n:
        cuda_lib.library().call("tn_hash_terms", pos.data_ptr(), g.data_ptr(), _levels_ptr(layout), n, layout.rows,
                                keys.data_ptr(), vals.data_ptr(), prods.data_ptr(), cuda_lib.stream_of(pos))
        hash_terms.launches += 1
    return keys, vals, prods


hash_terms.launches = 0


def hash_group_plain(keys: torch.Tensor, n_rows: int):
    """Plain PyTorch `hash_group`: the stable sort of the keys by their
    `n_rows.bit_length()` bits with the term indices as values."""
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device)
    return sort_pairs_i32_plain(keys, vals, 0, n_rows.bit_length())


def hash_group(keys: torch.Tensor, n_rows: int):
    """keys [T] int32 of `hash_terms` (rows, `n_rows` for a dropped term)
    -> (keys_s, vals_s) [T] int32: the terms grouped by row, each row's in
    term order, vals_s their term indices, the dropped terms last: the
    stable sort of the keys (`hash_group_plain`).  On CUDA tensors the
    `hash_group` kernels (an LSD radix sort of 8 bits a pass over the bits
    of `n_rows`, each pass one read of the pairs), on CPU tensors the plain
    version."""
    if cuda_lib.runs_plain("hash_group", keys):
        return hash_group_plain(keys, n_rows)
    n_terms = keys.numel()
    cuda_lib.check_cuda_inputs("hash_group", torch.int32, (n_terms,), keys)
    if n_terms >= 2**30 or not 1 <= n_rows < 2**31 - 1 or keys.data_ptr() % 16:
        raise ValueError(f"hash_group: {n_terms} terms (below 2^30, 16-byte aligned) into {n_rows} rows")
    bits = n_rows.bit_length()
    passes, tiles = -(-bits // 8), -(-n_terms // GROUP_TILE)
    keys_s, vals_s = torch.empty_like(keys), torch.empty_like(keys)
    # the passes before the last write here, in turns with keys_s, vals_s
    tmp_k, tmp_v = (torch.empty_like(keys), torch.empty_like(keys)) if passes > 1 else (keys_s, vals_s)
    # per pass its digit counts, its tile ticket and its tiles' look-back words
    scratch_ints = 4 * 257 + passes * 256 * tiles
    scratch = torch.empty(scratch_ints, dtype=torch.int32, device=keys.device)
    cuda_lib.library().call("tn_hash_group", keys.data_ptr(), n_terms, bits, scratch.data_ptr(), scratch_ints,
                            keys_s.data_ptr(), vals_s.data_ptr(), tmp_k.data_ptr(), tmp_v.data_ptr(),
                            cuda_lib.stream_of(keys))
    hash_group.launches += 1
    return keys_s, vals_s


hash_group.launches = 0


def hash_accumulate_plain(keys_s: torch.Tensor, vals_s: torch.Tensor, prods: torch.Tensor, n_rows: int):
    """Plain PyTorch `hash_accumulate`, in the kernel's association: the runs
    of equal keys inside each chunk of ACC_CHUNK terms summed in order from
    0, then each row's runs in order from 0; keys >= n_rows dropped."""
    out = torch.zeros(n_rows, FEATURES, dtype=torch.float32, device=prods.device)
    n_terms = keys_s.numel()
    if n_terms == 0:
        return out
    keys = keys_s.long()
    start = torch.ones(n_terms, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    start[::ACC_CHUNK] = True
    seg = torch.cumsum(start.long(), 0) - 1
    live = keys < n_rows
    partial = torch.zeros(int(seg[-1]) + 1, FEATURES, dtype=torch.float32, device=prods.device)
    partial.index_add_(0, seg[live], prods[vals_s.long()[live]])
    seg_key = keys[start]
    keep = seg_key < n_rows
    return out.index_add_(0, seg_key[keep], partial[keep])


def hash_accumulate(keys_s: torch.Tensor, vals_s: torch.Tensor, prods: torch.Tensor, n_rows: int) -> torch.Tensor:
    """-> [n_rows, F] f32: per row the sum of the products of its terms,
    read from the terms sorted by key (`keys_s`, `vals_s`) in their order.
    On CUDA tensors `hash_accumulate_kernel` and its combine kernel, on CPU
    tensors the plain version; rows without terms are exactly 0."""
    if cuda_lib.runs_plain("hash_accumulate", keys_s, vals_s, prods):
        return hash_accumulate_plain(keys_s, vals_s, prods, n_rows)
    n_terms = keys_s.numel()
    cuda_lib.check_cuda_inputs("hash_accumulate", torch.int32, (n_terms,), keys_s, vals_s)
    cuda_lib.check_cuda_inputs("hash_accumulate", torch.float32, (n_terms, FEATURES), prods)
    out = torch.empty(n_rows, FEATURES, dtype=torch.float32, device=prods.device)
    chunks = max(1, -(-n_terms // ACC_CHUNK))
    # per chunk: the sum of its leading run that continues the one before,
    # the sum of its last run where it owns that run and it continues, and
    # that run's key (-1: none)
    head = torch.empty(chunks, FEATURES, dtype=torch.float32, device=prods.device)
    tail = torch.empty_like(head)
    tail_key = torch.empty(chunks, dtype=torch.int32, device=prods.device)
    cuda_lib.library().call("tn_hash_accumulate", keys_s.data_ptr(), vals_s.data_ptr(), prods.data_ptr(), n_terms,
                            n_rows, head.data_ptr(), tail.data_ptr(), tail_key.data_ptr(), out.data_ptr(),
                            cuda_lib.stream_of(prods))
    hash_accumulate.launches += 1
    return out


hash_accumulate.launches = 0


def hash_table_grad(g: torch.Tensor, pos: torch.Tensor, layout: HashLayout) -> torch.Tensor:
    """The table gradient [rows, F] f32 of `hash_encode` at positions pos
    [n, 3] for the cotangent g [n, L F]: its terms, grouped by row in term
    order, each row's summed in that order."""
    keys, vals, prods = hash_terms(pos, g.float().contiguous(), layout)
    del vals  # the term indices, which `hash_group` makes itself
    keys_s, vals_s = hash_group(keys, layout.rows)
    del keys
    return hash_accumulate(keys_s, vals_s, prods, layout.rows)


class _HashLookup(torch.autograd.Function):
    """Forward: `hash_encode` of the table rounded to bf16.  Backward:
    `hash_table_grad` from the saved positions; positions get no gradient
    (they come from the no-grad march)."""

    @staticmethod
    def forward(ctx, tables, pos, layout):
        ctx.save_for_backward(pos)
        ctx.layout = layout
        return hash_encode(pos, tables.to(torch.bfloat16), layout)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        with span("field.table_grad"):
            return hash_table_grad(g, pos, ctx.layout), None, None


def hash_lookup(tables: torch.Tensor, pos: torch.Tensor, layout: HashLayout) -> torch.Tensor:
    """The multiresolution features [n, L F] f32 of positions pos [n, 3] in
    [-1, 1] from the f32 table [rows, F] (its corners rounded to bf16, the
    lerp in f32); the gradient flows to the table."""
    return _HashLookup.apply(tables, pos.float().contiguous(), layout)
