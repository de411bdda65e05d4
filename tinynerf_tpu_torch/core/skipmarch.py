"""Empty-space-skipping ray marching, for both marchers.

Counterpart of `tinynerf_tpu/core/skipmarch.py`.  Two skip grids and two
marches:

  * AABB (`make_skip_grid`, `skip_march`): a cone distance transform of
    the occupancy grid stores, per voxel and per (dominant axis, sign), how
    many axis slices a ray may advance before it can reach an occupied
    voxel; the march visits, per ray, one voxel per round and either emits
    the sample (occupied voxel, inside the box) or jumps over the
    certified-empty span.
  * Unbounded (`make_skip_grid_iso`, `skip_march_unbounded`): the Mip-360
    contraction bends world rays, so no cone can be certified; an isotropic
    grid stores the Chebyshev radius around each voxel that is empty, and
    the march converts that contracted radius into a world advance with a
    local Lipschitz bound of the order-inf contraction, then into a jump on
    the disparity grid through its closed-form inverse.

The emitted set equals the dense march's surviving set bit for bit, jitter
included: the grids absorb the nearest-voxel rounding and the jitter, the
advance bounds are conservative, and both marches compute a sample's
position by the same f32 operations in the same order, with the same
stateless hash (`ops/hashrng.py`).

Each march is one CUDA kernel on a CUDA tensor (`csrc/skipmarch.cu`: a ray
walks all its rounds with several lanes where the rays leave the card
idle, each lane probing one of the next candidates; eager PyTorch would
launch dozens of small ops per round) and the plain round loop (`walk`
over `aabb_candidates` / `unbounded_candidates`, as `skip_march_plain`,
`skip_march_unbounded_plain`) on a CPU tensor.  The JAX `_probe` is a TPU
lane trick for the same lookup; here it is a plain gather.  The grids are
built once per `render_only` and once per occupancy update: the cone grids
by one kernel on a CUDA tensor (`tn_skip_grid`: a cluster of blocks a
direction, each keeping a band of its sweep's carry plane in shared memory;
the plain slice loop, `make_skip_grid_plain`, launches ~3,570 small ops a
128^3 build), the isotropic grid in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops.hashrng import hash_u01

_INF = 1 << 20
_MAX_D = 127  # cone distances clip here; advances saturate long before


def _min3x3(x: torch.Tensor) -> torch.Tensor:
    """Min over the 3x3 lateral neighbourhood of the last two axes, cells
    outside the slice counting as _INF (the JAX package's min over the nine
    shifted carries, taken separably)."""
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=_INF)
    m = torch.minimum(torch.minimum(p[..., :-2, :], p[..., 1:-1, :]), p[..., 2:, :])
    return torch.minimum(torch.minimum(m[..., :-2], m[..., 1:-1]), m[..., 2:])


def _cone_sweep(occ_dil: torch.Tensor) -> torch.Tensor:
    """[..., r0, r1, r2] bool -> int32: D[v] = slices along +axis -3 to a
    dilated-occupied voxel within the lateral cone (|lateral| <= advance), 0
    on dilated-occupied voxels.  One reverse sweep over the axis -3 slices."""
    r0 = occ_dil.shape[-3]
    carry = torch.full((*occ_dil.shape[:-3], *occ_dil.shape[-2:]), _INF,
                       dtype=torch.int32, device=occ_dil.device)
    out = torch.empty(occ_dil.shape, dtype=torch.int32, device=occ_dil.device)
    zero = torch.zeros((), dtype=torch.int32, device=occ_dil.device)
    for i in range(r0 - 1, -1, -1):
        ahead = torch.clamp(_min3x3(carry) + 1, max=_INF)
        carry = torch.where(occ_dil[..., i, :, :], zero, ahead)
        out[..., i, :, :] = carry
    return out


def _dilate1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x | x shifted by +-1 along `axis` (zero fill)."""
    n = x.shape[axis]
    lo = torch.zeros_like(x)
    hi = torch.zeros_like(x)
    lo.narrow(axis, 0, n - 1).copy_(x.narrow(axis, 1, n - 1))
    hi.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
    return x | lo | hi


def make_skip_grid(occ_bool: torch.Tensor) -> torch.Tensor:
    """Cone skip grids for the six (dominant axis, sign) directions, in the
    order (+x, -x, +y, -y, +z, -z): int32 [6, r0, r1, r2].  Per voxel v and
    direction, 0 = v is occupied (the march emits it), k = every voxel a ray
    can visit within the next k - 1 axis slices (|lateral| <= advance + 1)
    is unoccupied.  Bit-equal to the JAX package's.  The kernel on a CUDA
    tensor (one launch; it raises on a grid whose slices do not fit a
    block's shared memory), the plain version on a CPU tensor."""
    if cuda_lib.runs_plain("make_skip_grid", occ_bool):
        return make_skip_grid_plain(occ_bool)
    if occ_bool.dim() != 3 or min(occ_bool.shape) < 1:
        raise ValueError(f"make_skip_grid: expected an occupancy grid [r0, r1, r2], got {tuple(occ_bool.shape)}")
    cuda_lib.check_cuda_inputs("make_skip_grid", torch.bool, occ_bool.shape, occ_bool)
    lib = cuda_lib.library()
    r0, r1, r2 = occ_bool.shape
    need, limit = lib.lib.tn_skip_grid_smem(r0, r1, r2), lib.lib.tn_smem_optin()
    if limit < 0:
        raise RuntimeError(f"make_skip_grid: reading the card's shared memory failed with CUDA error {-limit}")
    if need > limit:
        raise ValueError(f"make_skip_grid: the sweeps of a {(r0, r1, r2)} grid take {need} bytes of shared "
                         f"memory a block, the card gives {limit}")
    out = torch.empty((6, r0, r1, r2), dtype=torch.int32, device=occ_bool.device)
    lib.call("tn_skip_grid", occ_bool.data_ptr(), r0, r1, r2, out.data_ptr(), cuda_lib.stream_of(occ_bool))
    make_skip_grid.launches += 1
    return out


make_skip_grid.launches = 0


def make_skip_grid_plain(occ_bool: torch.Tensor) -> torch.Tensor:
    """The plain version of `make_skip_grid`: the JAX package's sweeps, one
    slice at a time."""
    grids = []
    for axis in (0, 1, 2):
        # 2-voxel lateral dilation: nearest-voxel rounding at both ends of a
        # skip can put a visited voxel 2 further out than the axis advance
        dil = occ_bool
        for lat in (0, 1, 2):
            if lat != axis:
                dil = _dilate1(_dilate1(dil, lat), lat)
        occ_a = torch.movedim(occ_bool, axis, 0)
        dil_a = torch.movedim(dil, axis, 0)
        # both signs in one sweep: the -axis grid is the +axis sweep of the
        # flipped grid, flipped back
        cone = _cone_sweep(torch.stack([dil_a, dil_a.flip(0)]))
        for c in (cone[0], cone[1].flip(0)):
            g = torch.where(occ_a, 0, torch.clamp(torch.clamp(c, min=1), 0, _MAX_D)).to(torch.int32)
            grids.append(torch.movedim(g, 0, axis))
    return torch.stack(grids).contiguous()


def _maxpool_shift(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over the shifts {-radius, 0, +radius} along every axis, vacated
    cells filled with 0 (not `max_pool3d`'s padding); on a radius-r pooled
    map this gives the radius-2r pool."""
    for axis in range(x.dim()):
        n = x.shape[axis]
        r = min(radius, n)
        lo = torch.zeros_like(x)
        hi = torch.zeros_like(x)
        lo.narrow(axis, 0, n - r).copy_(x.narrow(axis, r, n - r))
        hi.narrow(axis, r, n - r).copy_(x.narrow(axis, 0, n - r))
        x = torch.maximum(x, torch.maximum(lo, hi))
    return x


def make_skip_grid_iso(occ_bool: torch.Tensor, n_levels: int = 8) -> torch.Tensor:
    """Isotropic (Chebyshev-ball) skip grid for the curved contracted-space
    paths of the unbounded marcher: int32 [r0, r1, r2], per voxel v 0 = v is
    occupied (emit), g = every voxel within Chebyshev radius g - 1 of v is
    unoccupied.  Bit-equal to the JAX package's."""
    occ = occ_bool.float()
    g = torch.where(occ_bool, 0, 1).to(torch.int32)
    pooled = _maxpool_shift(occ, 1)
    radius = 1
    for _ in range(n_levels):
        g = torch.where(~occ_bool & (pooled == 0.0), min(1 + radius, _MAX_D), g).to(torch.int32)
        pooled = _maxpool_shift(pooled, radius)
        radius *= 2
    return g.contiguous()


def _aabb_arrays(aabb, shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, voxel widths) as float32: the widths as the JAX package
    computes them (the f32 extent over the integer voxel counts, in f64,
    then rounded to f32)."""
    lo, hi = (np.asarray(v, np.float32) for v in aabb)
    w = np.asarray((hi - lo) / np.array([s - 1 for s in shape]), np.float32)
    return lo, hi, w


def _check(rays_o, rays_d, t_min, t_exit, skip_grid, n_steps):
    r = rays_o.shape[0]
    if rays_o.shape != (r, 3) or rays_d.shape != (r, 3) or t_min.shape != (r,) or t_exit.shape != (r,):
        raise ValueError("skip_march: expected rays [R, 3] and entry / exit distances [R]")
    if skip_grid.dim() != 4 or skip_grid.shape[0] != 6 or min(skip_grid.shape[1:]) < 2:
        raise ValueError(f"skip_march: expected a skip grid [6, r0, r1, r2], got {tuple(skip_grid.shape)}")
    if n_steps < 1:
        raise ValueError(f"skip_march: n_steps must be >= 1, got {n_steps}")


def aabb_candidates(rays_o, rays_d, t_min, t_exit, step_size, n_samples, aabb, skip_grid, jitter_seed):
    """The AABB march's per-candidate functions: (k_end [R] int32, where a
    ray's walk ends; cand), where cand(kk), for one sample index per ray kk
    [R] (clamped to n_samples - 1), gives (emits [R] bool: the candidate is
    in the box and its voxel occupied; adv [R] int32 >= 1: how far a ray
    at kk moves), each from kk alone, in the JAX package's op order."""
    _check(rays_o, rays_d, t_min, t_exit, skip_grid, 1)
    dev = rays_o.device
    n_rays = rays_o.shape[0]
    _, r0, r1, r2 = skip_grid.shape
    lo_np, hi_np, w_np = _aabb_arrays(aabb, (r0, r1, r2))
    lo, hi, w_axis = (torch.from_numpy(a).to(dev) for a in (lo_np, hi_np, w_np))
    res = torch.tensor([r0 - 1, r1 - 1, r2 - 1], dtype=torch.float32, device=dev)
    flat = skip_grid.reshape(-1)
    ray_ids = torch.arange(n_rays, device=dev)
    # a 0-dim tensor on the rays' device: a CPU scalar divisor would be
    # turned into a reciprocal product by CUDA's division
    delta = torch.tensor(np.float32(step_size), device=dev)

    # dominant axis by INDEX rate (first maximum on ties): the cone bounds
    # the lateral index advance by the axis index advance
    idx_rate = rays_d.abs() / w_axis
    dom = torch.argmax(idx_rate, dim=-1)
    sign_neg = rays_d.gather(-1, dom[:, None])[:, 0] < 0.0
    grid_base = (dom * 2 + sign_neg.long()) * (r0 * r1 * r2)
    rate = delta * idx_rate.gather(-1, dom[:, None])[:, 0]
    # samples past the box exit are culled by the contraction's mask; +2
    # covers the 1-ulp disagreement of t_exit with that mask
    k_end = torch.clamp(torch.floor((t_exit - t_min) / delta) + 2.0, 0.0, float(n_samples)).to(torch.int32)

    ext = hi - lo
    zero = torch.zeros((), device=dev)

    def cand(kk):
        # the dense march's f32 order: (t_min + k * delta) + u * delta
        t = t_min + kk.float() * delta
        if jitter_seed is not None:
            t = t + hash_u01(jitter_seed, ray_ids, kk) * delta
        pos = rays_o + rays_d * t[:, None]
        inbox = torch.all((pos >= lo) & (pos <= hi), dim=-1)
        cpos = (pos - lo) / ext * 2.0 - 1.0
        idx = torch.minimum(torch.maximum(torch.round((cpos + 1.0) * 0.5 * res), zero), res).long()
        g = flat[grid_base + (idx[:, 0] * r1 + idx[:, 1]) * r2 + idx[:, 2]]
        # skipped sample k + i advances <= (i + 1) * rate + 1 axis slices,
        # all within the certified g - 1: m * rate <= g - 2
        adv = torch.clamp(torch.floor((g.float() - 2.0) / rate).to(torch.int32), min=1)
        return (g == 0) & inbox, adv

    return k_end, cand


def walk(k_end: torch.Tensor, cand, n_samples: int, n_steps: int, count_rounds: bool = False):
    """The round loop of both plain versions (one candidate per ray and
    round): a ray at k emits k if cand says so and moves by its advance,
    until k >= k_end.  Returns (k_idx, complete[, active rounds])."""
    k = torch.zeros_like(k_end)
    done = torch.zeros(k_end.shape, dtype=torch.bool, device=k_end.device)
    ys, rounds = [], 0
    for _ in range(n_steps):
        kk = torch.clamp(k, max=n_samples - 1)
        emits, adv = cand(kk)
        active = ~done & (k < k_end)
        k_next = torch.where(active, k + adv, k)
        done = done | (k_next >= k_end)
        ys.append(torch.where(active & emits, kk, -1))
        if count_rounds:
            rounds += int(active.sum())
        k = k_next
    k_idx = torch.stack(ys, dim=1)
    return (k_idx, done, rounds) if count_rounds else (k_idx, done)


def skip_march_plain(
    rays_o: torch.Tensor, rays_d: torch.Tensor, t_min: torch.Tensor, t_exit: torch.Tensor,
    step_size: float, n_samples: int, aabb, skip_grid: torch.Tensor, jitter_seed, n_steps: int,
    count_rounds: bool = False,
):
    """The plain version: the JAX package's round loop in its op order.
    With `count_rounds` it also returns the rounds in which a ray was still
    active (the work this input needs)."""
    _check(rays_o, rays_d, t_min, t_exit, skip_grid, n_steps)
    k_end, cand = aabb_candidates(rays_o, rays_d, t_min, t_exit, step_size, n_samples, aabb, skip_grid,
                                  jitter_seed)
    return walk(k_end, cand, n_samples, n_steps, count_rounds)


def _seed_words(jitter_seed, dev) -> Optional[torch.Tensor]:
    """The two jitter words as int64 [2] on `dev` (the kernels read them
    there), or None."""
    if jitter_seed is None:
        return None
    if isinstance(jitter_seed, torch.Tensor):
        seed = jitter_seed.to(device=dev, dtype=torch.int64).reshape(-1)
    else:
        seed = torch.tensor([int(s) for s in jitter_seed], dtype=torch.int64, device=dev)
    return torch.stack([seed[0], seed[-1]]).contiguous()


def _outputs(n_rays: int, n_steps: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty(n_rays, n_steps, dtype=torch.int32, device=dev),
            torch.empty(n_rays, dtype=torch.bool, device=dev))


def skip_march(
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3] unit-norm
    t_min: torch.Tensor,  # [R] box entry, as the marcher's entry_exit gives it
    t_exit: torch.Tensor,  # [R] box exit
    step_size: float,
    n_samples: int,
    aabb,
    skip_grid: torch.Tensor,  # [6, r0, r1, r2] int32 from make_skip_grid
    jitter_seed: Optional[object],
    n_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """March with cone empty-space skipping: (k_idx [R, n_steps] int32, the
    emitted sample indices in ascending order, -1 = none; complete [R] bool,
    False where the `n_steps` budget ran out before the ray finished).
    `jitter_seed` (two uint32 words, or None) jitters every sample as the
    dense march does.  The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if cuda_lib.runs_plain("skip_march", rays_o, rays_d, t_min, t_exit, skip_grid):
        return skip_march_plain(rays_o, rays_d, t_min, t_exit, step_size, n_samples, aabb,
                                skip_grid, jitter_seed, n_steps)
    args, k_idx, complete, _ = c_args_aabb(rays_o, rays_d, t_min, t_exit, step_size, n_samples, aabb,
                                           skip_grid, jitter_seed, n_steps)
    if rays_o.shape[0]:
        cuda_lib.library().call("tn_skip_march", *args, cuda_lib.stream_of(rays_o))
        skip_march.launches += 1
    return k_idx, complete


def c_args_aabb(rays_o, rays_d, t_min, t_exit, step_size, n_samples, aabb, skip_grid, jitter_seed,
                n_steps) -> tuple:
    """(the arguments of the C entry `tn_skip_march` before the stream,
    k_idx, complete, seed): CUDA inputs, checked here, new outputs, and the
    jitter words' tensor (or None) the arguments point into, which must
    outlive every launch with them."""
    _check(rays_o, rays_d, t_min, t_exit, skip_grid, n_steps)
    n_rays = rays_o.shape[0]
    cuda_lib.check_cuda_inputs("skip_march", torch.float32, (n_rays, 3), rays_o, rays_d)
    cuda_lib.check_cuda_inputs("skip_march", torch.float32, (n_rays,), t_min, t_exit)
    cuda_lib.check_cuda_inputs("skip_march", torch.int32, skip_grid.shape, skip_grid)
    seed = _seed_words(jitter_seed, rays_o.device)
    _, r0, r1, r2 = skip_grid.shape
    lo, hi, w = _aabb_arrays(aabb, (r0, r1, r2))
    k_idx, complete = _outputs(n_rays, n_steps, rays_o.device)
    return (rays_o.data_ptr(), rays_d.data_ptr(), t_min.data_ptr(), t_exit.data_ptr(), skip_grid.data_ptr(),
            seed.data_ptr() if seed is not None else None, n_rays, r0, r1, r2, n_samples,
            float(np.float32(step_size)), n_steps, *(float(v) for v in (*lo, *hi, *w)),
            k_idx.data_ptr(), complete.data_ptr()), k_idx, complete, seed


skip_march.launches = 0


# an upper bound on the Euclidean-in / Chebyshev-out Lipschitz constant of
# the order-inf Mip-360 contraction, its final / 2 included (the true one is
# ~0.50596, at ||x||_inf = 1.25 with two near-equal dominant coordinates)
_LIPSCHITZ = 0.5065


def _unbounded_constants(marcher, skip_grid: torch.Tensor) -> dict:
    """The march's f32 constants, each rounded as the JAX package rounds it."""
    r = skip_grid.shape[0]
    return dict(
        step_x=np.float32(marcher.step_x), rng=np.float32(marcher.uniform_range),
        near=np.float32(marcher.near),
        x_last=np.float32(marcher.n_samples) * np.float32(marcher.step_x),  # one past the last sample's x
        w_c=np.float32(2.0 / float(r - 1)),  # contracted voxel width
        inv_sqrt3=np.float32(1.0 / np.sqrt(3.0)), inv_lip=np.float32(1.0 / _LIPSCHITZ),
    )


def _check_unbounded(rays_o, rays_d, contraction, skip_grid, n_steps):
    r = rays_o.shape[0]
    if rays_o.shape != (r, 3) or rays_d.shape != (r, 3):
        raise ValueError("skip_march_unbounded: expected rays [R, 3]")
    # the certificate converts a Chebyshev voxel radius into a contracted
    # distance with one voxel width: a grid that is not cubic would need
    # its finest axis's
    if skip_grid.dim() != 3 or len(set(skip_grid.shape)) != 1 or skip_grid.shape[0] < 2:
        raise ValueError(f"skip_march_unbounded: expected a cubic skip grid [r, r, r], got {tuple(skip_grid.shape)}")
    if contraction.order != float("inf"):
        raise ValueError("skip_march_unbounded: the advance bound holds for the order-inf contraction only")
    if n_steps < 1:
        raise ValueError(f"skip_march_unbounded: n_steps must be >= 1, got {n_steps}")


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """||v||_2 over the last axis of [..., 3], summed in index order (a
    library reduction may fuse the products into FMAs on the card)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def unbounded_candidates(rays_o, rays_d, marcher, contraction, skip_grid, jitter_seed):
    """The unbounded march's per-candidate functions, as `aabb_candidates`
    (k_end = n_samples for every ray), in the op order of the JAX package's
    round loop (`tinynerf_tpu/core/skipmarch.py:skip_march_unbounded`).
    Every constant is an f32 0-dim tensor on the rays' device: a CPU scalar
    divisor would turn CUDA's division into a product with its reciprocal."""
    _check_unbounded(rays_o, rays_d, contraction, skip_grid, 1)
    dev = rays_o.device
    n_rays, n_samples = rays_o.shape[0], marcher.n_samples
    r0, r1, r2 = skip_grid.shape
    c = {k: torch.tensor(v, device=dev) for k, v in _unbounded_constants(marcher, skip_grid).items()}
    step_x, rng, near = c["step_x"], c["rng"], c["near"]
    res = torch.tensor([r0 - 1, r1 - 1, r2 - 1], dtype=torch.float32, device=dev)
    flat = skip_grid.reshape(-1)
    ray_ids = torch.arange(n_rays, device=dev)

    def t_of_x(x):
        f = torch.where(x < 0.5, 2.0 * x, 1.0 / torch.clamp(2.0 - 2.0 * x, min=1e-9))
        return f * rng + near

    def x_of_t(t):
        y = torch.clamp((t - near) / rng, min=0.0)
        return torch.where(y < 1.0, y * 0.5, 1.0 - 0.5 / torch.clamp(y, min=1.0))

    # per ray, the closest approach to the origin: past t every point's
    # radius is >= n_perp before it and >= the current radius after it
    t_star = -(rays_o[:, 0] * rays_d[:, 0] + rays_o[:, 1] * rays_d[:, 1] + rays_o[:, 2] * rays_d[:, 2])
    n_perp = _norm3(rays_o + rays_d * t_star[:, None])

    def cand(kk):
        # the dense march's t: t_of_x(k * step_x), then + u * delta
        t_lo = t_of_x(kk.float() * step_x)
        t = t_lo
        if jitter_seed is not None:
            delta = t_of_x((kk + 1).float() * step_x) - t_lo
            t = t_lo + hash_u01(jitter_seed, ray_ids, kk) * delta
        pos = rays_o + rays_d * t[:, None]
        cpos, _ = contraction(pos)
        idx = torch.clamp(torch.round((cpos + 1.0) * 0.5 * res), min=0.0)
        idx = torch.minimum(idx, res).long()
        g = flat[(idx[:, 0] * r1 + idx[:, 1]) * r2 + idx[:, 2]]
        # the contracted-empty radius rho = (g - 1) w_c; jittered skipped
        # samples stay within t_{k+m} - t_k of this one, whose contracted
        # displacement is at most L (t_{k+m} - t_k): safe while t_{k+m} <=
        # t_k + (rho - w_c) / L (the - w_c absorbs the rounding of both ends).
        # L is bounded over the rest of the ray [t, inf): at inf-radius m the
        # directional constant is at most F(m) = sqrt((1 - 1/(2m))^2 +
        # (1 - 1/m)^2) / m, decreasing past its peak at m = 1.25; every point
        # past t has inf-radius >= m0 = n_eff / sqrt(3), so for n_eff >= 2.25
        # (m0 >= 1.3) L <= F(m0), else the global bound
        rho = (g.float() - 1.0) * c["w_c"]
        n_eff = torch.clamp(torch.where(t < t_star, n_perp, _norm3(pos)), min=1.0)
        m0 = torch.clamp(n_eff * c["inv_sqrt3"], min=1.3)
        f_m0 = torch.sqrt((1.0 - 0.5 / m0) ** 2 + (1.0 - 1.0 / m0) ** 2) / m0
        l_inv = torch.where(n_eff >= 2.25, torch.maximum(1.0 / f_m0, c["inv_lip"]), c["inv_lip"])
        t_safe = t_lo + torch.clamp((rho - c["w_c"]) * l_inv, min=0.0)
        k_safe = torch.floor(torch.minimum(x_of_t(t_safe), c["x_last"]) / step_x).to(torch.int32)
        return g == 0, torch.clamp(k_safe - kk, min=1)

    return torch.full((n_rays,), n_samples, dtype=torch.int32, device=dev), cand


def skip_march_unbounded_plain(
    rays_o: torch.Tensor, rays_d: torch.Tensor, marcher, contraction, skip_grid: torch.Tensor,
    jitter_seed, n_steps: int, count_rounds: bool = False,
):
    """The plain version: the JAX package's round loop
    (`tinynerf_tpu/core/skipmarch.py:skip_march_unbounded`) in its op order.
    With `count_rounds` it also returns the rounds in which a ray was still
    active."""
    _check_unbounded(rays_o, rays_d, contraction, skip_grid, n_steps)
    k_end, cand = unbounded_candidates(rays_o, rays_d, marcher, contraction, skip_grid, jitter_seed)
    return walk(k_end, cand, marcher.n_samples, n_steps, count_rounds)


def skip_march_unbounded(
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3] unit-norm
    marcher,  # RayMarcherUnbounded
    contraction,  # ContractionMip360, order inf
    skip_grid: torch.Tensor,  # [r, r, r] int32 from make_skip_grid_iso
    jitter_seed: Optional[object],
    n_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """March the unbounded marcher's disparity grid with isotropic
    empty-space skipping; the same return contract as `skip_march`.  The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if cuda_lib.runs_plain("skip_march_unbounded", rays_o, rays_d, skip_grid):
        return skip_march_unbounded_plain(rays_o, rays_d, marcher, contraction, skip_grid,
                                          jitter_seed, n_steps)
    args, k_idx, complete, _ = c_args_unbounded(rays_o, rays_d, marcher, contraction, skip_grid, jitter_seed,
                                                n_steps)
    if rays_o.shape[0]:
        cuda_lib.library().call("tn_skip_march_unbounded", *args, cuda_lib.stream_of(rays_o))
        skip_march_unbounded.launches += 1
    return k_idx, complete


def c_args_unbounded(rays_o, rays_d, marcher, contraction, skip_grid, jitter_seed, n_steps) -> tuple:
    """(the arguments of the C entry `tn_skip_march_unbounded` before the
    stream, k_idx, complete, seed), as `c_args_aabb`."""
    _check_unbounded(rays_o, rays_d, contraction, skip_grid, n_steps)
    n_rays = rays_o.shape[0]
    cuda_lib.check_cuda_inputs("skip_march_unbounded", torch.float32, (n_rays, 3), rays_o, rays_d)
    cuda_lib.check_cuda_inputs("skip_march_unbounded", torch.int32, skip_grid.shape, skip_grid)
    seed = _seed_words(jitter_seed, rays_o.device)
    c = _unbounded_constants(marcher, skip_grid)
    k_idx, complete = _outputs(n_rays, n_steps, rays_o.device)
    return (rays_o.data_ptr(), rays_d.data_ptr(), skip_grid.data_ptr(), seed.data_ptr() if seed is not None else None,
            n_rays, skip_grid.shape[0], marcher.n_samples, n_steps,
            *(float(c[k]) for k in ("step_x", "rng", "near", "x_last", "w_c", "inv_sqrt3", "inv_lip")),
            k_idx.data_ptr(), complete.data_ptr()), k_idx, complete, seed


skip_march_unbounded.launches = 0
