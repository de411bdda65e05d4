"""A model of the skip marches' windowed walk (`csrc/skipmarch.cu`
march_kernel) against the plain versions, on the CPU.

The kernel gives a ray `lanes` lanes: lane j computes candidate base + j
(its emit flag and target), the ray at k takes lane k - base's values,
emits k or -1 and moves to the target; a target beyond the window reloads
it there.  `windowed_walk` repeats that resolution round by round (the
stale values a lane keeps past the ray's end, the shuffle from lane 0 for a
finished ray, the clamp of a target to k_end, a warp that stops once all
its rays have finished) on a table of every candidate's values, taken from
the plain versions' own per-candidate functions (a candidate's values
depend on its index alone).  For lanes 1, 2, 8 and 32 its k_idx and
complete must equal `skip_march_plain` / `skip_march_unbounded_plain`
exactly, on tests/test_torch_skipmarch.py's and test_torch_unbounded.py's
random grids and rays, on an all-occupied grid (every step a unit step:
one window per `lanes` rounds) and an all-empty one (every step a jump),
with rays that miss the box (k_end = 0), with and without jitter, at
budgets of 1, 7 and 64 / 96 rounds.
"""

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.core import ContractionMip360, RayMarcherAABB, RayMarcherUnbounded, skipmarch

torch.set_num_threads(2)

T = torch.from_numpy
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
ANISO = ((-1.5, -0.6, -1.5), (1.5, 0.6, 1.5))
RES, S = 16, 64
LANES = (1, 2, 8, 32)
GRIDS = {"d0.01": 0.01, "d0.05": 0.05, "d0.3": 0.3, "full": 1.0, "empty": 0.0}
JITTER = [0x12345678, 0x9ABCDEF0]


def windowed_walk(k_end: torch.Tensor, emits: torch.Tensor, adv: torch.Tensor, n_steps: int, lanes: int):
    """The kernel's walk: rays in warps of 32 / lanes, a window of `lanes`
    candidates per ray.  emits, adv: [R, n_samples], candidate kc's values.
    Returns (k_idx, complete, windows loaded, candidates gathered)."""
    n_rays, n_samples = emits.shape
    rows = torch.arange(n_rays)
    warp = rows // (32 // lanes)
    k = torch.zeros(n_rays, dtype=torch.int64)
    base = torch.full((n_rays,), -lanes, dtype=torch.int64)
    k_end = k_end.long()
    done = k >= k_end
    window = torch.zeros(n_rays, lanes, dtype=torch.int64)  # target * 2 + emits
    out = torch.full((n_rays, n_steps), -1, dtype=torch.int64)
    loads = gathers = 0
    for s in range(n_steps):
        live = torch.zeros(int(warp.max()) + 1, dtype=torch.bool).index_put_((warp,), ~done, accumulate=True)[warp]
        if not bool(live.any()):
            break  # every warp has finished: the rest of each row stays -1
        load = live & ~done & (k - base >= lanes)
        base = torch.where(load, k, base)
        for j in range(lanes):
            kc = base + j
            ok = load & (kc < k_end)  # a candidate past the end is never reached
            kcc = torch.clamp(kc, max=n_samples - 1)
            target = kc + torch.minimum(adv[rows, kcc].long(), k_end - kc)
            window[:, j] = torch.where(ok, target * 2 + emits[rows, kcc].long(), window[:, j])
            gathers += int(ok.sum())
        loads += int(load.sum())
        got = window[rows, torch.where(done, 0, k - base)]
        out[:, s] = torch.where(live & ~done & (got % 2 == 1), k, -1)
        k = torch.where(done, k, got // 2)
        done = done | (k >= k_end)
    return out.int(), done, loads, gathers


def candidate_table(k_end, cand, n_rays: int, n_samples: int):
    """emits, adv [R, n_samples] from the plain versions' cand(kk)."""
    cols = [cand(torch.full((n_rays,), kc, dtype=torch.int32)) for kc in range(n_samples)]
    return torch.stack([c[0] for c in cols], 1), torch.stack([c[1] for c in cols], 1)


def rays_with_misses(n, seed):
    """Unit directions from ~4 units out aimed near the origin; every 8th
    ray turned around, so it leaves the box behind (k_end = 0)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[::8] *= -1.0
    return T(o.astype(np.float32)), T(d)


def occupancy(kind, shape, seed):
    return T(np.random.default_rng(seed).random(shape) < GRIDS[kind])


def aabb_case(box, kind, seed):
    marcher = RayMarcherAABB(box, n_samples=S, near=0.1)
    grid = skipmarch.make_skip_grid(occupancy(kind, (RES,) * 3, seed))
    o, d = rays_with_misses(256, seed + 10)
    t_min, t_exit = marcher.entry_exit(o, d)
    head = (o, d, t_min, t_exit, marcher.step_size, S, box, grid)
    return (lambda j: skipmarch.aabb_candidates(*head, j),
            lambda j, n_steps, **kw: skipmarch.skip_march_plain(*head, j, n_steps, **kw), S, (1, 7, 64))


def unbounded_case(kind, seed):
    marcher = RayMarcherUnbounded(n_samples=S, near=0.1, far=1e5, uniform_range=2.0)
    grid = skipmarch.make_skip_grid_iso(occupancy(kind, (RES,) * 3, seed))
    o, d = rays_with_misses(256, seed + 10)
    head = (o, d, marcher, ContractionMip360(), grid)
    return (lambda j: skipmarch.unbounded_candidates(*head, j),
            lambda j, n_steps, **kw: skipmarch.skip_march_unbounded_plain(*head, j, n_steps, **kw), S,
            (1, 7, 96))


CASES = {"aabb_cube": lambda kind, seed: aabb_case(AABB, kind, seed),
         "aabb_aniso": lambda kind, seed: aabb_case(ANISO, kind, seed),
         "unbounded": unbounded_case}


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("kind", list(GRIDS))
@pytest.mark.parametrize("case", list(CASES))
def test_windowed_walk_equals_plain(case, kind, lanes):
    candidates, plain, n_samples, budgets = CASES[case](kind, 3 + len(kind))
    for jitter in (None, JITTER):
        k_end, cand = candidates(jitter)
        emits, adv = candidate_table(k_end, cand, 256, n_samples)
        for n_steps in budgets:
            k_ref, c_ref, rounds = plain(jitter, n_steps, count_rounds=True)
            k_idx, complete, loads, gathers = windowed_walk(k_end, emits, adv, n_steps, lanes)
            assert torch.equal(k_idx, k_ref), (case, kind, lanes, jitter is not None, n_steps)
            assert torch.equal(complete, c_ref), (case, kind, lanes, jitter is not None, n_steps)
            # a window costs one round at least, and holds `lanes` candidates
            assert loads <= rounds and gathers <= lanes * loads
            if lanes == 1:
                assert loads == gathers == rounds
        if case.startswith("aabb"):
            assert int((k_end == 0).sum()) >= 256 // 8  # the rays that miss the box
            assert bool(c_ref[k_end == 0].all()) and bool((k_ref[k_end == 0] == -1).all())


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("case", list(CASES))
def test_windowed_walk_work(case, lanes):
    """Through an all-occupied grid every step is a unit step: one window
    per `lanes` rounds, rounded up per ray; through an all-empty one every
    step is a jump past the window (a ray ends within two): one window per
    round."""
    for kind in ("full", "empty"):
        candidates, plain, n_samples, budgets = CASES[case](kind, 5)
        k_end, cand = candidates(None)
        emits, adv = candidate_table(k_end, cand, 256, n_samples)
        n_steps = budgets[-1]
        _, _, rounds = plain(None, n_steps, count_rounds=True)
        _, _, loads, _ = windowed_walk(k_end, emits, adv, n_steps, lanes)
        if kind == "empty":
            assert loads == rounds <= 2 * int((k_end > 0).sum())
        else:
            assert bool((adv == 1).all())
            per_ray = torch.clamp(k_end.long(), max=n_steps)
            assert loads == int(((per_ray + lanes - 1) // lanes).sum())
