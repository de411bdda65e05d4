"""The port's skip march (`core/skipmarch.py`, the kernel's plain version on
CPU tensors) and the renderer's skip path against the JAX package.

Mirrors tests/test_skipmarch.py: the cone skip grids must be bit-equal to
JAX's; `skip_march` must give JAX's `k_idx` and `complete` exactly, with and
without jitter (the jitter words are those of `fold_in(key, 0)`, as the JAX
renderer derives them), and with a budget too small for every ray; the set
it emits must equal the port's own dense mask (the contract the loss and
the serving fallback rely on), on a cubic and an anisotropic box; and the
packed render through it must match the dense march's and JAX's skip render
to 1e-5 at f32 (tests/test_skipmarch.py's tolerance).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.core import ContractionAABB as JContractionAABB
from tinynerf_tpu.core import RayMarcherAABB as JRayMarcherAABB
from tinynerf_tpu.core.skipmarch import make_skip_grid as jmake_skip_grid
from tinynerf_tpu.core.skipmarch import skip_march as jskip_march
from tinynerf_tpu_torch.core import ContractionAABB, NerfRenderer, OccupancyGrid, OccupancyState, RayMarcherAABB
from tinynerf_tpu_torch.core import skipmarch
from tinynerf_tpu_torch.core.skipmarch import make_skip_grid, skip_march
from torch_world import CFG, make_scene, make_world

torch.set_num_threads(2)

T = torch.from_numpy
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
ANISO = ((-1.5, -0.6, -1.5), (1.5, 0.6, 1.5))  # y voxels 2.5x finer
RES, S = 16, 64


def random_grid(shape, density, seed):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.float32)


def random_rays(n, seed):
    """Unit directions from ~4 units out, aimed near the origin."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    return o.astype(np.float32), d


def jitter_words(key):
    """The seed words the JAX renderer hashes with: `fold_in(key, 0)`."""
    if key is None:
        return None, None
    jkey = jax.random.fold_in(key, 0)
    return jkey, [int(w) for w in np.asarray(jkey).astype(np.uint32).reshape(-1)]


def marching(aabb, res=RES, n_samples=S):
    """The pieces the renderer's march methods read, without a field."""
    marcher = RayMarcherAABB(aabb, n_samples=n_samples, near=0.1)
    return SimpleNamespace(marcher=marcher, contraction=ContractionAABB(aabb),
                           occupancy=OccupancyGrid.cube(res, marcher.step_size), skip_steps=n_samples)


def state_of(grid):
    return OccupancyState(grid=T(grid), mean=torch.tensor(float(grid.mean())))


@pytest.mark.parametrize("density,seed", [(0.01, 2), (0.05, 0), (0.3, 1)])
def test_make_skip_grid_bit_equal_to_jax(density, seed):
    for shape in ((RES,) * 3, (9, 12, 7)):
        occ = random_grid(shape, density, seed) > 0
        ours = make_skip_grid(T(occ))
        assert ours.dtype == torch.int32 and ours.shape == (6, *shape)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jmake_skip_grid(jnp.asarray(occ))))


def test_make_skip_grid_from_renderer_state():
    """`skip_grid` thresholds the state as the dense query does: 0 exactly on
    the voxels the occupancy query keeps."""
    m = marching(AABB)
    grid = random_grid((RES,) * 3, 0.1, 3) * np.random.default_rng(4).uniform(0, 0.02, (RES,) * 3)
    grid = grid.astype(np.float32)
    state = state_of(grid)
    sg = NerfRenderer.skip_grid(SimpleNamespace(occupancy=m.occupancy, marcher=m.marcher, supports_skip_march=True), state)
    kept = (grid > min(0.01, float(grid.mean())))
    assert 0 < kept.sum() < grid.size
    np.testing.assert_array_equal((sg[0] == 0).numpy(), kept)


_WORD = np.uint64(0xFFFFFFFF)


def _sweep_model(occ: np.ndarray) -> np.ndarray:
    """A numpy model of `csrc/skipmarch.cu` skip_grid_kernel: per (axis,
    sign) a sweep whose carry is a byte saturating at 128 (the plain
    version's carry runs to 2^20), the lateral dilation taken from rows of
    32-bit occupancy words by OR over 5 rows and shifts across the
    neighbouring words, the carry's 3x3 minimum over a plane padded with
    128, the output 0 on occupied voxels, else the carry clamped to 1..127."""
    grids = np.empty((6, *occ.shape), np.int32)
    for axis in range(3):
        o = np.moveaxis(occ, axis, 0)
        ra, rb, rc = o.shape
        nw = -(-rc // 32)
        cols = np.zeros((ra, rb, nw * 32), bool)
        cols[..., :rc] = o
        words = (cols.reshape(ra, rb, nw, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        x = np.zeros_like(words)
        for d in range(-2, 3):  # rows p - 2 .. p + 2, zero outside
            lo, hi = max(d, 0), rb + min(d, 0)
            x[:, lo - d : hi - d] |= words[:, lo:hi]
        xl, xr = np.zeros_like(x), np.zeros_like(x)
        xl[..., 1:], xr[..., :-1] = x[..., :-1], x[..., 1:]
        s = np.uint64
        dil = (x | x << s(1) | x << s(2) | x >> s(1) | x >> s(2) | xl >> s(30) | xl >> s(31) | xr << s(30)
               | xr << s(31)) & _WORD
        dil = ((dil[..., None] >> np.arange(32, dtype=np.uint64)) & s(1)).reshape(ra, rb, nw * 32)[..., :rc] > 0
        for sign, order in ((0, range(ra - 1, -1, -1)), (1, range(ra))):
            carry = np.full((rb + 2, rc + 2), 128, np.uint8)
            out = np.empty((ra, rb, rc), np.int32)
            for i in order:
                m = np.minimum(np.minimum(carry[:-2], carry[1:-1]), carry[2:])
                m = np.minimum(np.minimum(m[:, :-2], m[:, 1:-1]), m[:, 2:])
                new = np.where(dil[i], 0, np.minimum(m.astype(np.int32) + 1, 128)).astype(np.uint8)
                carry[1:-1, 1:-1] = new
                out[i] = np.where(o[i], 0, np.clip(new, 1, 127))
            grids[2 * axis + sign] = np.moveaxis(out, 0, axis)
    return grids


@pytest.mark.parametrize("shape", [(300, 6, 5), (5, 260, 7), (7, 6, 290), (20, 45, 70), (9, 12, 7)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("density", [0.0, 0.003, 0.05, 0.3, 1.0])
def test_skip_grid_saturating_carry_equals_plain(shape, density):
    """The kernel's premise on the plain path: a carry saturating at 128
    (`_sweep_model`) gives `make_skip_grid`'s values, on grids whose empty
    runs pass 128 slices (a band of 200 slices cleared on the long axis) and
    rows of more than one 32-bit word (45, 70 columns); a CPU tensor takes
    the plain version and launches nothing."""
    occ = np.random.default_rng(int(density * 1000) + sum(shape)).random(shape) < density
    long_axis = int(np.argmax(shape))
    if shape[long_axis] > 200 and 0.0 < density < 1.0:
        band = [slice(None)] * 3
        band[long_axis] = slice(40, 240)
        occ[tuple(band)] = False
        occ[(slice(None),) * long_axis + (20,)] = True  # something to see across the band
    before = make_skip_grid.launches
    ours = make_skip_grid(T(occ))
    assert make_skip_grid.launches == before
    assert torch.equal(ours, skipmarch.make_skip_grid_plain(T(occ)))
    np.testing.assert_array_equal(_sweep_model(occ), ours.numpy())
    if shape[long_axis] > 200 and 0.0 < density < 1.0:
        assert int((ours == 127).sum()) > 0  # distances that the byte carry saturates


@pytest.mark.parametrize("aabb", [AABB, ANISO], ids=("cube", "aniso"))
@pytest.mark.parametrize("density,seed", [(0.05, 0), (0.3, 1), (0.01, 2)])
def test_skip_march_plain_matches_jax(aabb, density, seed):
    """`k_idx` and `complete` exactly, with and without jitter, at the full
    budget (no ray truncated) and at 8 rounds (many are)."""
    m = marching(aabb)
    occ = random_grid((RES,) * 3, density, seed) > 0
    sg = jmake_skip_grid(jnp.asarray(occ))
    o, d = random_rays(256, seed)
    jm = JRayMarcherAABB(aabb, n_samples=S, near=0.1)
    jt_min, jt_exit = jm.entry_exit(jnp.asarray(o), jnp.asarray(d))
    t_min, t_exit = m.marcher.entry_exit(T(o), T(d))
    np.testing.assert_array_equal(t_min.numpy(), np.asarray(jt_min))
    for key in (None, jax.random.PRNGKey(11)):
        jkey, words = jitter_words(key)
        for n_steps in (S, 8):
            jk, jc = jskip_march(jnp.asarray(o), jnp.asarray(d), jt_min, jt_exit, jm.step_size, S,
                                 JContractionAABB(aabb), sg, jkey, n_steps)
            before = skip_march.launches
            k, c = skip_march(T(o), T(d), t_min, t_exit, m.marcher.step_size, S, aabb,
                              T(np.array(sg)), words, n_steps)
            assert skip_march.launches == before  # CPU tensors: the plain version
            assert k.dtype == torch.int32 and k.shape == (256, n_steps) and c.dtype == torch.bool
            np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
            if n_steps == S:
                assert bool(c.all())  # budget = S: never truncates


@pytest.mark.parametrize("aabb", [AABB, ANISO], ids=("cube", "aniso"))
@pytest.mark.parametrize("density,seed", [(0.05, 0), (0.3, 1), (0.01, 2)])
def test_skip_sample_set_equals_dense_mask(aabb, density, seed):
    """The port's skip march emits exactly its dense march's surviving
    samples (ascending, no duplicates), and `_march_skip` recomputes their
    positions bit for bit."""
    m = marching(aabb)
    state = state_of(random_grid((RES,) * 3, density, seed))
    sg = NerfRenderer.skip_grid(SimpleNamespace(occupancy=m.occupancy, marcher=m.marcher, supports_skip_march=True), state)
    o, d = (T(a) for a in random_rays(256, seed + 20))
    for key in (None, jax.random.PRNGKey(13)):
        _, words = jitter_words(key)
        cpos_d, _, mask_d = NerfRenderer._march(m, o, d, state, words)
        cpos_s, _, mask_s, complete = NerfRenderer._march_skip(m, o, d, sg, words)
        assert bool(complete.all())
        k_idx, _ = skip_march(o, d, *m.marcher.entry_exit(o, d), m.marcher.step_size, S,
                              aabb, sg, words, S)
        skip = np.zeros(mask_d.shape, bool)
        for r, row in enumerate(k_idx.numpy()):
            ks = row[row >= 0]
            assert (np.diff(ks) > 0).all()
            skip[r, ks] = True
        np.testing.assert_array_equal(mask_d.numpy() > 0, skip)
        kk = torch.clamp(k_idx, min=0).long()
        emitted = mask_s > 0
        dense_pos = torch.gather(cpos_d, 1, kk[..., None].expand(-1, -1, 3))
        assert torch.equal(cpos_s[emitted], dense_pos[emitted])


def test_skip_march_wrapper_refuses_bad_input():
    o = torch.zeros(4, 3)
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="skip grid"):
        skip_march(o, o, t, t, 0.1, 8, AABB, torch.zeros(5, 4, 4, 4, dtype=torch.int32), None, 4)
    with pytest.raises(ValueError, match="n_steps"):
        skip_march(o, o, t, t, 0.1, 8, AABB, torch.zeros(6, 4, 4, 4, dtype=torch.int32), None, 0)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: nothing falls back
        skip_march(o.to("meta"), o.to("meta"), t.to("meta"), t.to("meta"), 0.1, 8, AABB,
                   torch.zeros(6, 4, 4, 4, dtype=torch.int32, device="meta"), None, 4)


def test_skip_march_rounds_count():
    """The plain version's count of active rounds (the work an input needs,
    which `chip_smoke.py` turns into the kernel's bound) is what it says."""
    m = marching(AABB)
    occ = random_grid((RES,) * 3, 0.05, 5) > 0
    o, d = (T(a) for a in random_rays(64, 6))
    t_min, t_exit = m.marcher.entry_exit(o, d)
    args = (o, d, t_min, t_exit, m.marcher.step_size, S, AABB, make_skip_grid(T(occ)), None)
    k1, c1, rounds = skipmarch.skip_march_plain(*args, S, count_rounds=True)
    k2, c2 = skipmarch.skip_march_plain(*args, S)
    assert torch.equal(k1, k2) and torch.equal(c1, c2)
    assert (k1 >= 0).sum() <= rounds < 64 * S


# ----------------------------------------------------------- renderer level


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(make_scene(tmp_path_factory.mktemp("torch_skip_scene") / "spheres"))


def _occ_pair(world, density, seed):
    grid = random_grid((CFG["occupancy_res"],) * 3, density, seed)
    jocc = world["jr"].occupancy.init_state()._replace(grid=jnp.asarray(grid), mean=jnp.float32(grid.mean()))
    return state_of(grid), jocc


def test_render_packed_skip_matches_dense_and_jax(world):
    """At f32: the skip render equals the port's dense-march render and
    JAX's skip render (1e-5), with the same sample count and validity."""
    jr, r = world["jr"], world["renderers"]["float32"]
    assert r.skip_steps == jr.skip_steps == CFG["n_samples"]
    tocc, jocc = _occ_pair(world, 0.05, 4)
    o, d = random_rays(256, 5)
    sg, jsg = r.skip_grid(tocc), jr.skip_grid(jocc)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))
    jrender = jax.jit(jr.render_packed, static_argnames=("cap", "march"))
    for key in (None, jax.random.PRNGKey(7)):
        _, words = jitter_words(key)
        with torch.no_grad():
            dense = r.render_packed(tocc, T(o), T(d), 4096, jitter_seed=words)
            skip = r.render_packed(tocc, T(o), T(d), 4096, jitter_seed=words, march="skip", skip_grid=sg)
        ref = jrender(world["params"], jocc, jnp.asarray(o), jnp.asarray(d), cap=4096, key=key,
                      march="skip", skip_grid=jsg)
        np.testing.assert_allclose(skip.rgb.numpy(), dense.rgb.numpy(), atol=1e-5)
        np.testing.assert_allclose(skip.rgb.numpy(), np.asarray(ref.rgb), atol=1e-5)
        assert int(skip.n_samples) == int(dense.n_samples) == int(ref.n_samples) > 0
        np.testing.assert_array_equal(skip.ray_valid.numpy(), dense.ray_valid.numpy())
        np.testing.assert_array_equal(skip.ray_valid.numpy(), np.asarray(ref.ray_valid))
        assert int(skip.n_complete) == int(ref.n_complete) == 256
        assert int(dense.n_complete) == 256


def test_skip_truncation_flags_rays_invalid(world):
    """With a 4-round budget most rays cannot finish: they are flagged
    invalid (excluded from the loss, re-rendered densely when serving),
    never silently truncated, exactly as in JAX."""
    jr = dataclasses.replace(world["jr"], skip_steps=4)
    r = world["renderers"]["float32"]
    tocc, jocc = _occ_pair(world, 0.3, 6)
    o, d = random_rays(64, 7)
    r.skip_steps = 4
    try:
        with torch.no_grad():
            out = r.render_packed(tocc, T(o), T(d), 4096, march="skip", skip_grid=r.skip_grid(tocc))
    finally:
        r.skip_steps = CFG["n_samples"]
    ref = jr.render_packed(world["params"], jocc, jnp.asarray(o), jnp.asarray(d), cap=4096,
                           march="skip", skip_grid=jr.skip_grid(jocc))
    assert float(out.ray_valid.mean()) < 0.5
    np.testing.assert_array_equal(out.ray_valid.numpy(), np.asarray(ref.ray_valid))
    assert int(out.n_complete) == int(ref.n_complete) < 64


def test_supports_skip_march_rules(world):
    """Nearest occupancy, the AABB marcher and contraction: yes; without an
    occupancy grid: no; a renderer that cannot skip refuses a skip grid."""
    r = world["renderers"]["float32"]
    assert r.supports_skip_march and world["jr"].supports_skip_march
    bare = SimpleNamespace(occupancy=None, marcher=r.marcher, contraction=r.contraction)
    assert not NerfRenderer.supports_skip_march.fget(bare)
    assert not world["jr"].__class__.supports_skip_march.fget(dataclasses.replace(world["jr"], occupancy=None))
    with pytest.raises(ValueError, match="skip"):
        NerfRenderer.skip_grid(SimpleNamespace(supports_skip_march=False), world["tocc"])
    with pytest.raises(ValueError, match="skip_grid"):
        r.render_packed(world["tocc"], torch.zeros(2, 3), torch.ones(2, 3), 16, march="skip")
