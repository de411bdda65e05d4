"""The training slice's ops and units (tinynerf_tpu_torch) against the JAX
package's.

Inputs are made with numpy from a seed and handed to both packages; the
JAX Pallas kernels run in interpret mode on the CPU, as the JAX suite runs
them, and the port runs its plain versions here (CPU tensors).  The CUDA
kernels against these plain versions are in test_torch_kernels.py.

Tolerances: hash bits and sorts equal; weight gradients atol 1e-5 (f32
scans in another order, as tests/test_segscan.py); table gradients 3e-5 of
their largest magnitude (tests/test_table_grad.py: the JAX kernel
accumulates (hi, lo) bf16 pairs, ~2^-16 relative); the multiscale lookup's
table gradients 1e-4 of the largest (f32 sums in another order through the
upsampling transpose); regularizers 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.data import RayPool as JRayPool
from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.models import make_model as jmake_model
from tinynerf_tpu.ops import bitonic as jbitonic
from tinynerf_tpu.ops import interp as jinterp
from tinynerf_tpu.ops import table_grad as jtable_grad
from tinynerf_tpu.ops.hashrng import hash_u01 as jhash_u01
from tinynerf_tpu.ops.segscan import compute_weights_packed as jcompute_weights_packed
from tinynerf_tpu.ops.trunc_exp import truncated_exp as jtrunc_exp
from tinynerf_tpu.ops.weights_pallas import compute_weights_pallas
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import loop as jloop
from tinynerf_tpu_torch.convert import load_params, param_tree, tree_leaves_with_path
from tinynerf_tpu_torch.data import RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.ops import bitonic, interp, segscan, table_grad, weights_dense
from tinynerf_tpu_torch.ops.hashrng import hash_u01
from tinynerf_tpu_torch.ops.trunc_exp import truncated_exp
from tinynerf_tpu_torch.train import (
    BucketEstimator,
    MarchPolicy,
    TrainConfig,
    build_renderer,
    lr_schedule,
    make_optimizer,
    pick_bucket,
)
from tinynerf_tpu_torch.train.loop import _decay_mask

torch.set_num_threads(2)

T = torch.from_numpy


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _key_words(key) -> np.ndarray:
    return np.asarray(key).astype(np.uint32).reshape(-1)


def test_hash_bits_equal_jax():
    """Every (ray, sample) uniform is bit-equal, for python-int and tensor
    seeds alike."""
    r = np.arange(0, 70_000, 7, dtype=np.int32)[:, None]
    s = np.arange(400, dtype=np.int32)[None, :]
    for k in (0, 3, 12345):
        key = jax.random.fold_in(jax.random.PRNGKey(k), 0)
        ref = np.asarray(jhash_u01(key, jnp.asarray(r), jnp.asarray(s)))
        words = _key_words(key)
        for seed in ([int(w) for w in words], T(words.astype(np.int64))):
            out = hash_u01(seed, T(r), T(s)).numpy()
            assert out.dtype == np.float32
            np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("clamp", [True, False])
def test_truncated_exp_gradient_matches_jax(clamp):
    x = np.linspace(-30, 30, 257).astype(np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jtrunc_exp(v, clamp) * g))(jnp.asarray(x)))
    t = T(x).requires_grad_()
    truncated_exp(t, clamp).backward(T(g))
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6)


def _packed(seed, n_rays=200, max_count=90, pad=500, p_empty=0.2):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count + 1, n_rays) * (rng.random(n_rays) > p_empty)
    n_valid = int(counts.sum())
    cap = n_valid + pad
    seg = np.full(cap, n_rays, np.int32)
    seg[:n_valid] = np.repeat(np.arange(n_rays), counts)
    valid = np.zeros(cap, np.float32)
    valid[:n_valid] = 1.0
    sig = rng.uniform(0.0, 8.0, cap).astype(np.float32) * valid
    dlt = rng.uniform(0.01, 0.1, cap).astype(np.float32)
    g = rng.normal(size=cap).astype(np.float32)
    return sig, dlt, valid, seg, g, n_rays


@pytest.mark.parametrize("thr", [0.0, 1e-4, 1e-2])
def test_packed_weights_gradient_matches_jax(thr):
    """jax.grad of the Pallas packed weights (interpret mode) against the
    port's autograd, with and without n_segments (the pad tail then gets 0,
    as valid = 0 gives it in JAX)."""
    sig, dlt, valid, seg, g, n_rays = _packed(1)
    ref = np.asarray(jax.grad(lambda s: jnp.sum(jcompute_weights_packed(
        s, jnp.asarray(dlt), jnp.asarray(valid), jnp.asarray(seg), thr, True) * g))(jnp.asarray(sig)))
    for n_seg in (None, n_rays):
        t = T(sig).requires_grad_()
        segscan.compute_weights_packed(t, T(dlt), T(valid), T(seg), thr, n_segments=n_seg).backward(T(g))
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-5)
    assert np.all(t.grad.numpy()[seg == n_rays] == 0.0)


@pytest.mark.parametrize("thr", [0.0, 1e-4, 1e-2])
def test_dense_weights_gradient_matches_jax(thr):
    rng = np.random.default_rng(2)
    r, s = 48, 130
    sig = rng.uniform(0, 8, (r, s)).astype(np.float32)
    dlt = rng.uniform(0.01, 0.1, (r, s)).astype(np.float32)
    msk = (rng.random((r, s)) > 0.3).astype(np.float32)
    g = rng.normal(size=(r, s)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(compute_weights_pallas(
        x, jnp.asarray(dlt), jnp.asarray(msk), thr, True) * g))(jnp.asarray(sig)))
    t = T(sig).requires_grad_()
    weights_dense.compute_weights_dense(t, T(dlt), T(msk), thr).backward(T(g))
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(1,), (300,), (3, 1000), (2, 1024)])
def test_sort_i32_bit_equal_jax(shape):
    rng = np.random.default_rng(3)
    keys = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    keys.reshape(-1)[::5] = 17
    ref = np.asarray(jbitonic.sort_i32(jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(bitonic.sort_i32(T(keys)).numpy(), ref)


def test_pack_keys_and_bits_match_jax():
    bucket = np.random.default_rng(4).integers(0, 1000, (2, 700)).astype(np.int32)
    ref = np.asarray(jbitonic.pack_keys(jnp.asarray(bucket), 10))
    packed = bitonic.pack_keys(T(bucket), 10)
    np.testing.assert_array_equal(packed.numpy(), ref)
    b, i = bitonic.unpack_keys(packed, 10)
    np.testing.assert_array_equal(b.numpy(), bucket)
    np.testing.assert_array_equal(i.numpy(), np.broadcast_to(np.arange(700), (2, 700)))
    for nb, ns in ((1024, 819_200), (1024, 2**21 + 1), (2, 2), (2**20, 2**11), (2**20, 2**11 + 1)):
        assert bitonic.packed_bits_ok(nb, ns) == jbitonic.packed_bits_ok(nb, ns), (nb, ns)


def _grad_case(seed, p=2, n=1500, f=8, n_cells=600):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(p, n, f)).astype(np.float32),
            rng.uniform(size=(p, n, 4)).astype(np.float32),
            rng.integers(0, n_cells, size=(p, n)).astype(np.int32), n_cells)


@pytest.mark.parametrize("w_window", [128, 256])
def test_sort_by_window_matches_jax(w_window):
    _, _, cell, n_cells = _grad_case(5)
    n_cells_pad = -(-n_cells // w_window) * w_window
    jperm, joff = jtable_grad.sort_by_window(jnp.asarray(cell), n_cells_pad, w_window, interpret=True)
    perm, off = table_grad.sort_by_window(T(cell), n_cells_pad, w_window)
    assert perm.dtype == off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,w_window", [(6, 128), (7, 256)])
def test_table_grad_sorted_matches_jax(payload, seed, w_window):
    """The whole sorted pipeline (sort, packed payload, gather, windowed
    accumulation) against JAX's in interpret mode.  The bf16 payload rounds
    g the same way in both, so it is held as tightly as the f32 one."""
    g, w4, cell, n_cells = _grad_case(seed)
    ref = np.asarray(jtable_grad.table_grad_sorted(
        jnp.asarray(g), jnp.asarray(w4), jnp.asarray(cell), n_cells, w_window,
        interpret=True, payload_dtype=getattr(jnp, payload)))
    out = table_grad.table_grad_sorted(T(g), T(w4), T(cell), n_cells, w_window,
                                       getattr(torch, payload)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-5 * np.abs(ref).max())
    scatter = table_grad.windowed_accumulate_ref(T(g), T(w4), T(cell), n_cells).numpy()
    jscatter = np.asarray(jtable_grad.windowed_accumulate_ref(
        jnp.asarray(g), jnp.asarray(w4), jnp.asarray(cell), n_cells))
    np.testing.assert_allclose(scatter, jscatter, atol=1e-5 * np.abs(jscatter).max())


def test_windowed_accumulate_empty_and_skewed_windows():
    """Every sample in one cell of window 2: the other windows come out
    exactly 0, window 2 holds the sum."""
    rng = np.random.default_rng(8)
    g = rng.normal(size=(1, 700, 4)).astype(np.float32)
    w4 = rng.uniform(size=(1, 700, 4)).astype(np.float32)
    cell = np.full((1, 700), 130, np.int32)
    out = table_grad.table_grad_sorted(T(g), T(w4), T(cell), 256, w_window=64).numpy()
    ref = table_grad.windowed_accumulate_ref(T(g), T(w4), T(cell), 256).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-5 * np.abs(ref).max())
    assert np.all(np.delete(out[0], 130, axis=0) == 0.0)


def test_upsample_and_pullback_match_jax():
    """upsample_to equals the JAX upsampling; the explicit transpose equals
    the JAX vjp and torch's autograd of upsample_to."""
    rng = np.random.default_rng(9)
    tables = [rng.normal(size=(r, r, 3)).astype(np.float32) for r in (5, 9, 17)]
    for t in tables[:2]:
        np.testing.assert_array_equal(
            interp.upsample_to(T(t), 17, 17).numpy(),
            np.asarray(jax.jit(lambda x: jinterp.upsample_to(x, 17, 17))(jnp.asarray(t))))
    fine = rng.normal(size=(17, 17, 9)).astype(np.float32)
    ref = jax.jit(jinterp._pullback_scales)(jnp.asarray(fine), tuple(jnp.asarray(t) for t in tables))
    out = interp._pullback_scales(T(fine), [T(t) for t in tables])
    for i, (o, r_, t) in enumerate(zip(out, ref, tables)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r_), rtol=1e-6, atol=1e-6)
        x = T(t).requires_grad_()
        interp.upsample_to(x, 17, 17).backward(T(fine[..., 3 * i : 3 * i + 3].copy()))
        np.testing.assert_allclose(o.numpy(), x.grad.numpy(), rtol=1e-6, atol=1e-6)
    gq = rng.normal(size=(16 * 16, 4 * 9)).astype(np.float32)
    np.testing.assert_array_equal(
        interp._fine_from_quad(T(gq), 17, 9).numpy(), np.asarray(jinterp._fine_from_quad(jnp.asarray(gq), 17, 9)))


@pytest.mark.parametrize("bwd_impl", ["scatter", "sorted", "sorted_bf16"])
def test_multiscale_lookup_multiproj_matches_jax(bwd_impl):
    """Values and every table gradient of the three-projection lookup, under
    each backward the JAX op offers (the port's sorted pipeline runs its
    plain versions here)."""
    rng = np.random.default_rng(10)
    n = 300
    tables = [[rng.normal(size=(r, r, 4)).astype(np.float32) for r in (9, 17, 33)] for _ in range(3)]
    coords = [rng.uniform(-1, 1, (n, 2)).astype(np.float32) for _ in range(3)]
    coords[0][:3] = [[-1, -1], [1, 1], [1, -1]]
    cot = [rng.normal(size=(n, 12)).astype(np.float32) for _ in range(3)]

    def jloss(ts):
        outs = jinterp.multiscale_lookup_multiproj(
            ts, tuple(jnp.asarray(c) for c in coords), jnp.float32, bwd_impl)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    jt = tuple(tuple(jnp.asarray(t) for t in ts) for ts in tables)
    (_, jouts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jt)
    tt = [[T(t).requires_grad_() for t in ts] for ts in tables]
    outs = interp.multiscale_lookup_multiproj(tt, [T(c) for c in coords], torch.float32, bwd_impl)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(torch.cat(o, -1).detach().numpy(), np.asarray(jo), atol=1e-5)
    sum(torch.sum(torch.cat(o, -1) * T(c)) for o, c in zip(outs, cot)).backward()
    for jg_p, t_p in zip(jgrads, tt):
        for jg, t in zip(jg_p, t_p):
            ref = np.asarray(jg)
            np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def field_pair():
    jfield, _, _ = jmake_model("kplanes", field_scale=0.07)
    params = jax.jit(jfield.init)(jax.random.PRNGKey(0))
    renderer = build_renderer(TrainConfig(field_scale=0.07), 1.0, None, device="cpu")
    load_params(renderer, {"field": jax.tree_util.tree_map(np.asarray, params),
                           "sigma": {"mlp": [{"w": w.detach().numpy(), "b": b.detach().numpy()}
                                             for w, b in zip(renderer.sigma_decoder.mlp.w,
                                                             renderer.sigma_decoder.mlp.b)]},
                           "rgb": {"mlp": [{"w": w.detach().numpy(), "b": b.detach().numpy()}
                                           for w, b in zip(renderer.rgb_decoder.mlp.w,
                                                           renderer.rgb_decoder.mlp.b)]}})
    return jfield, params, renderer.field


@pytest.mark.parametrize("name", ["loss_tv", "loss_l1"])
def test_regularizers_match_jax(field_pair, name):
    jfield, params, field = field_pair
    ref, jgrads = jax.jit(jax.value_and_grad(getattr(jfield, name)))(params)
    field.zero_grad()
    val = getattr(field, name)()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref), rtol=1e-6)
    for jg_s, scale in zip(jgrads["planes"], field.planes):
        for jg, plane in zip(jg_s, scale):
            ref_g = np.asarray(jg)
            np.testing.assert_allclose(plane.grad.numpy(), ref_g, atol=1e-6 * np.abs(ref_g).max())


def test_lr_schedule_matches_optax():
    """MultiStepLR semantics, milestones collapsing at small step counts
    included, in f32 like optax."""
    for steps in (8, 100, 4096):
        cfg = TrainConfig(steps=steps)
        ours, ref = lr_schedule(cfg), jloop.lr_schedule(JConfig(steps=steps))
        for count in sorted({0, 1, 2, 3, 4, 5, 7, steps // 2, steps * 3 // 4, steps - 1, steps}):
            assert np.float32(ours(count)) == np.float32(ref(count)), (steps, count)


def test_decay_mask_matches_jax():
    """Tables are not decayed, decoder weights are, in the same tree."""
    jcfg = JConfig(field_scale=0.07)
    jr = jloop.build_renderer(jcfg, 1.0, None)
    params = jax.jit(jr.init)(jax.random.PRNGKey(0))
    ref = jloop._decay_mask(params, table_keys=frozenset({"planes"}), mlp_keys=frozenset())
    renderer = build_renderer(TrainConfig(field_scale=0.07), 1.0, None, device="cpu")
    tree = param_tree(renderer)
    ours = _decay_mask(tree, renderer.field.table_keys, renderer.field.mlp_keys)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    our_leaves = list(tree_leaves_with_path(ours))
    assert [bool(v) for _, v in ref_leaves] == [v for _, v in our_leaves]
    assert len(our_leaves) == len(list(tree_leaves_with_path(tree)))
    with pytest.raises(ValueError, match="not declared"):
        _decay_mask({"field": {"grid": 0}}, frozenset({"planes"}))


def test_fused_adam_matches_jax():
    """Three updates of the fused Adam on the same parameters and gradients
    (weight decay on the decoders only, lr schedule, f32): parameters and
    the {count, mu, nu} state agree, in the JAX layout."""
    jcfg = JConfig(field_scale=0.07, steps=4)
    jr = jloop.build_renderer(jcfg, 1.0, None)
    params = jax.jit(jr.init)(jax.random.PRNGKey(1))
    renderer = build_renderer(TrainConfig(field_scale=0.07, steps=4), 1.0, None, device="cpu")
    load_params(renderer, jax.tree_util.tree_map(np.asarray, params))
    jopt = jloop.make_optimizer(jcfg)
    opt = make_optimizer(TrainConfig(field_scale=0.07, steps=4), renderer)
    jstate = jopt.init(params)
    rng = np.random.default_rng(11)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
        upd, jstate = jax.jit(jopt.update)(grads, jstate, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        by_path = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
                   for path, leaf in jax.tree_util.tree_leaves_with_path(grads)}
        opt.step([T(np.array(by_path[path])) for path in opt.paths])
    for (path, p), (_, jp) in zip(tree_leaves_with_path(param_tree(renderer)),
                                  tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, params))):
        np.testing.assert_allclose(p.detach().numpy(), jp, rtol=1e-5, atol=1e-7, err_msg=str(path))
    state = opt.state()
    assert int(state.count) == int(jstate.count) == 3
    for ours, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        for (_, a), b in zip(tree_leaves_with_path(ours), jax.tree_util.tree_leaves(ref)):
            b = np.asarray(b)  # f32 rounding of the moment updates' products
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max())


def test_bucket_and_march_policies_match_jax():
    cfg, jcfg = TrainConfig(), JConfig()
    for avg in (1.0, 3.5, 20.0, 64.0, 150.0, 400.0, 1e4):
        assert pick_bucket(cfg, avg) == jloop.pick_bucket(jcfg, avg)
    est, jest = BucketEstimator(cfg), jloop.BucketEstimator(jcfg)
    for i, (fill, rays) in enumerate([(0.9, 2048.0), (0.5, 4096.0)] * 9):
        if i == 5:
            est.mark_occupancy_changed()
            jest.mark_occupancy_changed()
        est.observe(torch.tensor(fill), torch.tensor(rays))
        jest.observe(jnp.float32(fill), jnp.float32(rays))
        assert est.just_refreshed == jest.just_refreshed
        assert est.avg_samples_per_ray == pytest.approx(jest.avg_samples_per_ray, rel=1e-6)
        assert est.bucket() == jest.bucket()
    # the march policy of a renderer that supports skip marching, in every
    # mode, pick for pick against JAX's
    for mode in ("auto", "dense", "skip"):
        pol, jpol = MarchPolicy(True, mode, 64), jloop.MarchPolicy(True, mode, 64)
        assert [pol.pick(a) for a in (10.0, 40.0)] == [jpol.pick(a) for a in (10.0, 40.0)]


def test_table_grad_impl_rules():
    """The table gradient's route: sorted bf16 on a CUDA device, the
    scatter (the accumulation kernel's plain version) on the CPU or, there,
    when the packed keys overflow 31 bits (the JAX rule); on a CUDA device
    never the scatter: no fallback where the packed keys overflow (the
    key-value sort takes them), and "scatter" is the f32 payload's sorted
    pipeline."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    n_cells = 512 * 512
    assert interp._resolve_bwd_impl("auto", cuda, n_cells, 819_200) == "sorted_bf16"
    assert interp._resolve_bwd_impl("auto", cpu, n_cells, 819_200) == "scatter"
    assert interp._resolve_bwd_impl("sorted", cpu, n_cells, 819_200) == "sorted"
    assert interp._resolve_bwd_impl("sorted_bf16", cpu, n_cells, 1 << 22) == "scatter"
    assert interp._resolve_bwd_impl("sorted_bf16", cuda, n_cells, 1 << 22) == "sorted_bf16"
    assert interp._resolve_bwd_impl("scatter", cuda, n_cells, 819_200) == "sorted"
    with pytest.raises(ValueError, match="unknown"):
        interp._resolve_bwd_impl("onehot", cpu, n_cells, 819_200)


def test_ray_pool_matches_jax(tmp_path):
    from tinynerf_tpu.utils.fixtures import make_synthetic_scene

    scene = make_synthetic_scene(tmp_path / "s", n_train=2, n_test=1, res=8, kind="spheres") or tmp_path / "s"
    jpool = JRayPool(jparse(scene, "train"))
    pool = RayPool(parse_nerf_synthetic(scene, "train"), device="cpu")
    for a, b in zip(pool.arrays(), jpool.arrays()):
        np.testing.assert_array_equal(a.numpy(), b)
    assert pool.n_rays == jpool.n_rays == 128 and pool.scene_scale == jpool.scene_scale
