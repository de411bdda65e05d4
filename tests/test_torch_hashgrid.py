"""Instant-NGP's hash-grid field of the port (`models/hashgrid.py`,
`ops/hashgrid.py`) against the plain reference `tests/plain_hashgrid.py` on
seeded random tables, on the CPU at field_scale 0.1 (16 levels from 16 to
205, T = 2^13: levels 0-1 dense, 2-15 hashed, 126,460 rows); the terms'
grouping by row against a stable sort; the published widths at 1.0; one
training step, `train()` and `render_only`; the spans.  The kernels against
their plain versions, the grouping against kernel 4's key-value sort, and
the table gradient repeating itself, on the card (marked `cuda`).

Tolerances: the corner rows are integers and must be equal; the weights are
the same f32 products (exact).  The features in bf16 differ from the
reference only in the order of the 8 corners' f32 sum: 1e-6 of the largest
feature.  Against the f32 reference, the corners' bf16 rounding (at most
2^-9 of a value, and the weights sum to 1) bounds the gap by 2^-9 of the
largest table value.  The table gradient sums the same f32 products in
another order (term order against autograd's scatter): 1e-5 of the largest
row.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import plain_hashgrid as plain
from tinynerf_tpu_torch.data import PoseSet, RayPool, parse_nerf_synthetic
from tinynerf_tpu_torch.models import HashGridFeatureField, make_model
from tinynerf_tpu_torch.models.hashgrid import NGP_RESOLUTIONS
from tinynerf_tpu_torch.ops import hashgrid
from tinynerf_tpu_torch.ops.bitonic import sort_pairs_i32
from tinynerf_tpu_torch.train import (TrainConfig, build_renderer, make_optimizer, make_train_step, render_only,
                                      train)
from tinynerf_tpu_torch.utils import make_spheres_data, make_synthetic_scene, trace

torch.set_num_threads(2)

SCALE = 0.1
DET_RUNS = 3


@pytest.fixture(scope="module")
def field():
    f = make_model("instantngp", field_scale=SCALE, generator=torch.Generator().manual_seed(0))[0]
    with torch.no_grad():  # values of a trained table's size, so rounding shows
        f.tables.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(1))
    return f


def _positions(n: int, seed: int) -> torch.Tensor:
    """n uniform positions in [-1, 1]^3, then the cube's 8 corners and
    points with each coordinate at -1, 0 or +1 exactly."""
    x = torch.rand(n, 3, generator=torch.Generator().manual_seed(seed)) * 2.0 - 1.0
    edges = torch.tensor([[a, b, c] for a in (-1.0, 0.0, 1.0) for b in (-1.0, 0.0, 1.0) for c in (-1.0, 0.0, 1.0)])
    return torch.cat([x, edges])


def _layout_args(f: HashGridFeatureField):
    return f.layout.resolutions, f.layout.log2_size


def test_layout_at_the_test_scale(field):
    lay = field.layout
    assert lay.resolutions[0] == 16 and lay.resolutions[-1] == 205 and lay.log2_size == 13
    assert lay.hashed == (False, False) + (True,) * 14  # the switch between levels 1 and 2
    assert list(lay.level_rows) == plain.level_rows(*_layout_args(field)) and lay.rows == 126_460


def test_hash_of_a_vertex_worked_by_hand():
    # (1 xor 2 * 2654435761 xor 3 * 805459861) mod 2^32 mod 2^19
    by_hand = (1 ^ ((2 * 2654435761) % 2**32) ^ ((3 * 805459861) % 2**32)) % 2**19
    v = torch.tensor([1]), torch.tensor([2]), torch.tensor([3])
    assert int(plain.spatial_hash(*v, 19)) == by_hand
    lay = hashgrid.HashLayout((2048,), 19)
    # a position whose cell origin is the vertex (1, 2, 3) of N = 2048
    x = ((torch.tensor([[1.25, 2.25, 3.25]]) / 2048.0) * 2.0 - 1.0).float()
    rows, _ = hashgrid.level_corners(x, lay, 0)
    assert int(rows[0, 0]) == by_hand


def test_corner_rows_and_weights_equal_the_reference(field):
    x = _positions(1000, seed=2)
    res, log2 = _layout_args(field)
    collided = 0
    for level in range(len(res)):
        rows, w = hashgrid.level_corners(x, field.layout, level)
        ref_rows, ref_w = plain.corners(x, level, res, log2)
        assert torch.equal(rows, ref_rows), level
        torch.testing.assert_close(w, ref_w, rtol=0.0, atol=1e-7)
        if field.layout.hashed[level]:
            origin, _ = plain.cell(x, res[level])
            verts = torch.cat([origin + torch.tensor(d) for d in
                               [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]])
            flat_rows = ref_rows.T.reshape(-1)
            pairs = torch.unique(torch.cat([verts, flat_rows[:, None]], dim=1), dim=0)
            collided += pairs.shape[0] - torch.unique(pairs[:, 3]).numel()  # distinct vertices on one row
    assert collided > 0


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_features_match_the_reference(field, prec):
    x = _positions(2000, seed=3)
    feats = field(x)
    ref = plain.features(field.tables.detach(), x, *_layout_args(field), prec=prec)
    tol = 1e-6 * float(ref.abs().max()) if prec == "bf16" else 2.0**-9 * float(field.tables.detach().abs().max())
    torch.testing.assert_close(feats, ref, rtol=0.0, atol=tol)
    assert feats.shape == (x.shape[0], 32) and field.feature_dim == 32


def test_table_gradient_matches_autograd(field):
    x = _positions(2000, seed=4)
    g = torch.randn(x.shape[0], 32, generator=torch.Generator().manual_seed(5))
    g[::7] = 0.0  # pad samples: their terms are dropped
    g[1::7, :6] = 0.0  # and some levels of others
    table = field.tables.detach().clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(hashgrid.hash_lookup(table, x, field.layout), table, g)
    table_ref = field.tables.detach().clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(plain.features(table_ref, x, *_layout_args(field)), table_ref, g)
    torch.testing.assert_close(grad, ref, rtol=0.0, atol=1e-5 * float(ref.abs().max()))
    untouched = ref.abs().sum(-1) == 0
    assert untouched.any() and bool((grad[untouched] == 0).all())


def test_accumulation_splits_runs_in_chunk_order():
    """A row whose terms span several chunks: its chunks' partial sums are
    added in order (the plain version of the kernel's combine)."""
    keys = torch.tensor([0] * 3 + [2] * 40 + [5] * 2 + [7], dtype=torch.int32)  # 7: the drop key
    prods = torch.randn(keys.numel(), 2, generator=torch.Generator().manual_seed(6))
    vals = torch.arange(keys.numel(), dtype=torch.int32)
    out = hashgrid.hash_accumulate_plain(keys, vals, prods, 7)
    starts = [3, 16, 32]  # row 2's terms, split at the chunks' starts 16 and 32
    parts = [prods[a:b].sum(0) for a, b in zip(starts, starts[1:] + [43])]
    torch.testing.assert_close(out[2], parts[0] + parts[1] + parts[2], rtol=1e-6, atol=0.0)
    assert torch.equal(out[[1, 3, 4, 6]], torch.zeros(4, 2))
    torch.testing.assert_close(out[5], prods[43:45].sum(0), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("case", ["dead_mixed", "hot_row", "empty_rows", "single", "layout_terms"])
def test_grouping_is_the_stable_sort(field, case):
    """`hash_group` on the CPU (its plain version) against numpy's stable
    argsort of the keys: keys in order, each row's term indices ascending;
    dead terms (key n_rows) last."""
    gen = torch.Generator().manual_seed(10)
    if case == "dead_mixed":
        n_rows = 50
        keys = torch.randint(0, n_rows + 1, (800,), generator=gen)
    elif case == "hot_row":  # one row holding thousands of terms
        n_rows = 40
        keys = torch.randint(0, n_rows, (6000,), generator=gen)
        keys[torch.rand(6000, generator=gen) < 0.6] = 7
    elif case == "empty_rows":  # terms on every 97th row of 1000 only
        n_rows = 1000
        keys = torch.randint(0, 10, (400,), generator=gen) * 97
    elif case == "single":
        n_rows = 3
        keys = torch.tensor([2])
    else:  # the test layout's own terms, with dropped (sample, level)s
        x = _positions(300, seed=11)
        g = torch.randn(x.shape[0], 32, generator=gen)
        g[::5] = 0.0
        g[1::5, 4:10] = 0.0
        keys, _, _ = hashgrid.hash_terms(x, g, field.layout)
        n_rows = field.layout.rows
    keys = keys.to(torch.int32)
    keys_s, vals_s = hashgrid.hash_group(keys, n_rows)
    order = np.argsort(keys.numpy(), kind="stable")
    assert keys_s.dtype == vals_s.dtype == torch.int32
    assert np.array_equal(keys_s.numpy(), keys.numpy()[order]) and np.array_equal(vals_s.numpy(), order)
    dead = int((keys == n_rows).sum())
    live = keys_s.numel() - dead
    assert bool((keys_s[live:] == n_rows).all()) and bool((keys_s[:live] < n_rows).all())
    if case in ("dead_mixed", "layout_terms"):
        assert 0 < dead < keys.numel()


def test_published_widths():
    f, sigma, rgb = make_model("instantngp", field_scale=1.0)
    lay = f.layout
    assert lay.resolutions == (16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776, 1072, 1482, 2048)
    assert lay.size == 2**19 and f.tables.shape[1] == 2 and f.feature_dim == 32
    assert lay.level_rows[:6] == (4913, 12167, 29791, 79507, 205379, 2**19) and lay.rows == 6_098_925
    assert sum(p.numel() for m in (f, sigma, rgb) for p in m.parameters()) == 12_218_078
    assert float(f.tables.detach().abs().max()) <= 1e-4


def _world(**extra):
    cfg = TrainConfig(method="instantngp", field_scale=SCALE, n_samples=32, batch_size=64, occupancy_res=16,
                      seed=1, **extra)
    pool = RayPool(make_spheres_data(n_views=1, res=16, seed=0))
    return cfg, build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cpu"), pool


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def test_train_step_matches_the_reference():
    """One deterministic `make_train_step` step (dense march, all-occupied
    grid, f32 decoders) against the same step with the reference field on
    the same table: loss, every gradient and the update."""
    runs = []
    for reference in (False, True):
        cfg, renderer, pool = _world(compute_dtype="float32")
        opt = make_optimizer(cfg, renderer)
        before = {k: p.detach().clone() for k, p in _leaves(opt.tree)}
        if reference:
            renderer.field = plain.PlainHashField(renderer.field.tables, *_layout_args(renderer.field))
        step = make_train_step(renderer, opt, cfg, n_cand=cfg.batch_size, deterministic=True)
        m = step(renderer.occupancy.init_state("cpu"), *pool.arrays())
        runs.append((m, dict(_leaves(m["grads"])), {k: p.detach() - before[k] for k, p in _leaves(opt.tree)}))
    (m, grads, moved), (m_ref, grads_ref, moved_ref) = runs
    assert float(m["fill"]) > 0.2
    torch.testing.assert_close(m["loss"], m_ref["loss"], rtol=1e-6, atol=0.0)
    assert grads.keys() == grads_ref.keys() == moved.keys() and "field/tables" in grads
    for k, g in grads_ref.items():
        scale = float(g.abs().max())
        assert scale > 0.0, k
        torch.testing.assert_close(grads[k], g, rtol=0.0, atol=1e-5 * scale, msg=k)
        clear = g.abs() > 1e-3 * scale  # Adam's first step moves these by lr * sign(g)
        torch.testing.assert_close(moved[k][clear], moved_ref[k][clear], rtol=1e-5, atol=0.0, msg=k)


def test_step_spans():
    cfg, renderer, pool = _world()
    step = make_train_step(renderer, make_optimizer(cfg, renderer), cfg, n_cand=cfg.batch_size)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(renderer.occupancy.init_state("cpu"), *pool.arrays(), torch.Generator().manual_seed(2))
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name in trace.NAMES]
    inside = lambda name, outer: [any(a <= s and e <= b for n2, a, b in spans if n2 == outer)
                                  for n, s, e in spans if n == name]
    assert inside("field.hash_encode", "render.field") == [True]
    assert inside("field.table_grad", "train_step.backward") == [True]


def test_train_and_render_only(tmp_path):
    """`train()` for two steps (its final render and checkpoint), then
    `render_only` from the checkpoint through `infer`'s packed path."""
    scene = tmp_path / "blob"
    make_synthetic_scene(scene, n_train=2, n_test=1, res=16)
    cfg = TrainConfig(method="instantngp", field_scale=SCALE, n_samples=32, batch_size=64, occupancy_res=16,
                      steps=2, output=tmp_path / "exp")
    test_set = PoseSet(parse_nerf_synthetic(scene, "test"))
    train(cfg, RayPool(parse_nerf_synthetic(scene, "train")), PoseSet(parse_nerf_synthetic(scene, "val")),
          test_set, device="cpu")
    assert (cfg.output / "ckpt_2.pkl").exists()
    assert all(np.isfinite(r["psnr"]) for r in json.loads((cfg.output / "metrics_test.json").read_text()))
    render_only(cfg, test_set, device="cpu")
    assert (cfg.output / "render_0000.png").exists()
    assert all(np.isfinite(r["psnr"]) for r in json.loads((cfg.output / "metrics_render.json").read_text()))


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_inputs(n: int, hot: int):
    """The published layout, a random table of a trained table's size,
    positions (uniform, the cube's edges, and `hot` samples at one point, so
    that a dense row's terms span thousands of chunks) and a cotangent with
    zero rows (pads) and zero levels."""
    lay = hashgrid.HashLayout(NGP_RESOLUTIONS, 19)
    gen = torch.Generator().manual_seed(7)
    x = torch.cat([_positions(n, seed=8), torch.full((hot, 3), 0.3)])
    table = torch.rand(lay.rows, 2, generator=gen) * 2.0 - 1.0
    g = torch.randn(x.shape[0], 32, generator=gen)
    g[::11] = 0.0
    g[3::11, 10:] = 0.0
    return lay, x, table, g


@pytest.mark.cuda
def test_kernels_match_their_plain_versions(cuda_device):
    lay, x, table, g = _card_inputs(60_000, 20_000)
    xc, gc = x.to(cuda_device), g.to(cuda_device)
    t16 = table.to(torch.bfloat16)
    assert torch.equal(hashgrid.hash_encode(xc, t16.to(cuda_device), lay).cpu(), hashgrid.hash_encode_plain(x, t16, lay))
    terms = hashgrid.hash_terms(xc, gc, lay)
    for a, b in zip(terms, hashgrid.hash_terms_plain(x, g, lay)):
        assert torch.equal(a.cpu(), b)
    # the grouping against kernel 4's key-value sort and the plain version:
    # every term bit-equal, the dropped ones last
    launched = hashgrid.hash_group.launches
    keys_s, vals_s = hashgrid.hash_group(terms[0], lay.rows)
    assert hashgrid.hash_group.launches == launched + 1
    sort_k, sort_v = sort_pairs_i32(terms[0], terms[1], 0, lay.rows.bit_length())
    assert torch.equal(keys_s, sort_k) and torch.equal(vals_s, sort_v)
    plain_k, plain_v = hashgrid.hash_group_plain(terms[0].cpu(), lay.rows)
    assert torch.equal(keys_s.cpu(), plain_k) and torch.equal(vals_s.cpu(), plain_v)
    assert 0 < int((keys_s == lay.rows).sum()) and int(torch.bincount(keys_s.long()).max()) > 20_000
    # fewer key bits than a pass, and a ragged last tile
    few = (terms[0][: 3 * hashgrid.GROUP_TILE + 5] % 200).contiguous()
    for a, b in zip(hashgrid.hash_group(few, 199), hashgrid.hash_group_plain(few.cpu(), 199)):
        assert torch.equal(a.cpu(), b)
    out = hashgrid.hash_accumulate(keys_s, vals_s, terms[2], lay.rows)
    ref = hashgrid.hash_accumulate_plain(keys_s.cpu(), vals_s.cpu(), terms[2].cpu(), lay.rows)
    assert torch.equal(out.cpu(), ref)
    full = hashgrid.hash_table_grad(gc, xc, lay)
    assert torch.equal(full.cpu(), hashgrid.hash_table_grad(g, x, lay)) and torch.equal(full, out)


@pytest.mark.cuda
def test_table_gradient_repeats_bit_for_bit(cuda_device):
    """Through the grouping (no key-value sort), equal to the gradient of
    the terms sorted by kernel 4."""
    lay, x, _, g = _card_inputs(200_000, 50_000)
    xc, gc = x.to(cuda_device), g.to(cuda_device)
    grouped, sorted_ = hashgrid.hash_group.launches, sort_pairs_i32.launches
    runs = [hashgrid.hash_table_grad(gc, xc, lay) for _ in range(DET_RUNS)]
    torch.cuda.synchronize()
    assert hashgrid.hash_group.launches == grouped + DET_RUNS and sort_pairs_i32.launches == sorted_
    assert all(torch.equal(r, runs[0]) for r in runs[1:]) and float(runs[0].abs().max()) > 0
    keys, vals, prods = hashgrid.hash_terms(xc, gc, lay)
    by_sort = hashgrid.hash_accumulate(*sort_pairs_i32(keys, vals, 0, lay.rows.bit_length()), prods, lay.rows)
    assert torch.equal(runs[0], by_sort)


@pytest.mark.cuda
def test_infer_replays_the_packed_graph_bit_equal_to_eager(cuda_device, tmp_path):
    """`infer` on the skip march: the packed chunk captured once and replayed,
    against the same chunks rendered eagerly."""
    from tinynerf_tpu_torch.train import InferStats, infer, make_render_chunk, make_render_chunk_packed
    from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_pose_set

    cfg, renderer, _ = _world()
    renderer.to(cuda_device)
    occ = make_shell_occupancy(renderer.occupancy, device=cuda_device)
    grid = renderer.skip_grid(occ)
    cap = 64 * 8

    def eager(occ_, o, d, grid_):
        out = renderer.render_packed(occ_, o, d, cap, rgb_dir_branch="ray", march="skip", skip_grid=grid_)
        return out.rgb, out.ray_valid > 0.0, out.n_samples, out.n_complete

    poses = make_spheres_pose_set(n_views=2, res=32)
    graphed, plain_stats = InferStats(), InferStats()
    kw = dict(chunk=64, render_chunk_fn=make_render_chunk(renderer), grid_args=(grid,), write=False)
    ours = infer(renderer, occ, poses, [0, 1], tmp_path, "g", packed_fn=make_render_chunk_packed(renderer, cap, "skip"),
                 stats=graphed, **kw)
    ref = infer(renderer, occ, poses, [0, 1], tmp_path, "e", packed_fn=eager, stats=plain_stats, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    assert graphed.graph_captures == 1 and graphed.graph_replays == 2 * 32 * 32 // 64 - 1
