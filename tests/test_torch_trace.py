"""The program's spans (`tinynerf_tpu_torch/utils/trace.py`) under a CPU
`torch.profiler`: a K-Planes and a Cobafa step on the dense and the skip
march, the step on a one-rank gloo group, one `infer` view with the packed
chunk and a forced fallback, and a few `train()` steps through its
`profile_start` hook.  Every span of the module's list appears where that
list puts it; with no profiler `span()` is one shared null context; a
deterministic step is bit-equal with the profiler on and off, and a step
with no group, with `single("cpu")` and on a one-rank gloo group bit-equal.

At the size of tests/torch_world.py (planes 9 / 17 / 33, Cobafa's basis
grids 8..12), 64 rays of the spheres scene, the shell occupancy."""

import contextlib
import json

import pytest
import torch
import torch.distributed as dist

from tinynerf_tpu_torch.data import RayPool
from tinynerf_tpu_torch.parallel import single, wrap_default_group
from tinynerf_tpu_torch.train import (
    InferStats,
    TrainConfig,
    build_renderer,
    infer,
    make_optimizer,
    make_render_chunk,
    make_render_chunk_packed,
    make_train_step,
    train,
)
from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_data, make_spheres_pose_set, trace

torch.set_num_threads(2)

CFGS = {
    "kplanes": dict(field_scale=0.07, n_samples=32, batch_size=64, occupancy_res=16, seed=1),
    "cobafa": dict(method="cobafa", field_scale=0.1, n_samples=32, batch_size=64, occupancy_res=16, seed=1),
    "instantngp": dict(method="instantngp", field_scale=0.1, n_samples=32, batch_size=64, occupancy_res=16, seed=1),
}
STEP_CHILDREN = ["train_step.batch", "render.march", "render.field", "render.decode", "train_step.loss",
                 "train_step.backward", "train_step.adam"]
RENDER = ("render.march", "render.field", "render.decode")
CHUNK = 64


def _world(method: str, **extra):
    """(config, renderer, shell occupancy, ray pool arrays) on the CPU."""
    cfg = TrainConfig(**CFGS[method], **extra)
    data = make_spheres_data(n_views=1, res=16, seed=0)
    pool = RayPool(data)
    renderer = build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cpu")
    return cfg, renderer, make_shell_occupancy(renderer.occupancy), pool.arrays()


def _record(fn):
    """fn() under a CPU profiler: (its result, the program's spans as
    (name, start us, end us) in start order)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.name in trace.NAMES)
    return out, [(n, s, e) for s, e, n in spans]


def _named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _each_inside(spans, name, outer_name) -> bool:
    outers = _named(spans, outer_name)
    return all(any(_inside(sp, o) for o in outers) for sp in _named(spans, name))


def _step_spans(method, march, group=None):
    cfg, renderer, occ, (pool_o, pool_d, pool_rgb) = _world(method)
    grid_args = (renderer.skip_grid(occ),) if march == "skip" else ()
    opt = make_optimizer(cfg, renderer, group)
    step = make_train_step(renderer, opt, cfg, n_cand=CHUNK, march=march, group=group)
    gen = torch.Generator().manual_seed(3)
    return _record(lambda: step(occ, *grid_args, pool_o, pool_d, pool_rgb, gen))


def _check_step(spans, extra=()):
    steps = _named(spans, "train_step")
    assert len(steps) == 1
    children = [(n, s, e) for n, s, e in spans if n in STEP_CHILDREN]
    assert [n for n, _, _ in children] == STEP_CHILDREN  # each once, in the step's order
    assert all(_inside((s, e), steps[0]) for _, s, e in children)
    for (_, _, e0), (_, s1, _) in zip(children, children[1:]):
        assert e0 <= s1
    grads = _named(spans, "field.table_grad")
    assert grads and _each_inside(spans, "field.table_grad", "train_step.backward")
    assert {n for n, _, _ in spans} == {"train_step", "field.table_grad", *STEP_CHILDREN, *extra}


@pytest.mark.parametrize("march", ["dense", "skip"])
@pytest.mark.parametrize("method", ["kplanes", "cobafa"])
def test_step_spans(method, march):
    metrics, spans = _step_spans(method, march)
    assert torch.isfinite(metrics["loss"])
    _check_step(spans)
    # one lookup Function a projection set (K-Planes) or a grid (Cobafa)
    assert len(_named(spans, "field.table_grad")) == (1 if method == "kplanes" else 7)


@pytest.fixture
def gloo_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        yield wrap_default_group("cpu")
    finally:
        dist.destroy_process_group()


def test_group_step_spans(gloo_group):
    _, spans = _step_spans("kplanes", "dense", gloo_group)
    steps = _named(spans, "train_step")
    reduces = _named(spans, "train_step.all_reduce")
    # the loss pieces' sum before the one backward (its objective holds the
    # regularizer), the gradients' after it
    assert len(steps) == 1 and len(reduces) == 2 and all(_inside(r, steps[0]) for r in reduces)
    backward = _named(spans, "train_step.backward")
    assert len(backward) == 1 and reduces[0][1] <= backward[0][0] <= backward[0][1] <= reduces[1][0]
    for name in STEP_CHILDREN:
        assert _named(spans, name) and _each_inside(spans, name, "train_step"), name
    assert _each_inside(spans, "field.table_grad", "train_step.backward")


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "sampled"])
@pytest.mark.parametrize("method", ["kplanes", "cobafa", "instantngp"])
def test_one_rank_groups_step_alike(gloo_group, method, deterministic):
    """One step with no group, with `single("cpu")` and on a one-rank gloo
    group: the loss, the counts, every gradient (deterministic) and every
    updated parameter bit-equal.  K-Planes with TV and L1 on; a sampled
    step draws its batch, the jitter and Cobafa's dropout mask from one
    seed."""

    def run(group):
        cfg, renderer, occ, pool = _world(method, **({"l1_reg_alpha": 1e-3} if method == "kplanes" else {}))
        opt = make_optimizer(cfg, renderer, group)
        step = make_train_step(renderer, opt, cfg, n_cand=CHUNK, deterministic=deterministic, group=group)
        gen = () if deterministic else (torch.Generator().manual_seed(3),)
        return step(occ, *pool, *gen), [p.detach().clone() for p in opt.params]

    (m0, p0), *others = [run(g) for g in (None, single("cpu"), gloo_group)]
    assert torch.isfinite(m0["loss"]) and float(m0["rays_used"]) > 0
    for m, p in others:
        for key in ("loss", "rays_used", "fill", "complete_frac"):
            assert torch.equal(m[key], m0[key]), key
        if deterministic:
            g0, g = dict(_leaves(m0["grads"])), dict(_leaves(m["grads"]))
            assert g.keys() == g0.keys() and all(torch.equal(g[k], g0[k]) for k in g0)
        assert len(p) == len(p0) and all(torch.equal(a, b) for a, b in zip(p, p0))


def test_infer_spans(tmp_path):
    cfg, renderer, occ, _ = _world("kplanes")
    views = make_spheres_pose_set(n_views=1, res=16, seed=0)
    # 8 samples a chunk: the chunks that cross the shell overflow, so the
    # fallback runs
    packed = make_render_chunk_packed(renderer, 8, march="skip")
    stats = InferStats()
    grid_args = (renderer.skip_grid(occ),)
    (img,), spans = _record(lambda: infer(renderer, occ, views, [0], tmp_path, "v", chunk=CHUNK,
                                          render_chunk_fn=make_render_chunk(renderer), packed_fn=packed,
                                          stats=stats, grid_args=grid_args, write=False))
    n_chunks = 16 * 16 // CHUNK
    assert img.shape == (16, 16, 3) and stats.fallback_rays > 0
    for name in ("serve.view", "serve.upload", "serve.enqueue", "serve.fallback", "serve.image"):
        assert len(_named(spans, name)) == 1, name
    assert len(_named(spans, "serve.readback")) == n_chunks
    for name in ("serve.upload", "serve.enqueue", "serve.readback", "serve.fallback", "serve.image"):
        assert _each_inside(spans, name, "serve.view"), name
    enqueue, fallback = _named(spans, "serve.enqueue")[0], _named(spans, "serve.fallback")[0]
    for name in RENDER:
        packed_calls = [sp for sp in _named(spans, name) if _inside(sp, enqueue)]
        dense_calls = [sp for sp in _named(spans, name) if _inside(sp, fallback)]
        assert len(packed_calls) == n_chunks and dense_calls, name
        assert len(packed_calls) + len(dense_calls) == len(_named(spans, name)), name
    assert not {n for n, _, _ in spans} & {"train_step", "field.table_grad", "occupancy.sweep"}


def test_train_profile_hook_spans(tmp_path):
    """`train()`'s profile_start hook writes a Chrome trace that holds the
    loop's spans: the sweep (no field span in it: `sigma_fn` is outside
    `render.field`), the skip-grid build, the steps and the readbacks."""
    cfg = TrainConfig(**CFGS["kplanes"], output=tmp_path, steps=4, occupancy_update_every=2, march="skip",
                      profile_start=0, profile_count=4)
    out = train(cfg, RayPool(make_spheres_data(n_views=1, res=16, seed=0)), device="cpu")
    assert out["march_steps"]["skip"] == 4
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in trace.NAMES)
    spans = [(n, s, e) for s, e, n in spans]
    assert len(_named(spans, "train_step")) == 4
    assert len(_named(spans, "occupancy.sweep")) == 2 and len(_named(spans, "occupancy.skip_grid")) == 2
    # the estimator's first read and the policy's reads of steps 1-3 (the
    # flush at the last step comes after the profiler stops)
    assert len(_named(spans, "train.readback")) >= 2
    for name in ("occupancy.sweep", "occupancy.skip_grid", "train.readback"):
        assert not any(_inside(sp, st) for sp in _named(spans, name) for st in _named(spans, "train_step")), name
    for sweep in _named(spans, "occupancy.sweep"):
        assert not any(_inside(sp, sweep) for name in RENDER for sp in _named(spans, name))
    for name in STEP_CHILDREN:
        assert len(_named(spans, name)) == 4 and _each_inside(spans, name, "train_step"), name


def test_every_listed_span_is_placed():
    """The module's list is what the tests above look for, each name once
    (`field.hash_encode`: `tests/test_torch_hashgrid.py`)."""
    placed = {"train_step", "field.table_grad", "train_step.all_reduce", "occupancy.sweep", "occupancy.skip_grid",
              "train.readback", "serve.view", "serve.upload", "serve.enqueue", "serve.readback", "serve.fallback",
              "serve.image", "field.hash_encode", *STEP_CHILDREN}
    assert len(trace.NAMES) == len(set(trace.NAMES)) == 20
    assert set(trace.NAMES) == placed


def test_span_is_one_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    null = trace.span("train_step")
    assert isinstance(null, contextlib.nullcontext) and trace.span("serve.view") is null
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(trace.span("train_step"), torch.profiler.record_function)
    assert trace.span("render.march") is null


@pytest.mark.parametrize("method", ["kplanes", "cobafa"])
def test_deterministic_step_is_bit_equal_with_the_profiler(method):
    def run(profiled: bool):
        cfg, renderer, occ, pool = _world(method)
        opt = make_optimizer(cfg, renderer)
        step = make_train_step(renderer, opt, cfg, n_cand=CHUNK, deterministic=True)
        ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
               else contextlib.nullcontext())
        with ctx:
            m = step(occ, *pool)
        return m, [p.detach().clone() for p in opt.params]

    (m0, p0), (m1, p1) = run(False), run(True)
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["fill"], m1["fill"])
    g0 = [g for _, g in sorted(_leaves(m0["grads"]))]
    g1 = [g for _, g in sorted(_leaves(m1["grads"]))]
    assert len(g0) == len(g1) > 0 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree
