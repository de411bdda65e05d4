"""The packed serving chunk as a CUDA graph (`train/loop.py`
`make_render_chunk_packed`, `packed_graph_key`) and the forward's constants
made on a device once (`utils/device.py` `device_constant`).

On the CPU the packed callable runs eagerly: it returns exactly what
`NerfRenderer.render_packed` returns and never captures.  The graph's key
follows the storage a replay reads by address.  Each hoisted constant
holds the values of the per-call construction it replaced.  The tests
marked `cuda` replay chunks on the card against the eager chunk, bit for
bit, after an in-place parameter change and after a rebuilt skip grid.

At the size of tests/torch_world.py (planes 9 / 17 / 33), chunks of 64
rays of the spheres scene behind the shell occupancy."""

import math

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.core.contraction import ContractionAABB
from tinynerf_tpu_torch.core.marching import RayMarcherAABB, RayMarcherUnbounded
from tinynerf_tpu_torch.core.occupancy import OccupancyState
from tinynerf_tpu_torch.data import RayPool
from tinynerf_tpu_torch.models.encodings import positional_encoding
from tinynerf_tpu_torch.models.kplanes import DIMENSION_PAIRS
from tinynerf_tpu_torch.ops import cuda_lib
from tinynerf_tpu_torch.train import InferStats, TrainConfig, build_renderer, infer, make_render_chunk
from tinynerf_tpu_torch.train.loop import make_render_chunk_packed, packed_graph_key
from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_data, make_spheres_pose_set
from tinynerf_tpu_torch.utils.device import device_constant

torch.set_num_threads(2)

CHUNK = 64
CAP = CHUNK * 8
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
CFGS = {
    "kplanes": dict(field_scale=0.07, n_samples=32, batch_size=CHUNK, occupancy_res=16, seed=1),
    "cobafa": dict(method="cobafa", field_scale=0.1, n_samples=32, batch_size=CHUNK, occupancy_res=16, seed=1),
}


def _world(method: str = "kplanes", device="cpu"):
    """(renderer, shell occupancy, skip grid, rays_o, rays_d) with two
    chunks of rays of the spheres scene (every other ray of a 16x16 view)."""
    cfg = TrainConfig(**CFGS[method])
    pool = RayPool(make_spheres_data(n_views=1, res=16, seed=0))
    renderer = build_renderer(cfg, pool.scene_scale, pool.bg_color, device=device)
    occ = make_shell_occupancy(renderer.occupancy, device=device)
    o, d, _ = (torch.as_tensor(np.asarray(a)) for a in pool.arrays())
    return renderer, occ, renderer.skip_grid(occ), o[::2].contiguous().to(device), d[::2].contiguous().to(device)


@pytest.mark.parametrize("march", ["dense", "skip"])
@pytest.mark.parametrize("method", ["kplanes", "cobafa"])
def test_packed_callable_is_render_packed_on_cpu(method, march):
    renderer, occ, skip_grid, o, d = _world(method)
    grid = (skip_grid,) if march == "skip" else ()
    fn = make_render_chunk_packed(renderer, CAP, march=march)
    with torch.inference_mode():
        for k in (0, CHUNK, 0):
            rgb, ok, n_samples, n_complete = fn(occ, o[k : k + CHUNK], d[k : k + CHUNK], *grid)
            ref = renderer.render_packed(occ, o[k : k + CHUNK], d[k : k + CHUNK], CAP, rgb_dir_branch="ray",
                                         march=march, skip_grid=skip_grid if grid else None)
            assert torch.equal(rgb, ref.rgb) and torch.equal(ok, ref.ray_valid > 0.0)
            assert int(n_samples) == int(ref.n_samples) and int(n_complete) == int(ref.n_complete)
    assert fn.captures == 0 and fn.replays == 0


def test_infer_counts_no_graph_on_cpu(tmp_path):
    renderer, occ, skip_grid, _, _ = _world()
    poses = make_spheres_pose_set(n_views=1, res=16)
    stats = InferStats()
    infer(renderer, occ, poses, [0], tmp_path, "view", chunk=CHUNK, render_chunk_fn=make_render_chunk(renderer),
          packed_fn=make_render_chunk_packed(renderer, CAP, march="skip"), stats=stats, grid_args=(skip_grid,),
          write=False)
    assert stats.packed_samples > 0
    assert stats.graph_captures == 0 and stats.graph_replays == 0


def test_graph_key_follows_storage():
    renderer, occ, skip_grid, o, d = _world()
    key = lambda march, occ_state, rays_o, grid: packed_graph_key(renderer, CAP, march, occ_state, rays_o, grid)
    o1 = o[:CHUNK]
    base = key("skip", occ, o1, (skip_grid,))
    assert key("skip", occ, o1, (skip_grid,)) == base
    # a rebuilt skip grid (the same values, new storage)
    assert key("skip", occ, o1, (renderer.skip_grid(occ),)) != base
    # another chunk of the same shape, and another shape
    assert key("skip", occ, o[CHUNK:], (skip_grid,)) == base
    assert key("skip", occ, o[: CHUNK // 2], (skip_grid,)) != base
    assert key("dense", occ, o1, ()) != base
    plane = renderer.field.planes[0][0]
    with torch.no_grad():
        plane.mul_(0.5)  # in place: the replay reads the new values
        assert key("skip", occ, o1, (skip_grid,)) == base
        plane.data = plane.data.clone()  # new storage
        assert key("skip", occ, o1, (skip_grid,)) != base
    # the dense march reads the occupancy state by address
    dense = key("dense", occ, o1, ())
    assert key("dense", OccupancyState(occ.grid.clone(), occ.mean), o1, ()) != dense
    assert key("dense", OccupancyState(occ.grid, occ.mean.clone()), o1, ()) != dense
    occ.grid.mul_(1.0)
    assert key("dense", occ, o1, ()) == dense


_OPTIONS = {"skip_steps": 7, "compute_dtype": torch.float16, "remat_field": True, "early_termination": 1e-3,
            "bg_color": (0.0, 0.5, 1.0)}


@pytest.mark.parametrize("option", ["rays_dtype", "tf32", *_OPTIONS])
def test_graph_key_follows_options(option):
    renderer, occ, skip_grid, o, d = _world()
    key = lambda rays_o: packed_graph_key(renderer, CAP, "skip", occ, rays_o, (skip_grid,))
    o1 = o[:CHUNK]
    base = key(o1)
    if option == "rays_dtype":
        assert key(o1.double()) != base
        return
    if option == "tf32":
        was = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = not was
            assert key(o1) != base
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
    else:
        was = getattr(renderer, option)
        setattr(renderer, option, _OPTIONS[option])
        assert key(o1) != base
        setattr(renderer, option, was)
    assert key(o1) == base


def test_packed_callable_runs_eagerly_with_gradients():
    renderer, occ, skip_grid, o, d = _world()
    fn = make_render_chunk_packed(renderer, CAP, march="skip")
    rgb, *_ = fn(occ, o[:CHUNK], d[:CHUNK], skip_grid)
    rgb.sum().backward()
    assert renderer.field.planes[0][0].grad is not None
    assert fn.captures == 0 and fn.replays == 0


def _x(n=257, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 3))).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hoisted_constants_hold_the_per_call_values(dtype):
    x = _x(dtype=dtype)
    # the K-Planes coordinate pairs: a stack of two columns, as list indexing
    for i, j in DIMENSION_PAIRS:
        old = x[..., [i, j]]
        new = torch.stack((x[..., i], x[..., j]), dim=-1)
        assert new.dtype == old.dtype and new.is_contiguous() and torch.equal(new, old)
    # the marcher's box, the contraction's lo / hi
    assert torch.equal(device_constant(AABB, dtype, x.device), torch.tensor(AABB, dtype=dtype))
    for v in AABB:
        assert torch.equal(device_constant(v, dtype, x.device), torch.tensor(v, dtype=dtype))
    # the encoding's frequencies
    for n in (4, 10):
        old = torch.tensor((2.0 ** np.arange(n)) * np.pi, dtype=dtype)
        new = device_constant(tuple(2.0**k * math.pi for k in range(n)), dtype, x.device)
        assert new.dtype == dtype and torch.equal(new, old)
    # the background, from build_renderer's tuple and from an f32 array
    for bg in ((1.0, 1.0, 1.0), tuple(np.asarray([0.1, 0.7, 0.3], np.float32))):
        assert torch.equal(device_constant(tuple(bg), torch.float32, x.device),
                           torch.tensor(bg, dtype=torch.float32))
    # the occupancy sweep's grid size
    assert torch.equal(device_constant((128, 64, 32), torch.float32, x.device),
                       torch.tensor((128, 64, 32), dtype=torch.float32))


def test_hoisted_constants_leave_every_output_unchanged():
    x = _x()
    rays_o, rays_d = x[:, :], torch.nn.functional.normalize(_x(seed=1), dim=-1)
    marcher = RayMarcherAABB(AABB, n_samples=16)
    t_min, t_exit = marcher.entry_exit(rays_o, rays_d)
    box = torch.tensor(AABB, dtype=torch.float32)
    d_safe = torch.where(rays_d == 0.0, rays_d + 1e-9, rays_d)
    t_planes = (box[:, None, :] - rays_o[None]) / d_safe[None]
    old_min = torch.clamp(torch.amax(torch.amin(t_planes, dim=0), dim=-1), marcher.near, marcher.far)
    assert torch.equal(t_min, old_min + np.float32(1e-4 * marcher.step_size).item())
    assert torch.equal(t_exit, torch.amin(torch.amax(t_planes, dim=0), dim=-1))
    coords, mask = ContractionAABB(AABB)(x)
    lo, hi = (torch.tensor(v, dtype=torch.float32) for v in AABB)
    assert torch.equal(coords, (x - lo) / (hi - lo) * 2.0 - 1.0)
    assert torch.equal(mask, torch.all((x >= lo) & (x <= hi), dim=-1).float())
    freqs = torch.tensor((2.0 ** np.arange(6)) * np.pi, dtype=torch.float32)
    xf = x[..., None] * freqs
    old = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1).reshape(x.shape[0], 36)
    assert torch.equal(positional_encoding(x, 6), old)
    unbounded = RayMarcherUnbounded(n_samples=24)
    t, deltas = unbounded(rays_o, rays_d)
    t_np, d_np = unbounded._grid()
    assert torch.equal(t[0], torch.from_numpy(t_np)) and torch.equal(deltas[-1], torch.from_numpy(d_np))
    # made once: another marcher of the same grid shares the tensors
    assert all(a is b for a, b in zip(unbounded.grid_on(x.device), RayMarcherUnbounded(n_samples=24).grid_on(x.device)))


def test_device_constant_is_made_once_outside_inference_mode():
    x = _x()
    with torch.inference_mode():
        a = device_constant((0.25, 0.5, 0.75), torch.float32, x.device)
    assert not a.is_inference()
    assert device_constant((0.25, 0.5, 0.75), torch.float32, x.device) is a
    with torch.inference_mode():
        positional_encoding(x, 3)
    # autograd may save the frequencies made inside inference mode
    xg = x.clone().requires_grad_()
    positional_encoding(xg, 3).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph and the kernels have no CPU mode)")
    return torch.device("cuda")


def _eager(renderer, occ, o, d, grid):
    out = renderer.render_packed(occ, o, d, CAP, rgb_dir_branch="ray", march="skip", skip_grid=grid)
    return out.rgb, out.ray_valid > 0.0, out.n_samples, out.n_complete


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_replay_matches_eager_after_in_place_update(cuda_device):
    renderer, occ, skip_grid, o, d = _world(device=cuda_device)
    fn = make_render_chunk_packed(renderer, CAP, march="skip")
    with torch.inference_mode():
        first = fn(occ, o[:CHUNK], d[:CHUNK], skip_grid)  # warm-up and capture
        assert fn.captures == 1 and fn.replays == 0
        assert _equal(first, _eager(renderer, occ, o[:CHUNK], d[:CHUNK], skip_grid))
        for k in (0, CHUNK):
            before = cuda_lib.launch_counts()
            replay = fn(occ, o[k : k + CHUNK], d[k : k + CHUNK], skip_grid)
            # a replay launches through no kernel wrapper
            assert not any(cuda_lib.launches_since(before).values())
            assert _equal(replay, _eager(renderer, occ, o[k : k + CHUNK], d[k : k + CHUNK], skip_grid))
        for p in renderer.parameters():
            p.mul_(0.75)
        updated = fn(occ, o[CHUNK:], d[CHUNK:], skip_grid)
        assert fn.captures == 1 and fn.replays == 3
        assert _equal(updated, _eager(renderer, occ, o[CHUNK:], d[CHUNK:], skip_grid))
        assert not torch.equal(updated[0], replay[0])


@pytest.mark.cuda
def test_replay_matches_eager_after_rebuilt_skip_grid(cuda_device):
    renderer, occ, skip_grid, o, d = _world(device=cuda_device)
    fn = make_render_chunk_packed(renderer, CAP, march="skip")
    with torch.inference_mode():
        fn(occ, o[:CHUNK], d[:CHUNK], skip_grid)
        fn(occ, o[:CHUNK], d[:CHUNK], skip_grid)
        thinner = OccupancyState(torch.where(torch.arange(occ.grid.shape[0], device=cuda_device)[:, None, None] % 2 == 0,
                                             occ.grid, 0.0), occ.mean)
        rebuilt = renderer.skip_grid(thinner)
        del skip_grid
        for k in (0, CHUNK):
            ours = fn(thinner, o[k : k + CHUNK], d[k : k + CHUNK], rebuilt)
            assert _equal(ours, _eager(renderer, thinner, o[k : k + CHUNK], d[k : k + CHUNK], rebuilt))
        assert fn.captures == 2 and fn.replays == 2


@pytest.mark.cuda
def test_infer_replays_bit_equal_to_eager(cuda_device, tmp_path):
    renderer, occ, skip_grid, _, _ = _world(device=cuda_device)
    poses = make_spheres_pose_set(n_views=2, res=32)
    packed = make_render_chunk_packed(renderer, CAP, march="skip")
    graphed, eager = InferStats(), InferStats()
    kw = dict(chunk=CHUNK, render_chunk_fn=make_render_chunk(renderer), grid_args=(skip_grid,), write=False)
    ours = infer(renderer, occ, poses, [0, 1], tmp_path, "g", packed_fn=packed, stats=graphed, **kw)
    ref = infer(renderer, occ, poses, [0, 1], tmp_path, "e", stats=eager,
                packed_fn=lambda *a: _eager(renderer, a[0], a[1], a[2], a[3]), **kw)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    n_chunks = 2 * 32 * 32 // CHUNK
    assert graphed.graph_captures == 1 and graphed.graph_replays == n_chunks - 1
    assert (graphed.packed_samples, graphed.fallback_rays) == (eager.packed_samples, eager.fallback_rays)
