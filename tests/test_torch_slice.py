"""The port's whole serving slice against the JAX package: `infer` and
`render_only` (packed path, dense fallback), checkpoints written by the
JAX package, and the command line.

Setup as in test_torch_render.py (tests/torch_world.py).  Images are held
to 1e-4 at f32 compute.  A JAX-written checkpoint is rendered by the port
in a subprocess in which `import jax` and `import optax` fail.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import save_checkpoint as jsave_checkpoint
from tinynerf_tpu.train.loop import infer as jinfer
from tinynerf_tpu.train.loop import make_optimizer
from tinynerf_tpu.train.loop import make_render_chunk as jmake_render_chunk
from tinynerf_tpu.train.loop import make_render_chunk_packed as jmake_render_chunk_packed
from tinynerf_tpu_torch.__main__ import main as cli_main
from tinynerf_tpu_torch.convert import occ_state_to_numpy, params_to_numpy
from tinynerf_tpu_torch.core import OccupancyGrid
from tinynerf_tpu_torch.train import (
    InferStats,
    TrainConfig,
    build_renderer,
    infer,
    load_checkpoint,
    make_render_chunk,
    make_render_chunk_packed,
    save_checkpoint,
)
from tinynerf_tpu_torch.utils import make_shell_occupancy
from torch_world import CFG, F32_ATOL, make_scene, make_world

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_scene") / "spheres")


@pytest.fixture(scope="module")
def world(scene):
    return make_world(scene)


@pytest.mark.parametrize("march", ["dense", "skip"])
@pytest.mark.parametrize("cap", [64 * 64, 16])
def test_infer_matches_jax_infer(world, tmp_path, cap, march):
    """The whole serving slice at f32: the port's packed infer (dense or
    skip march; a starved cap sends rays through the dense fallback) against
    the JAX infer with make_render_chunk_packed of the same march, each
    with the skip grid of its own occupancy state."""
    jr, r = world["jr"], world["renderers"]["float32"]
    skip = march == "skip"
    ref = jinfer(
        jr, world["params"], world["occ"], world["jset"], [0, 1], tmp_path / "jax", "r",
        chunk=CFG["batch_size"], render_chunk_fn=jmake_render_chunk(jr),
        packed_fn=jmake_render_chunk_packed(jr, cap, march=march),
        grid_args=(jr.skip_grid(world["occ"]),) if skip else (),
    )
    stats = InferStats()
    out = infer(
        r, world["tocc"], world["pset"], [0, 1], tmp_path / "port", "r",
        chunk=CFG["batch_size"], render_chunk_fn=make_render_chunk(r),
        packed_fn=make_render_chunk_packed(r, cap, march=march), stats=stats,
        grid_args=(r.skip_grid(world["tocc"]),) if skip else (),
    )
    for a, b in zip(out, ref):
        assert a.shape == (16, 16, 3)
        np.testing.assert_allclose(a, b, atol=F32_ATOL)
    assert (stats.fallback_rays > 0) == (cap == 16)
    assert stats.incomplete_rays == 0  # the round budget is the march's 32 samples
    assert (tmp_path / "port" / "r_0001.png").exists()


_BLOCKED_RENDER = """
import sys
sys.modules["jax"] = None      # `import jax` now raises ImportError
sys.modules["optax"] = None
import numpy as np
from tinynerf_tpu_torch.core import OccupancyGrid
from tinynerf_tpu_torch.data import PoseSet, parse_nerf_synthetic
from tinynerf_tpu_torch.train import InferStats, TrainConfig, render_only
cfg = TrainConfig(output=sys.argv[2], compute_dtype="float32", **{cfg})
stats = InferStats()
metrics = render_only(cfg, PoseSet(parse_nerf_synthetic(sys.argv[1], "test")), device="cpu", stats=stats)
np.save(sys.argv[3], np.stack(stats.images))
assert all(np.isfinite(m.psnr) for m in metrics)
loaded = [m for m in sys.modules if m.split(".")[0] in ("triton", "PIL") and sys.modules[m] is not None]
assert not loaded, loaded
"""


def test_render_only_reads_jax_checkpoint_without_jax(world, scene, tmp_path):
    """A checkpoint written by the JAX package (real OccupancyState, optax
    Adam state) is rendered by the port with jax and optax unimportable (and
    without loading Pillow or triton), and gives the JAX infer's images at
    f32."""
    jr = world["jr"]
    exp = tmp_path / "exp"
    jcfg = JConfig(compute_dtype="float32", output=exp, **CFG)
    opt_state = make_optimizer(jcfg).init(world["params"])
    jsave_checkpoint(exp, 7, {"params": world["params"], "opt_state": opt_state,
                              "occ_state": world["occ"], "meta": {"n_devices": 1}})
    cap = CFG["batch_size"] * jcfg.eval_samples_per_ray
    ref = jinfer(
        jr, world["params"], world["occ"], world["jset"], [0, 1], tmp_path / "jax", "r",
        chunk=CFG["batch_size"], render_chunk_fn=jmake_render_chunk(jr),
        packed_fn=jmake_render_chunk_packed(jr, cap, march="dense"),
    )
    out_npy = tmp_path / "port.npy"
    script = _BLOCKED_RENDER.replace("{cfg}", repr(CFG))
    proc = subprocess.run(
        [sys.executable, "-c", script, str(scene), str(exp), str(out_npy)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Rendering from" in proc.stdout and "ckpt_7.pkl" in proc.stdout
    np.testing.assert_allclose(np.load(out_npy), np.stack(ref), atol=F32_ATOL)
    assert json.loads((exp / "metrics_render.json").read_text())[0]["psnr"] > 0
    # the loader maps the JAX classes to stand-ins; the state reads back whole
    step, state = load_checkpoint(exp / "ckpt_7.pkl")
    assert step == 7 and state["opt_state"].count == 0
    np.testing.assert_array_equal(state["occ_state"].grid, np.asarray(world["occ"].grid))


def test_checkpoint_round_trip_and_refusal(world, tmp_path):
    occ = occ_state_to_numpy(world["tocc"])
    path = save_checkpoint(tmp_path, 3, {"params": {"x": np.ones(2, np.float32)}, "occ_state": occ})
    step, state = load_checkpoint(path)
    assert step == 3 and type(state["occ_state"]).__name__ == "OccupancyState"
    np.testing.assert_array_equal(state["occ_state"].grid, occ.grid)
    bad = tmp_path / "ckpt_9.pkl"
    bad.write_bytes(pickle.dumps({"step": 9, "state": {"f": subprocess.Popen}}))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        load_checkpoint(bad)


def test_cli_render_only(world, scene, tmp_path):
    """`python -m tinynerf_tpu_torch --render_only` on the CPU, of a K-Planes
    and of a vanilla checkpoint; `--datatype nerfstudio` reads the scene as
    a nerfstudio capture (this one has no `transforms.json`); the sharding
    flags render as without them on one rank (training is in
    test_torch_train_slice.py)."""
    exp = tmp_path / "exp"
    r = world["renderers"]["float32"]
    occ = make_shell_occupancy(OccupancyGrid.cube(128, r.marcher.step_size))  # the CLI's grid size
    save_checkpoint(exp, 1, {"params": params_to_numpy(r), "occ_state": occ_state_to_numpy(occ)})
    base = ["--data", str(scene), "--datatype", "synthetic", "--output", str(exp),
            "--method", "kplanes", "--batch_size", "64", "--n_samples", "32",
            "--field_scale", "0.07"]
    cli_main(base + ["--render_only", "--device", "cpu"])
    assert (exp / "render_0000.png").exists() and (exp / "metrics_render.json").exists()
    vanilla = tmp_path / "vanilla"
    rv = build_renderer(TrainConfig(method="vanilla", field_scale=0.07, occupancy_res=128), 1.0, None,
                        device="cpu")
    save_checkpoint(vanilla, 1, {"params": params_to_numpy(rv), "occ_state": occ_state_to_numpy(occ)})
    cli_main([{"kplanes": "vanilla", str(exp): str(vanilla)}.get(a, a) for a in base]
             + ["--render_only", "--device", "cpu"])
    assert (vanilla / "render_0001.png").exists() and (vanilla / "metrics_render.json").exists()
    with pytest.raises(FileNotFoundError, match="transforms.json"):
        cli_main([a if a != "synthetic" else "nerfstudio" for a in base] + ["--render_only"])
    # the sharding flags on one rank change nothing (as on a one-device JAX mesh)
    (exp / "render_0000.png").unlink()
    cli_main(base + ["--render_only", "--shard_tables", "--shard_bwd", "--device", "cpu"])
    assert (exp / "render_0000.png").exists()
    # a checkpoint whose occupancy grid does not fit the config is refused
    save_checkpoint(exp, 2, {"params": params_to_numpy(r), "occ_state": occ_state_to_numpy(world["tocc"])})
    with pytest.raises(ValueError, match="occupancy"):
        cli_main(base + ["--render_only", "--device", "cpu"])
