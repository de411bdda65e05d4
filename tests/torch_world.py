"""Shared setup of the port-vs-JAX renderer tests (test_torch_render.py,
test_torch_slice.py): one generated scene, JAX-initialized parameters
carried into port renderers, and the shell occupancy state."""

import jax
import numpy as np

from tinynerf_tpu.data import PoseSet as JPoseSet
from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train.loop import build_renderer as jbuild_renderer
from tinynerf_tpu.utils.fixtures import make_shell_occupancy as jmake_shell_occupancy
from tinynerf_tpu.utils.fixtures import make_synthetic_scene
from tinynerf_tpu_torch.convert import load_params, occ_state_to_torch
from tinynerf_tpu_torch.data import PoseSet, parse_nerf_synthetic
from tinynerf_tpu_torch.train import TrainConfig, build_renderer

# field_scale 0.07: planes 9 / 17 / 33
CFG = dict(field_scale=0.07, n_samples=32, batch_size=64, occupancy_res=16, seed=1)
F32_ATOL = 1e-4  # tests/test_core.py:189's packed-vs-dense tolerance
BF16_ATOL = 2e-2  # one-ulp bf16 rounding flips between frameworks


def make_scene(root):
    make_synthetic_scene(root, n_train=1, n_test=2, res=16, kind="spheres")
    return root


def make_world(scene) -> dict:
    """JAX renderer, params and shell occupancy (f32 compute), and port
    renderers (f32 and bf16 compute) holding the same params."""
    jset = JPoseSet(jparse(scene, "test"))
    jcfg = JConfig(compute_dtype="float32", **CFG)
    jr = jbuild_renderer(jcfg, jset.scene_scale, np.asarray(jset.bg_color))
    params = jax.jit(jr.init)(jax.random.PRNGKey(2))
    occ = jmake_shell_occupancy(jr, CFG["occupancy_res"])
    pset = PoseSet(parse_nerf_synthetic(scene, "test"))
    renderers = {}
    for dt in ("float32", "bfloat16"):
        r = build_renderer(TrainConfig(compute_dtype=dt, **CFG), pset.scene_scale, pset.bg_color, device="cpu")
        load_params(r, jax.tree_util.tree_map(np.asarray, params))
        renderers[dt] = r
    return dict(jset=jset, jr=jr, params=params, occ=occ, pset=pset, renderers=renderers,
                tocc=occ_state_to_torch(occ))
