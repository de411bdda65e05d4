"""The port's tools (`tools/{render_turntable,bench_infer,profile_step,
quality_run,profile_field,analyze_runs}_torch.py`) through `main(argv)` on
the CPU at a tiny size, against the JAX package on the same inputs.

  * render_turntable: the frames rendered from a JAX-written vanilla
    checkpoint against the JAX `infer` of the same orbit from the same
    checkpoint (packed on the skip march, the dense fallback), within the
    port's bf16 serving limits (2e-2 max, 1e-4 mean: tests/torch_world.py's
    BF16_ATOL, chip_smoke.py's packed-vs-dense mean); the orbit's cameras
    bit-equal;
  * bench_infer: the packed paths' `ok` share on the shell occupancy, the
    JAX `make_render_chunk_packed`'s on the same rays, exactly (it depends
    on the occupancy and the march, not on the parameters);
  * profile_step: the valid fraction behind the shell occupancy and, with
    `--march skip`, the skip march's emitted samples and complete fraction,
    JAX's exactly for the same rays and jitter words;
  * quality_run: the `TrainConfig` that `tools/quality_run.py` builds from
    the same flags, field by field; the JAX tool's line formats; a loss
    that falls over a few steps;
  * profile_field: every piece of both fields timed, and Cobafa's sorted
    oct gradient within 1e-5 of the `index_add_` it replaced;
  * analyze_runs: the run counts of the JAX tool's table, exactly, on the
    points the JAX tool marched (fed to the port's packing and counting:
    the two packages' jitter draws differ).
"""

import dataclasses
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.data import Intrinsics as JIntrinsics
from tinynerf_tpu.data import NerfData as JNerfData
from tinynerf_tpu.data import PoseSet as JPoseSet
from tinynerf_tpu.train import TrainConfig as JConfig
from tinynerf_tpu.train import build_renderer as jbuild_renderer
from tinynerf_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from tinynerf_tpu.train.loop import infer as jinfer
from tinynerf_tpu.train.loop import make_render_chunk_packed as jmake_render_chunk_packed
from tinynerf_tpu.utils import make_shell_occupancy as jmake_shell_occupancy
from tinynerf_tpu.utils.fixtures import CAMERA_ANGLE_X, look_at_matrix

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import analyze_runs_torch  # noqa: E402
import bench_infer_torch  # noqa: E402
import profile_field_torch  # noqa: E402
import profile_step_torch  # noqa: E402
import quality_run_torch  # noqa: E402
import render_turntable_torch  # noqa: E402

torch.set_num_threads(2)

# the tiny size: planes / MLP at field_scale 0.07, 32 samples, occupancy 16^3
TINY = dict(field_scale=0.07, n_samples=32, occupancy_res=16)
TINY_ARGS = ["--device", "cpu", "--field_scale", "0.07", "--n_samples", "32"]


def _jrenderer(method, **kw):
    cfg = JConfig(method=method, **dict(TINY, **kw))
    return cfg, jbuild_renderer(cfg, scene_scale=1.0, bg_color=np.ones(3, np.float32))


def test_render_turntable_matches_jax_infer(tmp_path):
    cfg, jr = _jrenderer("vanilla")
    params = jax.jit(jr.init)(jax.random.PRNGKey(3))
    occ = jmake_shell_occupancy(jr, TINY["occupancy_res"])
    ckpt = jsave_checkpoint(tmp_path / "exp", 7, {"params": params, "occ_state": occ})
    n_frames, res, chunk = 2, 12, 64
    got = render_turntable_torch.main([
        "--ckpt", str(ckpt), "--method", "vanilla", "--out", str(tmp_path / "frames"),
        "--n_frames", str(n_frames), "--res", str(res), "--chunk", str(chunk), *TINY_ARGS])
    assert got["step"] == 7 and got["march"] == "skip" and got["frames"] == n_frames
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == ["frame_0000.png", "frame_0001.png"]
    assert got["rays"] == n_frames * res * res and 0 <= got["fallback_rays"] <= got["rays"]

    cams = np.stack([look_at_matrix(4.0 * np.array([np.cos(t), np.sin(t), 0.5])).astype(np.float32)
                     for t in (2 * np.pi * i / n_frames for i in range(n_frames))])
    np.testing.assert_array_equal(got["cameras"], cams)
    focal = res / (2.0 * np.tan(0.5 * CAMERA_ANGLE_X))
    poses = JPoseSet(JNerfData(cameras=cams, intrinsics=JIntrinsics(focal, focal, res / 2, res / 2, res, res)))
    packed = jmake_render_chunk_packed(jr, chunk * cfg.eval_samples_per_ray, march="skip")
    ref = jinfer(jr, params, occ, poses, list(range(n_frames)), tmp_path / "jax", "frame", chunk=chunk,
                 packed_fn=packed, grid_args=(jax.jit(jr.skip_grid)(occ),))
    for a, b in zip(got["images"], ref):
        diff = np.abs(a - np.asarray(b))
        assert a.shape == (res, res, 3) and diff.max() <= 2e-2 and diff.mean() <= 1e-4
    assert np.ptp(np.asarray(ref[0])) > 0.01  # the orbit sees the field


def _jax_ok_share(method, chunk, spr_cap, n, march):
    cfg, jr = _jrenderer(method, batch_size=chunk)
    params = jax.jit(jr.init)(jax.random.PRNGKey(0))
    occ = jmake_shell_occupancy(jr, TINY["occupancy_res"])
    fn = jmake_render_chunk_packed(jr, chunk * spr_cap, march=march)
    grid = (jax.jit(jr.skip_grid)(occ),) if march == "skip" else ()
    o, d = bench_infer_torch.bench_rays(n + 2, chunk)
    return float(np.mean([np.asarray(fn(params, occ, jnp.asarray(o[2 + i]), jnp.asarray(d[2 + i]), *grid)[1])
                          for i in range(n)]))


def test_bench_infer_ok_share_matches_jax():
    chunk, spr_cap, n = 64, 1, 2
    got = bench_infer_torch.main(["--method", "vanilla", "--chunk", str(chunk), "--spr_cap", str(spr_cap),
                                  "--n", str(n), "--occupancy_res", "16", *TINY_ARGS])
    assert set(got) >= {"dense", "packed_dense", "packed_skip", "speedup"}
    for path, march in (("packed_dense", "dense"), ("packed_skip", "skip")):
        share = got[path]["ok_share"]
        assert 0 < share < 1  # the cap of one sample per ray overflows
        assert share == _jax_ok_share("vanilla", chunk, spr_cap, n, march)
        assert not any(got[path]["launches"].values())  # CPU tensors: the plain versions
    assert got["dense"]["rays_per_s"] > 0 and got["speedup"] > 0


def test_profile_step_counts_match_jax():
    from tinynerf_tpu.core.skipmarch import skip_march as jskip_march

    got = profile_step_torch.main(["--method", "vanilla", "--bucket", "1", "--batch_size", "64",
                                   "--occupancy_res", "16", "--n", "1", "--march", "skip", *TINY_ARGS])
    for stage in ("skip-grid build (per occ update)", "march+contract (no occ)", "occupancy query (R*S)",
                  "field fwd+bwd (CAP pts)", "packed weights fwd (segscan)", "optimizer update",
                  "render_packed fwd+bwd", "render_packed(skip) fwd+bwd"):
        assert got["stages"][stage]["ms"] > 0
    assert "TV reg grad" not in got["stages"]  # K-Planes only
    assert got["rays"] == 64 and got["cap"] == 64 * 32

    cfg, jr = _jrenderer("vanilla", batch_size=64)
    occ = jmake_shell_occupancy(jr, TINY["occupancy_res"])
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(-4.0 * d), jnp.asarray(d)
    t, _ = jr.marcher(o, d)
    cpos, maskin = jr.contraction(o[:, None, :] + d[:, None, :] * t[..., None])
    fill = float(jnp.sum(maskin * jr.occupancy.query(occ, cpos))) / (64 * 32)
    assert 0 < got["valid_fraction"] == pytest.approx(fill, rel=1e-6)
    t_min, t_exit = jr.marcher.entry_exit(o, d)
    k_idx, complete = jskip_march(o, d, t_min, t_exit, jr.marcher.step_size, cfg.n_samples, jr.contraction,
                                  jax.jit(jr.skip_grid)(occ), jax.random.PRNGKey(5), jr.skip_steps)
    assert got["skip_emitted"] == int(jnp.sum(k_idx >= 0)) > 0
    assert got["skip_complete_frac"] == pytest.approx(float(jnp.mean(complete)), abs=1e-7)


FLAG_SETS = {
    "defaults": [],
    "options": ["--method", "cobafa", "--scene_type", "unbounded", "--steps", "17", "--batch_size", "256",
                "--n_samples", "48", "--eval-every", "5", "--eval-n", "1", "--dtype", "bfloat16",
                "--occ_threshold", "0.02", "--lr", "0.005", "--lr-tables", "0.02", "--tv", "0.0",
                "--occ-interp", "trilinear", "--decay-tables", "--no-fwd-clamp", "--seed", "3",
                "--max-bucket", "4", "--march", "dense"],
}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_quality_run_config_matches_jax_tool(flags, monkeypatch, tmp_path):
    """The JAX tool's `TrainConfig` (caught where it calls `train`) and the
    port tool's, field by field, for the same flags."""
    import tinynerf_tpu.train as jtrain
    import tinynerf_tpu.utils.fixtures as jfixtures

    caught = {}

    class Caught(Exception):
        pass

    def fake_train(cfg, *a, **kw):
        caught["cfg"] = cfg
        raise Caught

    def tiny_scene(root, n_train, n_test, res, kind):
        caught["scene"] = (n_train, n_test, res, kind)
        return real_scene(root, n_train=1, n_test=1, res=8, kind=kind)

    real_scene = jfixtures.make_synthetic_scene
    monkeypatch.setattr(jtrain, "train", fake_train)
    monkeypatch.setattr(jfixtures, "make_synthetic_scene", tiny_scene)
    monkeypatch.setattr(sys, "argv", ["quality_run.py", *FLAG_SETS[flags]])
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    sys.path.insert(0, str(REPO / "tools"))
    import quality_run as jtool

    with pytest.raises(Caught):
        jtool.main()
    ref = caught["cfg"]
    ours = quality_run_torch.make_config(quality_run_torch.parse_args(FLAG_SETS[flags]), tmp_path / "exp")
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(ours)]
    for name in names:
        if name != "output":
            assert getattr(ours, name) == getattr(ref, name), name
    assert ours.sample_cap == ref.sample_cap and ours.total_steps == ref.total_steps
    assert ours.effective_lr == ref.effective_lr and ours.effective_lr_tables == ref.effective_lr_tables


def test_quality_run_trains_and_prints_the_jax_lines(tmp_path, capsys):
    got = quality_run_torch.main([
        "--device", "cpu", "--res", "16", "--n_train", "2", "--steps", "4", "--batch_size", "64",
        "--n_samples", "32", "--field_scale", "0.07", "--gather-dtype", "float8", "--init-range", "0,1",
        "--bwd-mode", "sorted", "--eval-every", "2", "--eval-n", "1", "--output", str(tmp_path)])
    out = capsys.readouterr().out
    assert re.search(r"^RESULT scene=spheres method=kplanes lookup=default gather=float8 dtype=float32 "
                     r"steps=4 deviations=\[init=0,1\] loss \d\.\d{4}->\d\.\d{5} test PSNR \d+\.\d\d dB  "
                     r"SSIM -?\d\.\d{3} rays/s/chip \d+$", out, re.M), out
    assert re.search(r"^TIMELINE (\d+:\d+s:\d+\.\d\d ?)+$", out, re.M), out
    assert re.search(r"^MARCH skip \d+ of 4 steps \(first skip step: (None|\d+)\)$", out, re.M), out
    assert len(got["losses"]) == 4 and all(np.isfinite(got["losses"]))
    assert got["last_loss"] < got["first_loss"]
    assert np.isfinite(got["psnr"]) and got["march_steps"]["dense"] + got["march_steps"]["skip"] == 4
    assert (tmp_path / "exp" / "ckpt_4.pkl").exists()
    assert (got["gather_dtype"], got["bwd_impl"]) == ("float8", "sorted")
    # the wrapper reached the field, and train/loop.py's make_model is restored
    import tinynerf_tpu_torch.models.registry as registry
    import tinynerf_tpu_torch.train.loop as loop_mod

    assert loop_mod.make_model is registry.make_model


FIELD_PIECES = {
    "kplanes": ("fwd: quad builds (x3 proj, kernel 7)", "fwd: full value (build+gather, x3)",
                "bwd: _cell_2d x3 (recompute)", "bwd: contrib build (w x g, 1 proj)",
                "bwd: permutation gather of the payload (x3 proj)", "bwd: windowed_accumulate (x3 proj, kernel 5)",
                "bwd: _fine_from_quad (1 proj)", "bwd: _pullback_scales (1 proj)",
                "field fwd+bwd (incl product rule)"),
    "cobafa": ("oct build: coef (kernel 6)", "oct build: ALL grids", "gathers: ALL grids (same coords)",
               "bwd: window sort + accumulate + reduce ALL grids",
               "bwd: index_add_ + reduce ALL grids (replaced; here only)", "field fwd+bwd (dropout on)"),
}


@pytest.mark.parametrize("method", sorted(FIELD_PIECES))
def test_profile_field_times_every_piece(method):
    got = profile_field_torch.main(["--method", method, "--cap", "3000", "--n", "1", "--pad", "0.4",
                                    "--field_scale", "0.1", "--device", "cpu"])
    assert got["method"] == method and got["cap"] == 3000 and got["card"] == "cpu"
    for name in FIELD_PIECES[method]:
        piece = got["pieces"][name]
        assert piece["ms"] > 0 and piece["device_ms"] is None and piece["launches_per_call"] == {}
    if method == "kplanes":
        assert sum(k.startswith("bwd: sort_by_window") for k in got["pieces"]) == 1
        assert got["bwd_impl"] == "scatter" and got["w_window"] == 256  # the CPU's rule
    else:
        assert len([k for k in got["pieces"] if k.startswith("oct build: basis")]) == 6
        assert got["bwd_sorted_vs_index_add"] <= 1e-5


def test_analyze_runs_counts_match_jax_tool(monkeypatch, capsys):
    """The JAX tool runs as it is; its march's output is kept, and the port
    packs and counts those same points: every row of the table equal."""
    import analyze_runs as jtool
    from tinynerf_tpu.core import renderer as jrenderer_mod

    kept = {}
    march = jrenderer_mod.NerfRenderer._march

    def keep_march(self, *a, **kw):
        out = march(self, *a, **kw)
        kept["cpos"], kept["mask"] = np.array(out[0]), np.asarray(out[2]) > 0.0
        return out

    monkeypatch.setattr(jrenderer_mod.NerfRenderer, "_march", keep_march)
    jtool.main()
    out = capsys.readouterr().out
    ref = [(m[0], int(m[1]), int(m[2]), int(m[3]))
           for m in re.findall(r"^\s*(xy|xz|yz|vox)\s+(\d+)\s+(\d+)/(\d+)", out, re.M)]
    assert len(ref) == 11
    from tinynerf_tpu_torch.core.renderer import compact

    mask = torch.from_numpy(kept["mask"])
    is_pad, safe_idx, seg_ids = compact(mask, mask.numel())
    pts = torch.from_numpy(kept["cpos"]).reshape(-1, 3)[safe_idx[~is_pad]].numpy()
    rows = analyze_runs_torch.count_runs(pts, seg_ids[~is_pad].numpy())
    assert [(r["name"], r["res"], r["runs"], r["samples"]) for r in rows] == ref
    assert int(kept["mask"].sum()) == rows[0]["samples"] > 0


def test_analyze_runs_main_on_the_port_march():
    got = analyze_runs_torch.main(["--device", "cpu", "--n_rays", "256", "--field_scale", "0.1"])
    assert got["rays"] == 256 and got["samples"] > 0 and len(got["rows"]) == 11
    assert [(r["name"], r["res"]) for r in got["rows"][:3]] == [("xy", 129), ("xz", 129), ("yz", 129)]
    for r in got["rows"]:
        assert 0 < r["runs"] <= r["samples"] == got["samples"]
    # finer cells, more runs
    by = {(r["name"], r["res"]): r["runs"] for r in got["rows"]}
    assert by[("xy", 129)] <= by[("xy", 257)] <= by[("xy", 513)] and by[("vox", 64)] <= by[("vox", 128)]


def test_quality_run_matmul_precision_flag(tmp_path, capsys):
    """`--matmul-precision` holds for the run, is named among the RESULT
    line's deviations, and torch's setting is restored after."""
    before = torch.get_float32_matmul_precision()
    got = quality_run_torch.main([
        "--device", "cpu", "--method", "vanilla", "--res", "16", "--n_train", "1", "--steps", "2",
        "--batch_size", "32", "--n_samples", "16", "--field_scale", "0.07", "--matmul-precision", "medium",
        "--eval-n", "1", "--output", str(tmp_path)])
    assert got["matmul_precision"] == "medium" and len(got["losses"]) == 2
    assert "deviations=[matmul=medium]" in capsys.readouterr().out
    assert torch.get_float32_matmul_precision() == before
