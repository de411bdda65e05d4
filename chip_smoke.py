#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tinynerf_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

0. card and toolchain: nvidia-smi's name and power limit, torch and CUDA;
1. build the hand-written CUDA kernels (csrc/*.cu, nvcc for sm_90a);
2. each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with the tolerances below, and both timed
   (median of 20 calls with CUDA events, and device time per call under
   the profiler);
3. the K-Planes serving slice at full width (TrainConfig defaults:
   planes 129/257/513 x 3 x 32, bf16 compute, 400 samples per ray, chunks
   of 2048 rays, 64 packed samples per ray): a checkpoint of seeded random
   parameters and the shell occupancy, `render_only` on two 800x800 views
   of the generated spheres scene (packed path, dense fallback), then
   `render_only` with eval_render="dense" on view 0.  Both kernels must
   have launched during those runs; the packed and dense renders of view 0
   must agree; and a 32x32 view rendered at f32 through the kernels must
   match the same view rendered on the CPU through the plain versions.

The last two lines are a JSON record of the kernels and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs no jax, no Pillow and no network.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# kernel vs plain version (both f32): the scans sum in different orders, and
# weights only matter where T > 1e-4, i.e. optical depth < 9.3, where f32
# sums of <= 400 terms stay within a few 1e-6
WEIGHTS_ATOL = 1e-5
CUMSUM_RTOL, CUMSUM_ATOL = 1e-5, 1e-4  # tests/test_segscan.py's tolerances
# packed vs dense render of one view at bf16 compute: the two paths run the
# decoders' f32-accumulated first layers as matmuls of different shapes, so
# an f32 sum may round to a neighbouring bf16 value (2^-8 relative) on one
# path only; the rgb difference that causes stays well under 2e-2
PACKED_DENSE_MAX_ABS = 2e-2
PACKED_DENSE_MEAN_ABS = 1e-4
# the same small view at f32 compute, kernels on the card vs plain on the CPU
SMALL_VIEW_ATOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, runs: int = 20) -> float:
    fn()  # warm up
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, runs: int = 20) -> float:
    """Device time per call (sum of the kernels' times under the profiler),
    without the host's enqueue gaps that a single-call event pair includes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA  # kernels only: aten ops repeat their kernels' time
    return sum(ev.self_device_time_total for ev in prof.key_averages() if ev.device_type == dev) / 1e3 / runs


def time_pair(label: str, kernel_fn, plain_fn) -> dict:
    """Median single-call time (CUDA events: what a caller waits, host
    enqueue included) and device time per call, of kernel and plain."""
    t = dict(ms=median_ms(kernel_fn), plain_ms=median_ms(plain_fn),
             device_ms=device_ms(kernel_fn), plain_device_ms=device_ms(plain_fn))
    print(f"{label}: call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms (median of 20, CUDA events); "
          f"device {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms (profiler, per call)")
    return t


def packed_problem(rng, n_rays=2048, cap=131072, max_count=400):
    """Serving-shaped packed buffer: ray-major samples of 2048 rays (counts
    in 0..400, most rays empty, as behind a converged occupancy grid), then
    a pad tail of id n_rays."""
    counts = rng.integers(0, max_count + 1, n_rays) * (rng.random(n_rays) < 0.15)
    ends = np.cumsum(counts)
    if ends[-1] >= cap:
        raise AssertionError("packed problem overflows its cap")
    n_valid = int(ends[-1])
    seg = np.full(cap, n_rays, np.int32)
    seg[:n_valid] = np.repeat(np.arange(n_rays), counts)
    valid = np.zeros(cap, np.float32)
    valid[:n_valid] = 1.0
    sig = rng.uniform(0.0, 50.0, cap).astype(np.float32) * valid
    dlt = np.full(cap, np.float32(5.196152 / 400), np.float32)
    return sig, dlt, valid, seg, n_valid


def check_kernels(dev):
    from tinynerf_tpu_torch.ops import segscan, weights_dense

    rng = np.random.default_rng(0)
    results = {}

    # kernel 1: packed weights + segmented cumsum at cap = 2048 x 64
    sig, dlt, valid, seg, n_valid = packed_problem(rng)
    t = lambda a: torch.from_numpy(a).to(dev)
    sig_t, dlt_t, val_t, seg_t = t(sig), t(dlt), t(valid), t(seg)
    n_rays = 2048
    err = 0.0
    for thr in (0.0, 1e-4):
        w_k = segscan.compute_weights_packed(sig_t, dlt_t, val_t, seg_t, thr, n_segments=n_rays)
        w_p = segscan.compute_weights_packed_plain(sig_t, dlt_t, val_t, seg_t, thr, n_segments=n_rays)
        torch.cuda.synchronize()
        e = float((w_k - w_p).abs().max())
        print(f"kernel segscan weights thr={thr:g}: max|kernel-plain| = {e:.3e} (tol {WEIGHTS_ATOL:g}), "
              f"{n_valid} valid samples of {sig.size}")
        if not e <= WEIGHTS_ATOL:
            raise AssertionError(f"packed weights disagree: {e} > {WEIGHTS_ATOL}")
        err = max(err, e)
    x = rng.uniform(0.0, 1.0, sig.size).astype(np.float32)
    x_t = t(x)
    c_k = segscan.segmented_cumsum(x_t, seg_t).cpu().numpy()
    c_p = segscan.segmented_cumsum_plain(x_t, seg_t).cpu().numpy()
    starts = np.concatenate([[0], np.nonzero(seg[1:] != seg[:-1])[0] + 1])
    base = np.repeat(np.concatenate([[0.0], np.cumsum(x.astype(np.float64))])[starts],
                     np.diff(np.concatenate([starts, [x.size]])))
    c_ref = np.cumsum(x.astype(np.float64)) - base
    np.testing.assert_allclose(c_k, c_p, rtol=CUMSUM_RTOL, atol=CUMSUM_ATOL)
    np.testing.assert_allclose(c_k, c_ref, rtol=CUMSUM_RTOL, atol=CUMSUM_ATOL)
    print(f"kernel segscan cumsum: max|kernel-plain| = {np.abs(c_k - c_p).max():.3e}, "
          f"max|kernel-float64| = {np.abs(c_k - c_ref).max():.3e} "
          f"(rtol {CUMSUM_RTOL:g}, atol {CUMSUM_ATOL:g})")
    results["segscan"] = dict(max_abs_err=err, **time_pair(
        f"kernel segscan weights [{sig.size}]",
        lambda: segscan.compute_weights_packed(sig_t, dlt_t, val_t, seg_t, 1e-4, n_segments=n_rays),
        lambda: segscan.compute_weights_packed_plain(sig_t, dlt_t, val_t, seg_t, 1e-4, n_segments=n_rays),
    ))

    # kernel 2: dense weights at [2048, 400]
    r, s = 2048, 400
    sig2 = t(rng.uniform(0.0, 50.0, (r, s)).astype(np.float32))
    dlt2 = t(np.full((r, s), np.float32(5.196152 / 400), np.float32))
    msk2 = t((rng.random((r, s)) < 0.3).astype(np.float32))
    err = 0.0
    for thr in (0.0, 1e-4):
        w_k = weights_dense.compute_weights_dense(sig2, dlt2, msk2, thr)
        w_p = weights_dense.compute_weights_dense_plain(sig2, dlt2, msk2, thr)
        torch.cuda.synchronize()
        e = float((w_k - w_p).abs().max())
        print(f"kernel weights_dense thr={thr:g}: max|kernel-plain| = {e:.3e} (tol {WEIGHTS_ATOL:g})")
        if not e <= WEIGHTS_ATOL:
            raise AssertionError(f"dense weights disagree: {e} > {WEIGHTS_ATOL}")
        err = max(err, e)
    results["weights_dense"] = dict(max_abs_err=err, **time_pair(
        f"kernel weights_dense [{r}, {s}]",
        lambda: weights_dense.compute_weights_dense(sig2, dlt2, msk2, 1e-4),
        lambda: weights_dense.compute_weights_dense_plain(sig2, dlt2, msk2, 1e-4),
    ))
    return results


def run_slice(tmp: str, card: str):
    from tinynerf_tpu_torch.convert import occ_state_to_numpy, params_to_numpy
    from tinynerf_tpu_torch.ops import segscan, weights_dense
    from tinynerf_tpu_torch.train import InferStats, TrainConfig, build_renderer, render_only, save_checkpoint
    from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_pose_set

    cfg = TrainConfig(output=tmp)
    pose_set = make_spheres_pose_set(n_views=2, res=800, seed=0)
    renderer = build_renderer(
        cfg, pose_set.scene_scale, pose_set.bg_color, device="cuda",
        generator=torch.Generator().manual_seed(0),
    )
    n_params = sum(p.numel() for p in renderer.parameters())
    occ = make_shell_occupancy(renderer.occupancy, device="cuda")
    save_checkpoint(tmp, 0, {
        "params": params_to_numpy(renderer), "occ_state": occ_state_to_numpy(occ),
        "meta": {"seed": 0},
    })
    print(f"slice: K-Planes resolutions {renderer.field.resolutions}, {n_params} params "
          f"({n_params * 4 / 1e6:.1f} MB f32), compute {cfg.compute_dtype}, "
          f"{cfg.n_samples} samples/ray, chunk {cfg.batch_size}, "
          f"packed cap {cfg.batch_size * cfg.eval_samples_per_ray}")
    del renderer

    segscan.compute_weights_packed.launches = 0
    weights_dense.compute_weights_dense.launches = 0
    torch.cuda.synchronize()
    packed = InferStats()
    m_packed = render_only(cfg, pose_set, stats=packed)
    dense = InferStats()
    m_dense = render_only(
        dataclasses.replace(cfg, eval_render="dense"),
        make_spheres_pose_set(n_views=1, res=800, seed=0),  # view 0 again
        name="render_dense", stats=dense,
    )
    torch.cuda.synchronize()
    launches = {
        "segscan": segscan.compute_weights_packed.launches,
        "weights_dense": weights_dense.compute_weights_dense.launches,
    }
    print(f"slice launches during render_only: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the serving path")

    for label, st, metrics in (("packed", packed, m_packed), ("dense", dense, m_dense)):
        for i, (img, sec, rays, m) in enumerate(zip(st.images, st.seconds, st.rays, metrics)):
            if img.shape != (800, 800, 3) or not np.isfinite(img).all():
                raise AssertionError(f"{label} view {i}: shape {img.shape} or non-finite values")
            if not (np.isfinite(m.psnr) and -1.0 <= m.ssim <= 1.0):
                raise AssertionError(f"{label} view {i}: bad metrics {m}")
            print(f"slice {label} view {i}: {sec:.3f} s, {rays / sec:,.0f} rays/s, "
                  f"psnr {m.psnr:.3f}, ssim {m.ssim:.4f} (random weights) [{card}]")
    print(f"slice packed: {packed.packed_samples} packed samples, "
          f"{packed.fallback_rays} rays re-rendered densely")
    diff = np.abs(packed.images[0] - dense.images[0])
    print(f"slice packed vs dense view 0: max abs {diff.max():.3e} (tol {PACKED_DENSE_MAX_ABS:g}), "
          f"mean abs {diff.mean():.3e} (tol {PACKED_DENSE_MEAN_ABS:g})")
    if not (diff.max() <= PACKED_DENSE_MAX_ABS and diff.mean() <= PACKED_DENSE_MEAN_ABS):
        raise AssertionError("packed and dense renders of view 0 disagree")

    # small view at f32: kernels on the card vs plain versions on the CPU
    small = make_spheres_pose_set(n_views=1, res=32, seed=0)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    imgs = {}
    for device in ("cuda", "cpu"):
        st = InferStats()
        render_only(cfg32, small, name=f"small_{device}", device=device, stats=st)
        imgs[device] = st.images[0]
    e = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
    print(f"slice 32x32 f32 view, card kernels vs CPU plain: max abs {e:.3e} (tol {SMALL_VIEW_ATOL:g})")
    if not e <= SMALL_VIEW_ATOL:
        raise AssertionError("card and CPU renders of the small view disagree")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tinynerf_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s incl. load)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda")
    kern = check_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(tmp, card)

    record = {"kernels": [
        {"name": "segscan.compute_weights_packed", "route": "cuda",
         "source": "tinynerf_tpu_torch/csrc/segscan.cu",
         "replaces": "tinynerf_tpu/ops/segscan.py:48", "launches": launches["segscan"],
         **kern["segscan"]},
        {"name": "weights_dense.compute_weights_dense", "route": "cuda",
         "source": "tinynerf_tpu_torch/csrc/weights_dense.cu",
         "replaces": "tinynerf_tpu/ops/weights_pallas.py:60",
         "launches": launches["weights_dense"], **kern["weights_dense"]},
    ]}
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
