#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tinynerf_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

0. card and toolchain: nvidia-smi's name and power limit, torch and CUDA;
1. build the hand-written CUDA kernels (csrc/*.cu, one nvcc per source,
   all started together, for sm_90a);
2. each kernel against its plain PyTorch version on the card, with the
   tolerances below, and both timed (median of 20 calls with CUDA events,
   and device time per call under the profiler), beside the least time the
   card could take (`bound_ms`: the bytes the function must move at 3.35
   TB/s, or its f32 operations at 67 TFLOP/s, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time
   (`library_ms`): the packed weights, forward and backward, on the
   serving chunk's buffer [131,072] and on three training buffers
   [819,200] (2,048 rays; the early step's 4,096 rays filling 0.937; the
   converged step's 131,072 rays of mostly 0-8 samples), ids outside the
   ray range exactly 0 and each direction one device launch per call (the
   profiler's kernel list), and on one ray of 32 samples, whose device
   time is the card's shortest launch of the kernel (`floor_device_ms`,
   the floor under a bound that is smaller); the dense weights and their
   backward at [2048, 400]; the radix sort and the windowed
   table-gradient accumulation (both payloads) at the training path's
   shapes: the sort as the trainer calls it (packed keys, by their window
   bits) and, under `full_range_*`, over all 32 bits of random keys, both
   beside `torch.sort`; the accumulation on cells laid out as training
   lays them out (a hot window, and the packed buffer's pad tail in one
   cell with a zero cotangent), so its split-window branch runs, its main
   kernel's device time apart from the wrapper's other launches, in the
   windows of 64 cells the trainer sorts by on the card (sums in
   registers) and, bf16, in windows of 256 (the shared-memory tile); the oct
   cell-pack build
   over the full-width Cobafa field's seven grids and the quad cell-pack
   build over the K-Planes field's nine planes, each in bf16 and f32,
   bit-equal to its plain version and to the yardstick `copy_` (the oct
   build also at 3, 5 and 6 channels on grids that are not cubic), and the
   quad build in float8_e4m3fn byte-equal to its plain version (JAX's
   float8 rule) on the nine planes seeded with the rule's boundaries
   (+-464, +-480, +-inf, NaN, -0.0, subnormals) and on small tables whose
   channel counts take its generic path, its `copy_` yardstick timed
   only (torch's cast saturates); all three outputs also on a plane 4
   bytes off a 16-byte boundary (the generic path), and each output's
   share of its bound printed; and the
   skip march on the shell occupancy's skip grid, at a 2048-ray serving
   chunk and a 131,072-ray training bucket (64 rounds), with and without
   jitter, k_idx and complete equal to its plain version's (and the skip
   grid's build timed); and the unbounded skip march on the isotropic grid
   of the shell occupancy, rays drawn over the nerfstudio capture's
   training views (a 2048-ray serving chunk and a 131,072-ray bucket, 96
   rounds, with and without jitter), k_idx and complete equal to its plain
   version's, timed the same way; and the sums that make a step repeat
   itself, each bit-equal over three calls on the same inputs: the per-ray
   sum (`segment_sum`) at the serving chunk's buffer and the early K-Planes
   step's, against its plain `index_add` and the renderer's former two
   `index_add` calls; the key-value radix sort at Cobafa's largest grid's
   window ids; Cobafa's oct gradient over the seven full-width grids
   (819,200 samples, a converged step's pad tail) against its plain version
   and the `index_add_` it replaced; and the training-shaped accumulation;
3. the K-Planes serving slice at full width (TrainConfig defaults:
   planes 129/257/513 x 3 x 32, bf16 compute, 400 samples per ray, chunks
   of 2048 rays, 64 packed samples per ray, 64 skip-march rounds): a
   checkpoint of seeded random parameters and the shell occupancy,
   `render_only` on two 800x800 views of the generated spheres scene
   (packed path with the skip march, dense fallback), then `render_only`
   with eval_render="dense" on view 0, then view 0 through `infer` with
   the packed path on the dense march and on the skip march again (both
   warm, so their times compare).  The weights kernels, the quad
   build and the skip march must have launched; the skip-packed,
   dense-march-packed and dense renders of view 0 must agree; and a 32x32
   view rendered at f32 through the kernels must match the same view
   rendered on the CPU through the plain versions;
4. the K-Planes training slice at full width: `train()` with TrainConfig
   defaults (batch 2048 rays, 400 samples, cap 819,200, bf16 compute) for
   64 steps from seeded random parameters on four generated 800x800 views,
   crossing the occupancy updates at steps 0 and 32.  The loss must be
   finite and fall; the packed weights, their backward, the sort, the
   accumulation and the quad build must have launched inside `train()`.
   Then, behind the shell occupancy at bucket 64 (131,072 rays drawn over
   the views), one deterministic step through the dense march and one
   through the skip march with a 400-round budget (no ray cut) must agree
   on the loss to 1e-5 relative, and a step at the default 64-round budget
   is timed beside them.  Then the gradients of one full-width dense chunk
   (2048 rays drawn over the views x 400 samples, f32 compute) through the
   dense weights' backward kernel must match the plain version's: d loss /
   d sigma and every parameter's;
5. the Cobafa serving slice at full width (TrainConfig(method="cobafa"):
   basis grids 32/51/70/89/108/128^3 x 8/8/8/4/4/4, coefficients 64^3 x 6,
   the 36 -> 128 field MLP with 5 hidden layers), as phase 3 on one view:
   the three renders must agree, the 32x32 f32 view on the card must match
   the CPU's, and the oct build, the skip march and both weights kernels
   must have launched;
6. the Cobafa training slice at full width, as phase 4 (dropout on): a
   finite, falling loss, the oct build and the packed weights and their
   backward launched inside `train()`; the dense and skip steps at bucket
   64; then one full-width dense chunk's gradients through the oct-build
   kernel must match those through the plain build, every leaf bit-equal;
7. the vanilla serving slice at full width (TrainConfig(method="vanilla"):
   posenc(10) into 10 layers of 256, He init), as phase 5 on one view;
8. the vanilla training slice at full width, as phase 4 (64 steps, the
   dense and skip steps at bucket 64), then one deterministic step (2048
   rays, f32 compute) with remat_field against one without, from the same
   parameters: the losses and every gradient leaf bit-equal;
9. the K-Planes serving slice on the unbounded marcher (the disparity grid
   over the test poses' scene scale, the Mip-360 contraction, the
   isotropic skip grid and the unbounded skip march, 96 rounds) of a
   nerfstudio capture: nine generated 800x800 spheres views written as
   tests/conftest.py writes one and read back with `parse_nerfstudio`
   through the native PNG loader; the 8th-frame holdout leaves two views
   to render (`render_only`, packed on the skip march with the dense
   fallback), view 0 again densely and through `infer` on both marches;
10. the K-Planes training slice on the unbounded marcher: `train()` for 64
   steps on a `RayPool` of the capture's seven training views, then the
   dense and skip steps at bucket 64 behind the shell occupancy (400
   rounds: no ray cut, the same loss; then the 96-round default, timed)
   and the dense chunk's gradients, from the seeded parameters (64 steps
   saturate this field: every gradient of the trained chunk is 0) behind
   the shell occupancy (the near field: far-field deltas of hundreds of
   units scale the f32 rounding of the dense backward's total - incl to
   ~1e-3 of the largest gradient; tests/test_torch_kernels.py holds those
   deltas at 1e-5 with densities that end the rays early).

11. data parallelism over `torch.distributed` on the one card (NCCL refuses
   two ranks on one device): (a) two spawned ranks on cuda:0 in a gloo
   group, K-Planes at full width; rank 0 takes the ungrouped deterministic
   step (2048 rays drawn over four generated 800x800 views, f32 compute),
   then both take the grouped step replicated, with shard_tables and with
   shard_tables + shard_bwd from the same parameters, each held against the
   ungrouped one (loss 1e-5 relative, gradients rtol 1e-4 / atol 1e-6,
   updated parameters the same plus the difference Adam's map makes of the
   two gradients near 0); then `train()` with shard_tables for 16 steps,
   with ms/step and peak memory per rank, and kernels 1, 4 and 5 must have
   launched once per step and 7 nine times per step on both ranks; (b) one
   NCCL rank in this process: the grouped step against the ungrouped one
   with the training default bf16 table-gradient payload (loss 1e-6
   relative, gradients and parameters as in (a), and each gradient leaf
   1e-5 of its max) and with the f32 payload (each gradient leaf 1e-5 of
   its max), 4 `train()` steps through the
   group (the same launches per step), then `render_only` from their
   checkpoint over the group, packed and dense, against `render_only`
   alone (max abs 1e-5);
12. the port's four tools through their `main(argv)`, at full width:
   (a) `tools/bench_infer_torch.py` at its defaults (K-Planes, 8192-ray
   chunks x 400 samples, cap 64 per ray, the 128^3 shell): dense,
   packed on the dense march and on the skip march, each path's kernels
   launched in its own chunks (2; 1 and 7; the skip march) and its `ok`
   share in (0, 1]; (b) `tools/profile_step_torch.py` at bucket 16, dense
   and `--march skip`: every stage, kernel 1 once per packed weights call;
   (c) `tools/quality_run_torch.py --method kplanes` at the JAX tool's
   defaults for QUALITY_STEPS steps: the skip march launched inside
   `train()` and taken by some of its steps, the loss down
   QUALITY_LOSS_DROP times, a finite test PSNR over QUALITY_PSNR_FLOOR;
   (d) the same with `--gather-dtype float8` for FP8_STEPS steps: every
   quad build float8, nine per field call, a finite falling loss; (e)
   `tools/render_turntable_torch.py` from (c)'s checkpoint, four 200x200
   frames: s/frame and the skip-serving fallback share on a trained scene;
   (f) `tools/profile_field_torch.py` for K-Planes and for Cobafa (a
   converged step's pad tail) at the 819,200 cap: every piece timed, most
   on the device too, kernels 4-7 launched, Cobafa's sorted oct gradient
   within 1e-5 of the `index_add_` it replaced; (g) `tools/analyze_runs_torch.py`
   at the JAX tool's geometry: the run counts;
13. determinism at full width, K-Planes and Cobafa: one deterministic step
   twice from one saved state (loss, every gradient, parameter and Adam
   moment bit-equal), and one 800x800 view served twice (packed on the skip
   march behind the shell occupancy, the dense fallback), bit-equal.

Each of phases 3-13 sets every kernel's launch count to 0 just before it
drives its path and reads the counts just after (phase 11(a) in each
rank's process, around `train()`; phase 12 around each tool); the
comparisons with the plain versions and phase 11's deterministic and
ungrouped steps are not counted.  The last two lines are a JSON
record of the kernels (launches summed over phases 3-13, and by phase;
the float8 quad build in a row of its own) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs no jax, no Pillow and no network.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

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
# weight gradients, kernel vs plain: f32 sums of up to 400 terms in another
# order; and the table-gradient accumulation and the per-ray sum, f32 sums
# over a cell's or a ray's samples in another order: both relative to the
# largest magnitude
GRAD_RTOL_OF_MAX = 1e-5
# one full-width dense chunk at f32 compute, through the kernels vs through
# the plain dense weights: d loss / d sigma (kernel 3's own output) to
# GRAD_RTOL_OF_MAX; the decoders' parameter gradients (f32 sums over the
# chunk's samples) to 1e-4 of each leaf's largest; the plane tables'
# gradients pass the training default bf16 payload, which rounds each
# sample's cotangent to bf16, so a cotangent that differs in its last f32
# bits may round to the neighbouring bf16 value, 2^-8 of that one
# contribution: 2^-8 of each table leaf's largest
CHUNK_GRAD_RTOL_OF_MAX = 1e-4
CHUNK_TABLE_GRAD_RTOL_OF_MAX = 2.0 ** -8
# Cobafa's dense chunk, oct-build kernel vs plain build: the build is
# bit-equal, so the forward is, and every sum of the backward has a fixed
# order (the grids' gradients through the window sort and the
# accumulation): every leaf bit-equal
COBAFA_CHUNK_GRAD_RTOL_OF_MAX = 0.0
TRAIN_STEPS = 64
# the skip and dense steps behind the shell occupancy: the same sample set
# and positions bit for bit, so only the f32 sums' order (atomics) differs
SKIP_DENSE_LOSS_RTOL = 1e-5
SKIP_BUCKET = 64  # the converged state's bucket: 131,072 candidate rays
# f32 operations per active round of the skip march (csrc/skipmarch.cu):
# position and jitter 9, box test 6, three voxel indices 30, the advance 3
SKIP_ROUND_FLOPS = 48
# and of the unbounded skip march: t_k and its jitter 16, position 6, the
# inf-norm 5, the contraction 18, three voxel indices 18, the local bound 25
# (radius, n_eff, m0, F(m0), 1/L), the advance through x_of_t 8
UNBOUNDED_ROUND_FLOPS = 96
# the vanilla step with remat_field against the one without, f32 compute:
# the same arithmetic, every sum in a fixed order: bit-equal
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL_OF_MAX = 0.0, 0.0
# the card's published peaks (H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
# f32 operations per sample of the weights (an exp counted as one): s =
# sigma * delta * mask, the scan's add, exp(-(c - s)), 1 - exp(-s), the
# product and the threshold; the backward's two scans and closed form
WEIGHTS_FWD_FLOPS, WEIGHTS_BWD_FLOPS = 10, 14


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


def device_ms_by_kernel(fn, runs: int = 20) -> dict:
    """Device time per call by kernel name (the kernels' times under the
    profiler, without the host's enqueue gaps that a single-call event pair
    includes).  The profiler has returned a window with no kernel at all
    (nothing recorded for work that ran): such a window is taken again, up
    to three times, and {} (not measured) is returned if none recorded a
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA  # kernels only: aten ops repeat their kernels' time
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        by_name = {ev.key: ev.self_device_time_total / 1e3 / runs for ev in prof.key_averages()
                   if ev.device_type == dev and ev.self_device_time_total > 0}
        if by_name:
            return by_name
    return {}


def device_ms(fn, runs: int = 20):
    """Device time per call, all kernels summed; None if not measured."""
    by_name = device_ms_by_kernel(fn, runs)
    return sum(by_name.values()) if by_name else None


def _ms(v) -> str:
    return f"{v:.4f} ms" if v is not None else "not measured"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float = 0.0) -> dict:
    """The least time the card could take for work that reads its inputs
    once and writes its outputs once (`n_bytes`) and does `flops` f32
    operations outside the tensor cores: the larger of the two times."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=n_bytes, bound_flops=flops)


def time_pair(label: str, kernel_fn, plain_fn, bound_: dict, library_fn=None) -> dict:
    """Median single-call time (CUDA events: what a caller waits, host
    enqueue included) and device time per call, of kernel and plain, beside
    the bound and the time of `library_fn` (one PyTorch call computing the
    same function, timed only here; None where there is none)."""
    by_name = device_ms_by_kernel(kernel_fn)
    t = dict(ms=median_ms(kernel_fn), plain_ms=median_ms(plain_fn),
             device_ms=sum(by_name.values()) if by_name else None, device_kernels=sorted(by_name),
             plain_device_ms=device_ms(plain_fn), **bound_,
             library_ms=median_ms(library_fn) if library_fn is not None else None,
             library_device_ms=device_ms(library_fn) if library_fn is not None else None)
    lib = f"{t['library_ms']:.4f} ms (device {_ms(t['library_device_ms'])})" if library_fn is not None else "none"
    print(f"{label}: call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {lib} (median of 20, "
          f"CUDA events); device {_ms(t['device_ms'])}, plain {_ms(t['plain_device_ms'])} (profiler, "
          f"per call); bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bound_bytes'] / 1e6:.1f} MB, "
          f"{t['bound_flops'] / 1e9:.3f} GFLOP)")
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


def _one_launch(label: str, timed: dict) -> None:
    """The profiler's kernel list of one call: exactly one device launch."""
    names = timed["device_kernels"]
    print(f"{label}: kernels of one call (profiler): {[k[:60] for k in names] or 'not measured'}")
    if len(names) > 1:
        raise AssertionError(f"{label}: one call launched {len(names)} kernels: {names}")


def check_packed_weights(dev, label: str, problem, n_rays: int) -> tuple:
    """Kernel 1 on one packed buffer: the forward at both thresholds and the
    backward against their plain versions, ids outside [0, n_rays) exactly
    0, one device launch per call, and both timed.  Returns the forward's
    and the backward's records."""
    from tinynerf_tpu_torch.ops import segscan

    sig, dlt, valid, seg, n_valid = problem
    args = [torch.from_numpy(a).to(dev) for a in (sig, dlt, valid, seg)]
    n = sig.size
    outside = args[3] >= n_rays
    err = 0.0
    for thr in (0.0, 1e-4):
        w_k = segscan.compute_weights_packed(*args, thr, n_segments=n_rays)
        w_p = segscan.compute_weights_packed_plain(*args, thr, n_segments=n_rays)
        torch.cuda.synchronize()
        e = float((w_k - w_p).abs().max())
        print(f"kernel segscan weights {label} thr={thr:g}: max|kernel-plain| = {e:.3e} (tol {WEIGHTS_ATOL:g}), "
              f"{n_valid} valid samples of {n} in {n_rays} rays")
        if not (e <= WEIGHTS_ATOL and bool((w_k[outside] == 0).all())):
            raise AssertionError(f"packed weights ({label}) disagree: {e} > {WEIGHTS_ATOL}, or a pad is not 0")
        err = max(err, e)
    fwd = dict(max_abs_err=err, n_valid=n_valid, **time_pair(
        f"kernel segscan weights {label} [{n}]",
        lambda: segscan.compute_weights_packed(*args, 1e-4, n_segments=n_rays),
        lambda: segscan.compute_weights_packed_plain(*args, 1e-4, n_segments=n_rays),
        bound(nbytes(*args) + 4 * n, WEIGHTS_FWD_FLOPS * n),
    ))
    _one_launch(f"kernel segscan weights {label}", fwd)

    w = segscan.compute_weights_packed(*args, 1e-4, n_segments=n_rays)
    g = torch.randn(n, device=dev, generator=torch.Generator(dev).manual_seed(6))
    out = segscan.weights_packed_bwd(*args, w, g, n_rays)
    ref = segscan.weights_packed_bwd_plain(*args, w, g, n_rays)
    err = _rel_err(out, ref)
    print(f"kernel segscan backward {label}: max|kernel-plain| / max|plain| = {err:.3e} (tol {GRAD_RTOL_OF_MAX:g})")
    if not (err <= GRAD_RTOL_OF_MAX and bool((out[outside] == 0).all())):
        raise AssertionError(f"packed weights backward ({label}) disagrees: {err}, or a pad is not 0")
    bwd = dict(max_abs_err=float((out - ref).abs().max()), n_valid=n_valid, **time_pair(
        f"kernel segscan backward {label} [{n}]",
        lambda: segscan.weights_packed_bwd(*args, w, g, n_rays),
        lambda: segscan.weights_packed_bwd_plain(*args, w, g, n_rays),
        bound(nbytes(*args, w, g) + 4 * n, WEIGHTS_BWD_FLOPS * n),
    ))
    _one_launch(f"kernel segscan backward {label}", bwd)
    return fwd, bwd


def check_kernels(dev):
    from tinynerf_tpu_torch.ops import segscan, weights_dense

    rng = np.random.default_rng(0)
    results = {}

    # kernel 1: packed weights + segmented cumsum at cap = 2048 x 64
    sig, dlt, valid, seg, n_valid = packed_problem(rng)
    t = lambda a: torch.from_numpy(a).to(dev)
    n_rays = 2048
    results["segscan"], _ = check_packed_weights(dev, "serving", (sig, dlt, valid, seg, n_valid), n_rays)
    x = rng.uniform(0.0, 1.0, sig.size).astype(np.float32)
    x_t, seg_t = t(x), t(seg)
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
        bound(nbytes(sig2, dlt2, msk2) + 4 * r * s, WEIGHTS_FWD_FLOPS * r * s),
    ))
    return results


def _packed_from_counts(rng, counts, cap):
    n_rays = counts.size
    n_valid = int(counts.sum())
    if n_valid > cap:
        raise AssertionError("packed problem overflows its cap")
    seg = np.full(cap, n_rays, np.int32)
    seg[:n_valid] = np.repeat(np.arange(n_rays), counts)
    valid = (seg < n_rays).astype(np.float32)
    sig = rng.uniform(0.0, 50.0, cap).astype(np.float32) * valid
    dlt = np.full(cap, np.float32(5.196152 / 400), np.float32)
    return sig, dlt, valid, seg, n_valid


def training_packed_problem(rng, n_rays=2048, cap=819_200, max_count=400, fill=0.95):
    """Training-shaped packed buffer: ray-major samples of `n_rays` rays
    (counts in 0..400) filling `fill` of cap = 2048 x 400, then the pad tail.
    4,096 rays at 0.937 is the early training step (bucket 2, PERF.md)."""
    counts = rng.integers(0, max_count + 1, n_rays)
    return _packed_from_counts(rng, (counts * (fill * cap / counts.sum())).astype(np.int64), cap)


def converged_packed_problem(rng, n_rays=131_072, cap=819_200):
    """The converged training step's buffer (bucket 64, fill ~0.466): most
    rays hold 0-8 samples (4 in 10 none at all), one in 200 a surface's
    20-200."""
    counts = rng.integers(0, 9, n_rays) * (rng.random(n_rays) < 0.6)
    long_rays = rng.random(n_rays) < 0.005
    counts[long_rays] = rng.integers(20, 201, int(long_rays.sum()))
    return _packed_from_counts(rng, counts.astype(np.int64), cap)


def one_ray_problem(n=32):
    """One ray of 32 samples: a kernel's time on it is the time of the
    card's shortest launch of that kernel (`floor_device_ms`)."""
    return (np.linspace(0.0, 50.0, n, dtype=np.float32), np.full(n, np.float32(5.196152 / 400)),
            np.ones(n, np.float32), np.zeros(n, np.int32), n)


def accumulation_problem(rng, n=819_200, n_cells=512 * 512, w_window=256, n_pad=300_000,
                         n_hot=40_000, n_pad_window=3_000):
    """Training-shaped cells of the three projections' samples [3, n], and
    the mask of samples whose cotangent is zero.  Uniform cells, then per
    projection a hot window of `n_hot` samples, `n_pad_window` real samples
    in the pad's window, and the packed buffer's pad tail: `n_pad` samples
    in ONE cell with a zero cotangent (every pad copies sample 0's
    position).  The hot and pad windows each span many chunks of the
    kernel's ACCUM_CHUNK samples, so its split-window branch runs."""
    cell = rng.integers(0, n_cells, (3, n))
    zero = np.zeros((3, n), bool)
    for p in range(3):
        hot_w, pad_w = rng.choice(n_cells // w_window, 2, replace=False)
        idx = rng.choice(n - n_pad, n_hot + n_pad_window, replace=False)
        cell[p, idx[:n_hot]] = hot_w * w_window + rng.integers(0, w_window, n_hot)
        cell[p, idx[n_hot:]] = pad_w * w_window + rng.integers(0, w_window, n_pad_window)
        cell[p, n - n_pad:] = pad_w * w_window + rng.integers(0, w_window)
        zero[p, n - n_pad:] = True
    return cell.astype(np.int32), zero


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def check_training_kernels(dev, results: dict) -> dict:
    """The backward kernels, the sort and the accumulation at the training
    path's shapes, against their plain versions; adds to `results`."""
    from tinynerf_tpu_torch.ops import bitonic, table_grad, weights, weights_dense

    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(a).to(dev)

    # kernel 1 at the training buffer [819,200]: today's 2048 rays, then the
    # two states of a training run, forward and backward
    _, results["segscan_bwd"] = check_packed_weights(dev, "training, 2,048 rays", training_packed_problem(rng), 2048)
    # the same kernels on one ray of 32 samples: the card's shortest launch
    # of each, the floor under every bound that is smaller
    floor = check_packed_weights(dev, "one ray of 32 samples", one_ray_problem(), 1)
    results["segscan"]["floor_device_ms"] = floor[0]["device_ms"]
    results["segscan_bwd"]["floor_device_ms"] = floor[1]["device_ms"]
    for key, label, problem, n_rays in (
            ("train_early", "early training, 4,096 rays", training_packed_problem(rng, 4096, fill=0.937), 4096),
            ("train_converged", "converged training, 131,072 rays", converged_packed_problem(rng), 131_072)):
        fwd, bwd = check_packed_weights(dev, label, problem, n_rays)
        print(f"kernel segscan {label}: fill {fwd['n_valid'] / problem[0].size:.4f}")
        results["segscan"].update({f"{key}_{k}": v for k, v in fwd.items()})
        results["segscan_bwd"].update({f"{key}_{k}": v for k, v in bwd.items()})

    # kernel 3: dense weights backward at [2048, 400]
    r, s = 2048, 400
    sig2 = t(rng.uniform(0.0, 50.0, (r, s)).astype(np.float32))
    dlt2 = t(np.full((r, s), np.float32(5.196152 / 400), np.float32))
    msk2 = t((rng.random((r, s)) < 0.3).astype(np.float32))
    w2 = weights_dense.compute_weights_dense(sig2, dlt2, msk2, 1e-4)
    g2 = torch.randn(r, s, device=dev)
    out = weights_dense.weights_dense_bwd(sig2, dlt2, msk2, w2, g2)
    ref = weights.compute_weights_bwd(sig2, dlt2, msk2, w2, g2)
    err = _rel_err(out, ref)
    print(f"kernel weights_dense backward: max|kernel-plain| / max|plain| = {err:.3e} (tol {GRAD_RTOL_OF_MAX:g})")
    if not err <= GRAD_RTOL_OF_MAX:
        raise AssertionError(f"dense weights backward disagrees: {err}")
    results["weights_dense_bwd"] = dict(max_abs_err=float((out - ref).abs().max()), **time_pair(
        f"kernel weights_dense backward [{r}, {s}]",
        lambda: weights_dense.weights_dense_bwd(sig2, dlt2, msk2, w2, g2),
        lambda: weights.compute_weights_bwd(sig2, dlt2, msk2, w2, g2),
        bound(nbytes(sig2, dlt2, msk2, w2, g2) + 4 * r * s, WEIGHTS_BWD_FLOPS * r * s),
    ))

    # kernel 4: the sort of the three projections' packed keys [3, 819,200],
    # as the trainer calls it: by the keys' window bits (the low bits are an
    # ascending iota), the windows those the trainer picks on the card
    n, n_cells, f, nc = 819_200, 512 * 512, 96, 4
    cell_np, zero_np = accumulation_problem(rng, n, n_cells)
    cell = t(cell_np)
    w_window = table_grad.default_window(dev, n_cells, n, nc * f)
    keys, idx_bits, window_bits, _ = table_grad.window_keys(cell, n_cells, w_window)
    bit_range = dict(begin_bit=idx_bits, end_bit=idx_bits + window_bits)
    out = bitonic.sort_i32(keys, **bit_range)
    if not (torch.equal(out, bitonic.sort_i32_plain(keys, **bit_range))
            and torch.equal(out, torch.sort(keys, dim=-1).values)):
        raise AssertionError("sort_i32 by the window bits differs from its plain version or from torch.sort")
    print(f"kernel radix sort [3, {n}] packed keys, bits [{idx_bits}, {idx_bits + window_bits}) "
          f"({n_cells // w_window} windows of {w_window} cells): bit-equal to torch.sort")
    results["sort"] = dict(max_abs_err=0.0, **time_pair(
        f"kernel radix sort [3, {n}] by {window_bits} window bits", lambda: bitonic.sort_i32(keys, **bit_range),
        lambda: bitonic.sort_i32_plain(keys, **bit_range), bound(2 * nbytes(keys)),
        lambda: torch.sort(keys, dim=-1)))
    # and over all 32 bits of random keys, like for like with torch.sort
    rkeys = t(rng.integers(-(2**31), 2**31 - 1, (3, n), dtype=np.int64).astype(np.int32))
    if not torch.equal(bitonic.sort_i32(rkeys), torch.sort(rkeys, dim=-1).values):
        raise AssertionError("sort_i32 of random keys differs from torch.sort")
    print(f"kernel radix sort [3, {n}] random keys, all 32 bits: bit-equal to torch.sort")
    results["sort"].update({f"full_range_{k}": v for k, v in time_pair(
        f"kernel radix sort [3, {n}] random keys, 32 bits", lambda: bitonic.sort_i32(rkeys),
        lambda: bitonic.sort_i32_plain(rkeys), bound(2 * nbytes(rkeys)),
        lambda: torch.sort(rkeys, dim=-1)).items()})
    del rkeys

    # kernel 5: windowed accumulation, 3 x 819,200 samples into 262,144 x 384
    gen = torch.Generator(dev).manual_seed(1)
    gq = torch.randn(3, n, f, device=dev, generator=gen)
    gq[t(zero_np)] = 0.0
    wq = torch.rand(3, n, nc, device=dev, generator=gen)
    perm, offsets = table_grad.sort_by_window(cell, n_cells, w_window)
    gidx = (perm.long() + (torch.arange(3, device=dev) * n)[:, None]).reshape(-1)
    counts = (offsets[:, 1:] - offsets[:, :-1]).cpu().numpy()
    n_split = (counts > table_grad.ACCUM_CHUNK).sum(axis=1)
    print(f"kernel windowed_accumulate input: {n_cells // w_window} windows of {w_window} cells, split into "
          f"chunks of {table_grad.ACCUM_CHUNK} "
          f"per projection {n_split.tolist()}, largest window {counts.max(axis=1).tolist()} samples, "
          f"{int(zero_np.sum())} samples with a zero cotangent")
    if not (n_split >= 2).all():
        raise AssertionError("the accumulation input splits too few windows")
    empty = t(np.stack([np.bincount(c, minlength=n_cells) == 0 for c in cell_np]))
    # the library yardstick: one index_add_ of the decoded f32 contributions
    # (w_c * g for each corner c) into the output's cells; the decode, which
    # the kernel does on the fly from the packed payload, is not timed
    contrib = (wq[..., :, None] * gq[..., None, :]).reshape(3 * n, nc * f)
    flat_cell = (cell.long() + (torch.arange(3, device=dev) * n_cells)[:, None]).reshape(-1)
    lib_out = torch.zeros(3 * n_cells, nc * f, device=dev)
    library = lambda: lib_out.index_add_(0, flat_cell, contrib)
    # the work this run's data needs: each sample with a nonzero cotangent
    # adds nc x f products into its cell (the pads' zero rows add nothing)
    flops = 2.0 * nc * f * int((~t(zero_np)).sum())
    out_bytes = 4 * 3 * n_cells * nc * f
    entry = {}
    for payload, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rows = table_grad.pack_payload(gq, wq, cell, w_window, payload)
        rows = rows.reshape(3 * n, -1)[gidx].reshape(3, n, -1)
        out = _repeats(f"kernel windowed_accumulate {label} payload",
                       lambda: table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, w_window))
        ref = table_grad.windowed_accumulate_plain(rows, offsets, f, nc, n_cells, w_window)
        err, abs_err = _rel_err(out, ref), float((out - ref).abs().max())
        print(f"kernel windowed_accumulate {label} payload: max|kernel-plain| / max|plain| = "
              f"{err:.3e} (tol {GRAD_RTOL_OF_MAX:g})")
        if not err <= GRAD_RTOL_OF_MAX:
            raise AssertionError(f"windowed accumulation ({label}) disagrees: {err}")
        if not bool((out[empty] == 0).all()):
            raise AssertionError(f"windowed accumulation ({label}): a cell with no samples is not 0")
        del out, ref
        timed = time_pair(
            f"kernel windowed_accumulate {label} payload [3, {n}] -> [3, {n_cells}, {nc * f}]",
            lambda: table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, w_window),
            lambda: table_grad.windowed_accumulate_plain(rows, offsets, f, nc, n_cells, w_window),
            bound(nbytes(rows, offsets) + out_bytes, flops), library,
        )
        # the accumulation kernel apart from the wrapper's other launches
        # (the scan of the work list, the item table, and the combine of the
        # split windows' later chunks)
        by_name = device_ms_by_kernel(
            lambda: table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, w_window))
        main = sum(ms for name, ms in by_name.items() if "windowed_accumulate" in name)
        timed["kernel_device_ms"] = main if by_name else None
        timed["other_device_ms"] = sum(by_name.values()) - main if by_name else None
        print(f"kernel windowed_accumulate {label} payload: device {_ms(timed['kernel_device_ms'])} in the "
              f"accumulation kernel, {_ms(timed['other_device_ms'])} in the wrapper's other launches "
              f"{sorted(k[:40] for k in by_name if 'windowed_accumulate' not in k)}")
        entry[label] = dict(max_abs_err=abs_err, **timed)
    del contrib, lib_out
    # windows of 256 cells, the JAX package's: too large for the kernel that
    # sums in registers, so the tile kernel takes them, a tile split over blocks
    perm, offsets = table_grad.sort_by_window(cell, n_cells, 256)
    gidx = (perm.long() + (torch.arange(3, device=dev) * n)[:, None]).reshape(-1)
    rows = table_grad.pack_payload(gq, wq, cell, 256, torch.bfloat16).reshape(3 * n, -1)[gidx].reshape(3, n, -1)
    out = table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, 256)
    ref = table_grad.windowed_accumulate_plain(rows, offsets, f, nc, n_cells, 256)
    err = _rel_err(out, ref)
    if not (err <= GRAD_RTOL_OF_MAX and bool((out[empty] == 0).all())):
        raise AssertionError(f"windowed accumulation, windows of 256 cells, disagrees: {err}")
    del out, ref
    entry["bf16"]["window256_device_ms"] = device_ms(
        lambda: table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, 256))
    print(f"kernel windowed_accumulate bf16 payload, windows of 256 cells (the tile kernel): max|kernel-plain| / "
          f"max|plain| = {err:.3e} (tol {GRAD_RTOL_OF_MAX:g}), device {_ms(entry['bf16']['window256_device_ms'])}")
    del rows
    # the training default is the bf16 payload (ops/interp.py); f32 rides along
    results["accumulate"] = {
        **entry["bf16"],
        "max_abs_err": max(entry["f32"]["max_abs_err"], entry["bf16"]["max_abs_err"]),
        **{f"f32_payload_{k}": v for k, v in entry["f32"].items() if k != "max_abs_err"},
    }
    return results


# the fixed-order sums: runs of each call that must give the same bits
REPEATS = 3
# f32 operations per sample of the per-ray sum (4 channels: scan add and carry)
SEGMENT_SUM_FLOPS = 8
# the pad tail's share of a converged Cobafa step's packed buffer (fill
# 0.4, PERF.md section 5): pads at one point with a zero cotangent
COBAFA_PAD_SHARE = 0.6


def _repeats(label: str, fn) -> torch.Tensor:
    """fn() REPEATS times: raise unless every output is bit-equal to the first."""
    outs = [fn() for _ in range(REPEATS)]
    torch.cuda.synchronize()
    if not all(torch.equal(o, outs[0]) for o in outs[1:]):
        raise AssertionError(f"{label}: {REPEATS} calls on the same inputs differ")
    print(f"{label}: {REPEATS} calls bit-equal")
    return outs[0]


def check_fixed_order_kernels(dev, results: dict) -> dict:
    """The sums that make a step repeat itself: the per-ray sum (segment_sum)
    at the serving chunk's buffer and the early K-Planes step's, against its
    plain version (one `index_add`) and the renderer's old two `index_add`
    calls; the key-value radix sort at Cobafa's largest grid; Cobafa's oct
    gradient over the seven full-width grids (window sort, accumulation in
    the register kernel's flat layout), against its plain version and the
    `index_add_` of [n, 8F] rows it replaced.  Each bit-equal over REPEATS
    calls; adds to `results`."""
    from tinynerf_tpu_torch.models import make_model
    from tinynerf_tpu_torch.ops import bitonic, interp, segscan, table_grad

    rng = np.random.default_rng(4)
    t = lambda a: torch.from_numpy(a).to(dev)
    entry = {}
    for key, label, problem, n_rays in (
            ("serving", "serving chunk, 2,048 rays", packed_problem(rng), 2048),
            ("train_early", "early training step, 4,096 rays", training_packed_problem(rng, 4096, fill=0.937), 4096)):
        seg = t(problem[3])
        n = seg.numel()
        x = t(rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32))
        out = _repeats(f"kernel segment_sum {label} [{n}]", lambda: segscan.segment_sum(x, seg, n_rays))
        ref = segscan.segment_sum_plain(x, seg, n_rays)
        err = _rel_err(out, ref)
        print(f"kernel segment_sum {label}: max|kernel-plain| / max|plain| = {err:.3e} (tol {GRAD_RTOL_OF_MAX:g})")
        if not err <= GRAD_RTOL_OF_MAX:
            raise AssertionError(f"segment_sum ({label}) disagrees with its plain version: {err}")
        seg_long = seg.long()
        rgb, w = x[:, :3].contiguous(), x[:, 3].contiguous()

        def two_index_adds():  # the renderer's per-ray sum before this kernel
            a = torch.zeros(n_rays + 1, 3, device=dev).index_add(0, seg_long, rgb)
            o = torch.zeros(n_rays + 1, device=dev).index_add(0, seg_long, w)
            return a[:n_rays], o[:n_rays]

        entry[key] = dict(max_abs_err=float((out - ref).abs().max()), **time_pair(
            f"kernel segment_sum {label} [{n}, 4] -> [{n_rays}, 4]",
            lambda: segscan.segment_sum(x, seg, n_rays), lambda: segscan.segment_sum_plain(x, seg, n_rays),
            bound(nbytes(x, seg) + 16 * n_rays, SEGMENT_SUM_FLOPS * n), two_index_adds))
    results["segment_sum"] = {**entry["train_early"], **{f"serving_{k}": v for k, v in entry["serving"].items()}}

    # Cobafa's seven grids at full width, one converged step's samples
    field = make_model("cobafa", device="meta")[0]
    grids = [tuple(p.shape) for p in (field.coef, *field.basis)]
    n = 819_200
    n_pad = int(COBAFA_PAD_SHARE * n)
    xs = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    xs[n - n_pad:] = xs[0]
    x = t(xs)
    cases = []
    for shape in grids:
        r0, r1, r2, f = shape
        cell, w = interp._cell_3d(x, r0, r1, r2)
        g = t(rng.normal(size=(n, f)).astype(np.float32))
        g[n - n_pad:] = 0.0
        cases.append((cell, w, g, (r0 - 1) * (r1 - 1) * (r2 - 1)))

    # kernel 4's key-value form, at the largest grid's window ids (64 cells a window)
    cell, _, _, n_cells = max(cases, key=lambda c: c[3])
    window = (cell.to(torch.int32) >> 6)[None].contiguous()
    vals = torch.arange(n, dtype=torch.int32, device=dev)[None].contiguous()
    bits = bitonic._bits(-(-n_cells // 64))
    k, v = _repeats(f"kernel sort_pairs [1, {n}] ({bits} key bits)",
                    lambda: torch.stack(bitonic.sort_pairs_i32(window, vals, 0, bits))).unbind(0)
    k_ref, v_ref = bitonic.sort_pairs_i32_plain(window, vals, 0, bits)
    if not (torch.equal(k, k_ref) and torch.equal(v, v_ref)):
        raise AssertionError("sort_pairs_i32 differs from its plain version")
    print(f"kernel sort_pairs [1, {n}] window ids of {n_cells} cells, {bits} bits, the sample index as the "
          f"value: bit-equal to its plain version")
    results["sort_pairs"] = dict(max_abs_err=0.0, **time_pair(
        f"kernel sort_pairs [1, {n}] by {bits} bits", lambda: bitonic.sort_pairs_i32(window, vals, 0, bits),
        lambda: bitonic.sort_pairs_i32_plain(window, vals, 0, bits), bound(4 * nbytes(window)),
        lambda: torch.sort(window, dim=-1, stable=True)))

    # Cobafa's oct gradient: the seven grids' cell tables
    def sorted_grads():
        return [interp.oct_table_grad(g, w, c, nc) for c, w, g, nc in cases]

    def plain_grads():  # sort plain, then windowed_accumulate_plain
        grads = []
        for c, w, g, nc in cases:
            w_window = table_grad.default_window(dev, nc, n, 8 * g.shape[1], packed_keys=False)
            nc_pad = -(-nc // w_window) * w_window
            perm, offsets = table_grad.sort_by_window_pairs(c[None], nc_pad, w_window)
            rows = table_grad.pack_payload(g[None], w[None], c[None], w_window, torch.float32, row_align=4)
            rows = rows[0, perm[0].long()][None]
            grads.append(table_grad.windowed_accumulate_plain(rows, offsets, g.shape[1], 8, nc_pad, w_window)[0, :nc])
        return grads

    def index_add_grads():  # the backward's scatter before this change
        return [torch.zeros(nc, 8 * g.shape[1], device=dev).index_add_(
            0, c, (g[:, None, :] * w[:, :, None]).reshape(n, 8 * g.shape[1])) for c, w, g, nc in cases]

    outs = _repeats("kernel oct gradient, 7 grids", lambda: torch.cat([o.reshape(-1) for o in sorted_grads()]))
    err = 0.0
    for ref in (plain_grads(), index_add_grads()):
        ref = torch.cat([o.reshape(-1) for o in ref])
        err = max(err, _rel_err(outs, ref))
    print(f"kernel oct gradient [{n} samples, {n_pad} pads] -> the 7 grids' cell tables: max|kernel-plain| and "
          f"|kernel-index_add_| / max = {err:.3e} (tol {GRAD_RTOL_OF_MAX:g})")
    if not err <= GRAD_RTOL_OF_MAX:
        raise AssertionError(f"Cobafa's oct gradient disagrees: {err}")
    out_bytes = sum(4 * nc * 8 * g.shape[1] for _, _, g, nc in cases)
    in_bytes = sum(nbytes(c, w, g) for c, w, g, _ in cases)
    flops = sum(2.0 * 8 * g.shape[1] * (n - n_pad) for _, _, g, _ in cases)
    timed = time_pair(f"Cobafa oct gradient (sort, pack, gather, accumulate), 7 grids x {n} samples",
                      sorted_grads, plain_grads, bound(in_bytes + out_bytes, flops), index_add_grads)
    results["accumulate"].update({f"cobafa_oct_{k}": v for k, v in timed.items()})
    results["accumulate"]["cobafa_oct_max_abs_err"] = err
    return results


def oct_yardstick(table: torch.Tensor, out_dtype) -> torch.Tensor:
    """The oct table by one PyTorch call: a `copy_` of the table's 2x2x2
    windows (unfold; corners dx, dy, dz with dz fastest) into the output
    viewed as [r0-1, r1-1, r2-1, 2, 2, 2, F].  The port never calls it."""
    r0, r1, r2, f = table.shape
    out = torch.empty((r0 - 1) * (r1 - 1) * (r2 - 1), 8 * f, dtype=out_dtype, device=table.device)
    windows = table.unfold(0, 2, 1).unfold(1, 2, 1).unfold(2, 2, 1).permute(0, 1, 2, 4, 5, 6, 3)
    out.view(r0 - 1, r1 - 1, r2 - 1, 2, 2, 2, f).copy_(windows)
    return out


def check_oct_build(dev):
    """Kernel 6 over the full-width Cobafa field's seven grids (the shapes
    every field call builds): bit-equal to the plain build and to the
    yardstick in bf16 (the field's) and f32, and timed as one roster."""
    from tinynerf_tpu_torch.models import make_model
    from tinynerf_tpu_torch.ops import octbuild

    field = make_model("cobafa", device="meta")[0]
    gen = torch.Generator(dev).manual_seed(2)
    tables = [torch.randn(p.shape, device=dev, generator=gen) for p in (*field.basis, field.coef)]
    roster = " ".join(f"{t.shape[0]}^3x{t.shape[3]}" for t in tables)
    entry = {}
    for out_dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for t in tables:
            out = octbuild.build_oct(t, out_dtype)
            if not (torch.equal(out, octbuild.build_oct_plain(t, out_dtype))
                    and torch.equal(out, oct_yardstick(t, out_dtype))):
                raise AssertionError(f"oct build ({label}) of {tuple(t.shape)} is not bit-equal to plain")
            del out
        print(f"kernel oct build {label} [{roster}]: bit-equal to the plain build and the copy_ yardstick")
        out_bytes = sum((t.shape[0] - 1) * (t.shape[1] - 1) * (t.shape[2] - 1) * 8 * t.shape[3]
                        for t in tables) * torch.empty((), dtype=out_dtype).element_size()
        entry[label] = dict(max_abs_err=0.0, **time_pair(
            f"kernel oct build {label}, the 7-grid roster",
            lambda: [octbuild.build_oct(t, out_dtype) for t in tables],
            lambda: [octbuild.build_oct_plain(t, out_dtype) for t in tables],
            bound(nbytes(*tables) + out_bytes),
            lambda: [oct_yardstick(t, out_dtype) for t in tables],
        ))
    # other channel counts (the value-by-value path, chunks across corner
    # pairs) and a grid that is not cubic
    gen_np = np.random.default_rng(7)
    for shape in ((20, 21, 22, 3), (33, 20, 17, 6), (9, 40, 25, 4), (12, 7, 30, 5)):
        t = torch.from_numpy(gen_np.normal(size=shape).astype(np.float32)).to(dev)
        for out_dtype in (torch.bfloat16, torch.float32):
            if not torch.equal(octbuild.build_oct(t, out_dtype), octbuild.build_oct_plain(t, out_dtype)):
                raise AssertionError(f"oct build ({out_dtype}) of {shape} is not bit-equal to plain")
    print("kernel oct build bf16 and f32, F = 3, 6, 4, 5 on grids that are not cubic: bit-equal to the plain build")
    for t in tables:  # the largest grid alone, bf16
        if t.shape[0] == max(field.basis_res):
            k = median_ms(lambda: octbuild.build_oct(t))
            print(f"kernel oct build bf16 {tuple(t.shape)}: call {k:.4f} ms, yardstick "
                  f"{median_ms(lambda: oct_yardstick(t, torch.bfloat16)):.4f} ms")
    # the field builds bf16 tables (models/cobafa.py); f32 rides along
    return {"oct_build": {**entry["bf16"],
                          **{f"f32_out_{k}": v for k, v in entry["f32"].items() if k != "max_abs_err"}}}


# JAX's float8_e4m3fn boundaries (tests/test_torch_gather_dtype.py): NaN
# above 464 and at +-inf, 464 itself to 448, signed zero, subnormals
FP8_BOUNDARY = (464.0, -464.0, 464.0001, -464.0001, 480.0, -480.0, float("inf"), float("-inf"), float("nan"),
                -0.0, 2.0**-10, 2.0**-9 * 1.5, 447.0, 448.0)


def quad_yardstick(table: torch.Tensor, out_dtype) -> torch.Tensor:
    """The quad table by one PyTorch call: a `copy_` of the table's 2x2
    windows (unfold; corners dx, dy with dy fastest) into the output viewed
    as [r0-1, r1-1, 2, 2, F].  The port never calls it."""
    r0, r1, f = table.shape
    out = torch.empty((r0 - 1) * (r1 - 1), 4 * f, dtype=out_dtype, device=table.device)
    out.view(r0 - 1, r1 - 1, 2, 2, f).copy_(table.unfold(0, 2, 1).unfold(1, 2, 1).permute(0, 1, 3, 4, 2))
    return out


def _bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _share(label: str, t: dict) -> None:
    """The share of the bound that a roster's device time reaches."""
    share = f"{t['bound_ms'] / t['device_ms']:.1%}" if t["device_ms"] else "not measured"
    print(f"{label}: device {_ms(t['device_ms'])} against its bound {t['bound_ms']:.4f} ms: {share}; "
          f"plain {_ms(t['plain_device_ms'])}, copy_ yardstick {_ms(t['library_device_ms'])} (device)")


def check_quad_build(dev):
    """Kernel 7 over the full-width K-Planes field's nine planes (the
    shapes every field call builds): bit-equal (as bytes) to the plain
    build, and to the yardstick in bf16 (the field's) and f32, timed as one
    roster in all three outputs; a plane viewed 4 bytes off a 16-byte
    boundary (the generic path) bit-equal as well."""
    from tinynerf_tpu_torch.models import make_model
    from tinynerf_tpu_torch.ops import octbuild

    field = make_model("kplanes", device="meta")[0]
    gen = torch.Generator(dev).manual_seed(3)
    tables = [torch.rand(p.shape, device=dev, generator=gen) for scale in field.planes for p in scale]
    roster = " ".join(f"{t.shape[0]}^2x{t.shape[2]}" for t in tables)
    entry = {}
    for out_dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for t in tables:
            out = octbuild.build_quad(t, out_dtype)
            if not (_bytes_equal(out, octbuild.build_quad_plain(t, out_dtype))
                    and _bytes_equal(out, quad_yardstick(t, out_dtype))):
                raise AssertionError(f"quad build ({label}) of {tuple(t.shape)} is not bit-equal to plain")
            del out
        print(f"kernel quad build {label} [{roster}]: bit-equal to the plain build and the copy_ yardstick")
        out_bytes = sum((t.shape[0] - 1) * (t.shape[1] - 1) * 4 * t.shape[2]
                        for t in tables) * torch.empty((), dtype=out_dtype).element_size()
        entry[label] = dict(max_abs_err=0.0, **time_pair(
            f"kernel quad build {label}, the 9-plane roster",
            lambda: [octbuild.build_quad(t, out_dtype) for t in tables],
            lambda: [octbuild.build_quad_plain(t, out_dtype) for t in tables],
            bound(nbytes(*tables) + out_bytes),
            lambda: [quad_yardstick(t, out_dtype) for t in tables],
        ))
    big = tables[-1]  # a 513^2 plane alone, bf16
    print(f"kernel quad build bf16 {tuple(big.shape)}: call {median_ms(lambda: octbuild.build_quad(big)):.4f} ms, "
          f"yardstick {median_ms(lambda: quad_yardstick(big, torch.bfloat16)):.4f} ms")
    # float8_e4m3fn (gather_dtype="float8"): the same planes with JAX's
    # float8 boundaries seeded in, held as bytes against the plain version
    # (the JAX rule written out in torch ops); the copy_ yardstick casts by
    # torch's saturating rule, so it is timed, not compared
    fp8 = torch.float8_e4m3fn
    seeded = []
    for t in tables:
        t = t.clone()
        vals = torch.tensor(FP8_BOUNDARY, device=dev).repeat(64)
        t.view(-1)[(torch.arange(vals.numel(), device=dev) * 7919) % t.numel()] = vals
        seeded.append(t)
    n_nan = 0
    for t in seeded:
        out = octbuild.build_quad(t, fp8).view(torch.uint8)
        if not torch.equal(out, octbuild.build_quad_plain(t, fp8).view(torch.uint8)):
            raise AssertionError(f"quad build (float8) of {tuple(t.shape)} is not byte-equal to plain")
        n_nan += int(((out & 0x7F) == 0x7F).sum())
        del out
    if n_nan == 0:
        raise AssertionError("the seeded float8 boundaries gave no NaN code")
    for shape in ((9, 17, 3), (17, 9, 6), (6, 7, 12)):  # F != 32: the generic path
        t = torch.randn(shape, device=dev, generator=gen) * 300.0
        if not torch.equal(octbuild.build_quad(t, fp8).view(torch.uint8),
                           octbuild.build_quad_plain(t, fp8).view(torch.uint8)):
            raise AssertionError(f"quad build (float8) of {shape} is not byte-equal to plain")
    print(f"kernel quad build float8 [{roster}], tables seeded with {len(FP8_BOUNDARY)} boundary values x 64: "
          f"byte-equal to the plain build ({n_nan} NaN codes)")
    # a 257^2 plane read from a buffer's second value: off 16 bytes, the
    # generic path (float8 on the seeded plane)
    r0, r1, f = tables[4].shape
    off = torch.empty(1 + tables[4].numel(), device=dev)[1:].view(r0, r1, f)
    if octbuild.quad_vector_loads(off):
        raise AssertionError("a table 4 bytes off a 16-byte boundary was given the vector path")
    for out_dtype, src in ((torch.bfloat16, tables[4]), (torch.float32, tables[4]), (fp8, seeded[4])):
        off.copy_(src)
        if not _bytes_equal(octbuild.build_quad(off, out_dtype), octbuild.build_quad_plain(off, out_dtype)):
            raise AssertionError(f"quad build ({out_dtype}) of a table off 16 bytes is not bit-equal to plain")
    print(f"kernel quad build bf16, f32, float8 of a {r0}^2x{f} plane 4 bytes off 16 (the generic path): "
          f"bit-equal to the plain build")
    out_bytes = sum((t.shape[0] - 1) * (t.shape[1] - 1) * 4 * t.shape[2] for t in tables)
    entry["fp8"] = dict(max_abs_err=0.0, **time_pair(
        "kernel quad build float8, the 9-plane roster",
        lambda: [octbuild.build_quad(t, fp8) for t in seeded],
        lambda: [octbuild.build_quad_plain(t, fp8) for t in seeded],
        bound(nbytes(*seeded) + out_bytes),
        lambda: [quad_yardstick(t, fp8) for t in seeded],
    ))
    for label in ("bf16", "f32", "fp8"):
        _share(f"kernel quad build {label}, the 9-plane roster", entry[label])
    # the field builds bf16 tables by default (models/kplanes.py); f32 rides along
    return {"quad_build": {**entry["bf16"],
                           **{f"f32_out_{k}": v for k, v in entry["f32"].items() if k != "max_abs_err"}},
            "quad_build_fp8": entry["fp8"]}


def _check_march(label: str, kernel, plain, pool, gen, seed, n_steps: int, march_args, round_flops: int,
                 batch: int) -> dict:
    """A skip march kernel against its plain version on rays drawn from
    `pool`: a serving chunk (`batch` rays, timed without jitter) and a
    training bucket (SKIP_BUCKET x `batch` rays, timed with jitter), each
    with and without jitter, k_idx and complete equal.  `march_args(o, d)`
    gives the arguments before the jitter words; each timing's bound counts
    the rays read, k_idx and complete written, and per active round one
    grid value and `round_flops` f32 operations (the work these inputs
    need), and each records its longest chain of dependent gathers (the
    fewest rounds in which every ray completes, or all of them if a ray
    never does; the march is a prefix of itself with more rounds).
    Returns the serving record with the bucket's beside it."""
    perm = torch.randperm(pool.n_rays, device=pool.rays_o.device, generator=gen)

    def longest_chain(head, j) -> int:
        lo, hi = 1, n_steps
        if not bool(kernel(*head, j, hi)[1].all()):
            return n_steps
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if bool(kernel(*head, j, mid)[1].all()) else (mid + 1, hi)
        return lo

    out = {}
    for part, n_rays, jitter in (("serving", batch, None), ("training", SKIP_BUCKET * batch, seed)):
        o, d = pool.rays_o[perm[:n_rays]].contiguous(), pool.rays_d[perm[:n_rays]].contiguous()
        head = march_args(o, d)
        args = lambda j: (*head, j, n_steps)
        rounds = {}
        for j in (None, seed):
            k, c = kernel(*args(j))
            k_ref, c_ref, rounds[j is not None] = plain(*args(j), count_rounds=True)
            if not (torch.equal(k, k_ref) and torch.equal(c, c_ref)):
                raise AssertionError(f"{label} ({part}, jitter {j is not None}) differs from plain")
            print(f"kernel {label} {part} [{n_rays} rays x {n_steps} rounds], jitter {j is not None}: "
                  f"k_idx and complete equal to plain; {int((k >= 0).sum())} samples emitted, "
                  f"{int(c.sum())} rays complete, {rounds[j is not None]} active rounds")
        timed_rounds = rounds[jitter is not None]
        # the per-ray inputs (the grid, 3-D or more, is read per round)
        per_ray = [t for t in head if isinstance(t, torch.Tensor) and t.dim() < 3]
        n_bytes = nbytes(*per_ray) + 4 * n_rays * n_steps + n_rays + 4 * timed_rounds
        out[part] = time_pair(
            f"kernel {label} {part} [{n_rays} x {n_steps}]", lambda: kernel(*args(jitter)),
            lambda: plain(*args(jitter)), bound(n_bytes, round_flops * timed_rounds))
        out[part]["active_rounds"] = timed_rounds
        out[part]["longest_rounds"] = longest_chain(head, jitter)
    # the serving chunk is the main record (313 launches per 800x800 view);
    # the training bucket rides along
    return {"max_abs_err": 0.0, **out["serving"], **{f"train_bucket_{k}": v for k, v in out["training"].items()}}


def check_skip_march(dev):
    """The skip march on the shell occupancy's skip grid (the smoke's
    serving state), with rays drawn over a generated 800x800 view, 64
    rounds; and the skip grid's build."""
    from tinynerf_tpu_torch.core import skipmarch
    from tinynerf_tpu_torch.data import RayPool
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer
    from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_data

    cfg = TrainConfig()
    renderer = build_renderer(cfg, 1.0, None, device="meta")
    marcher, occupancy, aabb = renderer.marcher, renderer.occupancy, renderer.contraction.aabb
    occ = make_shell_occupancy(occupancy, device=dev)
    grid_ms = median_ms(lambda: renderer.skip_grid(occ), runs=5)
    grid = renderer.skip_grid(occ)
    print(f"skip grid {tuple(grid.shape)} from the {occupancy.size[0]}^3 shell occupancy: "
          f"{grid_ms:.3f} ms (median of 5, CUDA events; plain PyTorch)")

    def march_args(o, d):
        t_min, t_exit = marcher.entry_exit(o, d)
        return o, d, t_min, t_exit, marcher.step_size, marcher.n_samples, aabb, grid

    rec = _check_march("skip march", skipmarch.skip_march, skipmarch.skip_march_plain,
                       RayPool(make_spheres_data(n_views=1, res=800, seed=0), device=dev),
                       torch.Generator(dev).manual_seed(4),
                       torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64, device=dev),
                       renderer.skip_steps, march_args, SKIP_ROUND_FLOPS, cfg.batch_size)
    return {"skip_march": {**rec, "skip_grid_ms": grid_ms}}


def check_skip_march_unbounded(dev, ns_root) -> dict:
    """The unbounded skip march on the iso grid of the shell occupancy, with
    rays drawn over the nerfstudio capture's training views (cameras on the
    spheres' ring, so rays cross the core and the far field), 96 rounds;
    and the iso grid's build."""
    from tinynerf_tpu_torch.core import skipmarch
    from tinynerf_tpu_torch.data import RayPool, parse_nerfstudio
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer
    from tinynerf_tpu_torch.utils import make_shell_occupancy

    cfg = TrainConfig(scene_type="unbounded")
    pool = RayPool(parse_nerfstudio(ns_root, "train"), device=dev)
    renderer = build_renderer(cfg, pool.scene_scale, None, device="meta")
    marcher, contraction, occupancy = renderer.marcher, renderer.contraction, renderer.occupancy
    occ = make_shell_occupancy(occupancy, device=dev)
    grid_ms = median_ms(lambda: renderer.skip_grid(occ), runs=5)
    grid = renderer.skip_grid(occ)
    print(f"iso skip grid {tuple(grid.shape)} from the {occupancy.size[0]}^3 shell occupancy: "
          f"{grid_ms:.3f} ms (median of 5, CUDA events; plain PyTorch); disparity grid over "
          f"{marcher.uniform_range:.4f} (the training views' scene scale)")
    rec = _check_march("skip march unbounded", skipmarch.skip_march_unbounded,
                       skipmarch.skip_march_unbounded_plain, pool, torch.Generator(dev).manual_seed(8),
                       torch.tensor([0x2345678, 0x9ABCDEF], dtype=torch.int64, device=dev),
                       renderer.skip_steps, lambda o, d: (o, d, marcher, contraction, grid),
                       UNBOUNDED_ROUND_FLOPS, cfg.batch_size)
    return {"skip_march_unbounded": {**rec, "skip_grid_ms": grid_ms}}


def write_nerfstudio_scene(root, n_frames: int = 9, res: int = 800):
    """A nerfstudio capture of `n_frames` generated 800x800 spheres views,
    as tests/conftest.py builds one: the Blender-synthetic writer, then one
    `transforms.json` with global intrinsics (the 8th-frame holdout leaves
    7 frames to train on and 2 to render)."""
    from pathlib import Path

    from tinynerf_tpu_torch.utils import make_synthetic_scene

    root = Path(root)
    make_synthetic_scene(root, n_train=n_frames, n_test=0, res=res, kind="spheres")
    meta = json.loads((root / "transforms_train.json").read_text())
    focal = res / (2.0 * np.tan(0.5 * meta["camera_angle_x"]))
    frames = [{"file_path": fr["file_path"].lstrip("./") + ".png", "transform_matrix": fr["transform_matrix"]}
              for fr in meta["frames"]]
    (root / "transforms.json").write_text(json.dumps(
        {"fl_x": focal, "fl_y": focal, "cx": res / 2.0, "cy": res / 2.0, "w": res, "h": res, "frames": frames}))
    return root


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0 (`ops/cuda_lib.py`'s
    counters, by the keys of the kernels record)."""
    from tinynerf_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.zero_launch_counts()


def read_counts(label: str, required) -> dict:
    """The launches since `zero_counts`; raise if a kernel of `required`
    was not launched."""
    from tinynerf_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    counts = cuda_lib.launch_counts()
    print(f"{label} launches: {counts}")
    for name in required:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by {label}")
    return counts


def _field_label(field) -> str:
    if hasattr(field, "resolutions"):
        return f"K-Planes resolutions {field.resolutions}"
    if hasattr(field, "basis_res"):
        return (f"Cobafa basis grids {field.basis_res} x channels {field.channels}, coefficients "
                f"{field.coef_res}^3 x {len(field.basis_res)}, field MLP 36 -> {field.mlp_hidden_dim} x 6")
    return f"vanilla posenc(10) -> {field.feature_dim} x 10 layers (He init)"


# the kernels each driven path must launch, by (method, scene type): the
# field's table build (the quad build for K-Planes, the oct build for
# Cobafa, none for the vanilla MLP) and the marcher's skip march
FIELD_KERNELS = {"vanilla": (), "kplanes": ("quad_build",), "cobafa": ("oct_build",)}
SKIP_KERNEL = {"aabb": "skip_march", "unbounded": "skip_march_unbounded"}
TRAINING_KERNELS = {"vanilla": ("segscan", "segscan_bwd", "segment_sum"),
                    "kplanes": ("segscan", "segscan_bwd", "segment_sum", "sort", "accumulate", "quad_build"),
                    "cobafa": ("segscan", "segscan_bwd", "segment_sum", "sort", "sort_pairs", "accumulate",
                               "oct_build")}


def serving_kernels(method: str, scene_type: str) -> tuple:
    return ("segscan", "segment_sum", "weights_dense", SKIP_KERNEL[scene_type]) + FIELD_KERNELS[method]


def march_kernels(method: str, scene_type: str, march: str) -> tuple:
    """A packed `infer` on the dense or the skip march."""
    return (("segscan", "segment_sum") + FIELD_KERNELS[method]
            + ((SKIP_KERNEL[scene_type],) if march == "skip" else ()))


def skip_step_kernels(method: str, scene_type: str) -> tuple:
    return TRAINING_KERNELS[method] + (SKIP_KERNEL[scene_type],)


CHUNK_KERNELS = {m: ("weights_dense", "weights_dense_bwd") + k for m, k in FIELD_KERNELS.items()}


def skip_and_dense_steps(renderer, pool, cfg, card: str, name: str) -> dict:
    """Behind the shell occupancy at bucket SKIP_BUCKET (131,072 rays drawn
    over the views), deterministic steps (no jitter, no dropout) through the
    dense march, the skip march with an n_samples-round budget (no ray cut:
    the same sample set, so the loss must agree) and the skip march at the
    default budget (rays that run out leave the loss).  Each is timed as
    the median of 3 synchronized calls from the same parameters and a fresh
    optimizer; the trained parameters are restored after."""
    from tinynerf_tpu_torch.train import make_optimizer, make_train_step
    from tinynerf_tpu_torch.utils import make_shell_occupancy

    n_cand = SKIP_BUCKET * cfg.batch_size
    occ = make_shell_occupancy(renderer.occupancy, device="cuda")
    grid = renderer.skip_grid(occ)
    gen = torch.Generator("cuda").manual_seed(5)
    rays = torch.randperm(pool.n_rays, device="cuda", generator=gen)[:n_cand]
    batch = tuple(a[rays].contiguous() for a in pool.arrays())
    start = [p.detach().clone() for p in renderer.parameters()]
    budget = renderer.skip_steps
    res = {}
    zero_counts()
    for label, march, rounds in (("dense", "dense", budget), (f"skip {cfg.n_samples} rounds", "skip", cfg.n_samples),
                                 (f"skip {budget} rounds", "skip", budget)):
        renderer.skip_steps = rounds
        step = make_train_step(renderer, make_optimizer(cfg, renderer), cfg, n_cand, deterministic=True,
                               march=march)
        times = []
        for _ in range(3):
            with torch.no_grad():
                for p, p0 in zip(renderer.parameters(), start):
                    p.copy_(p0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(occ, *((grid,) if march == "skip" else ()), *batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[label] = dict(loss=float(m["loss"]), ms=float(np.median(times)) * 1e3,
                          complete=round(float(m["complete_frac"]) * n_cand), fill=float(m["fill"]))
        print(f"{name} step, shell occupancy, bucket {SKIP_BUCKET} ({n_cand} rays), {label}: "
              f"{res[label]['ms']:.2f} ms (median of 3, host clock, synchronized), "
              f"{n_cand / res[label]['ms'] * 1e3:,.0f} candidate rays/s, loss {res[label]['loss']:.7f}, "
              f"fill {res[label]['fill']:.4f}, {res[label]['complete']} rays complete "
              f"({res[label]['complete'] / n_cand:.4f}) [{card}]")
    renderer.skip_steps = budget
    with torch.no_grad():
        for p, p0 in zip(renderer.parameters(), start):
            p.copy_(p0)
    counts = read_counts(f"{name} dense and skip steps", skip_step_kernels(cfg.method, cfg.scene_type))
    dense, full = res["dense"], res[f"skip {cfg.n_samples} rounds"]
    err = abs(full["loss"] - dense["loss"]) / abs(dense["loss"])
    print(f"{name} skip ({cfg.n_samples} rounds) vs dense step loss: relative difference {err:.3e} "
          f"(tol {SKIP_DENSE_LOSS_RTOL:g})")
    if not (err <= SKIP_DENSE_LOSS_RTOL and full["complete"] == n_cand and dense["fill"] > 0):
        raise AssertionError(f"{name}: the skip and dense steps disagree")
    if not np.isfinite(res[f"skip {budget} rounds"]["loss"]):
        raise AssertionError(f"{name}: the skip step at the default budget is not finite")
    return counts


def remat_check(renderer, pool, cfg, card: str, name: str) -> dict:
    """One deterministic step (2048 rays drawn over the views, the
    all-occupied grid, f32 compute) with remat_field against one without,
    from the same parameters: the loss to REMAT_LOSS_RTOL and every gradient
    leaf to REMAT_GRAD_RTOL_OF_MAX of its max; each step's peak memory."""
    from tinynerf_tpu_torch.convert import tree_leaves_with_path
    from tinynerf_tpu_torch.train import make_optimizer, make_train_step

    renderer.compute_dtype = torch.float32
    gen = torch.Generator("cuda").manual_seed(7)
    rays = torch.randperm(pool.n_rays, device="cuda", generator=gen)[:cfg.batch_size]
    batch = tuple(a[rays].contiguous() for a in pool.arrays())
    occ = renderer.occupancy.init_state("cuda")
    start = [p.detach().clone() for p in renderer.parameters()]
    res = {}
    zero_counts()
    for remat in (False, True):
        with torch.no_grad():
            for p, p0 in zip(renderer.parameters(), start):
                p.copy_(p0)
        renderer.remat_field = remat
        step = make_train_step(renderer, make_optimizer(cfg, renderer), cfg, cfg.batch_size, deterministic=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(occ, *batch)
        torch.cuda.synchronize()
        res[remat] = dict(loss=float(m["loss"]), ms=(time.perf_counter() - t0) * 1e3,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          grads=[g.detach().clone() for _, g in tree_leaves_with_path(m["grads"])])
    renderer.remat_field = False
    with torch.no_grad():
        for p, p0 in zip(renderer.parameters(), start):
            p.copy_(p0)
    counts = read_counts(f"{name} remat and plain steps", TRAINING_KERNELS[cfg.method])
    err_loss = abs(res[True]["loss"] - res[False]["loss"]) / abs(res[False]["loss"])
    err_grad = max(_rel_err(a, b) for a, b in zip(res[True]["grads"], res[False]["grads"]))
    n_zero = sum(int(float(g.abs().max()) == 0.0) for g in res[False]["grads"])
    print(f"{name} deterministic step [{cfg.batch_size} rays x {cfg.n_samples}] f32, remat_field on vs off: "
          f"loss relative difference {err_loss:.3e} (tol {REMAT_LOSS_RTOL:g}), gradients max|diff| / max "
          f"{err_grad:.3e} (tol {REMAT_GRAD_RTOL_OF_MAX:g}), {n_zero} of {len(res[False]['grads'])} leaves zero; "
          f"off {res[False]['ms']:.2f} ms, peak {res[False]['peak_gb']:.2f} GB; on {res[True]['ms']:.2f} ms, "
          f"peak {res[True]['peak_gb']:.2f} GB (one cold step each, host clock) [{card}]")
    if n_zero or not (err_loss <= REMAT_LOSS_RTOL and err_grad <= REMAT_GRAD_RTOL_OF_MAX):
        raise AssertionError(f"{name}: the steps with and without remat_field disagree")
    return counts


def chunk_check(renderer, occ_state, pool, cfg, name: str, method: str) -> dict:
    """One full-width dense chunk's gradients through the kernels against a
    reference pass through a plain version: K-Planes swaps in the plain
    dense weights (kernel 3's check), Cobafa the plain oct build (kernel
    6's), each inside this script."""
    from tinynerf_tpu_torch.core import renderer as renderer_module
    from tinynerf_tpu_torch.ops import interp, octbuild, weights, weights_dense

    # one full-width dense chunk, f32 compute: d loss / d sigma, kept by a
    # hook on the sigma decoder, and every parameter's gradient
    renderer.compute_dtype = torch.float32
    gen = torch.Generator("cuda").manual_seed(0)
    # rays drawn over all views (an image's first rows may miss the scene)
    rays = torch.randperm(pool.n_rays, device="cuda", generator=gen)[:cfg.batch_size]
    o, d = pool.rays_o[rays], pool.rays_d[rays]
    cot = torch.randn(cfg.batch_size, 3, device="cuda", generator=gen)
    sigma_out = {}

    def keep_sigma(module, args, y):
        y.retain_grad()
        sigma_out["y"] = y

    hook = renderer.sigma_decoder.register_forward_hook(keep_sigma)
    grads, dsigma, launches = {}, {}, None
    for impl in ("kernel", "plain"):
        renderer.zero_grad(set_to_none=True)
        if impl == "plain" and method == "kplanes":
            renderer_module.compute_weights_dense = weights.compute_weights
        elif impl == "plain":
            interp.build_oct = octbuild.build_oct_plain
        zero_counts()
        try:
            res = renderer.render_dense(occ_state, o, d)
            (res.rgb * cot).sum().backward()
        finally:
            renderer_module.compute_weights_dense = weights_dense.compute_weights_dense
            interp.build_oct = octbuild.build_oct
        if impl == "kernel":
            launches = read_counts(f"{name} dense chunk", CHUNK_KERNELS[method])
        grads[impl] = {k: p.grad.detach().clone() for k, p in renderer.named_parameters()}
        dsigma[impl] = sigma_out["y"].grad.detach().clone()
    hook.remove()
    torch.cuda.synchronize()
    n_valid = int(res.n_samples)
    n_zero = sum(int(float(g.abs().max()) == 0.0) for g in grads["plain"].values())
    err_sigma = _rel_err(dsigma["kernel"], dsigma["plain"])
    errs = {k: _rel_err(grads["kernel"][k], grads["plain"][k]) for k in grads["plain"]}
    err_field = max(e for k, e in errs.items() if k.startswith("field."))
    err_dec = max(e for k, e in errs.items() if not k.startswith("field."))
    if method == "kplanes":
        # the plane tables' gradient passes the bf16 payload (see the limits)
        limits = (GRAD_RTOL_OF_MAX, CHUNK_GRAD_RTOL_OF_MAX, CHUNK_TABLE_GRAD_RTOL_OF_MAX)
    else:
        limits = (COBAFA_CHUNK_GRAD_RTOL_OF_MAX,) * 3
    print(f"{name} dense chunk [{cfg.batch_size} x {cfg.n_samples}] f32, {n_valid} valid samples, "
          f"kernels vs plain, max|diff| / max|plain|: d loss/d sigma {err_sigma:.3e} (tol {limits[0]:g}); "
          f"decoder leaves {err_dec:.3e} (tol {limits[1]:g}); field leaves {err_field:.3e} "
          f"(tol {limits[2]:g}); {n_zero} of {len(errs)} leaves with a zero gradient")
    if n_valid == 0 or n_zero or not float(dsigma["plain"].abs().max()) > 0.0:
        raise AssertionError(f"the {name} dense chunk's check is empty: no valid samples or zero gradients")
    if not (err_sigma <= limits[0] and err_dec <= limits[1] and err_field <= limits[2]):
        raise AssertionError(f"{name} dense chunk gradients disagree")
    return launches


def run_training(tmp: str, card: str, method: str, scene_type: str = "aabb", pool=None) -> dict:
    """Phases 4 (K-Planes), 6 (Cobafa), 8 (vanilla) and 10 (K-Planes,
    unbounded): `train()` at full width on `pool` (default: four generated
    800x800 views), the launch counts inside it, the dense and skip steps
    at bucket 64; then the dense chunk's gradients against a plain version
    (the table fields) or the remat check (vanilla)."""
    from tinynerf_tpu_torch.data import RayPool
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer, train
    from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_data

    name = f"{method} {scene_type} training"
    cfg = TrainConfig(method=method, scene_type=scene_type, output=tmp, steps=TRAIN_STEPS, seed=0)
    if pool is None:
        pool = RayPool(make_spheres_data(n_views=4, res=800, seed=1), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = train(cfg, pool, device="cuda")
    launches = {"train": read_counts(f"{name} train()", TRAINING_KERNELS[method])}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = np.array([m.loss for m in out["train_metrics"]])
    if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
        raise AssertionError(f"{name} losses: shape {losses.shape} or non-finite values")
    first, last = losses[:8].mean(), losses[-8:].mean()
    print(f"{name} loss: first 8 steps {first:.5f}, last 8 steps {last:.5f} "
          f"(every 8th: {np.round(losses[::8], 5).tolist()})")
    if not last < first:
        raise AssertionError(f"the {name} loss did not fall")
    occ = [m.occupancy for m in out["train_metrics"]]
    print(f"{name} occupancy after the updates at steps 0 and 32: {occ[0]:.4f}, {occ[-1]:.4f}")
    ms = out["elapsed_s"] / TRAIN_STEPS * 1e3
    print(f"{name}: {ms:.2f} ms/step over {TRAIN_STEPS} steps (occupancy updates and host syncs "
          f"included), {out['rays_per_sec_per_chip']:,.0f} rays/s used by the loss, "
          f"peak device memory {peak_gb:.2f} GB, {pool.n_rays} rays in the pool [{card}]")

    renderer = out["renderer"]
    launches["skip_steps"] = skip_and_dense_steps(renderer, pool, cfg, card, name)
    if method == "vanilla":
        launches["remat"] = remat_check(renderer, pool, cfg, card, name)
    elif scene_type == "unbounded":
        # 64 steps from random parameters saturate the unbounded field (the
        # first samples opaque, the colors' sigmoid at 1: every gradient of
        # the chunk exactly 0), so its chunk starts from the seeded
        # parameters the run started from, behind the shell occupancy: the
        # dense backward's closed form takes total(w g) - incl(w g) in f32,
        # and the far field's deltas (hundreds of units) scale that
        # difference's rounding, summed in another order by the kernel and
        # by the plain version, to ~1e-3 of the largest gradient
        fresh = build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cuda",
                               generator=torch.Generator().manual_seed(cfg.seed))
        launches["chunk"] = chunk_check(fresh, make_shell_occupancy(fresh.occupancy, device="cuda"), pool,
                                        cfg, f"{name} (seeded parameters, shell occupancy)", method)
    else:
        launches["chunk"] = chunk_check(renderer, out["occ_state"], pool, cfg, name, method)
    del out, renderer
    torch.cuda.empty_cache()
    return launches


def run_slice(tmp: str, card: str, method: str, scene_type: str = "aabb", pose_set=None) -> dict:
    """Phases 3 (K-Planes, two views), 5 (Cobafa, one view), 7 (vanilla,
    one view) and 9 (K-Planes, unbounded, the nerfstudio test split's two
    views): serving at full width from a checkpoint of seeded random
    parameters behind the shell occupancy."""
    from tinynerf_tpu_torch.convert import occ_state_to_numpy, params_to_numpy
    from tinynerf_tpu_torch.data import PoseSet
    from tinynerf_tpu_torch.train import (
        InferStats, TrainConfig, build_renderer, infer, make_render_chunk, make_render_chunk_packed,
        render_only, save_checkpoint,
    )
    from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_pose_set

    name = f"{method} {scene_type} serving"
    if pose_set is None:
        pose_set = make_spheres_pose_set(n_views=2 if method == "kplanes" else 1, res=800, seed=0)

    def view0():
        # view 0 alone, on the marcher of the whole set (an unbounded
        # marcher spans its grid over the poses' scene scale)
        one = PoseSet(dataclasses.replace(pose_set._data, cameras=pose_set._data.cameras[:1],
                                          imgs=pose_set._data.imgs[:1]))
        one.scene_scale = pose_set.scene_scale
        return one

    cfg = TrainConfig(method=method, scene_type=scene_type, output=tmp)
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
    print(f"{name}: {_field_label(renderer.field)}, {n_params} params "
          f"({n_params * 4 / 1e6:.1f} MB f32), compute {cfg.compute_dtype}, "
          f"{cfg.n_samples} samples/ray, chunk {cfg.batch_size}, "
          f"packed cap {cfg.batch_size * cfg.eval_samples_per_ray}, skip march {renderer.skip_steps} rounds, "
          f"{len(pose_set)} views, scene scale {pose_set.scene_scale:.4f}")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    packed = InferStats()
    m_packed = render_only(cfg, pose_set, stats=packed)
    dense = InferStats()
    m_dense = render_only(dataclasses.replace(cfg, eval_render="dense"), view0(), name="render_dense", stats=dense)
    launches = {"serve": read_counts(f"{name} render_only", serving_kernels(method, scene_type))}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # view 0 once more, packed on the dense march, then on the skip march
    # again: both warm, so their times compare (render_only's first view
    # pays the warm-up)
    cap = cfg.batch_size * cfg.eval_samples_per_ray
    rerun = {}
    for march, grid_args in (("dense", ()), ("skip", (renderer.skip_grid(occ),))):
        zero_counts()
        rerun[march] = InferStats()
        infer(renderer, occ, view0(), [0], tmp, f"render_{march}_march", chunk=cfg.batch_size,
              render_chunk_fn=make_render_chunk(renderer),
              packed_fn=make_render_chunk_packed(renderer, cap, march=march), stats=rerun[march],
              grid_args=grid_args)
        launches[f"serve_{march}_march"] = read_counts(
            f"{name} {march}-march packed infer", march_kernels(method, scene_type, march))
    dense_march, skip_warm = rerun["dense"], rerun["skip"]
    del renderer

    for label, st, metrics in (("packed", packed, m_packed), ("dense", dense, m_dense)):
        for i, (img, sec, rays, m) in enumerate(zip(st.images, st.seconds, st.rays, metrics)):
            if img.shape != (800, 800, 3) or not np.isfinite(img).all():
                raise AssertionError(f"{name} {label} view {i}: shape {img.shape} or non-finite values")
            if not (np.isfinite(m.psnr) and -1.0 <= m.ssim <= 1.0):
                raise AssertionError(f"{name} {label} view {i}: bad metrics {m}")
            print(f"{name} {label} view {i}: {sec:.3f} s, {rays / sec:,.0f} rays/s, "
                  f"psnr {m.psnr:.3f}, ssim {m.ssim:.4f} (random weights) [{card}]")
    n_rays = sum(packed.rays)
    print(f"{name} packed (skip march): {packed.packed_samples} packed samples, "
          f"{packed.fallback_rays} rays re-rendered densely, {packed.incomplete_rays} of them out of "
          f"skip-march rounds (complete fraction {1 - packed.incomplete_rays / n_rays:.4f} of {n_rays} rays); "
          f"skip grid built in {packed.skip_grid_seconds * 1e3:.3f} ms; peak device memory of the renders "
          f"{peak_gb:.2f} GB [{card}]")
    print(f"{name} view 0, s/image: packed with the skip march {packed.seconds[0]:.3f} (render_only, "
          f"first view), then warm: packed with the dense march {dense_march.seconds[0]:.3f} "
          f"({dense_march.fallback_rays} rays re-rendered densely), packed with the skip march "
          f"{skip_warm.seconds[0]:.3f} ({skip_warm.fallback_rays} rays re-rendered densely); dense "
          f"{dense.seconds[0]:.3f} [{card}]")
    for label, a, b in (("skip-packed vs dense", packed, dense), ("dense-march-packed vs dense", dense_march, dense),
                        ("skip-packed vs dense-march-packed", packed, dense_march),
                        ("warm skip-packed vs dense-march-packed", skip_warm, dense_march)):
        diff = np.abs(a.images[0] - b.images[0])
        print(f"{name} {label} view 0: max abs {diff.max():.3e} (tol {PACKED_DENSE_MAX_ABS:g}), "
              f"mean abs {diff.mean():.3e} (tol {PACKED_DENSE_MEAN_ABS:g})")
        if not (diff.max() <= PACKED_DENSE_MAX_ABS and diff.mean() <= PACKED_DENSE_MEAN_ABS):
            raise AssertionError(f"{name}: {label} renders of view 0 disagree")

    # small view at f32: kernels on the card vs plain versions on the CPU
    small = make_spheres_pose_set(n_views=1, res=32, seed=0)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    imgs = {}
    for device in ("cuda", "cpu"):
        st = InferStats()
        render_only(cfg32, small, name=f"small_{device}", device=device, stats=st)
        imgs[device] = np.stack(st.images)
    e = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
    print(f"{name} 32x32 f32 view, card kernels vs CPU plain: max abs {e:.3e} (tol {SMALL_VIEW_ATOL:g})")
    if not e <= SMALL_VIEW_ATOL:
        raise AssertionError(f"{name}: card and CPU renders of the small view disagree")
    return launches


# phase 11, data parallelism on the one card: the group's deterministic step
# against the ungrouped one on the same global batch (f32 compute).  Two
# gloo ranks: tests/test_zero.py:234-256's limits (loss 1e-5 relative;
# gradients and updated parameters rtol 1e-4, atol 1e-6); one NCCL rank:
# the loss 1e-6 relative and each gradient leaf at 1e-5 of its max, with
# the training default bf16 table-gradient payload and with the f32 one,
# and with the bf16 payload the gradients and parameters at the limits
# above as well (the step repeats itself bit for bit, so a bf16 rounding of
# a sample's cotangent no longer goes either way between two runs).  Adam's
# first step moves a parameter by lr * a / (|a| + eps), a the gradient with
# its weight decay term: about lr times the sign of a however small a is,
# and in proportion to a where |a| nears eps = 1e-15.  Where the two steps'
# gradients, equal within the gradient limits, differ in sign (a sum of
# terms that nearly cancel, taken in another order) or lie near eps, the
# parameters may differ by up to 2 lr.  So a parameter is held to the
# limits plus the difference Adam's map makes of the two gradients it was
# given, lr * |a1 / (|a1| + eps) - a2 / (|a2| + eps)|, which is 0 to f32
# rounding wherever |a| >> eps; those the limits alone would fail are counted
DP_LOSS_RTOL, DP_RTOL, DP_ATOL = 1e-5, 1e-4, 1e-6
NCCL_LOSS_RTOL, NCCL_GRAD_RTOL_OF_MAX = 1e-6, 1e-5
DP_VARIANTS = {"replicated": {}, "shard_tables": dict(shard_tables=True),
               "shard_tables + shard_bwd": dict(shard_tables=True, shard_bwd=True)}
DP_TRAIN_STEPS, NCCL_TRAIN_STEPS = 16, 4
# the launches of each rank's K-Planes train() step at least: kernels 1
# (forward and backward), the per-ray sum, 4 and 5 once, 7 once per plane (9)
DP_STEP_LAUNCHES = {"segscan": 1, "segscan_bwd": 1, "segment_sum": 1, "sort": 1, "accumulate": 1,
                    "quad_build": 9}
# sharded serving (render_only over one NCCL rank) against render_only alone
DP_SERVE_ATOL = 1e-5


def _check_train_launches(label: str, counts: dict, steps: int) -> None:
    for name, per_step in DP_STEP_LAUNCHES.items():
        if counts[name] < per_step * steps:
            raise AssertionError(f"{label}: kernel {name} launched {counts[name]} times in {steps} train() "
                                 f"steps, fewer than {per_step} per step")


def _dp_world(tmp: str):
    """Full-width K-Planes at f32 compute, four generated 800x800 views on
    the card, and the 2048-ray global batch drawn over them."""
    from tinynerf_tpu_torch.data import RayPool
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer
    from tinynerf_tpu_torch.utils import make_spheres_data

    cfg = TrainConfig(method="kplanes", output=tmp, steps=DP_TRAIN_STEPS, seed=0, compute_dtype="float32")
    pool = RayPool(make_spheres_data(n_views=4, res=800, seed=1), device="cuda")
    gen = torch.Generator("cuda").manual_seed(7)
    rays = torch.randperm(pool.n_rays, device="cuda", generator=gen)[:cfg.batch_size]
    batch = tuple(a[rays].contiguous() for a in pool.arrays())
    renderer = build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cuda")
    return cfg, pool, batch, renderer


def _dp_step(renderer, cfg, batch, start, group=None) -> dict:
    """One deterministic step from the parameters `start`: its loss, its
    gradients and the updated parameters (JAX layout order), and without a
    group the parameters before it."""
    from tinynerf_tpu_torch.convert import tree_leaves_with_path
    from tinynerf_tpu_torch.parallel import shard_rays
    from tinynerf_tpu_torch.train import make_optimizer, make_train_step

    with torch.no_grad():
        for p, p0 in zip(renderer.parameters(), start):
            p.copy_(p0)
    opt = make_optimizer(cfg, renderer, group)
    before = [p.detach().clone() for p in opt.params] if group is None else None
    decay = dict(decay=opt.decay, weight_decay=opt.weight_decay)
    step = make_train_step(renderer, opt, cfg, cfg.batch_size, deterministic=True, group=group)
    rays = shard_rays(group, *batch) if group is not None else batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(renderer.occupancy.init_state("cuda"), *rays)
    torch.cuda.synchronize()
    return dict(loss=float(m["loss"]), ms=(time.perf_counter() - t0) * 1e3,
                paths=[path for path, _ in tree_leaves_with_path(m["grads"])],
                grads=[g.detach().clone() for _, g in tree_leaves_with_path(m["grads"])],
                params=[p.detach().clone() for p in opt.params], before=before, **decay)


def _dp_compare(ours: dict, ref: dict, lr: float, eps: float) -> dict:
    """Loss and every gradient against the reference step at DP_RTOL /
    DP_ATOL, and every updated parameter at those limits plus the difference
    Adam's map makes of the two steps' gradients (see DP_RTOL): the worst
    excess over the bound (<= 0 passes), the elements over it, and the
    parameters over the plain limits, with the largest difference in lr."""
    def adam_dir(g, p0, decayed):
        a = g + ref["weight_decay"] * p0 if decayed else g
        return a / (a.abs() + eps)

    g_worst, g_over, p_worst, p_over, p_adam, adam_lr = -np.inf, 0, -np.inf, 0, 0, 0.0
    for go, gr in zip(ours["grads"], ref["grads"]):
        e = (go - gr).abs() - (DP_ATOL + DP_RTOL * gr.abs())
        g_worst, g_over = max(g_worst, float(e.max())), g_over + int((e > 0).sum())
    for x, y, go, gr, p0, dec in zip(ours["params"], ref["params"], ours["grads"], ref["grads"], ref["before"],
                                     ref["decay"]):
        plain = (x - y).abs() - (DP_ATOL + DP_RTOL * y.abs())
        adam = lr * (adam_dir(go, p0, dec) - adam_dir(gr, p0, dec)).abs()
        e = plain - adam * (1.0 + 1e-3)
        p_worst, p_over = max(p_worst, float(e.max())), p_over + int((e > 0).sum())
        over = plain > 0
        p_adam += int(over.sum())
        if over.any():
            adam_lr = max(adam_lr, float((x - y).abs()[over].max()) / lr)
    return dict(loss_rel=abs(ours["loss"] - ref["loss"]) / abs(ref["loss"]), grad_excess=g_worst,
                grads_over=g_over, param_excess=p_worst, params_over=p_over, params_adam=p_adam,
                params_adam_max_lr=adam_lr)


def dp_worker(rank: int, rdv: str, tmp: str) -> None:
    """Phase 11(a), one of two ranks on cuda:0 in a gloo group: rank 0 first
    takes the ungrouped step (the reference); both ranks take the grouped
    step of each variant from the same parameters, then `train()` with
    shard_tables for DP_TRAIN_STEPS steps.  Writes the launch counts of its
    `train()` (the comparison steps' launches are not counted), step times,
    peak memory and rank 0's comparisons to tmp/rank{rank}.json."""
    import torch.distributed as dist

    from tinynerf_tpu_torch.ops import cuda_lib
    from tinynerf_tpu_torch.parallel import wrap_default_group
    from tinynerf_tpu_torch.train import TrainConfig, lr_schedule, train

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=2)
    try:
        group = wrap_default_group("cuda:0")
        cfg, pool, batch, renderer = _dp_world(f"{tmp}/rank{rank}")
        start = [p.detach().clone() for p in renderer.parameters()]
        ref = _dp_step(renderer, cfg, batch, start) if rank == 0 else None
        res = {"rank": rank, "steps": {}}
        lr, eps = float(lr_schedule(cfg)(0)), cfg.adam_eps
        for name, kw in DP_VARIANTS.items():
            c = dataclasses.replace(cfg, **kw)
            ours = _dp_step(renderer, c, batch, start, group)
            res["steps"][name] = dict(ms=ours["ms"], **(_dp_compare(ours, ref, lr, eps) if ref is not None else {}))
            del ours
        del ref, start
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tcfg = TrainConfig(method="kplanes", output=f"{tmp}/train", steps=DP_TRAIN_STEPS, seed=0,
                           shard_tables=True)
        zero_counts()
        out_train = train(tcfg, pool, device="cuda:0", group=group)
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
        losses = [m.loss for m in out_train["train_metrics"]]
        res.update(train_ms=out_train["elapsed_s"] / DP_TRAIN_STEPS * 1e3, losses=losses,
                   rays_per_sec_per_chip=out_train["rays_per_sec_per_chip"],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=launches)
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_data_parallel(card: str) -> dict:
    """Phase 11: (a) two gloo ranks on the card, spawned; (b) one NCCL rank
    in this process: its steps, `train()` and sharded serving.  Returns
    part -> kernel -> launches."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from tinynerf_tpu_torch.parallel import wrap_default_group
    from tinynerf_tpu_torch.train import InferStats, TrainConfig, lr_schedule, render_only, train
    from tinynerf_tpu_torch.utils import make_spheres_pose_set

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # a rank that raises makes join() raise; each join() returns when
        # one more rank has exited
        ctx = mp.start_processes(dp_worker, args=(f"{tmp}/rdv", tmp), nprocs=2, join=False,
                                 start_method="spawn")
        while not ctx.join():
            pass
        results = []
        for r in range(2):
            with open(f"{tmp}/rank{r}.json") as f:
                results.append(json.load(f))
    for res in results:
        r = res["rank"]
        print(f"phase 11(a) rank {r} of 2 (gloo, both on cuda:0): train() shard_tables {DP_TRAIN_STEPS} steps, "
              f"{res['train_ms']:.2f} ms/step, {res['rays_per_sec_per_chip']:,.0f} rays/s per rank used by the "
              f"loss, peak device memory {res['peak_gb']:.3f} GB, loss {res['losses'][0]:.5f} -> "
              f"{res['losses'][-1]:.5f}; grouped deterministic steps "
              + ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in res["steps"].items())
              + f" (one cold step each; two processes share the card over a host transport) [{card}]")
        launches[f"11a_rank{r}"] = res["launches"]
        print(f"phase 11(a) rank {r} train() launches: {res['launches']}")
        _check_train_launches(f"phase 11(a) rank {r}", res["launches"], DP_TRAIN_STEPS)
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"phase 11(a) rank {r}: train() losses are not finite")
    for name, cmp in results[0]["steps"].items():
        print(f"phase 11(a) {name}, 2 ranks vs the ungrouped step [2048 rays x 400, f32]: loss relative "
              f"difference {cmp['loss_rel']:.3e} (tol {DP_LOSS_RTOL:g}); gradients worst excess over "
              f"rtol {DP_RTOL:g} / atol {DP_ATOL:g} {cmp['grad_excess']:.3e} ({cmp['grads_over']} elements "
              f"over); updated parameters, the limits plus Adam's map of the gradients' difference: worst "
              f"excess {cmp['param_excess']:.3e} ({cmp['params_over']} over); {cmp['params_adam']} of them over "
              f"the limits alone, by at most {cmp['params_adam_max_lr']:.6f} lr")
        if not (cmp["loss_rel"] <= DP_LOSS_RTOL and cmp["grads_over"] == 0 and cmp["params_over"] == 0):
            raise AssertionError(f"phase 11(a) {name}: the 2-rank step disagrees with the ungrouped step")

    # (b) one NCCL rank: the grouped code path on the card's own transport
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        group = wrap_default_group("cuda:0")
        with tempfile.TemporaryDirectory() as tmp:
            cfg, pool, batch, renderer = _dp_world(tmp)
            start = [p.detach().clone() for p in renderer.parameters()]
            lr, eps = float(lr_schedule(cfg)(0)), cfg.adam_eps
            # the training default, the bf16 table-gradient payload
            ref = _dp_step(renderer, cfg, batch, start)
            ours = _dp_step(renderer, cfg, batch, start, group)
            cmp = _dp_compare(ours, ref, lr, eps)
            cmp["ms"], cmp["ref_ms"] = ours["ms"], ref["ms"]
            bf16_errs = [_rel_err(a, b) for a, b in zip(ours["grads"], ref["grads"])]
            del ours, ref
            # the f32 payload, which carries the last bits a bf16 rounding drops
            renderer.field.bwd_impl = "sorted"
            ref = _dp_step(renderer, cfg, batch, start)
            ours = _dp_step(renderer, cfg, batch, start, group)
            del renderer, start
            loss_rel = abs(ours["loss"] - ref["loss"]) / abs(ref["loss"])
            errs = [_rel_err(a, b) for a, b in zip(ours["grads"], ref["grads"])]
            worst = int(np.argmax(errs))
            print(f"phase 11(b) 1 NCCL rank vs the ungrouped step [2048 rays x 400, f32, bf16 table-gradient "
                  f"payload]: loss relative difference {cmp['loss_rel']:.3e} (tol {NCCL_LOSS_RTOL:g}); gradients "
                  f"worst excess over rtol {DP_RTOL:g} / atol {DP_ATOL:g} {cmp['grad_excess']:.3e} "
                  f"({cmp['grads_over']} elements over); updated parameters, the limits plus Adam's map of the "
                  f"gradients' difference: worst excess {cmp['param_excess']:.3e} ({cmp['params_over']} over); "
                  f"{cmp['params_adam']} of them over the limits alone, by at most {cmp['params_adam_max_lr']:.6f} "
                  f"lr; gradients max|diff| / max {max(bf16_errs):.3e} (tol {NCCL_GRAD_RTOL_OF_MAX:g}); "
                  f"{cmp['ms']:.1f} ms against {cmp['ref_ms']:.1f} ungrouped (one cold step each)")
            print(f"phase 11(b) 1 NCCL rank vs the ungrouped step [2048 rays x 400, f32, f32 table-gradient "
                  f"payload]: loss relative difference {loss_rel:.3e} (tol {NCCL_LOSS_RTOL:g}), gradients "
                  f"max|diff| / max {errs[worst]:.3e} at {ref['paths'][worst]} (tol {NCCL_GRAD_RTOL_OF_MAX:g})")
            if not (cmp["loss_rel"] <= NCCL_LOSS_RTOL and cmp["grads_over"] == 0 and cmp["params_over"] == 0
                    and max(bf16_errs) <= NCCL_GRAD_RTOL_OF_MAX):
                raise AssertionError("phase 11(b): the NCCL-grouped step disagrees with the ungrouped step "
                                     "(bf16 payload)")
            if not (loss_rel <= NCCL_LOSS_RTOL and errs[worst] <= NCCL_GRAD_RTOL_OF_MAX):
                raise AssertionError("phase 11(b): the NCCL-grouped step disagrees with the ungrouped step "
                                     "(f32 payload)")
            del ours, ref
            torch.cuda.empty_cache()
            tcfg = TrainConfig(method="kplanes", output=f"{tmp}/train", steps=NCCL_TRAIN_STEPS, seed=0)
            zero_counts()
            out = train(tcfg, pool, device="cuda:0", group=group)
            launches["11b_nccl"] = read_counts("phase 11(b) 1 NCCL rank train()", DP_STEP_LAUNCHES)
            _check_train_launches("phase 11(b) 1 NCCL rank", launches["11b_nccl"], NCCL_TRAIN_STEPS)
            losses = [m.loss for m in out["train_metrics"]]
            if len(losses) != NCCL_TRAIN_STEPS or not np.isfinite(losses).all():
                raise AssertionError(f"phase 11(b): train() over the NCCL group gave {losses}")
            print(f"phase 11(b) train() over 1 NCCL rank, {NCCL_TRAIN_STEPS} steps: "
                  f"{out['elapsed_s'] / NCCL_TRAIN_STEPS * 1e3:.2f} ms/step (the occupancy sweep included), "
                  f"losses {np.round(losses, 5).tolist()} [{card}]")
            del out, pool
            torch.cuda.empty_cache()
            # sharded serving: render_only over the group from train()'s
            # checkpoint, packed on the skip march and dense, against
            # render_only alone
            view = make_spheres_pose_set(n_views=1, res=800, seed=1)
            for render, kernels in (("packed", march_kernels("kplanes", "aabb", "skip")),
                                    ("dense", ("weights_dense",) + FIELD_KERNELS["kplanes"])):
                rcfg = dataclasses.replace(tcfg, eval_render=render)
                alone, grouped = InferStats(), InferStats()
                render_only(rcfg, view, name=f"{render}_alone", device="cuda:0", stats=alone)
                zero_counts()
                render_only(rcfg, view, name=f"{render}_group", stats=grouped, group=group)
                launches[f"11b_nccl_serve_{render}"] = read_counts(
                    f"phase 11(b) 1 NCCL rank render_only {render}", kernels)
                img, ref_img = grouped.images[0], alone.images[0]
                e = float(np.abs(img - ref_img).max())
                print(f"phase 11(b) render_only {render} over 1 NCCL rank vs alone, one 800x800 view: max abs "
                      f"{e:.3e} (tol {DP_SERVE_ATOL:g}); {grouped.seconds[0]:.3f} s against "
                      f"{alone.seconds[0]:.3f} s alone [{card}]")
                if img.shape != (800, 800, 3) or not np.isfinite(img).all() or not e <= DP_SERVE_ATOL:
                    raise AssertionError(f"phase 11(b): render_only {render} over the NCCL group disagrees")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


KERNELS = (  # (record key, name, source, the TPU kernel it replaces)
    ("segscan", "segscan.compute_weights_packed", "segscan.cu", "tinynerf_tpu/ops/segscan.py:48"),
    ("weights_dense", "weights_dense.compute_weights_dense", "weights_dense.cu",
     "tinynerf_tpu/ops/weights_pallas.py:60"),
    ("segscan_bwd", "segscan.weights_packed_bwd", "segscan.cu", "tinynerf_tpu/ops/segscan.py:48"),
    ("segment_sum", "segscan.segment_sum", "segscan.cu", "tinynerf_tpu/core/renderer.py:381"),
    ("weights_dense_bwd", "weights_dense.weights_dense_bwd", "weights_dense.cu",
     "tinynerf_tpu/ops/weights_pallas.py:70"),
    ("sort", "bitonic.sort_i32", "radix_sort.cu", "tinynerf_tpu/ops/bitonic.py:73"),
    ("sort_pairs", "bitonic.sort_pairs_i32", "radix_sort.cu", "tinynerf_tpu/ops/interp.py:478"),
    ("accumulate", "table_grad.windowed_accumulate", "table_grad.cu", "tinynerf_tpu/ops/table_grad.py:66"),
    ("oct_build", "octbuild.build_oct", "octbuild.cu", "tinynerf_tpu/ops/octbuild.py:73"),
    ("quad_build", "octbuild.build_quad", "octbuild.cu", "tinynerf_tpu/ops/octbuild.py:114"),
    ("quad_build_fp8", "octbuild.build_quad (float8_e4m3fn out)", "octbuild.cu", "tinynerf_tpu/ops/octbuild.py:114"),
    ("skip_march", "skipmarch.skip_march", "skipmarch.cu", "tinynerf_tpu/core/skipmarch.py:357"),
    ("skip_march_unbounded", "skipmarch.skip_march_unbounded", "skipmarch.cu",
     "tinynerf_tpu/core/skipmarch.py:209"),
)


def run_phases(card: str, ns_root) -> dict:
    """Phases 3-10; returns phase -> kernel -> launches."""
    from tinynerf_tpu_torch.data import PoseSet, RayPool, parse_nerfstudio

    phases = [(3, "kplanes", "aabb", run_slice, {}), (4, "kplanes", "aabb", run_training, {}),
              (5, "cobafa", "aabb", run_slice, {}), (6, "cobafa", "aabb", run_training, {}),
              (7, "vanilla", "aabb", run_slice, {}), (8, "vanilla", "aabb", run_training, {}),
              (9, "kplanes", "unbounded", run_slice, dict(pose_set=lambda: PoseSet(parse_nerfstudio(ns_root, "test")))),
              (10, "kplanes", "unbounded", run_training,
               dict(pool=lambda: RayPool(parse_nerfstudio(ns_root, "train"), device="cuda")))]
    launches = {}
    for phase, method, scene_type, run, data in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            kw = {k: make() for k, make in data.items()}
            for part, counts in run(tmp, card, method, scene_type, **kw).items():
                launches[f"{phase}_{method}_{scene_type}_{part}"] = counts
        print(f"phase {phase} ({method} {scene_type} {run.__name__}): {time.perf_counter() - t0:.1f} s")
    for phase in (9, 10):  # the unbounded skip march on both unbounded paths
        if not any(k.startswith(f"{phase}_") and c["skip_march_unbounded"] > 0 for k, c in launches.items()):
            raise AssertionError(f"phase {phase} did not launch the unbounded skip march")
    return launches


# phase 13, determinism at full width: one deterministic step twice from
# one saved state, and one served 800x800 view twice, bit for bit
DETERMINISM_METHODS = ("kplanes", "cobafa")


def run_determinism(tmp: str, card: str) -> dict:
    """Phase 13: for K-Planes and Cobafa at the TrainConfig defaults (2048
    rays drawn over four generated 800x800 views, 400 samples, bf16
    compute, the all-occupied grid): one deterministic step (after a first
    one, so that Adam's moments are not zero) twice from the same saved
    state: the loss, every gradient, every parameter and moment bit-equal;
    then one 800x800 view served twice (`infer`, packed on the skip march
    behind the shell occupancy, the dense fallback): the images bit-equal.
    Returns label -> kernel -> launches (counts zeroed before each path)."""
    from tinynerf_tpu_torch.convert import tree_leaves_with_path
    from tinynerf_tpu_torch.data import RayPool
    from tinynerf_tpu_torch.train import (
        InferStats, TrainConfig, build_renderer, infer, make_optimizer, make_render_chunk,
        make_render_chunk_packed, make_train_step,
    )
    from tinynerf_tpu_torch.utils import make_shell_occupancy, make_spheres_data, make_spheres_pose_set

    pool = RayPool(make_spheres_data(n_views=4, res=800, seed=1), device="cuda")
    poses = make_spheres_pose_set(n_views=1, res=800, seed=0)
    launches = {}
    for method in DETERMINISM_METHODS:
        cfg = TrainConfig(method=method, seed=0)
        renderer = build_renderer(cfg, pool.scene_scale, pool.bg_color, device="cuda")
        opt = make_optimizer(cfg, renderer)
        gen = torch.Generator("cuda").manual_seed(9)
        rays = torch.randperm(pool.n_rays, device="cuda", generator=gen)[:cfg.batch_size]
        batch = tuple(a[rays].contiguous() for a in pool.arrays())
        occ = renderer.occupancy.init_state("cuda")
        step = make_train_step(renderer, opt, cfg, cfg.batch_size, deterministic=True)
        zero_counts()
        step(occ, *batch)
        state = [*opt.params, *opt.mu, *opt.nu]
        start, count = [s.detach().clone() for s in state], opt.count
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for s, s0 in zip(state, start):
                    s.copy_(s0)
            opt.count = count
            m = step(occ, *batch)
            run = {"loss": m["loss"].clone()}
            run.update({f"grad {path}": g.clone() for path, g in tree_leaves_with_path(m["grads"])})
            run.update({f"{kind} {path}": s.detach().clone() for kind, tensors in
                        (("param", opt.params), ("mu", opt.mu), ("nu", opt.nu)) for path, s in zip(opt.paths, tensors)})
            runs.append(run)
        launches[f"13_{method}_step"] = read_counts(f"phase 13 {method} steps", TRAINING_KERNELS[method])
        differ = [k for k, v in runs[0].items() if not torch.equal(v, runs[1][k])]
        n_zero = sum(float(v.abs().max()) == 0.0 for k, v in runs[0].items() if k.startswith("grad "))
        print(f"phase 13 {method} deterministic step [{cfg.batch_size} rays x {cfg.n_samples}], twice from one "
              f"state: loss {float(runs[0]['loss']):.9f}, {len(runs[0])} tensors (loss, gradients, parameters, "
              f"moments), {len(differ)} not bit-equal {differ[:6]}; {n_zero} zero gradient leaves [{card}]")
        if differ or not np.isfinite(float(runs[0]["loss"])):
            raise AssertionError(f"phase 13: the {method} step does not repeat itself bit for bit: {differ[:12]}")
        del runs, start, opt, step

        shell = make_shell_occupancy(renderer.occupancy, device="cuda")
        cap = cfg.batch_size * cfg.eval_samples_per_ray
        zero_counts()
        images = []
        for _ in range(2):
            st = InferStats()
            infer(renderer, shell, poses, [0], tmp, f"det_{method}", chunk=cfg.batch_size,
                  render_chunk_fn=make_render_chunk(renderer),
                  packed_fn=make_render_chunk_packed(renderer, cap, march="skip"), stats=st,
                  grid_args=(renderer.skip_grid(shell),), write=False)
            images.append(st.images[0])
        launches[f"13_{method}_serve"] = read_counts(f"phase 13 {method} served views",
                                                     march_kernels(method, "aabb", "skip"))
        same = images[0].shape == (800, 800, 3) and np.array_equal(images[0], images[1])
        print(f"phase 13 {method} 800x800 view served twice (packed on the skip march, dense fallback "
              f"{st.fallback_rays} rays): bit-equal {same}, max abs {np.abs(images[0] - images[1]).max():.3e} [{card}]")
        if not (same and np.isfinite(images[0]).all()):
            raise AssertionError(f"phase 13: the served {method} view does not repeat itself bit for bit")
        del renderer
        torch.cuda.empty_cache()
    return launches


# phase 12, the port's four tools through their main(argv), as a user runs
# them.  (c) trains K-Planes with the JAX tool's defaults (spheres, 12 views
# at 100, batch 1024 x 128, f32) for QUALITY_STEPS steps: the occupancy
# grid decays from all-occupied by 0.01^(1/16) per update (every 64 steps),
# so it first culls at step 1024, and `MarchPolicy` can switch train() to
# the skip march only after that (the first card run switched at step 1089
# and reached 23.67 dB: PERF.md §6, PR 9); its test PSNR must reach
# QUALITY_PSNR_FLOOR dB, that run's less about 1.7 dB, and its loss fall at
# least QUALITY_LOSS_DROP times; (d) the same with float8 gathers for
# FP8_STEPS steps
QUALITY_STEPS, FP8_STEPS = 1280, 64
PROFILE_FIELD_N = 3  # (f): calls per piece, and as many under the profiler
QUALITY_PSNR_FLOOR, QUALITY_LOSS_DROP = 22.0, 10.0
TURNTABLE_FRAMES, TURNTABLE_RES = 4, 200


def _import_tool(name: str):
    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def run_tools(card: str) -> dict:
    """Phase 12: bench_infer, profile_step (dense, skip), quality_run (the
    default bf16 gathers, then float8) and render_turntable from
    quality_run's checkpoint.  Returns label -> kernel -> launches."""
    launches = {}

    def counted(label: str, required, fn):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        launches[label] = read_counts(f"phase {label}", required)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    # (a) serving throughput at the JAX tool's full-width defaults, each
    # path's kernels launched in its own timed chunks
    bench = counted("12a_bench_infer", ("weights_dense", "segscan", "quad_build", "skip_march"),
                    lambda: _import_tool("bench_infer_torch").main([]))
    for path, need in (("dense", ("weights_dense",)), ("packed_dense", ("segscan", "quad_build")),
                       ("packed_skip", ("skip_march",))):
        if not all(bench[path]["launches"][k] > 0 for k in need):
            raise AssertionError(f"bench_infer {path} did not launch {need}: {bench[path]['launches']}")
        if path != "dense" and not 0.0 < bench[path]["ok_share"] <= 1.0:
            raise AssertionError(f"bench_infer {path}: ok share {bench[path]['ok_share']}")
    print(f"12a bench_infer rays/s: " + ", ".join(f"{p} {bench[p]['rays_per_s']:.0f}"
                                                  for p in ("dense", "packed_dense", "packed_skip"))
          + f"; speedup {bench['speedup']:.2f}x ({card})")

    # (b) the stage table at bucket 16, dense then skip
    for march in ("dense", "skip"):
        prof = counted(f"12b_profile_step_{march}", ("segscan", "quad_build"),
                       lambda: _import_tool("profile_step_torch").main(["--march", march]))
        weights = prof["stages"]["packed weights fwd (segscan)"]["launches_per_call"]
        if weights.get("segscan") != 1:
            raise AssertionError(f"profile_step: kernel 1 launched {weights} per packed weights call")
        if march == "skip" and not prof["stages"]["skip-march scan (K=64)"]["launches_per_call"].get("skip_march"):
            raise AssertionError("profile_step: the skip march stage launched no skip march")

    # (c) a trained scene: the skip march launched inside train(), the loss
    # falling, a finite test PSNR over the floor
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--method", "kplanes", "--steps", str(QUALITY_STEPS)]
        q = counted("12c_quality_run", TRAINING_KERNELS["kplanes"] + ("skip_march",),
                    lambda: _import_tool("quality_run_torch").main(base + ["--output", f"{tmp}/q"]))
        drop = q["first_loss"] / q["last_loss"]
        print(f"12c quality_run: loss {q['first_loss']:.5f} -> {q['last_loss']:.5f} ({drop:.1f}x), test PSNR "
              f"{q['psnr']:.2f} dB, SSIM {q['ssim']:.3f}, {q['march_steps']['skip']} of {QUALITY_STEPS} steps "
              f"on the skip march (first: step {q['first_skip_step']}), {q['rays_per_sec_per_chip']:.0f} "
              f"rays/s, {q['elapsed_s']:.1f} s ({card})")
        if not q["march_steps"]["skip"] > 0:
            raise AssertionError("quality_run: train() never took the skip march")
        if not (np.isfinite(q["psnr"]) and q["psnr"] >= QUALITY_PSNR_FLOOR and drop >= QUALITY_LOSS_DROP):
            raise AssertionError(f"quality_run: PSNR {q['psnr']} (floor {QUALITY_PSNR_FLOOR}) or loss drop "
                                 f"{drop:.2f}x (at least {QUALITY_LOSS_DROP}) missed")

        # (d) float8 gathers: every quad build of the field in float8
        q8 = counted("12d_quality_run_fp8", ("quad_build_fp8", "segscan", "sort", "accumulate"),
                     lambda: _import_tool("quality_run_torch").main(
                         ["--method", "kplanes", "--steps", str(FP8_STEPS), "--gather-dtype", "float8",
                          "--output", f"{tmp}/q8"]))
        c = launches["12d_quality_run_fp8"]
        if not (c["quad_build_fp8"] == c["quad_build"] and c["quad_build_fp8"] % 9 == 0):
            raise AssertionError(f"quality_run float8: {c['quad_build_fp8']} float8 quad builds of "
                                 f"{c['quad_build']}, not nine per field call")
        if not (np.isfinite(q8["losses"]).all() and q8["last_loss"] < q8["first_loss"]):
            raise AssertionError(f"quality_run float8: loss {q8['first_loss']} -> {q8['last_loss']}")
        print(f"12d quality_run float8: loss {q8['first_loss']:.5f} -> {q8['last_loss']:.5f}, test PSNR "
              f"{q8['psnr']:.2f} dB, {c['quad_build_fp8']} float8 quad builds")

        # (e) the turntable from (c)'s checkpoint, on the skip march
        tt = counted("12e_render_turntable", ("segscan", "quad_build", "skip_march"),
                     lambda: _import_tool("render_turntable_torch").main(
                         ["--ckpt", f"{tmp}/q/exp/ckpt_{QUALITY_STEPS}.pkl", "--method", "kplanes",
                          "--out", f"{tmp}/frames", "--n_frames", str(TURNTABLE_FRAMES),
                          "--res", str(TURNTABLE_RES)]))
        if not all(np.isfinite(img).all() and img.shape == (TURNTABLE_RES, TURNTABLE_RES, 3)
                   for img in tt["images"]):
            raise AssertionError("render_turntable: a frame is not finite or of the wrong shape")
        print(f"12e render_turntable: {tt['seconds_per_frame']:.4f} s/frame ({tt['seconds']}), fallback "
              f"{tt['fallback_rays']} of {tt['rays']} rays ({tt['fallback_share']:.4%}), incomplete "
              f"{tt['incomplete_rays']} ({card})")

    # (f) the field's pieces at the training cap, both fields (Cobafa with a
    # converged step's pad tail): kernels 4-7 launched, every piece timed
    for method, required, extra in (("kplanes", ("quad_build", "sort", "accumulate"), []),
                                    ("cobafa", ("oct_build", "sort_pairs", "accumulate"),
                                     ["--pad", str(COBAFA_PAD_SHARE)])):
        prof = counted(f"12f_profile_field_{method}", required, lambda: _import_tool("profile_field_torch").main(
            ["--method", method, "--n", str(PROFILE_FIELD_N), *extra]))
        # every piece timed with CUDA events; the profiler has returned
        # windows without a kernel (PERF.md section 6), so device time is
        # required of most pieces, not of each
        untimed = [k for k, v in prof["pieces"].items() if not v["ms"] > 0]
        unmeasured = [k for k, v in prof["pieces"].items() if not v["device_ms"]]
        if untimed or 2 * len(unmeasured) > len(prof["pieces"]):
            raise AssertionError(f"profile_field {method}: pieces not timed {untimed}, or not on the device "
                                 f"{unmeasured}")
        if method == "cobafa" and not prof["bwd_sorted_vs_index_add"] <= GRAD_RTOL_OF_MAX:
            raise AssertionError(f"profile_field: the sorted oct gradient is {prof['bwd_sorted_vs_index_add']} "
                                 f"from index_add_'s")
        print(f"12f profile_field {method}: {len(prof['pieces'])} pieces, device time not measured for "
              f"{unmeasured}; " + ", ".join(
            f"{k} {_ms(v['device_ms'])}" for k, v in prof["pieces"].items() if k.startswith(("bwd", "field")))
            + f" ms device ({card})")

    # (g) same-cell runs in the packed stream at the benchmark's geometry
    runs = counted("12g_analyze_runs", (), lambda: _import_tool("analyze_runs_torch").main([]))
    if not (runs["samples"] > 0 and len(runs["rows"]) == 11
            and all(0 < r["runs"] <= r["samples"] for r in runs["rows"])):
        raise AssertionError(f"analyze_runs: bad counts {runs}")
    print(f"12g analyze_runs: {runs['samples']} samples of {runs['rays']} rays; runs/samples " + ", ".join(
        f"{r['name']} {r['res']} {r['runs']}" for r in runs["rows"]) + f" ({card})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from tinynerf_tpu_torch.utils.device import card_line

    t_start = time.perf_counter()
    card = card_line(torch.device("cuda"))
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
    with tempfile.TemporaryDirectory() as scene_tmp:
        t0 = time.perf_counter()
        ns_root = write_nerfstudio_scene(f"{scene_tmp}/capture")
        print(f"nerfstudio capture of 9 generated 800x800 views written in {time.perf_counter() - t0:.1f} s")
        kern = check_kernels(dev)
        check_training_kernels(dev, kern)
        check_fixed_order_kernels(dev, kern)
        kern.update(check_oct_build(dev))
        kern.update(check_quad_build(dev))
        kern.update(check_skip_march(dev))
        kern.update(check_skip_march_unbounded(dev, ns_root))
        launches = run_phases(card, ns_root)
        t0 = time.perf_counter()
        launches.update(run_data_parallel(card))
        print(f"phase 11 (data parallel): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches.update(run_tools(card))
        print(f"phase 12 (tools): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(run_determinism(tmp, card))
        print(f"phase 13 (determinism): {time.perf_counter() - t0:.1f} s")

    # the quad build's counter counts every launch; its float8 launches
    # have a row of their own
    own = lambda c, key: c[key] - c["quad_build_fp8"] if key == "quad_build" else c[key]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"tinynerf_tpu_torch/csrc/{source}", "replaces": replaces,
         "launches": sum(own(c, key) for c in launches.values()),
         "launches_by_phase": {ph: own(c, key) for ph, c in launches.items()}, **kern[key]}
        for key, name, source, replaces in KERNELS
    ]}
    for k in record["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was launched by no driven path")
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
