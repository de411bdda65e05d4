#!/usr/bin/env python3
"""Device and call time of the packed weights kernels (forward, backward)
and of the oct and quad cell-pack builds on one GPU (tinynerf_tpu_torch).

    python3 tools/profile_weights_oct_torch.py [--root DIR] [--runs 20] [--oct-probe] [--sweep]

The packed weights run on `chip_smoke.py`'s buffers: the serving chunk
[131,072] (2048 rays, 15% of them not empty), the early training step
[819,200] (4,096 rays filling 0.937), the converged one (131,072 rays,
most of 0-8 samples) and one ray of 32 samples (the card's shortest launch
of the kernel).  The builds run on the Cobafa field's seven grids and the
K-Planes field's nine planes, bf16 and f32.  Every kernel is first held
against its plain version, then timed per call (median of --runs, CUDA
events: what a caller waits) and on the device (profiler, by kernel name,
in two windows: one that lost kernel records shows as a disagreement); the
weights also by the host's clock over 1000 calls back to back (what the
wrapper costs the host when nothing waits for the device).

--root DIR imports the package from another checkout (its `chip_smoke.py`
is not used), so that two commits can be timed in turns within one job:
the entry points called here have kept their signatures.
--oct-probe builds tools/octbuild_probe_torch.cu (the gather design of the
oct build with its loads or its stores taken out) and times it on the same
grids.  --sweep times the oct build over its block shapes
(`octbuild.OCT_BAND`, `OCT_THREADS`), the default taken again in between.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _load_smoke():
    """This checkout's chip_smoke.py (its problems and timers), whatever
    package --root puts on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, n: int = 1000) -> float:
    """Host time per call, back to back with no synchronization between."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def timed(label: str, fn, runs: int, host: bool = False) -> None:
    call = smoke.median_ms(fn, runs)
    if host:
        label = f"{label}: host {host_us(fn):.2f} us per call back to back"
    windows = [smoke.device_ms_by_kernel(fn, runs) for _ in range(2)]
    total = " / ".join(f"{sum(w.values()):.4f}" if w else "not measured" for w in windows)
    names = sorted({k[:48] for w in windows for k in w})
    print(f"  {label}: call {call:.4f} ms, device {total} ms, {len(windows[0])} kernels per call {names}",
          flush=True)


def weights_section(dev, runs: int) -> None:
    from tinynerf_tpu_torch.ops import segscan

    rng = np.random.default_rng(0)
    problems = (
        ("serving [131,072], 2,048 rays", smoke.packed_problem(rng), 2048),
        ("early training [819,200], 4,096 rays", smoke.training_packed_problem(rng, 4096, fill=0.937), 4096),
        ("converged training [819,200], 131,072 rays", smoke.converged_packed_problem(rng), 131_072),
        ("one ray of 32 samples", smoke.one_ray_problem(), 1),
    )
    print("packed weights (kernel 1):")
    for label, (sig, dlt, valid, seg, n_valid), n_rays in problems:
        a = [torch.from_numpy(x).to(dev) for x in (sig, dlt, valid, seg)]
        w = segscan.compute_weights_packed(*a, 1e-4, n_segments=n_rays)
        w_ref = segscan.compute_weights_packed_plain(*a, 1e-4, n_segments=n_rays)
        g = torch.randn(sig.size, device=dev, generator=torch.Generator(dev).manual_seed(6))
        grad = segscan.weights_packed_bwd(*a, w, g, n_rays)
        ref = segscan.weights_packed_bwd_plain(*a, w, g, n_rays)
        e_w, e_g = float((w - w_ref).abs().max()), smoke._rel_err(grad, ref)
        if not (e_w <= smoke.WEIGHTS_ATOL and e_g <= smoke.GRAD_RTOL_OF_MAX):
            raise AssertionError(f"{label}: kernel and plain differ: weights {e_w}, gradient {e_g} of max")
        print(f" {label}: fill {n_valid / sig.size:.4f}; max|kernel-plain| weights {e_w:.2e}, gradient {e_g:.2e} of max")
        timed("forward", lambda: segscan.compute_weights_packed(*a, 1e-4, n_segments=n_rays), runs, host=True)
        timed("backward", lambda: segscan.weights_packed_bwd(*a, w, g, n_rays), runs, host=True)


def rosters(dev):
    from tinynerf_tpu_torch.models import make_model

    gen = torch.Generator(dev).manual_seed(2)
    cobafa, kplanes = make_model("cobafa", device="meta")[0], make_model("kplanes", device="meta")[0]
    oct_tables = [torch.randn(p.shape, device=dev, generator=gen) for p in (*cobafa.basis, cobafa.coef)]
    quad_tables = [torch.rand(p.shape, device=dev, generator=gen) for scale in kplanes.planes for p in scale]
    return oct_tables, quad_tables


def builds_section(dev, runs: int, oct_tables, quad_tables) -> None:
    from tinynerf_tpu_torch.ops import octbuild

    print("cell-pack builds (kernels 6 and 7):")
    for out_dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for build, plain, tables in ((octbuild.build_oct, octbuild.build_oct_plain, oct_tables),
                                     (octbuild.build_quad, octbuild.build_quad_plain, quad_tables)):
            for t in tables:
                if not torch.equal(build(t, out_dtype), plain(t, out_dtype)):
                    raise AssertionError(f"{build.__name__} {label} of {tuple(t.shape)} is not bit-equal to plain")
        timed(f"oct roster {label}", lambda: [octbuild.build_oct(t, out_dtype) for t in oct_tables], runs)
        timed(f"quad roster {label}", lambda: [octbuild.build_quad(t, out_dtype) for t in quad_tables], runs)
    for t in oct_tables:
        timed(f"oct bf16 {tuple(t.shape)}", lambda: octbuild.build_oct(t), runs)


def sweep_section(runs: int, oct_tables) -> None:
    from tinynerf_tpu_torch.ops import octbuild

    base = (octbuild.OCT_BAND, octbuild.OCT_THREADS)
    refs = {dt: [octbuild.build_oct_plain(t, dt) for t in oct_tables] for dt in (torch.bfloat16, torch.float32)}

    def setting(band, threads):
        octbuild.OCT_BAND, octbuild.OCT_THREADS = band, threads
        for dt, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for t, ref in zip(oct_tables, refs[dt]):
                torch.full_like(ref, float("nan"))  # the block the kernel's torch.empty gets next
                if not torch.equal(octbuild.build_oct(t, dt), ref):
                    raise AssertionError(f"band {band}, {threads} threads: {tuple(t.shape)} {label} differs")
            timed(f"band {band}, {threads} threads, roster {label}",
                  lambda: [octbuild.build_oct(t, dt) for t in oct_tables], runs)

    print(f"oct build sweep (band, threads; default {base}):")
    setting(*base)
    for band, threads in ((1, 256), (3, 256), (4, 256), (8, 256), (1, 128), (2, 128), (3, 128), (4, 128), (2, 64)):
        setting(band, threads)
    setting(*base)
    octbuild.OCT_BAND, octbuild.OCT_THREADS = base


def probe_section(dev, runs: int, oct_tables) -> None:
    """The gather design with its loads, its stores, or both taken out."""
    from tinynerf_tpu_torch.ops import cuda_lib

    out = cuda_lib.BUILD_DIR / "liboct_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(HERE / "octbuild_probe_torch.cu"),
                    "-o", str(out)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).tn_probe_oct
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, i, i, i, i, i, i, p, p, p], i
    sums = torch.empty(132 * 32 * 256, dtype=torch.int32, device=dev)
    names = {0: "as it was", 1: "loads replaced by a constant", 2: "stores replaced by a checksum",
             3: "neither loads nor stores (index arithmetic)"}
    print("oct build, the gather design (one thread gathers one 16-byte chunk from global memory):")
    for out_dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        outs = [torch.empty((t.shape[0] - 1) * (t.shape[1] - 1) * (t.shape[2] - 1), 8 * t.shape[3],
                            dtype=out_dtype, device=dev) for t in oct_tables]

        def run(probe):
            for t, o in zip(oct_tables, outs):
                rc = fn(t.data_ptr(), *t.shape, int(out_dtype == torch.bfloat16), probe, o.data_ptr(),
                        sums.data_ptr(), cuda_lib.stream_of(t))
                if rc != 0:
                    raise RuntimeError(f"tn_probe_oct failed with CUDA error {rc}")

        for probe in (0, 1, 2, 3, 0):
            timed(f"roster {label}, {names[probe]}", lambda: run(probe), runs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE.parent, help="the checkout whose package is timed")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--oct-probe", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_weights_oct_torch: needs a CUDA device")
    sys.path.insert(0, str(args.root.resolve()))
    global smoke
    smoke = _load_smoke()
    from tinynerf_tpu_torch.ops import cuda_lib

    card = smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; package from {args.root}")
    ours = False
    for line in cuda_lib.library().log.splitlines():
        if "Compiling entry" in line:
            ours = "segscan" in line or "weights_packed" in line or "oct_build" in line
        if ours and ("Compiling entry" in line or "registers" in line):
            print(f"  ptxas: {line.strip()[:200]}")
    dev = torch.device("cuda")
    weights_section(dev, args.runs)
    oct_tables, quad_tables = rosters(dev)
    builds_section(dev, args.runs, oct_tables, quad_tables)
    if args.oct_probe:
        probe_section(dev, args.runs, oct_tables)
    if args.sweep:
        sweep_section(max(5, args.runs // 2), oct_tables)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
