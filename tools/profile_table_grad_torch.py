#!/usr/bin/env python3
"""Device time of the K-Planes table gradient's two kernels on one GPU
(tinynerf_tpu_torch): the window sort and the windowed accumulation, by the
kernels each call launches.

    python3 tools/profile_table_grad_torch.py [--runs 20] [--window W] [--sweep] [--clocks]

At the training path's shapes (3 projections x 819,200 samples, 262,144
cells x 4 corners x 96 features) and on cells laid
out as training lays them out (`chip_smoke.accumulation_problem`: uniform
cells, a hot window, the packed buffer's pad tail in one cell with a zero
cotangent), it reports, per call and summed by kernel name under the
profiler:

  * `sort_by_window` (pack, the sort kernels, unpack, searchsorted);
  * `sort_i32` of random 32-bit keys [3, 819,200] beside `torch.sort`;
  * `windowed_accumulate` with the bf16 and the f32 payload: the
    accumulation kernel apart from the wrapper's other launches.

Windows hold --window cells (default: `table_grad.default_window`, the
trainer's choice on the card).  With --sweep it also times the accumulation
kernels (bf16 payload) over window sizes (256: a tile per corner, four
blocks visit each sample; 128; 64 and less: the register kernel, or the
tile kernel in its place) and over their ring, block shapes and chunk size
(`ACCUM_OWNER_RING_BYTES`, `ACCUM_OWNER_STAGE_ROWS`, `ACCUM_SHAPES`, `ACCUM_CHUNK`), the default taken again in
between so that settings compare within one run, every setting held
against the plain version and timed in two profiler windows.  It prints
what ptxas reported for the two kernels' sources (registers, spills).
With --clocks the library is built with -DTN_ACCUM_CLOCKS, and one call of
the accumulation reports where its blocks' time goes, phase by phase (the
clock reads slow the kernel a little: its other times are then not the
port's).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import accumulation_problem
from tinynerf_tpu_torch.ops import bitonic, cuda_lib, table_grad


def by_kernel(fn, runs: int) -> dict:
    """Device ms per call of `fn`, by kernel name (and "total")."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            out[ev.key] = ev.self_device_time_total / 1e3 / runs
    out["total"] = sum(out.values())
    return out


def report(label: str, fn, runs: int) -> float:
    t = by_kernel(fn, runs)
    print(f"{label}: device {t['total']:.4f} ms per call ({runs} calls, profiler)")
    for name, ms in sorted(t.items(), key=lambda kv: -kv[1]):
        if name != "total":
            print(f"    {ms:8.4f} ms  {name[:120]}")
    return t["total"]


# the phases of a block's time, in the tile kernel / in the register kernel
PHASES = ("start (index load, barriers)", "zero fill of the tile / classify the stage's rows + block barrier",
          "wait for the first copy / for every copy", "rows (thread 0's warp) / add the warp's rows",
          "wait for the other warps / thread 0 feeds the ring", "write-out")


def phase_clocks(fn) -> None:
    """One call of the accumulation built with -DTN_ACCUM_CLOCKS: per phase,
    the time summed over the work items (the tile kernel: those with
    samples), as thread 0 of each block saw it, its own clock reads
    included, and per item."""
    import ctypes

    read = cuda_lib.library().lib.tn_accum_clocks
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_uint64 * (len(PHASES) + 1))()
    torch.cuda.synchronize()
    read(out)  # reset
    fn()
    torch.cuda.synchronize()
    if read(out) != 0:
        raise RuntimeError("tn_accum_clocks failed")
    blocks, total = out[len(PHASES)], sum(out[: len(PHASES)])
    print(f"  phases over {blocks} work items, {total / 1e6:.3f} ms of block time in all "
          f"({total / blocks / 1e3:.2f} us per item):")
    for name, ns in zip(PHASES, out):
        print(f"    {name}: {ns / 1e6:.3f} ms, {ns / blocks / 1e3:.2f} us per item, {100 * ns / total:.1f}%")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--window", type=int, default=0, help="cells per window (default: the trainer's)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--clocks", action="store_true",
                    help="build the kernels with -DTN_ACCUM_CLOCKS and report the accumulation's phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_table_grad_torch: needs a CUDA device")
    if args.clocks:  # before the library is built: a library of its own in the cache
        cuda_lib.NVCC_FLAGS = (*cuda_lib.NVCC_FLAGS, "-DTN_ACCUM_CLOCKS")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ours = False
    for line in cuda_lib.library().log.splitlines():
        if "Compiling entry" in line:
            ours = "radix" in line or "windowed" in line
        if ours and ("Compiling entry" in line or "registers" in line or "spill" in line):
            print(f"  ptxas: {line.strip()[:200]}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n, n_cells, w_window, f, nc = 819_200, 512 * 512, 256, 96, 4
    cell_np, zero_np = accumulation_problem(rng, n, n_cells, w_window)
    cell = torch.from_numpy(cell_np).to(dev)

    w_window = args.window or table_grad.default_window(dev, nc * f)
    report(f"sort_by_window [3, {n}] cells, {n_cells // w_window} windows of {w_window}",
           lambda: table_grad.sort_by_window(cell, n_cells, w_window), args.runs)
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (3, n), dtype=np.int64).astype(np.int32)).to(dev)
    if not torch.equal(bitonic.sort_i32(keys), torch.sort(keys, dim=-1).values):
        raise AssertionError("sort_i32 differs from torch.sort")
    report(f"sort_i32 of random 32-bit keys [3, {n}]", lambda: bitonic.sort_i32(keys), args.runs)
    report("torch.sort of the same keys", lambda: torch.sort(keys, dim=-1), args.runs)

    gen = torch.Generator(dev).manual_seed(1)
    g = torch.randn(3, n, f, device=dev, generator=gen)
    g[torch.from_numpy(zero_np).to(dev)] = 0.0
    w = torch.rand(3, n, nc, device=dev, generator=gen)

    def sorted_payload(window: int, payload):
        """(window-sorted payload rows, offsets) for windows of `window` cells."""
        perm, offsets = table_grad.sort_by_window(cell, n_cells, window)
        gidx = (perm.long() + (torch.arange(3, device=dev) * n)[:, None]).reshape(-1)
        rows = table_grad.pack_payload(g, w, cell, window, payload)
        return rows.reshape(3 * n, -1)[gidx].reshape(3, n, -1), offsets

    def accumulate(rows, offsets, window):
        return lambda: table_grad.windowed_accumulate(rows, offsets, f, nc, n_cells, window)

    for payload, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rows, offsets = sorted_payload(w_window, payload)
        ref = table_grad.windowed_accumulate_plain(rows, offsets, f, nc, n_cells, w_window)
        err = float((accumulate(rows, offsets, w_window)() - ref).abs().max()) / float(ref.abs().max())
        del ref
        print(f"windowed_accumulate {label} payload: max|kernel-plain| / max|plain| = {err:.3e}")
        report(f"windowed_accumulate {label} payload [3, {n}] -> [3, {n_cells}, {nc * f}], windows of {w_window}",
               accumulate(rows, offsets, w_window), args.runs)
        if args.clocks:
            phase_clocks(accumulate(rows, offsets, w_window))
        del rows

    if args.sweep:
        base = (table_grad.ACCUM_CHUNK, table_grad.ACCUM_SHAPES, table_grad.ACCUM_OWNER_RING_BYTES,
                table_grad.ACCUM_OWNER_STAGE_ROWS)
        runs = max(5, args.runs // 2)
        cache = {}

        def timed(window, shape=None, chunk=base[0], owner=base[2], stage_rows=base[3]):
            """One setting: windows of `window` cells, chunks of `chunk`
            samples, a ring of `owner` bytes in stages of `stage_rows` rows in the
            register kernel (0: the tile kernel takes its windows too), the tile kernel's block
            `shape` (tile bytes, stages, bytes per stage, threads; default:
            the wrapper's choice)."""
            if window not in cache:
                cache.clear()
                rows, offsets = sorted_payload(window, torch.bfloat16)
                cache[window] = rows, offsets, table_grad.windowed_accumulate_plain(rows, offsets, f, nc, n_cells, window)
            rows, offsets, ref = cache[window]
            table_grad.ACCUM_CHUNK, table_grad.ACCUM_OWNER_RING_BYTES, table_grad.ACCUM_OWNER_STAGE_ROWS = chunk, owner, stage_rows
            table_grad.ACCUM_SHAPES = (shape,) if shape else base[1]
            torch.full_like(ref, float("nan"))  # the block the kernel's torch.empty gets next
            err = float((accumulate(rows, offsets, window)() - ref).abs().max()) / float(ref.abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"windows of {window}, {shape}, chunk {chunk}, owner {owner}: kernel and plain differ by {err}")
            # two profiler windows: one that lost kernel records shows as a disagreement
            took = [by_kernel(accumulate(rows, offsets, window), runs) for _ in range(2)]
            kern = [sum(ms for name, ms in t.items() if "windowed_accumulate" in name) for t in took]
            which = ("tile kernel" if owner == 0 or window > table_grad.OWNER_WINDOW
                     else f"register kernel, ring of {owner // 1024} KB in stages of {stage_rows} rows")
            print(f"  windows of {window}, {which}, shape {shape or 'default'}, chunk {chunk}: device "
                  f"{took[0]['total']:.4f} / {took[1]['total']:.4f} ms per call, the accumulation kernel "
                  f"{kern[0]:.4f} / {kern[1]:.4f}", flush=True)

        print(f"sweep, bf16 payload ({runs} calls each; chunk, shapes, ring bytes, rows per stage {base}):")
        kb = 1024
        timed(w_window)
        for owner, stage_rows in ((32, 32), (64, 32), (64, 64), (96, 64), (128, 64), (64, 128), (96, 128), (128, 128)):
            timed(w_window, owner=owner * kb, stage_rows=stage_rows)
        timed(w_window)
        # the tile kernel: a tile per corner (four blocks visit each sample), two corners, all four
        timed(256, (96 * kb, 2, 8192, 480))
        timed(128, (96 * kb, 2, 8192, 480))
        timed(128)
        timed(64, owner=0)
        for shape in ((96 * kb, 2, 8192, 480), (96 * kb, 4, 4096, 544), (96 * kb, 1, 16384, 544)):
            timed(64, shape, owner=0)
        timed(w_window)
        for chunk in (512, 2048, 4096):
            timed(w_window, chunk=chunk)
        timed(w_window)
        (table_grad.ACCUM_CHUNK, table_grad.ACCUM_SHAPES, table_grad.ACCUM_OWNER_RING_BYTES,
         table_grad.ACCUM_OWNER_STAGE_ROWS) = base
    print(f"card: {card}")


if __name__ == "__main__":
    main()
