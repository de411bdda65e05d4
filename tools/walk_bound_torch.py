#!/usr/bin/env python3
"""The skip marches' bound as a dependent walk, on one GPU (tinynerf_tpu_torch).

    python3 tools/walk_bound_torch.py [--steps 200000]

`csrc/skipmarch.cu` runs one thread per ray; each round's sample position
comes from the grid value the round before gathered, so a ray's rounds are
a chain of dependent 4-byte loads into the 6 x r^3 int32 skip grid (about
the L2's size).  The least time such a march could take is the larger of
two terms: its longest chain of dependent gathers (n_steps where a ray runs
out of rounds, else the fewest rounds in which every ray completes) x the
latency of one dependent load, and the bytes it must move at 3.35 TB/s,
each gather counted as the 32-byte sector it touches (plus the rays in and
the indices out).  This measures the latency (tools/load_latency_probe_torch.cu:
one thread chasing a random cycle, one element per sector, through a buffer
the L2 holds and through one 20 times its size), then runs `chip_smoke.py`'s
two skip-march checks (the AABB march on the shell's cone grid, 2048 and
131,072 rays x 64 rounds; the unbounded march on its iso grid, x 96) and
sets each march's device time beside that bound.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

SECTOR = 32


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_latency_ns(dev, n_bytes: int, steps: int) -> float:
    """ns per dependent load through a random cycle over `n_bytes`, one
    element per 32-byte sector, timed after a first walk (warm L2)."""
    from tinynerf_tpu_torch.ops import cuda_lib

    out = cuda_lib.BUILD_DIR / "libload_latency_probe.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        str(HERE / "load_latency_probe_torch.cu"), "-o", str(out)],
                       check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).tn_chase
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_void_p], ctypes.c_int
    per = SECTOR // 4
    n = n_bytes // SECTOR
    perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(0))
    nxt = torch.zeros(n * per, dtype=torch.int32, device=dev)
    nxt[perm * per] = (torch.roll(perm, -1) * per).int()
    end = torch.zeros(1, dtype=torch.int32, device=dev)
    start = int(perm[0]) * per
    del perm

    def walk(k):
        rc = fn(nxt.data_ptr(), start, k, end.data_ptr(), cuda_lib.stream_of(nxt))
        if rc != 0:
            raise RuntimeError(f"tn_chase failed with CUDA error {rc}")

    walk(min(n, 4 * steps))  # warm: the L2 buffer's whole cycle
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    walk(steps)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) * 1e6 / steps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200_000, help="dependent loads timed per buffer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("walk_bound_torch: needs a CUDA device")
    from tinynerf_tpu_torch.train import TrainConfig, build_renderer
    from tinynerf_tpu_torch.utils.device import card_line

    smoke = _load_smoke()
    dev = torch.device("cuda")
    card = card_line(dev)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    l2_mb, hbm_mb = 16, 1024
    l2_ns = load_latency_ns(dev, l2_mb << 20, args.steps)
    hbm_ns = load_latency_ns(dev, hbm_mb << 20, args.steps // 4)
    print(f"dependent 4-byte load: {l2_ns:.1f} ns through {l2_mb} MB (L2), {hbm_ns:.1f} ns through "
          f"{hbm_mb} MB (device memory); one thread, random cycle, one element per 32-byte sector")

    with tempfile.TemporaryDirectory() as tmp:
        recs = {**smoke.check_skip_march(dev),
                **smoke.check_skip_march_unbounded(dev, smoke.write_nerfstudio_scene(f"{tmp}/capture"))}
    steps = {"skip_march": build_renderer(TrainConfig(), 1.0, None, device="meta").skip_steps,
             "skip_march_unbounded": build_renderer(TrainConfig(scene_type="unbounded"), 1.0, None,
                                                    device="meta").skip_steps}
    batch = TrainConfig().batch_size
    print("the skip marches against a dependent walk's bound (device ms; bound = max(longest chain x L2 "
          "latency, bytes with 32 per gather at 3.35 TB/s)):")
    for key, rec in recs.items():
        for part, pre, n_rays in (("serving", "", batch), ("training bucket", "train_bucket_", smoke.SKIP_BUCKET * batch)):
            rounds, dev_ms = rec[f"{pre}active_rounds"], rec[f"{pre}device_ms"]
            chain = rec[f"{pre}longest_rounds"]
            walk_bytes = rec[f"{pre}bound_bytes"] + (SECTOR - 4) * rounds  # the bytes bound counted 4 a gather
            by_bytes = walk_bytes / smoke.HBM_BYTES_PER_S * 1e3
            by_latency = chain * l2_ns * 1e-6
            walk = max(by_bytes, by_latency)
            share = f"{walk / dev_ms:.1%}" if dev_ms else "not measured"
            print(f"  {key} {part} [{n_rays} x {steps[key]}]: {rounds} active rounds, the longest chain "
                  f"{chain}; device {smoke._ms(dev_ms)}; latency term {by_latency:.4f} ms (with device "
                  f"memory's {chain * hbm_ns * 1e-6:.4f}), bytes term {by_bytes:.4f} ms ({walk_bytes / 1e6:.1f} MB); "
                  f"bound {walk:.4f} ms by {'latency' if by_latency >= by_bytes else 'bytes'}: {share}; "
                  f"the bytes-only bound {rec[f'{pre}bound_ms']:.4f} ms")
    print(f"card: {card}")


if __name__ == "__main__":
    main()
