#!/usr/bin/env python3
"""The skip marches' bounds, and what a round costs, on one GPU (tinynerf_tpu_torch).

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
sets each march's device time beside that bound, and beside the bound that
holds for any design: the larger of the bytes-only bound and the launch
floor (kernel 1's device time on one ray of 32 samples).

It also splits a round in two (the probes in load_latency_probe_torch.cu,
on the library's own per-candidate functions, one thread per ray): the
round's arithmetic with the gather replaced by the value it gathered,
recorded beforehand and loaded two rounds ahead (the same walk: its k_idx
must equal the kernel's), and the chain of gathers alone.  Their device
times over the kernel's are the arithmetic's and the gathers' shares of
the march.  And it times the march with 1, 2, 4, 8, 16 and 32 lanes per
ray at each shape (each equal to the wrapper's own k_idx), the sweep that
set the wrapper's pick (csrc/skipmarch.cu lanes_for).  Needs a CUDA device.
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
SWEEP_LANES = (1, 2, 4, 8, 16, 32)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_library() -> ctypes.CDLL:
    """load_latency_probe_torch.cu, built on first use beside the port's
    library (it includes csrc/skipmarch.cu)."""
    from tinynerf_tpu_torch.ops import cuda_lib

    out = cuda_lib.BUILD_DIR / "libload_latency_probe.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                               str(HERE / "load_latency_probe_torch.cu"), "-o", str(out)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on load_latency_probe_torch.cu:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.tn_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    extra = (ctypes.c_void_p,) * 2  # rec_g, rec_off
    for name in ("tn_skip_march", "tn_skip_march_unbounded"):
        sig = cuda_lib._SIGNATURES[name]
        fn = getattr(lib, name.replace("tn_", "tn_probe_"))
        fn.argtypes = [ctypes.c_int, ctypes.c_int, *sig[:-1], *extra, sig[-1]]
    for fn in (lib.tn_chase, lib.tn_probe_skip_march, lib.tn_probe_skip_march_unbounded):
        fn.restype = ctypes.c_int
    return lib


def round_probe(lib, smoke):
    """`chip_smoke._check_march`'s probe: the round's arithmetic alone and
    its gathers alone, device ms per call (profiler)."""
    from tinynerf_tpu_torch.core import skipmarch
    from tinynerf_tpu_torch.ops import cuda_lib

    def run(label, head, jitter, n_steps, k_idx) -> dict:
        if "unbounded" in label:
            args, k, c, seed = skipmarch.c_args_unbounded(*head, jitter, n_steps)
            fn = lib.tn_probe_skip_march_unbounded
        else:
            args, k, c, seed = skipmarch.c_args_aabb(*head, jitter, n_steps)
            fn = lib.tn_probe_skip_march
        n_rays = head[0].shape[0]
        rec_g, rec_off = (torch.empty(n_steps, n_rays, dtype=torch.int32, device=head[0].device) for _ in range(2))
        stream = cuda_lib.stream_of(head[0])

        def call(mode, lanes=0):  # args point into k, c and seed, alive until run returns
            rc = fn(mode, lanes, *args, rec_g.data_ptr(), rec_off.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{fn.__name__} mode {mode} failed with CUDA error {rc}")

        call(0)
        call(1)
        torch.cuda.synchronize()
        if not torch.equal(k, k_idx):
            raise AssertionError(f"{label}: the arithmetic probe did not walk the kernel's rounds")
        rec = {"arith_device_ms": smoke.device_ms(lambda: call(1)),
               "chain_device_ms": smoke.device_ms(lambda: call(2)),
               "lanes": cuda_lib.library().lib.tn_skip_lanes(n_rays), "lanes_device_ms": {}}
        for lanes in SWEEP_LANES:  # the march with every number of lanes per ray
            k.fill_(-2)  # a value the march never writes: every element must be written
            call(3, lanes)
            torch.cuda.synchronize()
            if not torch.equal(k, k_idx):
                raise AssertionError(f"{label}: the march with {lanes} lanes per ray differs")
            rec["lanes_device_ms"][lanes] = smoke.device_ms(lambda: call(3, lanes))
        return rec

    return run


def load_latency_ns(dev, lib, n_bytes: int, steps: int) -> float:
    """ns per dependent load through a random cycle over `n_bytes`, one
    element per 32-byte sector, timed after a first walk (warm L2)."""
    from tinynerf_tpu_torch.ops import cuda_lib

    fn = lib.tn_chase
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
    lib = probe_library()
    l2_mb, hbm_mb = 16, 1024
    l2_ns = load_latency_ns(dev, lib, l2_mb << 20, args.steps)
    hbm_ns = load_latency_ns(dev, lib, hbm_mb << 20, args.steps // 4)
    print(f"dependent 4-byte load: {l2_ns:.1f} ns through {l2_mb} MB (L2), {hbm_ns:.1f} ns through "
          f"{hbm_mb} MB (device memory); one thread, random cycle, one element per 32-byte sector")

    floor = smoke.check_packed_weights(dev, "one ray of 32 samples", smoke.one_ray_problem(), 1)[0]["device_ms"]
    print(f"launch floor: kernel 1 on one ray of 32 samples, {smoke._ms(floor)} device")
    floor = floor or 0.0
    probe = round_probe(lib, smoke)
    with tempfile.TemporaryDirectory() as tmp:
        recs = {**smoke.check_skip_march(dev, probe),
                **smoke.check_skip_march_unbounded(dev, smoke.write_nerfstudio_scene(f"{tmp}/capture"), probe)}
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
            holds = max(rec[f"{pre}bound_ms"], floor)
            share = lambda v: f"{v / dev_ms:.1%}" if dev_ms and v else "not measured"
            print(f"  {key} {part} [{n_rays} x {steps[key]}]: {rounds} active rounds, the longest chain "
                  f"{chain}; device {smoke._ms(dev_ms)} (call {rec[f'{pre}ms']:.4f} ms); the bound that holds "
                  f"{holds:.4f} ms (bytes-only {rec[f'{pre}bound_ms']:.4f}, floor {floor:.4f}): {share(holds)}; "
                  f"the one-thread-per-ray chain's walk bound {walk:.4f} ms by "
                  f"{'latency' if by_latency >= by_bytes else 'bytes'} (latency term {by_latency:.4f} ms, with "
                  f"device memory's {chain * hbm_ns * 1e-6:.4f}; bytes term {by_bytes:.4f} ms, "
                  f"{walk_bytes / 1e6:.1f} MB): {share(walk)}")
            arith, gathers = rec[f"{pre}arith_device_ms"], rec[f"{pre}chain_device_ms"]
            print(f"    one thread per ray, a round in two: arithmetic alone {smoke._ms(arith)} ({share(arith)} "
                  f"of the march), gathers alone {smoke._ms(gathers)} ({share(gathers)})")
            print(f"    lanes per ray, device ms (the wrapper picks {rec[f'{pre}lanes']}): " + ", ".join(
                f"{n} {smoke._ms(ms)}" for n, ms in rec[f"{pre}lanes_device_ms"].items()))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
