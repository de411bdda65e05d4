#!/usr/bin/env python3
"""The benchmark of `tinynerf_tpu_torch` on one card.

    python3 nerfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell `<name>` of BENCHMARK.json once, from the root of a
checkout: set-up (inputs and parameters made from the seed on the card,
the kernel library from the checkout's build cache, warm-up), a window of
`--seconds` (`--trace 1`: a traced window of the traffic's `trace_steps`
or `trace_views`, and the per-layer metrics), the comparison with the
plain reference, and one JSON line last on standard output, each number
compared beside its limit last on standard error.  Exits non-zero, with
no result, without enough cards or when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's root
THREADS = 4  # host threads of the one process that drives the card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from nerfbench import harness

    bench = harness.load_benchmark()
    chips = harness.entry(bench["workloads"], args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nerfbench: {args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, bench)
    found = harness.forbidden_modules()
    if found:
        print(f"nerfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
