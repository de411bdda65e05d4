#!/usr/bin/env python3
"""The program's spans in a Chrome trace of `torch.profiler`: the device
time launched inside each, its host seconds and calls, the host syncs made
in it, and the idle gaps by the innermost one open when each began.

    python3 nerfbench/spans.py <trace.json>

reads a trace of the program (`--profile_start` / `--profile_count` write
one as `<experiment>/trace.json`) and prints one JSON object: device
seconds by span, host seconds, calls and syncs by span, and the idle
seconds by span, total and longest.

The spans are those listed in `tinynerf_tpu_torch/utils/trace.py` (none
where the program lists none).  A device operation (kernel, copy or set)
is matched to the runtime or driver call that launched it by
`args.correlation`, and counted for every program span open on any thread
at that call: the table gradient, launched from autograd's thread, counts
in `field.table_grad` and in the main thread's `train_step.backward` and
`train_step`.  A sync or an idle gap goes to the innermost program span
open at it ("none" outside every one).  Everything is read inside the
harness's window span where the trace has one, else over the whole trace.
The benchmark's traced runs do not read these yet: `nerfbench/trace.py`
keeps no events."""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's root

from nerfbench.trace import DEVICE_CATEGORIES, WINDOW_SPAN  # noqa: E402

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
NO_PROGRAM_SPAN = "none"


@dataclass
class SpanSummary:
    device: Dict[str, float] = field(default_factory=dict)  # span -> device seconds launched in it
    host: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # span -> (host seconds, calls)
    syncs: Dict[str, int] = field(default_factory=dict)  # innermost span -> host syncs
    idle: List[Tuple[str, float]] = field(default_factory=list)  # (innermost span, idle seconds), every gap

    def breakdown(self) -> dict:
        """Device seconds by span; host rows of seconds, calls and syncs;
        idle seconds by span, total and longest; each largest first."""
        device = sorted(([k, s] for k, s in self.device.items()), key=lambda kv: -kv[1])
        host = sorted(([k, s, n, self.syncs.get(k, 0)] for k, (s, n) in self.host.items()), key=lambda row: -row[1])
        return {"program_device": device, "program_host": host, "program_idle": _idle_rows(self.idle)}


def _idle_rows(gaps: List[Tuple[str, float]]) -> list:
    idle: Dict[str, float] = defaultdict(float)
    longest: Dict[str, float] = defaultdict(float)
    for name, s in gaps:
        idle[name] += s
        longest[name] = max(longest[name], s)
    rows = [[f"{n}.total", s] for n, s in idle.items()] + [[f"{n}.longest", s] for n, s in longest.items()]
    rows.sort(key=lambda kv: -kv[1])
    return rows


def program_span_names() -> Tuple[str, ...]:
    """The program's span names, or none where the program lists none."""
    try:
        from tinynerf_tpu_torch.utils.trace import NAMES
    except ImportError:
        return ()
    return tuple(NAMES)


def _window(events: list) -> Tuple[float, float]:
    """The harness's window span, else the extent of the trace."""
    ends = []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts = float(e.get("ts", 0.0))
        if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN:
            return ts, ts + float(e["dur"])
        ends.append((ts, ts + float(e.get("dur", 0.0))))
    return (min(s for s, _ in ends), max(e for _, e in ends)) if ends else (0.0, 0.0)


def _gap_starts(device: List[Tuple[float, float, object]], w0: float, w1: float) -> List[Tuple[float, float]]:
    """(start, seconds) of each stretch of the window with no device
    operation running."""
    gaps, cursor = [], w0
    for start, end, _ in sorted(device):
        if start > cursor:
            gaps.append((cursor, (start - cursor) * 1e-6))
        cursor = max(cursor, end)
    if cursor < w1:
        gaps.append((cursor, (w1 - cursor) * 1e-6))
    return gaps


def summarize_events(events: list, names: Optional[Iterable[str]] = None) -> Optional[SpanSummary]:
    """The spans `names` (the program's by default) in a Chrome trace's
    events; None when none of them was recorded.  One sweep in time over
    the spans' opening and closing, the launches of the device's
    operations, the syncs and the idle gaps' starts; at equal times a span
    opens before, and closes after, what falls there."""
    wanted = set(program_span_names() if names is None else names)
    w0, w1 = _window(events)
    spans, syncs, launch_at, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, ts = e.get("cat", ""), e.get("name", ""), float(e.get("ts", 0.0))
        if cat == "user_annotation":
            if name in wanted and w0 <= ts <= w1:
                spans.append((ts, ts + float(e["dur"]), name))
        elif cat in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = ts
            if name in SYNCS and w0 <= ts <= w1:
                syncs.append(ts)
        elif cat in DEVICE_CATEGORIES:
            end = ts + float(e["dur"])
            if end > w0 and ts < w1:
                device.append((max(ts, w0), min(end, w1), e.get("args", {}).get("correlation")))
    if not spans:
        return None
    gaps = _gap_starts(device, w0, w1)
    OPEN, QUERY, CLOSE = 0, 1, 2
    timeline = [(s, OPEN, i) for i, (s, _, _) in enumerate(spans)]
    timeline += [(e, CLOSE, i) for i, (_, e, _) in enumerate(spans)]
    timeline += [(launch_at[c], QUERY, ("device", (e - s) * 1e-6)) for s, e, c in device if c in launch_at]
    timeline += [(t, QUERY, ("sync", 0.0)) for t in syncs]
    timeline += [(t, QUERY, ("gap", k)) for k, (t, _) in enumerate(gaps)]
    timeline.sort(key=lambda item: (item[0], item[1]))
    span_device: Dict[str, float] = defaultdict(float)
    span_syncs: Dict[str, int] = defaultdict(int)
    gap_label = [NO_PROGRAM_SPAN] * len(gaps)
    open_spans: Dict[int, Tuple[float, str]] = {}
    for _, kind, what in timeline:
        if kind == OPEN:
            open_spans[what] = (spans[what][0], spans[what][2])
        elif kind == CLOSE:
            open_spans.pop(what, None)
        elif open_spans:
            tag, value = what
            if tag == "device":
                for name in {n for _, n in open_spans.values()}:
                    span_device[name] += value
            else:
                innermost = max(open_spans.values())[1]
                if tag == "sync":
                    span_syncs[innermost] += 1
                else:
                    gap_label[value] = innermost
    host: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, e, name in spans:
        host[name][0] += (e - s) * 1e-6
        host[name][1] += 1
    return SpanSummary(device=dict(span_device), host={k: (v[0], v[1]) for k, v in host.items()},
                       syncs=dict(span_syncs), idle=[(label, s) for label, (_, s) in zip(gap_label, gaps)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", type=Path, help="a Chrome trace of torch.profiler")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        summary = summarize_events(json.load(f)["traceEvents"])
    if summary is None:
        print(f"nerfbench: no span of the program in {args.trace}", file=sys.stderr)
        return 1
    print(json.dumps(summary.breakdown()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
