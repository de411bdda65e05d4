"""The traced window: `torch.profiler` over the window, its Chrome trace read
back for the device's operations, the union of their intervals (busy),
device time by kernel name, and the idle gaps labelled by the harness's
host span that was open when each began."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "window"
SPANS = ("step", "occupancy_update", "skip_grid", "view", "fallback")
TOP = 10
NAME_CHARS = 96
# spans walked back from a gap to find the one open at its start: a view
# holds a few tens of fallback spans
LABEL_LOOKBACK = 256


@dataclass
class TraceSummary:
    window_s: float  # the traced window, from its host span
    busy_s: float  # union of the device's operations inside it
    kernels: int  # kernel launches inside it
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # kernel -> (seconds, launches)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host span, idle seconds), all gaps

    def device_seconds(self, match: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds `match`."""
        hits = [v for k, v in self.by_name.items() if match in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self) -> dict:
        ops = sorted(((k[:NAME_CHARS], s) for k, (s, _) in self.by_name.items()), key=lambda kv: -kv[1])
        idle: Dict[str, float] = defaultdict(float)
        longest: Dict[str, float] = defaultdict(float)
        for name, s in self.gaps:
            idle[name] += s
            longest[name] = max(longest[name], s)
        gaps = [[f"{n}.total", s] for n, s in idle.items()] + [[f"{n}.longest", s] for n, s in longest.items()]
        gaps.sort(key=lambda kv: -kv[1])
        return {"device_ops": [[k, s] for k, s in ops[:TOP]], "idle_gaps": gaps[:TOP]}


@contextlib.contextmanager
def profiled(on: bool, device: torch.device):
    """A profiler over the block when `on` (None otherwise); the block runs
    inside the harness's window span."""
    if not on:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def summarize(prof) -> Optional[TraceSummary]:
    """Read the profile's Chrome trace; None when it holds no window span."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window = None
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation":
            if name == WINDOW_SPAN:
                window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            elif name in SPANS:
                spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), name))
        elif cat in DEVICE_CATEGORIES:
            device.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), cat, name))
    if window is None:
        return None
    w0, w1 = window
    device = sorted(d for d in device if d[1] > w0 and d[0] < w1)
    by_name: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    busy, cursor, kernels = 0.0, w0, 0
    gaps: List[Tuple[float, float]] = []
    for start, end, cat, name in device:
        start, end = max(start, w0), min(end, w1)
        if cat == "kernel":
            kernels += 1
            by_name[name][0] += (end - start) * 1e-6
            by_name[name][1] += 1
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if cursor < w1:
        gaps.append((cursor, w1))
    spans.sort()
    starts = [s for s, _, _ in spans]
    labelled = []
    for g0, g1 in gaps:
        label = "host"
        k = bisect.bisect_right(starts, g0) - 1
        for k in range(k, max(-1, k - LABEL_LOOKBACK), -1):
            if spans[k][1] >= g0:
                label = spans[k][2]
                break
        labelled.append((label, (g1 - g0) * 1e-6))
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernels=kernels,
                        by_name={k: (v[0], v[1]) for k, v in by_name.items()}, gaps=labelled)
