"""The program's spans (`nerfbench/spans.py`) on a small synthetic Chrome
trace: nested program spans on two threads, launches matched to their
device work by correlation id, a sync inside a program span and syncs
outside, and idle gaps.  The harness's own summary (`nerfbench/trace.py`)
reads this trace as it always has; the spans count device time
inclusively, across threads, by correlation id; a CPU profile of the
program's spans, and the command line, read back."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from nerfbench import spans, trace

PROGRAM = ("train_step", "render.field", "train_step.backward", "field.table_grad", "serve.view",
           "serve.readback")


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if args:
        e["args"] = args
    return e


def _events() -> list:
    """A window of 1000 us: the harness's `step` (10-500) and `view`
    (600-950); the program's `train_step` holding `render.field` and
    `train_step.backward`, with `field.table_grad` on a second thread; a
    view with one readback; an unlisted annotation."""
    return [
        _x("user_annotation", "window", 0.0, 1000.0),
        _x("user_annotation", "step", 10.0, 490.0),
        _x("user_annotation", "view", 600.0, 350.0),
        _x("user_annotation", "train_step", 20.0, 460.0),
        _x("user_annotation", "render.field", 30.0, 70.0),
        _x("user_annotation", "train_step.backward", 150.0, 250.0),
        _x("user_annotation", "field.table_grad", 160.0, 140.0, tid=2),
        _x("user_annotation", "serve.view", 610.0, 330.0),
        _x("user_annotation", "serve.readback", 700.0, 60.0),
        _x("user_annotation", "unlisted", 40.0, 5.0),
        _x("cuda_runtime", "cudaLaunchKernel", 40.0, 4.0, correlation=1),
        _x("kernel", "k_field", 50.0, 20.0, pid=0, tid=7, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 170.0, 4.0, tid=2, correlation=2),
        _x("kernel", "k_grad", 200.0, 50.0, pid=0, tid=7, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 450.0, 3.0, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoD", 460.0, 10.0, pid=0, tid=7, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 520.0, 4.0, correlation=4),
        _x("kernel", "k_step_tail", 530.0, 10.0, pid=0, tid=7, correlation=4),
        _x("cuda_runtime", "cudaMemsetAsync", 620.0, 2.0, correlation=7),
        _x("gpu_memset", "Memset", 625.0, 5.0, pid=0, tid=7, correlation=7),
        _x("cuda_runtime", "cudaMemcpyAsync", 705.0, 3.0, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoH", 710.0, 5.0, pid=0, tid=7, correlation=5),
        _x("cuda_runtime", "cudaStreamSynchronize", 712.0, 40.0),
        _x("cuda_driver", "cuLaunchKernel", 800.0, 4.0, correlation=6),
        _x("kernel", "k_view", 820.0, 30.0, pid=0, tid=7, correlation=6),
        _x("kernel", "k_unlaunched", 900.0, 10.0, pid=0, tid=7, correlation=99),
        _x("cuda_runtime", "cudaStreamSynchronize", 960.0, 30.0),
        _x("cuda_runtime", "cudaDeviceSynchronize", 20.0, 1.0, tid=3),
        _x("kernel", "k_outside", 1100.0, 10.0, pid=0, tid=7, correlation=8),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 50.0, "id": 1, "pid": 0, "tid": 7},
    ]


class _Profile:
    """What `trace.summarize` reads of a profiler: its Chrome trace."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


@pytest.fixture
def summary():
    return trace.summarize(_Profile(_events()))


@pytest.fixture
def program():
    return spans.summarize_events(_events())


def test_harness_summary_reads_as_before(summary):
    """The values `nerfbench/trace.py` gives on this trace, program spans
    and all."""
    assert summary.window_s == 0.001 and summary.busy_s == 0.00014 and summary.kernels == 5
    assert summary.by_name == {
        "k_field": (1.9999999999999998e-05, 1), "k_grad": (4.9999999999999996e-05, 1),
        "k_step_tail": (9.999999999999999e-06, 1), "k_view": (2.9999999999999997e-05, 1),
        "k_unlaunched": (9.999999999999999e-06, 1)}
    assert summary.gaps == [
        ("host", 4.9999999999999996e-05), ("step", 0.00013), ("step", 0.00020999999999999998),
        ("step", 5.9999999999999995e-05), ("host", 8.499999999999999e-05), ("view", 7.999999999999999e-05),
        ("view", 0.00010499999999999999), ("view", 4.9999999999999996e-05), ("view", 8.999999999999999e-05)]
    b = summary.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"] == [
        ["k_grad", 4.9999999999999996e-05], ["k_view", 2.9999999999999997e-05],
        ["k_field", 1.9999999999999998e-05], ["k_step_tail", 9.999999999999999e-06],
        ["k_unlaunched", 9.999999999999999e-06]]
    assert b["idle_gaps"] == [
        ["step.total", 0.00039999999999999996], ["view.total", 0.000325],
        ["step.longest", 0.00020999999999999998], ["host.total", 0.00013499999999999997],
        ["view.longest", 0.00010499999999999999], ["host.longest", 8.499999999999999e-05]]


def test_the_program_lists_the_spans():
    assert set(PROGRAM) <= set(spans.program_span_names())
    assert not set(trace.SPANS) & set(spans.program_span_names())


def test_device_time_is_inclusive_across_threads(program):
    """k_field counts in `train_step` and `render.field`; k_grad, launched
    from the second thread, in `field.table_grad` and in the first thread's
    `train_step.backward` and `train_step`; the copy and the set by their
    calls; k_step_tail (launched in the harness's span alone) and the
    kernel with no launch in none."""
    us = 1e-6
    assert program.device == pytest.approx({
        "train_step": 80 * us, "render.field": 20 * us, "train_step.backward": 50 * us,
        "field.table_grad": 50 * us, "serve.view": 40 * us, "serve.readback": 5 * us}, rel=1e-12)
    assert program.host == pytest.approx({
        "train_step": (460 * us, 1), "render.field": (70 * us, 1), "train_step.backward": (250 * us, 1),
        "field.table_grad": (140 * us, 1), "serve.view": (330 * us, 1), "serve.readback": (60 * us, 1)},
        rel=1e-12)


def test_syncs_outside_program_spans_are_not_counted(program):
    """The readback's sync counts in its innermost span, a sync on another
    thread at the step's start in the step; the harness's sync after the
    view counts nowhere."""
    assert program.syncs == {"serve.readback": 1, "train_step": 1}


def test_idle_gaps_by_innermost_program_span(summary, program):
    """The same gaps as the harness's summary, each labelled by the
    innermost program span open at its start."""
    assert [label for label, _ in program.idle] == [
        "none", "render.field", "field.table_grad", "train_step", "none", "serve.view", "serve.readback",
        "serve.view", "serve.view"]
    assert [s for _, s in program.idle] == [s for _, s in summary.gaps]
    b = program.breakdown()
    assert set(b) == {"program_device", "program_host", "program_idle"}
    assert b["program_device"][0] == ["train_step", pytest.approx(80e-6)]
    assert b["program_host"][0] == ["train_step", pytest.approx(460e-6), 1, 1]
    assert b["program_idle"][0] == ["serve.view.total", pytest.approx(220e-6)]


def test_a_trace_without_program_spans_reads_none():
    assert spans.summarize_events([e for e in _events() if e["name"] not in PROGRAM]) is None


def test_a_trace_without_a_window_is_read_whole(program):
    """A trace of `train()`'s profiler has no harness window: the launches,
    spans and syncs read alike, and the gaps cover the trace's extent."""
    whole = spans.summarize_events([e for e in _events() if e["name"] != trace.WINDOW_SPAN])
    assert whole.device == pytest.approx(program.device, rel=1e-12)
    assert whole.host == program.host and whole.syncs == program.syncs
    # 10 us (the step's start) to 1110 us (k_outside's end), 150 us busy
    assert sum(s for _, s in whole.idle) == pytest.approx(950e-6, rel=1e-12)
    assert whole.idle[0] == ("none", pytest.approx(40e-6))


def test_a_cpu_profile_of_the_program_spans(tmp_path):
    """The program's `span()` under a CPU profiler: nested spans read back
    with their calls; no device, so no device time."""
    from tinynerf_tpu_torch.utils.trace import span

    x = torch.ones(64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with span("train_step"):
                with span("render.field"):
                    x = x * 2
                with span("train_step.adam"):
                    x = x + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        got = spans.summarize_events(json.load(f)["traceEvents"])
    assert {k: n for k, (_, n) in got.host.items()} == {"train_step": 2, "render.field": 2, "train_step.adam": 2}
    assert got.host["train_step"][0] >= got.host["render.field"][0] + got.host["train_step.adam"][0]
    assert got.device == {} and got.syncs == {}


def test_command_line(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert spans.main([str(path)]) == 0
    b = json.loads(out.getvalue())
    assert len(b["program_device"]) == 6 and b["program_host"][0][:2] == ["train_step", pytest.approx(460e-6)]
    path.write_text(json.dumps({"traceEvents": [e for e in _events() if e["name"] not in PROGRAM]}))
    assert spans.main([str(path)]) == 1
