"""On the card: the control (one precision below the configuration's
bfloat16) comes out not correct under each cell's limits, and the program
as stated comes out correct, on one seed, with the training pool cut to a
few views so that a test run holds it (the steps keep their shapes)."""

from __future__ import annotations

import pytest

from nerfbench import calibrate, check, harness

WORKLOADS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, cuda_device):
    bench = harness.load_benchmark()
    cell = harness.entry(bench["workloads"], workload)
    config = harness.load_config(bench, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    if traffic["kind"] == "train":
        rec = calibrate.train_seed(config, dict(traffic, views=4), 4242, cuda_device)
    else:
        rec = calibrate.serve_seed(config, traffic, 4242, cuda_device)
    limits = check.load_limits(workload)
    sound = check.judge(rec["program"], limits)
    control = check.judge(rec["control"], limits)
    assert all(c["ok"] for c in sound.values()), sound
    assert not all(c["ok"] for c in control.values()), control
