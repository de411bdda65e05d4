"""The Instant-NGP cell at the tiny size on the CPU (the card check
skipped): a sound run is correct, traced and untraced, and agrees with the
reference within the plain path's tolerances; a run with the hash broken
underneath is not correct; the byte models of its two kernels against
values worked by hand."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_run

from nerfbench import counts, harness
from tinynerf_tpu_torch.ops import hashgrid

CELL = "instantngp.train.early"
# the program's plain path against the float32 reference (as
# test_nerfbench_run.py's TRAIN)
TRAIN = {"first_loss_gap": 1e-2, "loss_gap": 1e-2, "count_gap": 0.0, "grad_gap": 5e-2, "update_gap": 5e-2}
# two levels of 3 and 4 cells a side in a table of 2^6 rows: 4^3 = 64 dense
# rows, then 64 hashed ones
SMALL = {"field": {"kind": "hashgrid", "resolutions": [3, 4], "log2_hashmap_size": 6, "features_per_level": 2}}


@pytest.mark.parametrize("tracing", [False, True])
def test_sound_run_is_correct(tracing):
    result = tiny_run(CELL, tracing=tracing)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    _, per_layer = harness.cell_metrics(harness.load_benchmark(), CELL)
    names = {"setup_s", "train_rays_per_s", "peak_device_gb"} if not tracing else {m["name"] for m in per_layer}
    assert set(result["metrics"]) <= names and (tracing or set(result["metrics"]) == names)


def test_reference_agrees_with_the_plain_path():
    result = tiny_run(CELL, limits=TRAIN)
    assert result["correct"], result["checks"]


def _one_prime_wrong(monkeypatch):
    monkeypatch.setattr(hashgrid, "PRIMES", (1, 2654435761, 805459863))


def _hashed_level_indexed_densely(monkeypatch):
    dense = hashgrid.HashLayout.hashed

    def first_hashed_dense(self):
        flags = list(dense.fget(self))
        flags[flags.index(True)] = False  # its rows: the dense index, mod T
        return tuple(flags)

    corners = hashgrid.level_corners

    def wrapped(pos, layout, level):
        rows, w = corners(pos, layout, level)
        if level == list(dense.fget(layout)).index(True):
            off = layout.offsets[level]
            res = layout.resolutions[level]
            v = torch.clamp((pos.float() + 1.0) * 0.5 * float(res), 0.0, float(res))
            o = torch.clamp(torch.floor(v), 0.0, float(res - 1)).long()
            r1 = res + 1
            rows = torch.stack([((o[:, 0] + dx) * r1 + o[:, 1] + dy) * r1 + o[:, 2] + dz
                                for dx, dy, dz in hashgrid.CORNERS_3D], dim=-1) % layout.size + off
        return rows, w

    monkeypatch.setattr(hashgrid, "level_corners", wrapped)


@pytest.mark.parametrize("fault", [_one_prime_wrong, _hashed_level_indexed_densely])
def test_a_broken_hash_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not tiny_run(CELL)["correct"]


def test_hash_encode_bytes():
    # 64 + 64 rows of 2 bf16 (4 bytes); per sample 12 bytes in, 2 x 2 x 4 out
    assert counts.kernel("hash_encode").bytes_per_call(SMALL, 10) == 10 * 12 + 128 * 4 + 10 * 16


def test_hash_accumulate_bytes():
    # 10 samples x 2 levels x 8 corners = 160 terms of 4 + 4 + 8 bytes; 128 rows x 2 x 4
    assert counts.kernel("hash_accumulate").bytes_per_call(SMALL, 10) == 160 * 16 + 128 * 8


def test_full_size_bounds():
    """The bounds PERF.md's kernel table gives at the cell's widths and
    819,200 samples."""
    config = harness.load_config(harness.load_benchmark(), "instantngp")
    hbm = counts.peaks()["hbm_bytes_per_s"]
    enc = counts.kernel("hash_encode").bytes_per_call(config, 819_200)
    acc = counts.kernel("hash_accumulate").bytes_per_call(config, 819_200)
    assert enc == 819_200 * 12 + 6_098_925 * 4 + 819_200 * 128
    assert acc == 819_200 * 128 * 16 + 6_098_925 * 8
    assert abs(enc / hbm * 1e3 - 0.0415) < 0.0001 and abs(acc / hbm * 1e3 - 0.5153) < 0.0001
