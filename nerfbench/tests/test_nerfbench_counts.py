"""The operation and byte counts against values worked by hand on small
shapes."""

from __future__ import annotations

from nerfbench import counts

KPLANES = {"field": {"kind": "kplanes", "resolutions": [3, 5], "features": 2, "pairs": [[0, 1], [0, 2], [1, 2]]}}
COBAFA = {"field": {"kind": "cobafa", "basis_res": [3, 4], "channels": [2, 1], "coef_res": 2}}


def test_windowed_accumulate_bytes():
    # F = 2 x 2 scales = 4; a bf16 payload row of 4 + 2 x 4 + 1 = 13 values
    # padded to 128 (256 bytes); the finest plane's 4 x 4 = 16 cells padded
    # to one window of 64: 3 x 10 x 256 rows + 3 x 2 x 4 offsets + 3 x 64 x
    # 4 corners x 4 values x 4 bytes
    assert counts.kernel("windowed_accumulate").bytes_per_call(KPLANES, 10) == 7680 + 24 + 12288


def test_oct_accumulate_bytes():
    # grids: coefficients (2, 2 channels), bases (3, 2) and (4, 1); per
    # sample 4F + 32 + 4 bytes, per grid (r-1)^3 cells x 8F f32
    per_sample = (8 + 36) + (8 + 36) + (4 + 36)
    cells = 1 * 64 + 8 * 64 + 27 * 32
    assert counts.kernel("oct_accumulate").bytes_per_call(COBAFA, 5) == 5 * per_sample + cells


def test_quad_build_bytes():
    model = counts.kernel("quad_build")
    # per plane r^2 F f32 in, (r-1)^2 x 4F bf16 out; three planes a scale
    per_scale = [4 * 9 * 2 + 2 * 8 * 4, 4 * 25 * 2 + 2 * 8 * 16]
    assert model.bytes_per_call(KPLANES) == 3 * sum(per_scale)
    assert model.launches_per_call(KPLANES) == 6


def test_forward_flops():
    table = {"sample_matmuls": [[4, 3], [3, 1]], "direction_matmuls": [[2, 3]]}
    assert counts.forward_flops(table, direction_per_sample=True) == (2 * (12 + 3 + 6), 0)
    assert counts.forward_flops(table, direction_per_sample=False) == (2 * 15, 12)


def test_full_size_bounds_match_the_kernel_table():
    """The bounds PERF.md's kernel table gives at the cells' widths."""
    from nerfbench import harness

    bench = harness.load_benchmark()
    kp = harness.load_config(bench, "kplanes")
    hbm = counts.peaks()["hbm_bytes_per_s"]
    assert abs(counts.kernel("windowed_accumulate").bytes_per_call(kp, 819_200) / hbm * 1e3 - 0.548) < 0.001
    assert abs(counts.kernel("quad_build").bytes_per_call(kp) / hbm * 1e3 - 0.1185) < 0.0001
