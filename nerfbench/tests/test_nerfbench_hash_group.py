"""The byte model of `train.hash_group_roofline` by hand, and its reader's
silence where a trace holds no `hash_group` kernel."""

from types import SimpleNamespace

from nerfbench import counts, harness

SMALL = {"field": {"resolutions": [4, 8], "log2_hashmap_size": 6, "features_per_level": 2}}


def test_hash_group_bytes():
    # 10 samples x 2 levels x 8 corners = 160 terms, a key and a value of 4 bytes each
    assert counts.kernel("hash_group").bytes_per_call(SMALL, 10) == 160 * 8


def test_full_size_bound():
    config = harness.load_config(harness.load_benchmark(), "instantngp")
    n = counts.kernel("hash_group").bytes_per_call(config, 819_200)
    assert n == 819_200 * 16 * 8 * 8
    assert abs(n / counts.peaks()["hbm_bytes_per_s"] * 1e3 - 0.2504) < 0.0001


def test_silent_without_the_kernels():
    trace = SimpleNamespace(device_seconds=lambda match: (0.0, 0))
    reading = SimpleNamespace(trace=trace, config={}, counters={"samples": [819_200]})
    assert harness.metric_reader("train.hash_group_roofline")(reading) is None
    assert harness.metric_reader("train.hash_group_roofline")(SimpleNamespace(trace=None)) is None
