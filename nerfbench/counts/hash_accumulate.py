"""`csrc/hashgrid.cu` `hash_accumulate_kernel` and its combine kernel:
Instant-NGP's table gradient of one backward, the (sample, level, corner)
terms sorted by row summed per row into the [rows, F] f32 gradient."""

MATCH = "hash_accumulate"


def bytes_per_call(config: dict, n_samples: int) -> int:
    """Per term (8 a sample and level) its sorted key and value (int32) and
    its product [F] f32 read once; the table gradient written once."""
    field = config["field"]
    size = 2 ** field["log2_hashmap_size"]
    rows = sum(min((r + 1) ** 3, size) for r in field["resolutions"])
    f = field["features_per_level"]
    terms = n_samples * len(field["resolutions"]) * 8
    return terms * (4 + 4 + 4 * f) + rows * f * 4
