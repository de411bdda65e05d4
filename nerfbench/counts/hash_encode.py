"""`csrc/hashgrid.cu` `hash_encode_kernel`: Instant-NGP's lookup of one
training step's kept samples over every level, from the bf16 copy of the
table.  The occupancy sweep's launches (16 in a 64-step window) are in the
kernel's device time and not in this bound, so the share reads a few
percent low."""

MATCH = "hash_encode"


def bytes_per_call(config: dict, n_samples: int) -> int:
    """Positions [n, 3] f32 and the bf16 table read once, the features
    [n, L F] f32 written once."""
    field = config["field"]
    size = 2 ** field["log2_hashmap_size"]
    rows = sum(min((r + 1) ** 3, size) for r in field["resolutions"])
    f = field["features_per_level"]
    return n_samples * 12 + rows * f * 2 + n_samples * len(field["resolutions"]) * f * 4
