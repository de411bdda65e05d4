"""`csrc/hashgrid.cu` `hash_group_*` kernels: Instant-NGP's table-gradient
terms of one backward grouped by row, each row's in term order (the stable
sort of the row keys with the term indices as values)."""

MATCH = "hash_group"


def bytes_per_call(config: dict, n_samples: int) -> int:
    """The grouped key and value (int32) of every term (8 a sample and
    level) written once: what any grouping has to write, whatever it
    reads."""
    return n_samples * len(config["field"]["resolutions"]) * 8 * (4 + 4)
