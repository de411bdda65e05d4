"""Kernel 5, `csrc/table_grad.cu` `windowed_accumulate_kernel` (and its
register form `windowed_accumulate_owner_kernel`): the K-Planes table
gradient of one backward, the three projections' bf16 payload rows of the
kept samples accumulated into [P, cells, 4 corners x F] f32 over the finest
plane's cells, in windows of 64 cells."""

MATCH = "windowed_accumulate"
CORNERS = 4
WINDOW = 64
ROW_ALIGN = 128  # payload values per row, padded
PAYLOAD_BYTES = 2  # bf16


def bytes_per_call(config: dict, n_samples: int) -> int:
    """Payload rows of the samples read once, the window offsets read once,
    the cell table written once."""
    field = config["field"]
    p = len(field["pairs"])
    f = field["features"] * len(field["resolutions"])
    row = -(-(f + 2 * CORNERS + 1) // ROW_ALIGN) * ROW_ALIGN * PAYLOAD_BYTES
    r = max(field["resolutions"])
    cells = -(-((r - 1) ** 2) // WINDOW) * WINDOW
    return p * n_samples * row + 4 * p * (cells // WINDOW + 1) + 4 * p * cells * CORNERS * f
