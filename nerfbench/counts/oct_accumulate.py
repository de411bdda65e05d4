"""`csrc/table_grad.cu` `oct_accumulate_kernel`: CoBaFa's table gradient of
one backward, per grid (the coefficient grid and each basis grid) the kept
samples' cotangent g [n, F], corner weights [n, 8] and cell [n] accumulated
into [cells, 8 corners x F] f32."""

MATCH = "oct_accumulate"


def bytes_per_call(config: dict, n_samples: int) -> int:
    """g, w and cell of every sample read once, each grid's cell table
    written once, summed over the seven grids."""
    field = config["field"]
    grids = [(field["coef_res"], len(field["basis_res"]))] + list(zip(field["basis_res"], field["channels"]))
    return sum(n_samples * (4 * f + 4 * 8 + 4) + 4 * (r - 1) ** 3 * 8 * f for r, f in grids)
