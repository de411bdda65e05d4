"""Kernel 7, `csrc/octbuild.cu` `quad_build_kernel` (and
`quad_build_any_kernel`): one launch per K-Planes plane and field call,
the plane [r, r, F] f32 in, its quad table [(r-1)^2, 4F] bf16 out."""

MATCH = "quad_build"
OUT_BYTES = 2  # bf16


def launches_per_call(config: dict) -> int:
    field = config["field"]
    return len(field["resolutions"]) * len(field["pairs"])


def bytes_per_call(config: dict, n_samples: int = 0) -> int:
    """Every plane read once and its quad table written once."""
    field = config["field"]
    f = field["features"]
    return len(field["pairs"]) * sum(4 * r * r * f + OUT_BYTES * 4 * f * (r - 1) ** 2 for r in field["resolutions"])
