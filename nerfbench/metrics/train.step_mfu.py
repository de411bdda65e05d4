"""The training step's share of the card's bf16 peak: the forward and
backward (3x the forward) operations of the field's and decoders' matrix
products for the samples each step kept, over the traced window's seconds
and 989 TFLOP/s."""

from nerfbench import counts


def read(r):
    samples = r.counters.get("samples")
    if not samples or r.window_s <= 0:
        return None
    per_sample, _ = counts.forward_flops(counts.flops(r.config_name), direction_per_sample=True)
    ops = 3.0 * per_sample * sum(samples)
    return 100.0 * ops / (r.window_s * counts.peaks()["bf16_flops_per_s"])
