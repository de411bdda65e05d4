"""Serving's share of the card's bf16 peak: the forward operations of the
field's and decoders' matrix products for the packed samples (the color
decoder's direction rows once per ray) and for the dense fallback's
samples (every sample of each re-rendered ray), over the traced window's
seconds and 989 TFLOP/s."""

from nerfbench import counts


def read(r):
    rays = r.counters.get("rays")
    if not rays or r.window_s <= 0:
        return None
    table = counts.flops(r.config_name)
    per_sample, per_ray = counts.forward_flops(table, direction_per_sample=False)
    dense, _ = counts.forward_flops(table, direction_per_sample=True)
    n_samples = r.config["train"]["n_samples"]
    ops = (per_sample * r.counters["packed_samples"] + per_ray * rays
           + dense * n_samples * r.counters["fallback_rays"])
    return 100.0 * ops / (r.window_s * counts.peaks()["bf16_flops_per_s"])
