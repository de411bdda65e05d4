"""Instant-NGP's table-gradient accumulation's share of its bytes bound:
each backward's bound from the kept samples of its step
(`counts/hash_accumulate.py`, 3.35 TB/s), summed, over the profiler's
device time of the accumulation and its combine kernel."""

from nerfbench import counts

KERNEL = "hash_accumulate"


def read(r):
    return counts.roofline(r, KERNEL)
