"""Kernel 5's share of its bytes bound: each launch's bound from the kept
samples of its step (`counts/windowed_accumulate.py`, 3.35 TB/s), summed,
over the profiler's device time of the kernel."""

from nerfbench import counts

KERNEL = "windowed_accumulate"


def read(r):
    return counts.roofline(r, KERNEL)
