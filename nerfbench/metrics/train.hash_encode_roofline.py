"""Instant-NGP's lookup kernel's share of its bytes bound: each step's
bound from its kept samples (`counts/hash_encode.py`, 3.35 TB/s), summed,
over the profiler's device time of the kernel."""

from nerfbench import counts

KERNEL = "hash_encode"


def read(r):
    return counts.roofline(r, KERNEL)
