"""Instant-NGP's grouping of the table-gradient terms by row, as a share of
its bytes bound: each backward's bound from the kept samples of its step
(`counts/hash_group.py`, 3.35 TB/s), summed, over the profiler's device
time of the `hash_group` kernels.  None where the trace holds none of them."""

from nerfbench import counts

KERNEL = "hash_group"


def read(r):
    return counts.roofline(r, KERNEL)
