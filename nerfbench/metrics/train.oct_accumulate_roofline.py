"""CoBaFa's oct accumulation kernel's share of its bytes bound: each
backward's bound over the seven grids from the kept samples of its step
(`counts/oct_accumulate.py`, 3.35 TB/s), summed, over the profiler's
device time of the kernel."""

from nerfbench import counts

KERNEL = "oct_accumulate"


def read(r):
    return counts.roofline(r, KERNEL)
