"""Kernel 7's share of its bytes bound while serving: each field call's
nine quad builds (`counts/quad_build.py`, 3.35 TB/s), over the profiler's
device time of the kernel."""

from nerfbench import counts

KERNEL = "quad_build"


def read(r):
    return counts.roofline(r, KERNEL)
