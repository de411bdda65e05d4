"""tinynerf_tpu_torch: the PyTorch/CUDA port of tinynerf_tpu, for one NVIDIA H100.

The JAX package `tinynerf_tpu` stays the reference; this package mirrors its
module names (ops, core, models, data, train, utils) and is tested against
it.  The ported slices are K-Planes serving (`render_only`) and K-Planes
training on one GPU (`train`, dense march), with every TPU kernel on their
path hand-written in CUDA (`csrc/`): the packed and dense transmittance
weights and their backwards, the bitonic sort and the windowed
table-gradient accumulation.  Importing the package imports neither jax
nor optax and builds nothing; kernels are compiled at their first launch.
"""

__version__ = "0.1.0"
