"""tinynerf_tpu_torch: the PyTorch/CUDA port of tinynerf_tpu, for one NVIDIA H100.

The JAX package `tinynerf_tpu` stays the reference; this package mirrors its
module names (ops, core, models, data, train, utils) and is tested against
it.  The ported slice is the K-Planes serving path (`render_only`), with the
packed and dense transmittance-weights kernels hand-written in CUDA
(`csrc/`).  Importing the package imports neither jax nor optax and builds
nothing; kernels are compiled at their first launch.
"""

__version__ = "0.1.0"
