"""tinynerf_tpu_torch: the PyTorch/CUDA port of tinynerf_tpu, for one NVIDIA H100.

The JAX package `tinynerf_tpu` stays the reference; this package mirrors its
module names (ops, core, models, data, train, utils) and is tested against
it.  The ported slices are serving (`render_only`) and training on one GPU
(`train`, dense march) of the K-Planes and Cobafa fields, with every TPU
kernel on their path hand-written in CUDA (`csrc/`): the packed and dense
transmittance weights and their backwards, the bitonic sort, the windowed
table-gradient accumulation and the oct cell-pack build.  Importing the
package imports neither jax, optax nor the JAX package and builds nothing;
kernels (and the native PNG loader) are compiled at their first use.
"""

__version__ = "0.1.0"
