"""tinynerf_tpu_torch: the PyTorch/CUDA port of tinynerf_tpu, for one NVIDIA H100.

The JAX package `tinynerf_tpu` stays the reference; this package mirrors its
module names (ops, core, models, data, train, utils) and is tested against
it.  The ported slices are serving (`render_only`) and training on one GPU
(`train`) of the vanilla, K-Planes and Cobafa fields, on Blender-synthetic
or nerfstudio data, AABB or unbounded scenes, with skip or dense marching,
and every TPU kernel hand-written in CUDA (`csrc/`): the packed and dense
transmittance weights and their backwards, the sort of the table-gradient
keys, the windowed table-gradient accumulation, the oct and quad cell-pack
builds; both skip marches' round loops are CUDA kernels too.  Importing the
package imports neither jax, optax nor the JAX package and builds nothing;
kernels (and the native PNG loader) are compiled at their first use.
"""

__version__ = "0.1.0"
