"""siga-tpu-torch: the siga-tpu assembler on PyTorch and CUDA.

A port of the JAX package `siga_tpu` (which stays the reference) to one
NVIDIA Hopper GPU.  Module names mirror `siga_tpu`'s.  The framework-free
layers (`io/`, `core/`, `index/fm.py`, `overlap/`, `graph/`, `ml/`, the
command option tables and the C++ runtime in `native/`) are imported from
`siga_tpu`, not copied; this package never imports jax.
"""

__version__ = "0.1.0"
