"""siga-tpu-torch: the siga-tpu assembler on PyTorch and CUDA.

A port of the JAX package `siga_tpu` (which stays the reference) to one
NVIDIA Hopper GPU.  Module names mirror `siga_tpu`'s.  The package stands
alone: it imports neither jax nor `siga_tpu`.  The framework-free layers it
needs (`constants.py`, `core/`, `io/`, `index/fm.py`, `index/kmerdistr.py`,
`overlap/builder.py`, `graph/`, `correct/`, `ml/`, the host-only commands,
the option tables of `cli.py` and the C++ runtime in `native/`) are copies
of the JAX package's modules under the same subpaths, changed only in where
they import from (and `native/` builds into `_build/`), so that their
outputs stay byte-equal to the reference's.
"""

__version__ = "0.1.0"
