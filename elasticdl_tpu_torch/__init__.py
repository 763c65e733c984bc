"""PyTorch/CUDA port of elasticdl_tpu.

Same sub-package layout as ``elasticdl_tpu`` (``serve/engine.py`` here
ports ``elasticdl_tpu/serve/engine.py``), same wire protocol, same
export format. Imports ``torch`` and never JAX or the JAX package.
Hand-written Hopper kernels live under ``ops/csrc/`` and are built with
``nvcc`` at first use; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.
"""
