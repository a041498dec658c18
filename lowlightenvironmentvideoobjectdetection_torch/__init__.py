"""PyTorch/CUDA port of the LLVOD video object detection framework.

The JAX package ``lowlightenvironmentvideoobjectdetection_tpu`` is the
reference; this package mirrors its module paths and names. It imports torch
and numpy only: the JAX package imports jax at package import, so nothing here
may import it. The hand-written CUDA kernels live in ``csrc/`` and are built
at first use on a CUDA tensor (see ``ops/cuda_build.py``).
"""
