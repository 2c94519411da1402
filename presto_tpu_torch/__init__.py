"""presto_tpu_torch: the PyTorch/CUDA port of presto_tpu.

The same SQL engine — parser, analyzer, planner, operators over padded
columnar batches — with device data in torch tensors. The JAX package
`presto_tpu` is the reference; this package imports none of it (and no
JAX). Its hot kernels are written by hand for NVIDIA Hopper under
`csrc/`, each beside a plain PyTorch version that the CPU path runs.

Importing the package touches no device and builds nothing.
"""

__version__ = "0.1.0"
