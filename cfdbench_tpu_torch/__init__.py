"""PyTorch/CUDA port of cfdbench_tpu, the JAX package beside it.

The port mirrors the JAX package's module paths and NHWC layout; its
FNO forward runs through hand-written Hopper kernels
(``ops/fno_kernels.py``, ``csrc/``). It imports no JAX: splits,
padding, masks and case parameters come from the JAX package's
JAX-free host modules (``config``, ``data``, ``utils.artifacts``).
"""

__version__ = "0.1.0"
