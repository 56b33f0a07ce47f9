"""PyTorch/CUDA port of cfdbench_tpu, the JAX package beside it.

The port mirrors the JAX package's module paths and NHWC layout; its
FNO forward, in training and in the rollout, runs through hand-written
Hopper kernels (``ops/fno_kernels.py``, ``csrc/``). It imports no JAX
and nothing of the JAX package: its host code (``config``, ``data``,
``utils.artifacts``) is its own copy.
"""

__version__ = "0.1.0"
