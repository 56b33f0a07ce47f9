"""Hand-written CUDA kernels, their plain versions, and the spectral conv."""

from __future__ import annotations

import functools
from typing import List

import torch


def common_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The tensors' common dtype (``torch.promote_types``, which for
    bfloat16 and float32 is JAX's rule and flax's ``promote_dtype``):
    bfloat16 with float32 gives float32."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def promote(*tensors: torch.Tensor) -> List[torch.Tensor]:
    """``tensors`` in their :func:`common_dtype`."""
    dtype = common_dtype(*tensors)
    return [t.to(dtype) for t in tensors]
