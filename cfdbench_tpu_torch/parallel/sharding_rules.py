"""Parameter sharding rules of tensor parallelism (port of
``cfdbench_tpu/parallel/sharding_rules.py``, its own copy of the rules).

The JAX rule (:func:`_spec_for`): a tensor of at least two axes and
``min_size`` elements is split over the model axis along its output
features, the trailing axis of a flax kernel, or, for the FNO's spectral
weight ``(2, 2, Cin, Cout, m1, m2)``, along ``Cout``; everything else is
replicated, and so is a tensor whose axis does not divide by the model
axis's size. At the flagship FNO (width 32, 12x12 modes, head 128) that
splits the four spectral weights and fc1, and replicates the 1x1 bypass,
the lift and fc2.

The port's layouts differ from flax's (``utils/flax_import.py``): a
module whose weight is ``(out, in, ...)`` (``Dense``, ``Conv``) or ``(in,
out, ...)`` (the U-Net's transposed conv) names the axis that holds
flax's trailing one in its ``OUT_AXIS``; any other parameter (a raw
``nn.Parameter``: spectral weights, norms, biases) has flax's layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

MIN_SIZE = 4096  # the JAX trainer's min_size


def _spec_for(shape: Sequence[int], model_size: int, min_size: int) -> Optional[int]:
    """The axis of a flax-layout tensor of ``shape`` to split over
    ``model_size`` ranks, or None to replicate it: the JAX ``_spec_for``."""
    shape = tuple(shape)
    if len(shape) < 2 or torch.Size(shape).numel() < min_size:
        return None
    if len(shape) == 6 and shape[0] == 2 and shape[1] == 2:  # spectral: split Cout
        return 3 if shape[3] % model_size == 0 else None
    return len(shape) - 1 if shape[-1] % model_size == 0 else None


def _flax_axis(module: torch.nn.Module, leaf: str, ndim: int) -> int:
    """The port axis of ``module.<leaf>`` that holds flax's trailing axis."""
    out = getattr(module, "OUT_AXIS", None)
    return out if out is not None and leaf == "weight" else ndim - 1


def param_shardings(module: torch.nn.Module, model_size: int,
                    min_size: int = MIN_SIZE) -> Dict[str, Optional[int]]:
    """Each named parameter of ``module`` → the port axis to split it on
    over ``model_size`` ranks, or None: :func:`_spec_for` on its flax
    layout, the split axis mapped back to the port's."""
    axes = {}
    for path, sub in module.named_modules():
        for leaf, p in sub.named_parameters(recurse=False):
            name = f"{path}.{leaf}" if path else leaf
            trailing = _flax_axis(sub, leaf, p.dim())
            shape = list(p.shape)
            shape.append(shape.pop(trailing))  # the flax order of the axes that matter
            axis = _spec_for(shape, model_size, min_size) if model_size > 1 else None
            if axis is None or p.dim() == 6:
                axes[name] = axis
            else:
                axes[name] = trailing
    return axes


def shard_params(module: torch.nn.Module, axis, min_size: int = MIN_SIZE
                 ) -> Dict[str, Optional[int]]:
    """Replace each parameter of ``module`` that :func:`param_shardings`
    splits by this model rank's slice of it (``axis``: the mesh's model
    axis); returns the split axes. Replicated parameters are untouched."""
    axes = param_shardings(module, axis.size, min_size)
    params = dict(module.named_parameters())
    for name, dim in axes.items():
        if dim is not None:
            p = params[name]
            n = p.shape[dim] // axis.size
            p.data = p.data.narrow(dim, axis.rank * n, n).clone()
    return axes
