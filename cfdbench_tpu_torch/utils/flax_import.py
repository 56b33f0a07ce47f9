"""Carry the JAX package's FNO parameters into the port and back.

The JAX ``Fno2d`` param tree (nested dicts of numpy arrays, as
``model.init``/``load_params`` return them or as ``tests/_golden.py``
decodes the ``P|…`` keys of ``tests/golden/fno.npz``) maps onto the
port's ``Fno2d.state_dict()``:

- a flax ``Dense`` kernel ``(in, out)`` becomes an ``nn.Linear``
  weight ``(out, in)``; biases are unchanged;
- spectral weights keep the real-pair layout
  ``(corner, re/im, in, out, m1, m2)``.

========================================  =========================
JAX path                                  port key
========================================  =========================
``Dense_0/Dense_0/{kernel,bias}``         ``fc0.{weight,bias}``
``FnoBlock_i/SpectralConv2d_0/weights``   ``blocks.i.weights``
``FnoBlock_i/Dense_0/Dense_0/…``          ``blocks.i.w0.…``
``Dense_1/Dense_0/…``                     ``fc1.…``
``Dense_2/Dense_0/…``                     ``fc2.…``
========================================  =========================
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_DENSES = {"Dense_0": "fc0", "Dense_1": "fc1", "Dense_2": "fc2"}


def _dense_to_torch(node, prefix: str, out: dict) -> None:
    inner = node["Dense_0"]
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(inner["kernel"], np.float32).T)
    )
    out[f"{prefix}.bias"] = torch.from_numpy(
        np.array(inner["bias"], np.float32)
    )


def params_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Fno2d`` params → the port's ``Fno2d`` state dict. Takes the
    ``params`` collection itself (not ``{"params": …}``)."""
    if "params" in params:
        raise ValueError(
            "pass the 'params' collection, not the variables dict"
        )
    sd: Dict[str, torch.Tensor] = {}
    for name, prefix in _DENSES.items():
        _dense_to_torch(params[name], prefix, sd)
    i = 0
    while f"FnoBlock_{i}" in params:
        blk = params[f"FnoBlock_{i}"]
        sd[f"blocks.{i}.weights"] = torch.from_numpy(
            np.array(blk["SpectralConv2d_0"]["weights"], np.float32)
        )
        _dense_to_torch(blk["Dense_0"], f"blocks.{i}.w0", sd)
        i += 1
    known = set(_DENSES) | {f"FnoBlock_{j}" for j in range(i)}
    extra = sorted(set(params) - known)
    if i == 0 or extra:
        raise KeyError(
            f"not an Fno2d param tree: {i} FnoBlock_i entries, "
            f"unexpected keys {extra}"
        )
    return sd


def _dense_to_flax(sd, prefix: str) -> dict:
    return {
        "Dense_0": {
            "kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].cpu().numpy().T),
            "bias": sd[f"{prefix}.bias"].cpu().numpy(),
        }
    }


def params_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`."""
    params: Dict[str, Any] = {
        name: _dense_to_flax(sd, prefix) for name, prefix in _DENSES.items()
    }
    i = 0
    while f"blocks.{i}.weights" in sd:
        params[f"FnoBlock_{i}"] = {
            "SpectralConv2d_0": {
                "weights": sd[f"blocks.{i}.weights"].cpu().numpy()
            },
            "Dense_0": _dense_to_flax(sd, f"blocks.{i}.w0"),
        }
        i += 1
    return params
