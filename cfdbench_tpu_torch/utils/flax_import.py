"""Carry the JAX package's parameters into the port and back.

A JAX model's variables (nested dicts of numpy arrays, as
``model.init``/``load_params`` return them or as ``tests/_golden.py``
decodes the ``P|…``/``S|…`` keys of ``tests/golden/*.npz``) map onto the
port model's ``state_dict()``, whose keys are the reference CFDBench
torch models' own (the names ``cfdbench_tpu/utils/torch_import.py``
reads), so the three layouts meet:

- a flax ``Dense`` kernel ``(in, out)`` is an ``nn.Linear`` weight
  ``(out, in)``; biases are unchanged;
- a flax ``Conv`` kernel ``(kh, kw, I, O)`` is a conv weight
  ``(O, I, kh, kw)``;
- a flax ``ConvTranspose`` kernel ``(kh, kw, I, O)`` is a transposed
  conv weight ``(I, O, kh, kw)`` with both spatial axes flipped (torch
  computes a true transposed conv, flax a fractionally strided one);
- a BatchNorm's ``params`` ``{scale, bias}`` are its ``weight``/``bias``
  and its ``batch_stats`` ``{mean, var}`` its ``running_mean``/
  ``running_var`` buffers (``num_batches_tracked`` has no flax
  counterpart: it is set to 0);
- the FNO's spectral weights keep the real-pair layout
  ``(corner, re/im, in, out, m1, m2)``, the FFNO's ``(re/im, in, out,
  modes)``;
- a GroupNorm's ``{scale, bias}`` are its ``weight``/``bias``.

The model is recognised from the tree (or the keys): ``FilmResBlock_i``
is the PUNetG of pixel diffusion and GenCast (flax's auto-names in call
order: ``Dense_0``-``Dense_3`` the timestep and case-parameter MLPs,
``Conv_0`` the conv-in, then the downsampling, upsampling and output
convs; inside a block ``Conv_0`` is the 1x1 residual conv where the
widths differ), ``FnoBlock_i`` the FNO, ``FfnoBlock_i`` the FFNO, ``DoubleConv_0`` the U-Net,
``ResidualBlock_i`` the ResNet, ``Dense_0`` beside ``Mlp_0`` the
non-autoregressive DeepONet (``fc_trunk_t`` and ``fc_trunk_xy``),
``CnnBranch_0`` the AutoDeepONetCnn, three, two or one ``Mlp_i`` the
AutoEDeepONet, AutoDeepONet or AutoFfn. The non-autoregressive FFN's
tree and keys are the AutoFfn's (``Mlp_0`` ↔ ``ffn.layers.{2j}``), so it
maps as that family does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

P, S = "params", "batch_stats"
# (collection, flax path, port key, layout)
Entry = Tuple[Optional[str], Tuple[str, ...], str, str]

_TO_TORCH = {
    "=": lambda a: a,
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(3, 2, 0, 1),
    "conv_t": lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
}
_TO_FLAX = {
    "=": lambda a: a,
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "conv_t": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
}


def _dense(path, key) -> Iterator[Entry]:
    yield P, path + ("Dense_0", "kernel"), f"{key}.weight", "dense"
    yield P, path + ("Dense_0", "bias"), f"{key}.bias", "="


def _conv(path, key) -> Iterator[Entry]:
    yield P, path + ("Conv_0", "kernel"), f"{key}.weight", "conv"
    yield P, path + ("Conv_0", "bias"), f"{key}.bias", "="


def _mlp(path, key, n: int) -> Iterator[Entry]:
    for j in range(n):
        yield from _dense(path + (f"Dense_{j}",), f"{key}.layers.{2 * j}")


def _norm(path, key) -> Iterator[Entry]:
    yield P, path + ("scale",), f"{key}.weight", "="
    yield P, path + ("bias",), f"{key}.bias", "="


def _bn(path, key) -> Iterator[Entry]:
    yield from _norm(path, key)
    yield S, path + ("mean",), f"{key}.running_mean", "="
    yield S, path + ("var",), f"{key}.running_var", "="
    yield None, (), f"{key}.num_batches_tracked", "count"


def _double_conv(path, key) -> Iterator[Entry]:
    yield from _conv(path + ("Conv_0",), f"{key}.conv1.0")
    yield from _bn(path + ("BatchNorm_0",), f"{key}.conv1.1")
    yield from _conv(path + ("Conv_1",), f"{key}.conv2.0")
    yield from _bn(path + ("BatchNorm_1",), f"{key}.conv2.1")


def _entries(family: str, shape) -> Iterator[Entry]:
    """Every leaf of ``family``'s variables with its port key; ``shape``
    is what varies within the family (block counts, MLP depths)."""
    if family == "punetg":
        n_down, residual = shape
        for i, key in enumerate(("t_dense1", "t_dense2", "c_dense1", "c_dense2")):
            yield from _dense((f"Dense_{i}",), key)
        convs = ["conv_in"] + [f"downs.{j}" for j in range(n_down)] + [
            f"ups.{j}" for j in range(n_down)] + ["conv_out"]
        for i, key in enumerate(convs):
            yield from _conv((f"Conv_{i}",), key)
        yield from _norm(("GroupNorm_0",), "norm_out")
        for i, projected in enumerate(residual):
            block, key = (f"FilmResBlock_{i}",), f"res_blocks.{i}"
            names = ["res_conv"] * projected + ["conv1", "conv2"]
            for j, name in enumerate(names):
                yield from _conv(block + (f"Conv_{j}",), f"{key}.{name}")
            yield from _norm(block + ("GroupNorm_0",), f"{key}.norm1")
            yield from _norm(block + ("GroupNorm_1",), f"{key}.norm2")
            yield from _dense(block + ("Dense_0",), f"{key}.cond")
    elif family == "fno":
        yield from _dense(("Dense_0",), "fc0")
        for i in range(shape):
            yield P, (f"FnoBlock_{i}", "SpectralConv2d_0", "weights"), f"blocks.{i}.weights", "="
            yield from _dense((f"FnoBlock_{i}", "Dense_0"), f"blocks.{i}.w0")
        yield from _dense(("Dense_1",), "fc1")
        yield from _dense(("Dense_2",), "fc2")
    elif family == "ffno":
        yield from _dense(("Dense_0",), "fc0")
        for i in range(shape):
            block = (f"FfnoBlock_{i}",)
            for w in ("weights_h", "weights_w"):
                yield P, block + (w,), f"blocks.{i}.{w}", "="
            yield from _dense(block + ("Dense_0",), f"blocks.{i}.dense0")
            yield from _dense(block + ("Dense_1",), f"blocks.{i}.dense1")
        yield from _dense(("Dense_1",), "fc1")
        yield from _dense(("Dense_2",), "fc2")
    elif family == "deeponet":
        n_branch, n_trunk = shape
        yield from _mlp(("Mlp_0",), "branch_net", n_branch)
        yield from _dense(("Dense_0",), "fc_trunk_t")
        yield from _dense(("Dense_1",), "fc_trunk_xy")
        yield from _mlp(("Mlp_1",), "trunk_net", n_trunk)
        yield P, ("bias",), "bias", "="
    elif family == "unet":
        yield from _double_conv(("DoubleConv_0",), "in_conv")
        for i in range(4):
            yield from _double_conv((f"Down_{i}", "DoubleConv_0"), f"down{i + 1}.maxpool_conv.1")
        if shape:  # insert_case_params_at="hidden"
            yield from _dense(("Dense_0",), "case_params_fc")
        for i in range(4):
            yield P, (f"Up_{i}", "ConvTranspose_0", "kernel"), f"up{i + 1}.up.weight", "conv_t"
            yield P, (f"Up_{i}", "ConvTranspose_0", "bias"), f"up{i + 1}.up.bias", "="
            yield from _double_conv((f"Up_{i}", "DoubleConv_0"), f"up{i + 1}.conv")
        yield from _conv(("Conv_0",), "out_conv.conv")
    elif family == "resnet":
        for i, projected in enumerate(shape):
            names = ["res_conv"] * projected + ["conv1", "conv2"]
            for j, name in enumerate(names):
                yield from _conv((f"ResidualBlock_{i}", f"Conv_{j}"), f"blocks.{i}.{name}")
    elif family == "auto_deeponet_cnn":
        n_mid, n_trunk, n_out = shape
        yield from _conv(("CnnBranch_0", "Conv_0"), "branch_net.in_conv")
        for j in range(n_mid):
            yield from _conv(("CnnBranch_0", f"Conv_{j + 1}"), f"branch_net.blocks.{3 * j}")
        yield from _conv(("CnnBranch_0", f"Conv_{n_mid + 1}"), "branch_net.out_conv")
        yield from _mlp(("Mlp_0",), "trunk_net", n_trunk)
        yield from _mlp(("Mlp_1",), "out_ffn", n_out)
    else:  # the MLP models: one Mlp_i per port name, in order
        names = _MLP_NAMES[family]
        for i, (name, n) in enumerate(zip(names, shape)):
            yield from _mlp((f"Mlp_{i}",), name, n)
        if family != "auto_ffn":
            yield P, ("bias",), "bias", "="


_MLP_NAMES = {
    "auto_ffn": ("ffn",),
    "auto_deeponet": ("branch_net", "trunk_net"),
    "auto_edeeponet": ("branch1", "branch2", "trunk_net"),
}


def _count(prefix: str, keys) -> int:
    pat = re.compile(re.escape(prefix) + r"(\d+)")
    return len({m.group(1) for k in keys if (m := pat.match(k))})


def _flax_shape(params) -> Tuple[str, Any]:
    if "FilmResBlock_0" in params:
        return "punetg", ((_count("Conv_", params) - 2) // 2,
                          ["Conv_2" in params[f"FilmResBlock_{i}"]
                           for i in range(_count("FilmResBlock_", params))])
    if "FnoBlock_0" in params:
        return "fno", _count("FnoBlock_", params)
    if "FfnoBlock_0" in params:
        return "ffno", _count("FfnoBlock_", params)
    if "DoubleConv_0" in params:
        return "unet", "Dense_0" in params
    if "ResidualBlock_0" in params:
        return "resnet", [len(params[f"ResidualBlock_{i}"]) == 3
                          for i in range(_count("ResidualBlock_", params))]
    if "Dense_0" in params and "Mlp_0" in params:
        return "deeponet", (len(params["Mlp_0"]), len(params["Mlp_1"]))
    mlps = [len(params[f"Mlp_{i}"]) for i in range(_count("Mlp_", params))]
    if "CnnBranch_0" in params:
        return "auto_deeponet_cnn", (len(params["CnnBranch_0"]) - 2, *mlps)
    family = {1: "auto_ffn", 2: "auto_deeponet", 3: "auto_edeeponet"}.get(len(mlps))
    if family is None:
        raise KeyError(f"not a param tree of a ported model: keys {sorted(params)}")
    return family, mlps


def _port_shape(keys) -> Tuple[str, Any]:
    keys = set(keys)
    if "res_blocks.0.norm1.weight" in keys:
        return "punetg", (_count("downs.", keys),
                          [f"res_blocks.{i}.res_conv.weight" in keys
                           for i in range(_count("res_blocks.", keys))])
    if "blocks.0.weights" in keys:
        return "fno", _count("blocks.", (k for k in keys if k.endswith(".weights")))
    if "blocks.0.weights_h" in keys:
        return "ffno", _count("blocks.", (k for k in keys if k.endswith(".weights_h")))
    if "fc_trunk_t.weight" in keys:
        return "deeponet", (_count("branch_net.layers.", keys), _count("trunk_net.layers.", keys))
    if "in_conv.conv1.0.weight" in keys:
        return "unet", "case_params_fc.weight" in keys
    if "blocks.0.conv1.weight" in keys:
        return "resnet", [f"blocks.{i}.res_conv.weight" in keys
                          for i in range(_count("blocks.", keys))]
    if "branch_net.in_conv.weight" in keys:
        return "auto_deeponet_cnn", (_count("branch_net.blocks.", keys),
                                     _count("trunk_net.layers.", keys),
                                     _count("out_ffn.layers.", keys))
    for family, names in _MLP_NAMES.items():
        if all(f"{n}.layers.0.weight" in keys for n in names):
            return family, [_count(f"{n}.layers.", keys) for n in names]
    raise KeyError(f"not a state dict of a ported model: keys {sorted(keys)}")


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,)


def params_from_flax(params: Dict[str, Any],
                     batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """A JAX model's ``params`` collection (not ``{"params": …}``) and,
    for the U-Net, its ``batch_stats`` → the port model's state dict."""
    if P in params:
        raise ValueError("pass the 'params' collection, not the variables dict")
    family, shape = _flax_shape(params)
    trees = {P: params, S: batch_stats}
    if family == "unet" and batch_stats is None:
        raise ValueError("the U-Net's BatchNorm needs the 'batch_stats' collection too")
    sd: Dict[str, torch.Tensor] = {}
    used = {P: set(), S: set()}
    for coll, path, key, layout in _entries(family, shape):
        if layout == "count":
            sd[key] = torch.tensor(0, dtype=torch.long)
            continue
        arr = np.asarray(_get(trees[coll], path), np.float32)
        sd[key] = torch.from_numpy(np.array(_TO_TORCH[layout](arr), order="C"))
        used[coll].add(path)
    for coll, tree in trees.items():
        extra = sorted("/".join(p) for p in _leaves(tree or {}) if p not in used[coll])
        if extra:
            raise KeyError(f"{family} {coll}: unexpected entries {extra}")
    return sd


def _to_flax(sd: Dict[str, torch.Tensor], collection: str) -> Dict[str, Any]:
    family, shape = _port_shape(sd)
    out: Dict[str, Any] = {}
    for coll, path, key, layout in _entries(family, shape):
        if coll != collection:
            continue
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        arr = sd[key].detach().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(_TO_FLAX[layout](arr))
    return out


def params_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: the ``params`` collection of
    the port's state dict (or of any dict holding its parameters' keys,
    such as their gradients)."""
    return _to_flax(sd, P)


def batch_stats_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The ``batch_stats`` collection of a U-Net's state dict (BatchNorm
    running means and variances); empty for the other models."""
    return _to_flax(sd, S)
