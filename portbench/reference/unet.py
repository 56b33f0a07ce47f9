"""The plain U-Net of CFDBench (``src/models/unet.py``) in evaluation mode, in
float32 PyTorch: the yardstick of the U-Net's cells.

The interface that ``models.py`` finds by the configuration's ``model``:
``initial_stats``, ``predict``, ``forward_macs``. A
functional forward over a dict of the benchmark's weights, named as the
reference's ``state_dict``: DoubleConvs (3x3 convolution with replicate
padding, BatchNorm, ReLU; twice) down four levels behind 2x2 max pools, up
four levels through 2x2 stride-2 transposed convolutions whose output is
zero-padded to the skip's size and concatenated after it, then a 1x1
convolution; the case parameters enter as constant input planes after the
mask. The prediction is the input's first ``out_chan`` channels plus the
network's output, times the mask. Computed NCHW.

BatchNorm normalises by the running statistics, eps 1e-5. Departure from
``unet.py``, the program's too: the residual and the mask product are the
JAX package's (CFDBench's trainer adds them outside the module). """

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import counts

Weights = Dict[str, torch.Tensor]
EPS = 1e-5

LEVELS = ["in_conv"] + [f"down{i}.maxpool_conv.1" for i in range(1, 5)]
UPS = [f"up{i}" for i in range(1, 5)]


def norm_names(P: Weights) -> List[str]:
    """The prefixes of the BatchNorms, ``<double conv>.conv<j>.1``."""
    return [n[: -len(".weight")] for n, t in P.items() if n.endswith(".weight") and t.dim() == 1]


def initial_stats(config: dict, P: Weights) -> Weights:
    """Running statistics before training: mean 0, variance 1."""
    out = {}
    for n in norm_names(P):
        c = P[n + ".weight"].shape[0]
        out[n + ".running_mean"] = torch.zeros(c, device=P[n + ".weight"].device)
        out[n + ".running_var"] = torch.ones(c, device=P[n + ".weight"].device)
    return out


def _batch_norm(x, P, S, name):
    """BatchNorm over the channels of NCHW ``x`` on the running statistics
    ``S``."""
    mean, var = S[name + ".running_mean"], S[name + ".running_var"]
    scale = torch.rsqrt(var + EPS) * P[name + ".weight"]
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + P[name + ".bias"][None, :, None, None]


def _double_conv(x, P, S, prefix):
    for j in (1, 2):
        conv = f"{prefix}.conv{j}.0"
        x = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), P[conv + ".weight"], P[conv + ".bias"])
        x = F.relu(_batch_norm(x, P, S, f"{prefix}.conv{j}.1"))
    return x


def _planes(inputs, case_params, mask):
    """[inputs | mask | case parameters], NCHW."""
    B, H, W, _ = inputs.shape
    planes = case_params[:, None, None, :].expand(B, H, W, case_params.shape[-1])
    return torch.cat([inputs, mask, planes], dim=-1).permute(0, 3, 1, 2)


def _network(x, P, S, inputs, mask, out_chan):
    """The network on the NCHW input ``x``."""
    skips = []
    for i, level in enumerate(LEVELS):
        if i:
            x = F.max_pool2d(x, 2)
        x = _double_conv(x, P, S, level)
        skips.append(x)
    x = skips.pop()
    for up in UPS:
        skip = skips.pop()
        x = F.conv_transpose2d(x, P[up + ".up.weight"], P[up + ".up.bias"], stride=2)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        x = _double_conv(torch.cat([skip, x], dim=1), P, S, up + ".conv")
    out = F.conv2d(x, P["out_conv.conv.weight"], P["out_conv.conv.bias"]).permute(0, 2, 3, 1)
    return (out + inputs[..., :out_chan]) * mask


def predict(config: dict, P: Weights, S: Weights, inputs, case_params, mask):
    """The prediction in evaluation mode: BatchNorm on the running
    statistics ``S``."""
    return _network(_planes(inputs, case_params, mask), P, S, inputs, mask,
                    config["args"]["out_chan"])


def forward_macs(config: dict, batch: int) -> int:
    """Multiply-adds of one forward of ``batch`` cases (``counts.py``)."""
    a, (H, W) = config["args"], config["grid"]
    return batch * counts.unet_forward_macs(H, W, a["in_chan"], config["n_case_params"],
                                            a["unet_dim"], a["out_chan"])
