"""Model registry (port of ``cfdbench_tpu/models/__init__.py``).

Only ``fno`` is ported; every other ``--model`` raises and names the
ROADMAP.md item that will port it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import Args

from .fno import Fno2d

__all__ = ["init_auto_model", "get_input_shapes", "Fno2d"]

_NOT_PORTED = {
    "ffno": "A12",
    "unet": "A9",
    "resnet": "A9",
    "auto_ffn": "A10",
    "auto_deeponet": "A10",
    "auto_edeeponet": "A10",
    "auto_deeponet_cnn": "A10",
    "ffn": "A11",
    "deeponet": "A11",
    "pixel_diffusion": "A13",
    "latent_diffusion": "A13",
    "latent_diffusion2": "A13",
    "latent_diffusion_lite": "A13",
    "latent_diffusion2_lite": "A13",
    "gencast": "A13",
}


def check_model_ported(name: str) -> None:
    if name == "fno":
        return
    item = _NOT_PORTED.get(name)
    if item is None:
        raise ValueError(f"Invalid model name: {name}")
    raise NotImplementedError(
        f"--model {name} is not ported to PyTorch yet (ROADMAP.md {item}); "
        "only fno is"
    )


def get_input_shapes(args: Args) -> Tuple[int, int, int]:
    """(n_rows, n_cols, n_case_params) per data_name; tube and dam are
    padded by (+2, +1)."""
    if any(x in args.data_name for x in ["tube", "dam"]):
        n_rows, n_cols = args.num_rows + 2, args.num_cols + 1
    else:
        n_rows, n_cols = args.num_rows, args.num_cols
    n_case_params = 8 if "cylinder" in args.data_name else 5
    return n_rows, n_cols, n_case_params


def init_auto_model(args: Args, n_case_params: int = None, *,
                    generator: torch.Generator = None, device=None):
    """Construct an autoregressive model from args. ``n_case_params``
    may come from the dataset; it defaults to ``get_input_shapes``.
    Initial weights come from ``generator`` (seeded with ``args.seed``
    when omitted)."""
    check_model_ported(args.model)
    p = n_case_params if n_case_params is not None else get_input_shapes(args)[2]
    if generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    return Fno2d(
        in_chan=args.in_chan,
        out_chan=args.out_chan,
        n_case_params=p,
        num_layers=args.fno_depth,
        hidden_dim=args.fno_hidden_dim,
        modes1=args.fno_modes_x,
        modes2=args.fno_modes_y,
        generator=generator,
        device=device,
    )
