"""Model registry (port of ``cfdbench_tpu/models/__init__.py``).

Every model of the JAX package but the latent diffusion models is
ported: the autoregressive ones (``fno``, ``ffno``, the conv family
``unet`` and ``resnet``, the point family ``auto_ffn``, ``auto_deeponet``,
``auto_edeeponet`` and ``auto_deeponet_cnn``), built by
:func:`init_auto_model` for ``main_auto``; pixel diffusion, a task built
by :func:`init_pixel_diffusion`, also for ``main_auto``; GenCast, built by
:func:`init_gencast` for ``main_gencast``; and the non-autoregressive
``ffn`` and ``deeponet``, built by :func:`init_nonauto_model` for
``main_train``. ``main_multistep`` rolls out every kind. The latent
diffusion models raise and name ROADMAP.md A13b.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import Args
from ..metrics import LossFn

from .diffusion import GenCastCfdModel, PixelDiffusionCfdModel
from .ffno import Ffno2d
from .fno import Fno2d
from .nonauto import DeepONet, FfnModel
from .point import AutoDeepONet, AutoDeepONetCnn, AutoEDeepONet, AutoFfn
from .resnet import ResNet
from .unet import UNet

__all__ = ["init_auto_model", "init_nonauto_model", "get_input_shapes", "Fno2d", "Ffno2d",
           "UNet", "ResNet", "AutoFfn", "AutoDeepONet", "AutoEDeepONet", "AutoDeepONetCnn",
           "FfnModel", "DeepONet", "init_pixel_diffusion", "init_gencast",
           "PixelDiffusionCfdModel", "GenCastCfdModel"]

AUTO_MODELS = ("fno", "ffno", "unet", "resnet", "auto_ffn", "auto_deeponet", "auto_edeeponet",
               "auto_deeponet_cnn", "pixel_diffusion")
NONAUTO_MODELS = ("ffn", "deeponet")
GENCAST_MODELS = ("gencast",)
# The models whose network is a PUNetG, which take --use_gradient_checkpointing.
DIFFUSION_MODELS = ("pixel_diffusion", "gencast")
# The entry point that trains each kind, and its root script.
ENTRY_POINTS = {"auto": "main_auto (train_auto_torch.py)", "nonauto": "main_train (train_torch.py)",
                "gencast": "main_gencast (train_gencast_torch.py)"}

_NOT_PORTED = {
    "latent_diffusion": "A13b",
    "latent_diffusion2": "A13b",
    "latent_diffusion_lite": "A13b",
    "latent_diffusion2_lite": "A13b",
}


def check_model_ported(name: str, regime: Optional[str] = None) -> None:
    """Raise unless ``--model name`` is ported, and, when ``regime`` is
    given, is of that kind: ``"auto"`` for ``main_auto``, ``"nonauto"``
    for ``main_train``, ``"gencast"`` for ``main_gencast``. A model of
    another kind raises a ValueError that names the entry point that
    trains it (the JAX package raises ``Invalid model name`` there)."""
    kinds = {"auto": AUTO_MODELS, "nonauto": NONAUTO_MODELS, "gencast": GENCAST_MODELS}
    what = {"auto": "an autoregressive", "nonauto": "a non-autoregressive",
            "gencast": "the GenCast"}
    for kind, models in kinds.items():
        if name in models:
            if regime is not None and kind != regime:
                raise ValueError(
                    f"Invalid model name: {name} is {what[kind]} model; train it with "
                    f"{ENTRY_POINTS[kind]}"
                )
            return
    item = _NOT_PORTED.get(name)
    if item is None:
        raise ValueError(f"Invalid model name: {name}")
    raise NotImplementedError(
        f"--model {name} is not ported to PyTorch yet (ROADMAP.md {item}); "
        f"the ported models are {', '.join(AUTO_MODELS + NONAUTO_MODELS + GENCAST_MODELS)}"
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


def init_auto_model(args: Args, n_case_params: int = None, field_shape=None, *,
                    generator: torch.Generator = None, device=None):
    """Construct an autoregressive model from args. ``n_case_params`` and
    ``field_shape`` (H, W) may come from the dataset; they default to
    ``get_input_shapes``. The point models' sizes follow the field's.
    Initial weights come from ``generator`` (seeded with ``args.seed``
    when omitted), drawn on the CPU, then moved to ``device``. Pixel
    diffusion is a task, built by :func:`init_pixel_diffusion`."""
    check_model_ported(args.model, "auto")
    if args.model == "pixel_diffusion":
        raise ValueError("--model pixel_diffusion is a task with its own sampler: build it "
                         "with init_pixel_diffusion")
    n_rows, n_cols, default_p = get_input_shapes(args)
    if field_shape is not None:
        n_rows, n_cols = field_shape
    p = n_case_params if n_case_params is not None else default_p
    if generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    init = dict(generator=generator, device=device)
    if args.model == "fno":
        return Fno2d(in_chan=args.in_chan, out_chan=args.out_chan, n_case_params=p,
                     num_layers=args.fno_depth, hidden_dim=args.fno_hidden_dim,
                     modes1=args.fno_modes_x, modes2=args.fno_modes_y, **init)
    if args.model == "ffno":
        return Ffno2d(in_chan=args.in_chan, out_chan=args.out_chan, n_case_params=p,
                      num_layers=args.fno_depth, hidden_dim=args.fno_hidden_dim,
                      modes1=args.fno_modes_x, modes2=args.fno_modes_y, **init)
    if args.model == "unet":
        return UNet(in_chan=args.in_chan, out_chan=args.out_chan, n_case_params=p,
                    insert_case_params_at=args.unet_insert_case_params_at,
                    dim=args.unet_dim, **init)
    if args.model == "resnet":
        return ResNet(in_chan=args.in_chan, out_chan=args.out_chan, n_case_params=p,
                      hidden_chan=args.resnet_hidden_chan, num_blocks=args.resnet_depth,
                      kernel_size=args.resnet_kernel_size, padding=args.resnet_padding,
                      **init)
    if args.model == "auto_ffn":
        return AutoFfn(input_field_dim=n_rows * n_cols, num_case_params=p,
                       width=args.autoffn_width, depth=args.autoffn_depth, **init)
    if args.model == "auto_deeponet":
        return AutoDeepONet(branch_dim=n_rows * n_cols + p, width=args.deeponet_width,
                            branch_depth=args.branch_depth, trunk_depth=args.trunk_depth,
                            act_name=args.act_fn, **init)
    if args.model == "auto_edeeponet":
        return AutoEDeepONet(dim_branch1=n_rows * n_cols, dim_branch2=p,
                             width=args.autoedeeponet_width,
                             branch_depth=args.autoedeeponet_depth,
                             trunk_depth=args.autoedeeponet_depth,
                             act_name=args.autoedeeponet_act_fn, **init)
    return AutoDeepONetCnn(in_chan=args.in_chan, num_case_params=p,
                           field_shape=(n_rows, n_cols), **init)


def init_nonauto_model(args: Args, n_case_params: int = None, *,
                       generator: torch.Generator = None, device=None):
    """Construct a non-autoregressive model from args
    (``src/train.py:254-292``); ``n_case_params`` defaults to 8 for
    cylinder, else 5. ``--act_fn``, ``--act_scale_invariant`` and
    ``--act_on_output`` reach the DeepONet only: the FFN always runs the
    scale-invariant ReLU, as in the JAX package. Initial weights come
    from ``generator`` (seeded with ``args.seed`` when omitted), drawn on
    the CPU, then moved to ``device``."""
    check_model_ported(args.model, "nonauto")
    p = n_case_params
    if p is None:
        p = 8 if "cylinder" in args.data_name else 5
    if generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    init = dict(generator=generator, device=device)
    if args.model == "deeponet":
        return DeepONet(n_case_params=p, width=args.deeponet_width,
                        branch_depth=args.branch_depth, trunk_depth=args.trunk_depth,
                        act_name=args.act_fn, act_norm=bool(args.act_scale_invariant),
                        act_on_output=bool(args.act_on_output), **init)
    return FfnModel(n_case_params=p, width=args.ffn_width, depth=args.ffn_depth, **init)


def _diffusion_init(args: Args, generator, device) -> dict:
    """The PUNetG's widths from the ``--pixel_diffusion_*`` flags, and its
    initial weights from ``generator`` (seeded with ``args.seed`` when
    omitted) on ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    return dict(noise_scheduler_timesteps=args.ldm_noise_scheduler_timesteps,
                base_channels=args.pixel_diffusion_base_channels,
                channel_mults=tuple(args.pixel_diffusion_channel_mults),
                num_res_blocks=args.pixel_diffusion_num_res_blocks,
                dropout=args.pixel_diffusion_dropout, generator=generator, device=device)


def _configure(task, args: Args):
    task.num_inference_steps = args.ldm_num_inference_steps
    task.use_gradient_checkpointing = bool(args.use_gradient_checkpointing)
    return task


def init_pixel_diffusion(args: Args, n_case_params: int, loss_fn: Optional[LossFn] = None, *,
                         generator: torch.Generator = None,
                         device=None) -> PixelDiffusionCfdModel:
    """The pixel-diffusion task from args (``cfdbench_tpu/cli.py:83-100``):
    ``--ldm_noise_scheduler_timesteps``, ``--ldm_num_inference_steps``,
    the ``--pixel_diffusion_*`` widths and ``--use_gradient_checkpointing``."""
    check_model_ported(args.model, "auto")
    return _configure(PixelDiffusionCfdModel(loss_fn, out_chan=args.out_chan,
                                             n_case_params=n_case_params,
                                             **_diffusion_init(args, generator, device)), args)


def init_gencast(args: Args, stats, n_case_params: int, loss_fn: Optional[LossFn] = None, *,
                 generator: torch.Generator = None, device=None) -> GenCastCfdModel:
    """The GenCast task from args and the residual statistics ``stats``
    (``residual_mean``, ``residual_std``), at the pixel-diffusion widths
    (``cfdbench_tpu/cli.py:776-792``)."""
    return _configure(GenCastCfdModel(loss_fn, stats["residual_mean"], stats["residual_std"],
                                      in_chan=args.in_chan, out_chan=args.out_chan,
                                      n_case_params=n_case_params,
                                      **_diffusion_init(args, generator, device)), args)
