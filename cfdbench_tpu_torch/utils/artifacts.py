"""Result-dir layout and the multistep plot (the port's own copy of
``get_output_dir`` and ``plot_multistep_metrics`` from
``cfdbench_tpu/utils/artifacts.py``).

The result path encodes key hparams per model family and is parsed by
downstream tooling — the layout is API (``src/utils/common.py:182-275``).
Both packages must give the same path for the same flags
(``tests/test_torch_host.py``), so that one run directory serves both.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..config import Args


def get_output_dir(args: Args, is_auto: bool = False) -> Path:
    """Mirror of ``src/utils/common.py:182-275``."""
    output_dir = Path(
        args.output_dir,
        "auto" if is_auto else "non-auto",
        args.data_name,
        f"dt{args.delta_time}",
        args.model,
    )
    m = args.model
    if m == "deeponet":
        d = (
            f"lr{args.lr}_width{args.deeponet_width}"
            f"_depthb{args.branch_depth}_deptht{args.trunk_depth}"
            f"_normprop{args.norm_props}_act{args.act_fn}"
            f"-{args.act_scale_invariant}-{args.act_on_output}"
        )
    elif m == "unet":
        d = f"lr{args.lr}_d{args.unet_dim}_cp{args.unet_insert_case_params_at}"
    elif m in ("fno", "ffno"):
        d = (
            f"lr{args.lr}_d{args.fno_depth}_h{args.fno_hidden_dim}"
            f"_m1{args.fno_modes_x}_m2{args.fno_modes_y}"
        )
    elif m == "resnet":
        d = f"lr{args.lr}_d{args.resnet_depth}_w{args.resnet_hidden_chan}"
    elif m == "auto_edeeponet":
        d = (
            f"lr{args.lr}_width{args.autoedeeponet_width}"
            f"_depthb{args.autoedeeponet_depth}"
            f"_deptht{args.autoedeeponet_depth}"
            f"_normprop{args.norm_props}_act{args.autoedeeponet_act_fn}"
        )
    elif m == "auto_deeponet":
        d = (
            f"lr{args.lr}_width{args.deeponet_width}"
            f"_depthb{args.branch_depth}_deptht{args.trunk_depth}"
            f"_normprop{args.norm_props}_act{args.act_fn}"
        )
    elif m == "auto_ffn":
        d = f"lr{args.lr}_width{args.autoffn_width}_depth{args.autoffn_depth}"
    elif m == "auto_deeponet_cnn":
        d = f"lr{args.lr}_depth{args.autoffn_depth}"
    elif m == "ffn":
        d = f"lr{args.lr}_width{args.ffn_width}_depth{args.ffn_depth}"
    elif m in (
        "latent_diffusion", "latent_diffusion2",
        "latent_diffusion_lite", "latent_diffusion2_lite",
    ):
        d = (
            f"lr{args.lr}_latentdim{args.ldm_latent_dim}"
            f"_steps{args.ldm_noise_scheduler_timesteps}"
        )
    elif m in ("pixel_diffusion", "gencast"):
        d = f"lr{args.lr}_steps{args.ldm_noise_scheduler_timesteps}"
    elif m == "vae":
        d = f"lr{args.lr}_kl{args.vae_kl_weight}"
    else:
        raise NotImplementedError(f"no output-dir rule for model {m}")
    return output_dir / d


def plot_multistep_metrics(metrics, out_path: Optional[Path] = None) -> None:
    """Log-scale nmse/mse/mae vs step (``test_multistep.py:58-70``);
    nothing when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    for key in ["nmse", "mse", "mae"]:
        plt.plot([m[key] for m in metrics], label=key.upper())
    plt.legend()
    plt.xlabel("Steps")
    plt.yscale("log")
    if out_path is not None:
        plt.savefig(out_path, bbox_inches="tight")
    plt.clf()
    plt.close()
