"""Result-dir layout and the plots a run writes (the port's own copy of
``get_output_dir``, ``plot_loss``, ``plot_predictions``, ``plot_example``
and ``plot_multistep_metrics`` from ``cfdbench_tpu/utils/artifacts.py``).

The result path encodes key hparams per model family and is parsed by
downstream tooling — the layout is API (``src/utils/common.py:182-275``).
Both packages must give the same path for the same flags
(``tests/test_torch_host.py``), so that one run directory serves both.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

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


def plot_loss(losses, out: Path, fontsize: int = 12) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.plot(np.asarray(losses))
    plt.xlabel("Step", fontsize=fontsize)
    plt.ylabel("Loss", fontsize=fontsize)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out)
    plt.clf()
    plt.close()


def _plot_panels(
    inp: Optional[np.ndarray],
    label: np.ndarray,
    pred: np.ndarray,
    out_path: Path,
) -> None:
    """Input/label/pred panels with a shared color scale (reference
    ``plot_predictions``, ``src/utils/common.py:34-93``).

    Like the reference's ``plot`` (``src/utils/common.py:102-105``,
    which torch.saves ``(inp, label, pred)`` to ``tensors/<stem>.pt``
    beside each image), the raw arrays are dumped to
    ``tensors/<stem>.npz`` — npz instead of .pt, the same
    framework-neutral deviation as ``preds.npy`` (MIGRATING.md
    §behavioral-deltas). Written before the matplotlib import so the
    data survives even on plotting-less installs."""
    out_path = Path(out_path)
    tensor_dir = out_path.parent / "tensors"
    tensor_dir.mkdir(parents=True, exist_ok=True)
    arrays = dict(label=np.asarray(label), pred=np.asarray(pred))
    if inp is not None:
        arrays["input"] = np.asarray(inp)
    np.savez(tensor_dir / f"{out_path.stem}.npz", **arrays)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    panels = [("label", label), ("pred", pred)]
    if inp is not None:
        panels.insert(0, ("input", inp))
    vmin = min(float(np.min(p)) for _, p in panels)
    vmax = max(float(np.max(p)) for _, p in panels)
    fig, axs = plt.subplots(1, len(panels), figsize=(4 * len(panels), 3.2))
    for ax, (title, p) in zip(np.atleast_1d(axs), panels):
        im = ax.imshow(np.asarray(p), vmin=vmin, vmax=vmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)


def plot_predictions(
    inp: Optional[np.ndarray],
    label: np.ndarray,
    pred: np.ndarray,
    out_dir: Path,
    step: int,
) -> None:
    """Per-step panel image under ``out_dir`` (test-time plots)."""
    _plot_panels(inp, label, pred, Path(out_dir) / f"step-{step}.png")


def plot_example(
    inp: Optional[np.ndarray],
    label: np.ndarray,
    pred: np.ndarray,
    out_path: Path,
) -> None:
    """Single input/label/pred snapshot at a fixed path — the train-time
    ``example.png`` contract (reference plots one on the first step of
    each epoch, ``src/train_auto.py:234-250``)."""
    _plot_panels(inp, label, pred, out_path)


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
