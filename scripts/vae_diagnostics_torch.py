#!/usr/bin/env python
"""VAE latent-space diagnostics (mirror of ``src/utils/vae.py`` and
``scripts/utils/test_vae_collapse.py``; the port's counterpart of
``scripts/vae_diagnostics.py``): per-dimension KL (posterior-collapse
check), latent statistics, 2-D embedding of latent means (t-SNE when
sklearn is installed — ``src/utils/vae.py:55-57`` — else PCA),
per-channel latent traversal grid (``src/utils/vae.py:279-320``), latent
histograms vs N(0,1) (``src/utils/vae.py:86-140``),
original-vs-reconstruction pairs (``src/utils/vae.py:322-348``), and
latent interpolation.

It reads the port's VAE weights (``<--ldm_vae_weights_path>/model.pt``,
what ``main_vae`` writes) and encodes and decodes on the CUDA card, or on
``--device cpu``; the statistics and plots are computed on the host. The
plotted arrays also go to ``diagnostics.npz``; without matplotlib only it
and ``diagnostics.json`` are written.

Usage: python scripts/vae_diagnostics_torch.py --data_name cavity_prop_bc_geo \
    --data_dir <root> --ldm_vae_weights_path weights/vaelite \
    --output_dir diag_out [--device cpu]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cfdbench_tpu_torch.config import Args  # noqa: E402
from cfdbench_tpu_torch.data import get_auto_dataset  # noqa: E402
from cfdbench_tpu_torch.data.vae_data import build_vae_dataset  # noqa: E402
from cfdbench_tpu_torch.models.vae import make_cfd_vae  # noqa: E402
from cfdbench_tpu_torch.training.checkpoints import load_params  # noqa: E402
from cfdbench_tpu_torch.utils.device import entry_device, set_numerics  # noqa: E402


def per_dim_kl(mean, logvar):
    """KL per latent dim, averaged over batch and spatial positions
    (posterior-collapse check, ``src/utils/vae.py:396-425``): a dim
    with KL ≈ 0 is collapsed."""
    kl = 0.5 * (np.square(mean) + np.exp(logvar) - 1.0 - logvar)
    return kl.mean(axis=(0, 1, 2))  # (latent_dim,)


def embed_2d(flat, perplexity=30):
    """2-D embedding of flattened latent means: t-SNE when sklearn is
    available (``src/utils/vae.py:55-57``), else top-2 PCA. Returns
    ``(points, method_name)``."""
    # TSNE needs perplexity < n_samples, so n >= 4 for the minimum
    # perplexity of 2 plus headroom; tiny sample counts (smoke tests,
    # 2-frame datasets) go straight to PCA.
    if flat.shape[0] >= 4:
        try:
            from sklearn.manifold import TSNE

            p = min(perplexity, max(2, flat.shape[0] - 2))
            return (
                TSNE(n_components=2, random_state=42,
                     perplexity=p).fit_transform(flat),
                "tsne",
            )
        except ImportError:
            pass
    centered = flat - flat.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:2].T, "pca"


def write_diagnostics(vae, frames, out_dir, n_traversal_steps=7,
                      traversal_scale=2.0, n_recon_pairs=4):
    """Encode ``frames`` (N, H, W, C) with ``vae`` (an ``AutoencoderKL``,
    on the device its parameters are on) and write every diagnostic plot +
    a ``diagnostics.json`` summary. Factored out of ``main`` so the
    test tier can drive it with a freshly-initialized tiny VAE.

    The arrays the plots show (the latent means, their 2-D embedding, the
    traversals', reconstructions' and interpolation's decodes) also go to
    ``diagnostics.npz``; where matplotlib is not installed, as on a
    card's machine without it, that file and the summary are all that is
    written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(vae.parameters()).device
    frames = np.asarray(frames, np.float32)

    def decode(z):
        with torch.inference_mode():
            return vae.decode(torch.as_tensor(np.asarray(z, np.float32), device=device)
                              ).float().cpu().numpy()

    with torch.inference_mode():
        posterior = vae.encode(torch.as_tensor(frames, device=device))
    mean = posterior.mean.float().cpu().numpy()     # (N, h, w, latent_dim)
    logvar = posterior.logvar.float().cpu().numpy()
    latent_dim = mean.shape[-1]

    kl_dims = per_dim_kl(mean, logvar)
    summary = dict(
        per_dim_kl=[float(k) for k in kl_dims],
        collapsed_dims=[int(i) for i, k in enumerate(kl_dims) if k < 0.01],
        latent_mean=float(mean.mean()),
        latent_std=float(mean.std()),
        # A fully-collapsed posterior (identical means — the pathology
        # this tool diagnoses) has std 0: report null, not Infinity
        # (json.dump would emit non-spec `Infinity`).
        scaling_factor=(
            float(1.0 / mean.std()) if float(mean.std()) > 0 else None
        ),
    )

    # 2-D embedding of latent means (t-SNE or PCA).
    flat = mean.reshape(mean.shape[0], -1)
    proj, method = embed_2d(flat)
    summary["embedding_method"] = method

    # Per-channel latent traversal: add a constant to one channel of a
    # base latent and decode.
    z_base = mean[:1]
    vals = np.linspace(-traversal_scale, traversal_scale,
                       n_traversal_steps)
    traversals = []
    for dim in range(latent_dim):
        shift = np.zeros_like(z_base)
        shift[..., dim] = 1.0
        traversals.append(decode(np.concatenate([z_base + float(v) * shift for v in vals])))

    # Original vs reconstruction pairs.
    n_pairs = min(n_recon_pairs, frames.shape[0])
    recon = decode(mean[:n_pairs])

    # Latent interpolation between the first two frames.
    alphas = np.linspace(0, 1, 6)
    interpolation = (decode(np.stack([mean[0] * (1 - a) + mean[1] * a for a in alphas]))
                     if mean.shape[0] >= 2 else None)

    np.savez(out_dir / "diagnostics.npz", latent_means=mean, embedding=proj,
             traversal_values=vals, traversals=np.stack(traversals),
             reconstructions=recon,
             **({} if interpolation is None else dict(interpolation=interpolation)))
    with open(out_dir / "diagnostics.json", "w") as f:
        json.dump(summary, f, indent=2)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not installed: diagnostics.json and diagnostics.npz only")
        return summary

    plt.scatter(proj[:, 0], proj[:, 1], s=6)
    plt.title(f"latent means ({method})")
    plt.savefig(out_dir / "latent_embedding.png")
    plt.clf()

    # Latent histograms: overall + per channel, against N(0, 1).
    fig, axes = plt.subplots(
        1, 1 + latent_dim, figsize=(4 * (1 + latent_dim), 3)
    )
    axes = np.atleast_1d(axes)
    grid = np.linspace(-3, 3, 200)
    normal = np.exp(-grid**2 / 2) / np.sqrt(2 * np.pi)
    axes[0].hist(mean.reshape(-1), bins=100, density=True, alpha=0.7)
    axes[0].plot(grid, normal, "r--", lw=1)
    axes[0].set_title("all latent values")
    for c in range(latent_dim):
        axes[1 + c].hist(
            mean[..., c].reshape(-1), bins=60, density=True, alpha=0.7
        )
        axes[1 + c].plot(grid, normal, "r--", lw=1)
        axes[1 + c].set_title(f"channel {c} (KL {kl_dims[c]:.3f})")
    fig.tight_layout()
    fig.savefig(out_dir / "latent_histograms.png")
    plt.close(fig)

    # The traversals' u-velocity reconstructions.
    fig, axes = plt.subplots(
        latent_dim, n_traversal_steps,
        figsize=(2 * n_traversal_steps, 2 * latent_dim), squeeze=False,
    )
    for dim, recons in enumerate(traversals):
        for step, v in enumerate(vals):
            ax = axes[dim][step]
            ax.imshow(recons[step, ..., 0], cmap="viridis")
            ax.axis("off")
            if dim == 0:
                ax.set_title(f"{v:+.1f}", fontsize=9)
        axes[dim][0].text(
            -0.15, 0.5, f"ch {dim}", transform=axes[dim][0].transAxes,
            rotation=90, va="center",
        )
    fig.suptitle("latent traversal per channel (u recon)")
    fig.savefig(out_dir / "latent_traversals.png", dpi=120)
    plt.close(fig)

    fig, axes = plt.subplots(n_pairs, 2, figsize=(6, 3 * n_pairs),
                             squeeze=False)
    for i in range(n_pairs):
        axes[i][0].imshow(np.asarray(frames[i, ..., 0]), cmap="viridis")
        axes[i][0].set_title(f"original #{i}")
        axes[i][1].imshow(recon[i, ..., 0], cmap="viridis")
        axes[i][1].set_title(f"reconstruction #{i}")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_dir / "reconstructions.png")
    plt.close(fig)

    if interpolation is not None:
        fig, axs = plt.subplots(
            1, len(alphas), figsize=(2 * len(alphas), 2)
        )
        for ax, a, r in zip(axs, alphas, interpolation):
            ax.imshow(r[..., 0])
            ax.set_title(f"a={a:.1f}")
            ax.axis("off")
        fig.savefig(out_dir / "latent_interpolation.png")
        plt.close(fig)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None,
                    help="torch device of the encode and decode (the card by default)")
    known, rest = ap.parse_known_args(argv)
    args = Args.parse_args(rest)
    device = entry_device(known.device)
    set_numerics()
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    _, dev, _ = get_auto_dataset(
        data_dir=Path(args.data_dir),
        data_name=args.data_name,
        delta_time=args.delta_time,
        norm_props=bool(args.norm_props),
        norm_bc=bool(args.norm_bc),
        load_splits=["dev"],
        seed=args.seed,
        cache_dir=args.cache_dir or None,
    )
    frames = build_vae_dataset(dev).frames[:256]

    # Same variant/shape flags the trainer honors (cli.py main_vae) — a
    # v2- or custom-trained checkpoint restores into the right modules.
    vae = make_cfd_vae(
        args.vae_variant, 2, 2,
        args.z_channels if args.vae_variant == "custom"
        else args.ldm_latent_dim,
        ch=args.ch,
        ch_mult=tuple(args.ch_mult),
        num_res_blocks=args.num_res_blocks,
        generator=torch.Generator().manual_seed(0),
    )
    vae.load_state_dict(load_params(Path(args.ldm_vae_weights_path)))
    vae.to(device).eval()

    summary = write_diagnostics(vae, frames, out_dir)
    print("Per-dimension KL (collapse check; ~0 = collapsed):")
    for i, k in enumerate(summary["per_dim_kl"]):
        flag = "  <-- COLLAPSED" if i in summary["collapsed_dims"] else ""
        print(f"  dim {i}: {k:.4f}{flag}")
    print(
        f"latent mean stats: mean={summary['latent_mean']:.4f} "
        f"std={summary['latent_std']:.4f}"
    )
    sf = summary["scaling_factor"]
    print(
        "suggested scaling_factor = 1/std = "
        + (f"{sf:.4f}" if sf is not None else "undefined (collapsed)")
    )
    print(f"plots, diagnostics.json and diagnostics.npz written to {out_dir} "
          f"(embedding: {summary['embedding_method']})")
    return summary


if __name__ == "__main__":
    main()
