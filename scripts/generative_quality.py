#!/usr/bin/env python
"""Seeded quality of the diffusion models in both packages: the dev and
test nmse of generated frames beside the persistence baseline (the input
frame as the prediction), on a synthetic cavity tree.

Each model trains through each package's entry point (``main_auto`` for
pixel diffusion and the latent models ``latent_diffusion``,
``latent_diffusion2`` and ``latent_diffusion_lite``, ``main_gencast`` for
GenCast) from the same initial weights (the port's, handed to the JAX task
in place of its own init), with each package's own random draws, and is
evaluated at the end. The latent models decode with one lite VAE, trained
first by the JAX ``main_vae`` (``--vae_epochs``, from the port's init) and
carried to the port by ``export_torch_checkpoint.py``. The JAX package
runs on the CPU; so does the port, with ``device="cpu"``:

    python scripts/generative_quality.py [--epochs 10] [--base 8] [--grid 16]

It prints one JSON object: per model and package, ``dev_nmse`` (the
generated frames'; GenCast's ``gen_frame_nmse``), ``dev_persistence_nmse``,
``test_nmse`` and ``test_persistence_nmse``.
It imports the JAX package, as ``export_torch_checkpoint.py`` does, and is
no part of the port.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import jax  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from cfdbench_tpu import cli as jax_cli  # noqa: E402
from cfdbench_tpu.config import Args as JaxArgs  # noqa: E402
from cfdbench_tpu.models import diffusion as jax_diffusion  # noqa: E402
from cfdbench_tpu.models import vae as jax_vae  # noqa: E402
from cfdbench_tpu_torch import cli  # noqa: E402
from cfdbench_tpu_torch.config import Args  # noqa: E402
from cfdbench_tpu_torch.data import get_auto_dataset  # noqa: E402
from cfdbench_tpu_torch.data.synthetic import generate_problem  # noqa: E402
from cfdbench_tpu_torch.data.wrapper import compute_residual_stats, wrap_gencast  # noqa: E402
from cfdbench_tpu_torch.models import (  # noqa: E402
    LATENT_MODELS,
    init_gencast,
    init_latent_diffusion,
    init_pixel_diffusion,
    make_cfd_vae,
)
from cfdbench_tpu_torch.utils.flax_import import params_to_flax  # noqa: E402
from export_torch_checkpoint import export_vae  # noqa: E402  (this script's neighbour)


def scores(run: Path, epochs: int, model: str) -> dict:
    dev = json.loads((run / f"ckpt-{epochs - 1}" / "dev_scores.json").read_text())["mean"]
    test = json.loads((run / "test" / "scores.json").read_text())["mean"]
    return dict(dev_nmse=dev["gen_frame_nmse" if model == "gencast" else "nmse"],
                dev_persistence_nmse=dev["input_nmse"], test_nmse=test["nmse"],
                test_persistence_nmse=test["input_nmse"])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(REPO_ROOT / "build" / "generative_quality"))
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--base", type=int, default=8)
    parser.add_argument("--grid", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vae_epochs", type=int, default=5)
    opts = parser.parse_args(argv)
    out = Path(opts.out)
    shutil.rmtree(out, ignore_errors=True)
    generate_problem(out / "data", "cavity", cases_per_subset=4, num_frames=12, grid=opts.grid,
                     seed=opts.seed)
    common = [
        "--pixel_diffusion_base_channels", str(opts.base), "--pixel_diffusion_channel_mults",
        "1", "2", "--pixel_diffusion_num_res_blocks", "1", "--num_rows", str(opts.grid),
        "--num_cols", str(opts.grid), "--data_name", "cavity_prop_bc_geo", "--data_dir",
        str(out / "data"), "--num_epochs", str(opts.epochs), "--eval_interval", str(opts.epochs),
        "--batch_size", "16", "--eval_batch_size", "16", "--log_interval", "1000",
        "--mesh_shape", "1", "--mode", "train_test", "--plot_train_examples", "0",
        "--seed", str(opts.seed), "--lr", "1e-3"]
    train, _, _ = get_auto_dataset(out / "data", "cavity_prop_bc_geo", 0.1, True, True,
                                   load_splits=["train"])
    # The latent models: one lite VAE for both packages, a one-level latent
    # UNet of --base channels (the 16x16 grid's latents are 2x2).
    weights = out / "vae_weights"
    vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(opts.seed))
    vae_params = params_to_flax(vae.state_dict())
    own_vae_init = jax_vae.AutoencoderKL.init
    jax_vae.AutoencoderKL.init = lambda self, *a, **k: {"params": vae_params}
    try:
        jax_cli.main_vae(["--data_name", "cavity_prop_bc_geo", "--data_dir", str(out / "data"),
                          "--output_dir", str(out / "jax"), "--ldm_vae_weights_path",
                          str(weights), "--num_epochs", str(opts.vae_epochs), "--batch_size",
                          "16", "--seed", str(opts.seed), "--mesh_shape", "1"])
    finally:
        jax_vae.AutoencoderKL.init = own_vae_init
    latent = ["--ldm_vae_weights_path", str(weights), "--unet_base_channels", str(opts.base),
              "--unet_channel_mult", *(["1"] if opts.grid < 32 else ["1", "2"])]
    result = {}
    for model in ("pixel_diffusion", "gencast", "latent_diffusion", "latent_diffusion2",
                  "latent_diffusion_lite"):
        argv_of = {pkg: ["--model", model, "--output_dir", str(out / pkg)] + common + latent
                   for pkg in ("jax", "port")}
        args = Args.parse_args(argv_of["port"])
        if model in LATENT_MODELS:
            task = init_latent_diffusion(args, 5, vae.state_dict())
            cls = {"latent_diffusion": jax_diffusion.LatentDiffusionCfdModel,
                   "latent_diffusion2": jax_diffusion.LatentDiffusionCfdModel2,
                   "latent_diffusion_lite": jax_diffusion.LatentDiffusionCfdModelLite}[model]
            if not (weights / "model.pt").exists():
                export_vae(JaxArgs.parse_args(argv_of["jax"]))
        elif model == "pixel_diffusion":
            task, cls = init_pixel_diffusion(args, 5), jax_diffusion.PixelDiffusionCfdModel
        else:
            task = init_gencast(args, compute_residual_stats(wrap_gencast(train)), 5)
            cls = jax_diffusion.GenCastCfdModel
        params = params_to_flax(task.model.state_dict())
        own_init = cls.init_variables
        cls.init_variables = lambda self, rng, sample: (params, {})
        try:
            (jax_cli.main_gencast if model == "gencast" else jax_cli.main_auto)(argv_of["jax"])
        finally:
            cls.init_variables = own_init
        (cli.main_gencast if model == "gencast" else cli.main_auto)(argv_of["port"],
                                                                    device="cpu")
        result[model] = {pkg: scores(cli.run_dir(Args.parse_args(argv)), opts.epochs, model)
                         for pkg, argv in argv_of.items()}
    result["config"] = dict(vars(opts), tree="cavity, 4 cases a subset, 12 frames",
                            timesteps=1000, inference_steps=50, batch=16, lr=1e-3,
                            latent_unet_mults=latent[5:], vae="lite")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
