#!/usr/bin/env python
"""Seeded quality of pixel diffusion and GenCast in both packages: the dev
and test nmse of generated frames beside the persistence baseline (the
input frame as the prediction), on a synthetic cavity tree.

Each model trains through each package's entry point (``main_auto`` for
pixel diffusion, ``main_gencast`` for GenCast) from the same initial
weights (the port's, handed to the JAX task in place of its own init),
with each package's own random draws, and is evaluated at the end. The
JAX package runs on the CPU; so does the port, with ``device="cpu"``:

    python scripts/generative_quality.py [--epochs 10] [--base 8] [--grid 16]

It prints one JSON object: per model and package, ``dev_nmse`` (pixel
diffusion's generated frames; GenCast's ``gen_frame_nmse``),
``dev_persistence_nmse``, ``test_nmse`` and ``test_persistence_nmse``.
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

jax.config.update("jax_platforms", "cpu")

from cfdbench_tpu import cli as jax_cli  # noqa: E402
from cfdbench_tpu.models import diffusion as jax_diffusion  # noqa: E402
from cfdbench_tpu_torch import cli  # noqa: E402
from cfdbench_tpu_torch.config import Args  # noqa: E402
from cfdbench_tpu_torch.data import get_auto_dataset  # noqa: E402
from cfdbench_tpu_torch.data.synthetic import generate_problem  # noqa: E402
from cfdbench_tpu_torch.data.wrapper import compute_residual_stats, wrap_gencast  # noqa: E402
from cfdbench_tpu_torch.models import init_gencast, init_pixel_diffusion  # noqa: E402
from cfdbench_tpu_torch.utils.flax_import import params_to_flax  # noqa: E402


def scores(run: Path, epochs: int, model: str) -> dict:
    dev = json.loads((run / f"ckpt-{epochs - 1}" / "dev_scores.json").read_text())["mean"]
    test = json.loads((run / "test" / "scores.json").read_text())["mean"]
    return dict(dev_nmse=dev["nmse" if model == "pixel_diffusion" else "gen_frame_nmse"],
                dev_persistence_nmse=dev["input_nmse"], test_nmse=test["nmse"],
                test_persistence_nmse=test["input_nmse"])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(REPO_ROOT / "build" / "generative_quality"))
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--base", type=int, default=8)
    parser.add_argument("--grid", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
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
    result = {}
    for model in ("pixel_diffusion", "gencast"):
        argv_of = {pkg: ["--model", model, "--output_dir", str(out / pkg)] + common
                   for pkg in ("jax", "port")}
        args = Args.parse_args(argv_of["port"])
        if model == "pixel_diffusion":
            task, cls = init_pixel_diffusion(args, 5), jax_diffusion.PixelDiffusionCfdModel
        else:
            task = init_gencast(args, compute_residual_stats(wrap_gencast(train)), 5)
            cls = jax_diffusion.GenCastCfdModel
        params = params_to_flax(task.model.state_dict())
        own_init = cls.init_variables
        cls.init_variables = lambda self, rng, sample: (params, {})
        try:
            (jax_cli.main_auto if model == "pixel_diffusion" else jax_cli.main_gencast)(
                argv_of["jax"])
        finally:
            cls.init_variables = own_init
        (cli.main_auto if model == "pixel_diffusion" else cli.main_gencast)(argv_of["port"],
                                                                            device="cpu")
        result[model] = {pkg: scores(cli.run_dir(Args.parse_args(argv)), opts.epochs, model)
                         for pkg, argv in argv_of.items()}
    result["config"] = dict(vars(opts), tree="cavity, 4 cases a subset, 12 frames",
                            timesteps=1000, inference_steps=50, batch=16, lr=1e-3)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
