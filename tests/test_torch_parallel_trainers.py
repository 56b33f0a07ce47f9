"""Data parallelism in ``main_train``, ``main_gencast``, ``main_vae`` and
``main_uncond`` on the CPU: two ranks in spawned processes, in a gloo group
that meets through a file under the test's temporary directory
(``tests/_torch_dp_worker.py``).

- A trainer's step on two ranks, each on its block of the global batch,
  against the port's single process and against the JAX package's step on
  ``make_mesh("2")`` (the batch sharded over the conftest's virtual
  devices), from the same weights and with JAX's draws: the FFN on a
  global batch of 5 rows padded to 6, the DeepONet, GenCast's four
  micro-steps at ``--gradient_accumulation_steps 2`` (two updates), the
  VAE and the unconditional DDPM (its EMA), both on 5 rows padded to 6.
  Narrow widths: the PUNetG at base 8 and the custom VAE at 8 channels,
  both with four groups a GroupNorm (``test_torch_diffusion.four_groups``).
- ``GenCastAdamW``'s gate: a gradient that is not finite on one rank skips
  the update on both.
- ``main_train --mesh_shape 2 --mode train_test`` against the JAX
  ``main_train --mesh_shape 2`` (the port's query sampler replaced by JAX's
  draws, as ``test_torch_nonauto_cli.py`` does); ``main_gencast``,
  ``main_vae`` and ``main_uncond`` on two ranks against one process; each
  checkpoint written once, loadable without a group; ``--resume`` on the
  mesh; the VAE's plateau cut and early stop on the same epoch on both
  ranks.
"""

import copy
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfdbench_tpu.cli import main_train as jax_main_train
from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models import init_nonauto_model as jax_init_nonauto_model
from cfdbench_tpu.models import punetg as jax_punetg
from cfdbench_tpu.models import vae as jax_vae
from cfdbench_tpu.models.punetg import PUNetGCFD as JaxPUNetG
from cfdbench_tpu.ops import diffusion as jax_ops
from cfdbench_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from cfdbench_tpu.parallel.mesh import replicated_sharding
from cfdbench_tpu.training import trainer_nonauto as jax_trainer_nonauto
from cfdbench_tpu.training.optim import make_adam as jax_make_adam
from cfdbench_tpu.training.trainer_gencast import make_gencast_tx as jax_make_gencast_tx
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_nonauto_model, make_cfd_vae
from cfdbench_tpu_torch.models.common import num_groups_for
from cfdbench_tpu_torch.parallel import mesh as port_mesh
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training import trainer_gencast, trainer_uncond
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils.rng import train_key, uncond_key, vae_key
from tests import _torch_dp_worker as worker
from tests.test_torch_diffusion import SMALL, jax_dropout_masks, jax_key, jax_train_noise_and_t
from tests.test_torch_generative_cli import gen_argv
from tests.test_torch_nonauto import NONAUTO_FLAGS
from tests.test_torch_nonauto_cli import jax_draws, nonauto_run
from tests.test_torch_parallel import jax_data_shards  # noqa: F401  (a fixture)
from tests.test_torch_train import (  # noqa: F401  (port_tree is a fixture)
    assert_close_rel,
    port_tree,
    result_files,
)
from tests.test_torch_uncond import jax_uncond_noise_and_t
from tests.test_torch_vae import jax_posterior_noise

torch.set_num_threads(1)

LOSS_RTOL = 1e-5  # a step's scores, relative
FORWARD_RTOL = 2e-5  # the network's output, of its largest
GRAD_RTOL = 1e-5  # each gradient, of the largest
PARAM_RTOL = 1e-5  # the parameters after the steps, of the largest
# Two ranks against one process through an entry point: the per-step and
# per-epoch losses, and the scores (relative); the weights (of the largest).
RUN_RTOL = 1e-5
H = W = 16
LR = 1e-3
GENCAST_WIDTHS = dict(SMALL)  # base 8, mults 1-2, one res block, dropout 0.1, T 20
VAE_WIDTHS = dict(variant="custom", latent_dim=4, ch=8, ch_mult=(1, 2), num_res_blocks=1)
UNCOND_BASE, UNCOND_T = 8, 10
STEP_CASES = ["ffn", "deeponet", "gencast", "vae", "uncond"]
# The calls of the two ranks' CLI job, in order.
CALLS = ["main_train", "main_train_cut", "main_train_resumed", "main_gencast", "main_vae",
         "main_uncond"]


# --- one step of each trainer ---------------------------------------------

def four_groups(mp):
    """The JAX PUNetG's and VAE's GroupNorms at four groups, as the worker
    builds the port's."""
    mp.setattr(jax_punetg, "_num_groups", lambda groups, c: num_groups_for(4, c))
    mp.setattr(jax_vae, "num_groups_for", lambda groups, c: num_groups_for(4, c))


def rows(rng, B, valid, **shapes):
    """A seeded global batch of ``B`` rows of ``shapes``, the last ``B -
    valid`` of them zero padding with weight 0."""
    batch = {k: rng.standard_normal((B,) + s).astype(np.float32) for k, s in shapes.items()}
    for v in batch.values():
        v[valid:] = 0
    batch["weights"] = (np.arange(B) < valid).astype(np.float32)
    return batch


def nonauto_case(name, rng, B, valid):
    flags = NONAUTO_FLAGS[name]
    net = init_nonauto_model(Args.parse_args(flags), n_case_params=5)
    batch = rows(rng, B, valid, case_params=(5,), t=(1,), labels=(H, W, 1))
    batch["t"] = np.abs(batch["t"]) * 10
    return dict(model=name, flags=flags, state=net.state_dict(), lr=LR, batches=[batch],
                keys=[jax_draws(0, 0, 1000, H, W).numpy()])


def gencast_case(rng):
    """Four micro-batches of 4 rows (the last with 3 real), two of them a
    update: the schedule's first update runs at lr 0 (its warmup), the
    second at ``lr``."""
    with worker.four_groups():
        task = worker.make_task("gencast", GENCAST_WIDTHS)
    batches = [rows(rng, 4, 3 if i == 3 else 4, inputs=(H, W, 2), inputs_prev=(H, W, 2),
                    labels=(H, W, 2), mask=(H, W, 1), case_params=(5,)) for i in range(4)]
    for b in batches:
        b["mask"] = (b["mask"] > -0.8).astype(np.float32)
    keys = [train_key(trainer_gencast.TRAIN_KEY_OFFSET, s) for s in range(4)]
    shapes = task.model.dropout_shapes((4, H, W, 6))
    with pytest.MonkeyPatch.context() as mp:
        four_groups(mp)
        masks = jax_dropout_masks(jax_gencast_task().unet)
        draws = dict(noise_and_t={}, masks={})
        for key in keys:
            noise, t = jax_train_noise_and_t(key, (4, H, W, 2), GENCAST_WIDTHS[
                "noise_scheduler_timesteps"], "cpu")
            draws["noise_and_t"][key] = (noise.numpy(), t.numpy())
            draws["masks"][key] = [m.numpy() for m in masks(key, shapes, 0.1, "cpu")]
    return dict(model="gencast", widths=GENCAST_WIDTHS, state=task.model.state_dict(), lr=LR,
                batches=batches, keys=keys, draws=draws, accum=2, weight_decay=1e-2)


def vae_case(rng):
    with worker.four_groups():
        net = make_cfd_vae(**VAE_WIDTHS, generator=torch.Generator().manual_seed(0))
    batch = rows(rng, 6, 5, frames=(H, W, 2))
    key = vae_key(2, 0)
    latent = net.encode(torch.from_numpy(batch["frames"])).mean.shape
    draws = dict(posterior={key: jax_posterior_noise(key, latent, "cpu").numpy()})
    return dict(model="vae", widths=VAE_WIDTHS, state=net.state_dict(), lr=LR, batches=[batch],
                keys=[key], draws=draws, kl_weight=1e-2)


def jax_uncond_unet():
    return JaxPUNetG(in_channels=2, out_channels=2, base_channels=UNCOND_BASE, n_case_params=1)


def uncond_case(rng):
    case = dict(model="uncond", widths=dict(base_channels=UNCOND_BASE, timesteps=UNCOND_T), lr=LR)
    net = worker.make_uncond_unet(case)
    batch = rows(rng, 6, 5, x=(H, W, 2))
    key = uncond_key(3, 0)
    noise, t = jax_uncond_noise_and_t(key, (6, H, W, 2), UNCOND_T, "cpu")
    masks = jax_dropout_masks(jax_uncond_unet(), n_case_params=1,
                              dropout_key=lambda k: jax.random.split(jax_key(k), 3)[2])
    draws = dict(noise_and_t={key: (noise.numpy(), t.numpy())},
                 masks={key: [m.numpy() for m in masks(key, net.dropout_shapes((6, H, W, 2)),
                                                       net.dropout, "cpu")]})
    return dict(case, state=net.state_dict(), batches=[batch], keys=[key], draws=draws)


def gate_case(rng):
    """Six steps of GenCastAdamW on three tensors; at step 2 rank 1's
    gradient holds a NaN and rank 0's does not."""
    shapes = [(3, 4), (5,), (2, 2, 3)]
    grads = [[[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
             for _ in range(6)]
    grads[2][1][1][3] = np.nan
    return dict(start=[rng.standard_normal(s).astype(np.float32) for s in shapes], lr=1e-2,
                grads=grads, kw=dict(total_steps=6, warmup_steps=1, weight_decay=1e-2))


def jax_gencast_task():
    return jax_diffusion.GenCastCfdModel(
        jax_loss_name_to_fn("nmse"), residual_mean=np.array(worker.GENCAST_STATS[0], np.float32),
        residual_std=np.array(worker.GENCAST_STATS[1], np.float32), **GENCAST_WIDTHS)


def jax_step_fn(case):
    """``(loss(params, batch, draw) -> (loss, scores), tx, the draws)`` of
    the JAX package's trainer for the case: its task's loss (the VAE's and
    the DDPM's as their trainers write them) and its optimizer."""
    model = case["model"]
    if model in ("ffn", "deeponet"):
        task = jax_trainer_nonauto.NonAutoTask(
            jax_init_nonauto_model(JaxArgs.parse_args(case["flags"]), n_case_params=5),
            jax_loss_name_to_fn("nmse"))
        return task.loss_scores, jax_make_adam(case["lr"], steps_per_epoch=10), case["keys"]
    rngs = [jax_key(k) for k in case["keys"]]
    if model == "gencast":
        task = jax_gencast_task()

        def loss(p, b, rng):
            value, (scores, _) = task.loss_scores(p, b, train=True, rng=rng)
            return value, scores

        tx = jax_make_gencast_tx(case["lr"], len(case["batches"]), warmup_steps=1,
                                 weight_decay=case["weight_decay"], grad_accum_steps=case["accum"])
        return loss, tx, rngs
    if model == "vae":
        vae = jax_vae.make_cfd_vae(**VAE_WIDTHS)

        def loss(p, b, rng):  # trainer_vae.make_steps' loss_parts
            recon, posterior = vae.apply({"params": p}, b["frames"], rng=rng, train=True)
            w = b["weights"]

            def wmean(x):
                return jnp.sum(x * w) / jnp.maximum(jnp.sum(w), 1.0)

            rec = wmean(jnp.mean(jnp.square(recon - b["frames"]), axis=(1, 2, 3)))
            kl = wmean(posterior.kl())
            total = rec + case["kl_weight"] * kl
            return total, dict(total=total, recon=rec, kl=kl)

        return loss, optax.adam(case["lr"]), rngs
    unet, scheduler = jax_uncond_unet(), jax_ops.make_ddpm_scheduler(UNCOND_T)

    def loss(p, b, rng):  # trainer_uncond's step
        x, w = b["x"], b["weights"]
        nkey, tkey, dkey = jax.random.split(rng, 3)
        noise = jax.random.normal(nkey, x.shape, x.dtype)
        t = jax.random.randint(tkey, (x.shape[0],), 0, UNCOND_T)
        eps = unet.apply({"params": p}, scheduler.add_noise(x, noise, t), t,
                         jnp.zeros((x.shape[0], 1), x.dtype), train=True, rngs={"dropout": dkey})
        per = jnp.mean(jnp.square(eps - noise), axis=(1, 2, 3))
        value = jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)
        return value, dict(loss=value)

    return loss, optax.adamw(case["lr"]), rngs


def jax_steps(case, mesh):
    """The JAX trainer's steps of ``case`` on ``mesh``: the parameters
    replicated, each batch sharded over its data axis. Returns the first
    step's scores and gradients and the parameters after the last, in the
    port's layout."""
    loss, tx, draws = jax_step_fn(case)
    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    update = jax.jit(tx.update)
    params = jax.device_put(params_to_flax(case["state"]), replicated_sharding(mesh))
    state = tx.init(params)
    first = None
    for batch, draw in zip(case["batches"], draws):
        (_, scores), grads = grad_fn(params, jax.device_put(batch, batch_sharding(mesh)), draw)
        if first is None:
            first = dict(scores={k: float(v) for k, v in scores.items()},
                         grads=params_from_flax(jax.device_get(grads)))
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return dict(first, params=params_from_flax(jax.device_get(params)))


@pytest.fixture(scope="module")
def trainer_steps(tmp_path_factory, jax_data_shards):  # noqa: F811
    """Each case's steps on two ranks, in one process, and in JAX on a
    2-device mesh; the gate's parameters on two ranks and in one process."""
    rng = np.random.default_rng(0)
    cases = {"ffn": nonauto_case("ffn", rng, 6, 5), "deeponet": nonauto_case("deeponet", rng, 4, 4),
             "gencast": gencast_case(rng), "vae": vae_case(rng), "uncond": uncond_case(rng)}
    gate = gate_case(rng)
    ranks = worker.spawn(dict(kind="trainer_steps", cases=cases, gate=gate),
                         tmp_path_factory.mktemp("dp_trainer_steps"))
    single = {name: worker.trainer_step(case, port_mesh.SINGLE) for name, case in cases.items()}
    mean_grads = [[np.mean(pair, axis=0) for pair in zip(*per_rank)] for per_rank in gate["grads"]]
    single["gate"] = worker.gate(dict(gate, grads=[[g] for g in mean_grads]), port_mesh.SINGLE)
    mesh = jax_make_mesh("2", tune_spectral=False)
    with pytest.MonkeyPatch.context() as mp:
        four_groups(mp)
        jax_results = {name: jax_steps(case, mesh) for name, case in cases.items()}
    return cases, ranks, single, jax_results


def assert_step_close(got, want, want_grads, lr, what, forward=None):
    """Scores within LOSS_RTOL; each gradient within GRAD_RTOL of the
    largest; the parameters within PARAM_RTOL of the largest, but where the
    two gradients may differ in sign (below twice their bound): Adam's first
    step moves an element by lr·g/(|g| + eps), so there within 2 lr more
    (``test_torch_parallel.assert_params_close``); the network's output,
    when given, within FORWARD_RTOL of its largest."""
    assert got["scores"].keys() == want["scores"].keys(), what
    for k, v in want["scores"].items():
        assert math.isclose(got["scores"][k], v, rel_tol=LOSS_RTOL), (what, k, got["scores"][k], v)
    gmax = max(g.abs().max().item() for g in want_grads.values())
    for k, g in want_grads.items():
        d = (got["grads"][k] - g).abs().max().item()
        assert d <= GRAD_RTOL * gmax, (what, "grad", k, d / gmax)
    pmax = max(p.abs().max().item() for p in want["params"].values())
    for k, p in want["params"].items():
        d = (got["params"][k] - p).abs()
        big = want_grads[k].abs() > 2 * GRAD_RTOL * gmax
        if big.any():
            assert d[big].max().item() <= PARAM_RTOL * pmax, (what, "param", k, d.max() / pmax)
        assert d.max().item() <= 2 * lr + PARAM_RTOL * pmax, (what, "param", k, d.max())
    if forward is not None:
        assert got["output"].shape == forward.shape, what
        d = (got["output"] - forward).abs().max().item()
        assert d <= FORWARD_RTOL * forward.abs().max().item(), (what, "output", d)


@pytest.mark.parametrize("name", STEP_CASES)
def test_trainer_step_matches_one_process(trainer_steps, name):
    """Two ranks, each on its block, against one process on the whole
    global batch: the scores, the network's output (gathered), the
    gradients (averaged), the parameters after the steps, equal on both
    ranks; the DDPM's EMA too."""
    _, ranks, single, _ = trainer_steps
    want = single[name]
    for rank, result in enumerate(ranks):
        assert_step_close(result[name], want, want["grads"], LR, (name, rank), want["output"])
    for k, p in ranks[0][name]["params"].items():
        assert torch.equal(p, ranks[1][name]["params"][k]), (name, k)
    if name == "uncond":
        for k, e in want["ema"].items():
            assert torch.equal(ranks[0][name]["ema"][k], ranks[1][name]["ema"][k]), k
            d = (ranks[0][name]["ema"][k] - e).abs().max().item()
            assert d <= PARAM_RTOL * e.abs().max().item() + 1e-12, k


@pytest.mark.parametrize("name", STEP_CASES)
def test_trainer_step_matches_jax_on_a_mesh(trainer_steps, name):
    """Two ranks against the JAX trainer's step on a 2-device mesh from the
    same weights and draws: the scores, the gradients (GenCast's first
    micro-batch's), the parameters after the steps."""
    _, ranks, _, jax_results = trainer_steps
    want = jax_results[name]
    assert_step_close(ranks[0][name], want, want["grads"], LR, name)


def test_gencast_gate_skips_a_non_finite_gradient_on_every_rank(trainer_steps):
    """Rank 1's gradient holds a NaN at step 2: the averaged gradient does
    on both ranks, so both skip that update and stay equal, and every step
    equals one process's on the averaged gradients."""
    _, ranks, single, _ = trainer_steps
    got0, got1, want = ranks[0]["gate"], ranks[1]["gate"], single["gate"]
    for step, (a, b, w) in enumerate(zip(got0, got1, want)):
        for x, y, z in zip(a, b, w):
            assert torch.equal(x, y), step
            torch.testing.assert_close(x, z, rtol=1e-6, atol=0)
    for x, y in zip(got0[2], got0[1]):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(got0[3], got0[2]))


# --- the entry points -------------------------------------------------------

def dp(argv):
    return argv + ["--mesh_shape", "2"]


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """A 16x16 cavity tree of 12 cases, 3 frames each, for the VAE
    (``test_torch_vae.tiny_tree``)."""
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    root = tmp_path_factory.mktemp("dp_tiny_tree")
    generate_problem(root, "cavity", cases_per_subset=4, num_frames=3, grid=16, seed=0)
    return root


def train_argv(data_root, out, epochs):
    return NONAUTO_FLAGS["deeponet"] + [
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root), "--output_dir",
        str(out), "--num_epochs", str(epochs), "--batch_size", "16", "--eval_interval", "1",
        "--log_interval", "100"]


def vae_argv(data_root, out):
    """Five epochs at most; no epoch after the first beats the best by the
    huge delta, so the rate is cut after each (patience 0) and the run stops
    after epoch 2 (patience 1)."""
    return ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out / "result"), "--ldm_vae_weights_path", str(out / "w"),
            "--vae_variant", "custom", "--ch", "4", "--ch_mult", "1", "2", "--num_res_blocks",
            "1", "--z_channels", "2", "--num_epochs", "5", "--batch_size", "6", "--lr", "1e-3",
            "--mode", "train_anneal", "--lr_scheduler_patience", "0",
            "--early_stopping_patience", "1", "--early_stopping_delta", "1e9"]


def uncond_argv(data_root, out):
    return ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out), "--num_epochs", "2", "--batch_size", "14",
            "--lr", "1e-3", "--pixel_diffusion_base_channels", str(UNCOND_BASE),
            "--ldm_noise_scheduler_timesteps", str(UNCOND_T), "--seed", "3"]


def gencast_argv(data_root, out):
    return gen_argv("gencast", data_root, 1, out)[:-2] + ["--gradient_accumulation_steps", "2",
                                                           "--mode", "train_test"]


@pytest.fixture(scope="module")
def cli_runs(port_tree, tiny_tree, tmp_path_factory, jax_data_shards):  # noqa: F811
    """The entry points on two ranks: ``main_train --mode train_test`` for 2
    epochs (and 1 epoch, then ``--resume`` for the second), ``main_gencast
    --mode train_test``, ``main_vae`` and ``main_uncond``; the JAX
    ``main_train --mesh_shape 2`` from the port's initial weights; the
    others in one process. The query points are JAX's in every
    ``main_train``."""
    root = tmp_path_factory.mktemp("dp_cli")
    train = train_argv(port_tree, root / "jax", 2) + ["--mode", "train_test"]
    start = init_nonauto_model(Args.parse_args(train), n_case_params=5).state_dict()
    params = params_to_flax(start)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_nonauto.NonAutoTask, "init_params", lambda self, r, s: params)
        jax_main_train(dp(train))
    resumed = train_argv(port_tree, root / "resumed", 2) + ["--mode", "train"]
    entries = {
        "main_gencast": gencast_argv(port_tree, root / "{}_gencast"),
        "main_vae": vae_argv(tiny_tree, root / "{}_vae"),
        "main_uncond": uncond_argv(port_tree, root / "{}_uncond"),
    }
    calls = [("main_train", dp(train_argv(port_tree, root / "port", 2) + ["--mode", "train_test"])),
             ("main_train", dp(resumed + ["--num_epochs", "1"])),
             ("main_train", dp(resumed + ["--resume", "1"]))]
    calls += [(entry, dp([a.format("mesh") for a in argv])) for entry, argv in entries.items()]
    query_draws = [jax_draws(0, s, 1000, H, W).numpy() for s in range(20)]
    ranks = worker.spawn(dict(kind="cli", calls=calls, query_draws=query_draws),
                         root / "ranks")
    single = {}
    for entry, argv in entries.items():
        single[entry] = getattr(cli, entry)([a.format("single") for a in argv], device="cpu")
    return root, ranks, single, entries


def entry_run(root, entry, which):
    """The result directory of ``entry``'s run ``which`` (mesh or single)."""
    if entry == "main_gencast":
        return cli.run_dir(Args.parse_args(gencast_argv("", root / f"{which}_gencast")))
    if entry == "main_vae":
        return root / f"{which}_vae" / "result" / "vae" / "cavity_prop_bc_geo"
    if entry == "main_uncond":
        return root / f"{which}_uncond" / "uncond_ddpm" / "cavity_prop_bc_geo"
    return nonauto_run(train_argv("", root / which, 2))


def load(run, name):
    return json.loads((run / name).read_text())


def test_main_train_on_two_ranks_matches_jax_on_two_devices(cli_runs):
    """Per-step train losses, dev losses, test scores and predictions
    against the JAX main_train --mesh_shape 2, at the entry points' rel
    1e-4 (``test_torch_nonauto_cli.py``); both ranks return the same
    weights."""
    root, ranks, _, _ = cli_runs
    got_run, want_run = entry_run(root, "main_train", "port"), entry_run(root, "main_train", "jax")
    assert result_files(got_run) == result_files(want_run)
    assert_close_rel(load(got_run, "train_losses.json"), load(want_run, "train_losses.json"),
                     "train losses")
    for ep in (0, 1):
        got, want = (load(r, f"ckpt-{ep}/dev_loss.json") for r in (got_run, want_run))
        assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), f"dev {ep}")
    got, want = load(got_run, "test/scores.json"), load(want_run, "test/scores.json")
    assert_close_rel(list(got["mean"].values()), list(want["mean"].values()), "test scores")
    assert_close_rel(got["all"]["nmse"], want["all"]["nmse"], "test nmse per frame")
    np.testing.assert_allclose(np.load(got_run / "test/preds.npy"),
                               np.load(want_run / "test/preds.npy"), rtol=0, atol=1e-4)
    torch.testing.assert_close(ranks[0]["states"][0], ranks[1]["states"][0], rtol=0, atol=0)


def leaves(obj):
    """The numbers of a JSON value, in key order."""
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in leaves(obj[k])]
    if isinstance(obj, list):
        return [x for v in obj for x in leaves(v)]
    return [obj]


def assert_runs_close(got_run, want_run, names, what):
    for name in names:
        got, want = (leaves(load(r, name)) for r in (got_run, want_run))
        assert len(got) == len(want), (what, name)
        for g, w in zip(got, want):
            assert math.isclose(g, w, rel_tol=RUN_RTOL, abs_tol=1e-12), (what, name, g, w)


@pytest.mark.parametrize("entry", ["main_gencast", "main_vae", "main_uncond"])
def test_entry_point_on_two_ranks_matches_one_process(cli_runs, entry):
    """The run's files, losses and scores against one process's within
    RUN_RTOL, and the weights both ranks return: equal to each other, and
    to one process's within RUN_RTOL of the largest."""
    root, ranks, single, _ = cli_runs
    got_run, want_run = (entry_run(root, entry, w) for w in ("mesh", "single"))
    assert result_files(got_run) == result_files(want_run)
    if entry == "main_gencast":
        assert_runs_close(got_run, want_run, ["ckpt-0/dev_scores.json", "test/scores.json"],
                          entry)
        assert load(got_run, "training_meta.json").keys() == {"epoch", "best_nmse", "dev_nmse"}
        np.testing.assert_allclose(np.load(got_run / "test/preds.npy"),
                                   np.load(want_run / "test/preds.npy"), rtol=0,
                                   atol=RUN_RTOL * np.abs(np.load(want_run / "test/preds.npy")).max())
    elif entry == "main_vae":
        assert_runs_close(got_run, want_run, ["loss_history.json"], entry)
    else:
        assert_runs_close(got_run, want_run, ["train_losses.json"], entry)
    got = [r["states"][CALLS.index(entry)] for r in ranks]
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)
    want = network_output(entry, single[entry], worker.returned_state(single[entry]))
    out = network_output(entry, single[entry], got[0])
    assert (out - want).abs().max().item() <= RUN_RTOL * want.abs().max().item(), entry


def network_output(entry, single, state):
    """The output of the run's network with the weights ``state`` on a
    seeded input. Its weights are not compared one by one: a bias that a
    GroupNorm of one channel a group cancels has a gradient of rounding
    alone, which Adam turns into steps of ±lr, and the output does not
    depend on it."""
    if entry == "main_vae":
        net = trained_network(entry, single)
    else:
        net = copy.deepcopy(single.model if entry == "main_gencast" else single[0])
    net.load_state_dict(state)
    net.eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if entry == "main_vae":
            return net(torch.randn((2, 64, 64, 2), generator=gen))[0]
        x = torch.randn((2, H, W, 6 if entry == "main_gencast" else 2), generator=gen)
        t = torch.tensor([1, 7])
        case_params = torch.randn((2, 5 if entry == "main_gencast" else 1), generator=gen)
        return net(x, t, case_params)


def trained_network(entry, single):
    """A network of the CLI run's widths, built in this process."""
    if entry == "main_train":
        return init_nonauto_model(Args.parse_args(train_argv("", "", 2)), n_case_params=5)
    if entry == "main_vae":
        return make_cfd_vae("custom", 2, 2, 2, ch=4, ch_mult=(1, 2), num_res_blocks=1,
                            generator=torch.Generator())
    return single.model if entry == "main_gencast" else single[0]


@pytest.mark.parametrize("entry,weights", [
    ("main_train", "ckpt-1"), ("main_gencast", trainer_gencast.BEST_DIR), ("main_vae", None),
    ("main_uncond", trainer_uncond.EMA_DIR)])
def test_dp_checkpoints_are_written_once_and_load_without_a_group(cli_runs, entry, weights):
    """Rank 0 writes each file once: the run holds the files of one
    process's run (a second save of a checkpoint would leave a backup beside
    it; ``main_train``'s are held to the JAX run's, which are one process's,
    ``test_torch_nonauto_cli.py``). Its weights hold host tensors and load
    into a network in a process without a group."""
    root, _, single, _ = cli_runs
    if entry == "main_train":
        run, other = (entry_run(root, entry, w) for w in ("port", "jax"))
    else:
        run, other = (entry_run(root, entry, w) for w in ("mesh", "single"))
    assert result_files(run) == result_files(other)
    assert (run / ckpt.STATE_DIR / ckpt.MODEL_FILE).exists()
    path = root / "mesh_vae" / "w" if entry == "main_vae" else run / weights
    assert not (path / ckpt.BACKUP_FILE).exists(), path
    state = torch.load(path / ckpt.MODEL_FILE, weights_only=True)
    assert {v.device.type for v in state.values()} == {"cpu"}
    trained_network(entry, single.get(entry)).load_state_dict(state)


def test_resume_on_the_mesh_continues_as_one_run(cli_runs):
    """One epoch, then --resume on the mesh for the second: the straight
    run's per-step losses and weights, exactly."""
    root, ranks, _, _ = cli_runs
    straight, resumed = (entry_run(root, "main_train", w) for w in ("port", "resumed"))
    assert load(resumed, "train_losses.json") == load(straight, "train_losses.json")
    got = torch.load(resumed / "ckpt-1" / ckpt.MODEL_FILE, weights_only=True)
    want = torch.load(straight / "ckpt-1" / ckpt.MODEL_FILE, weights_only=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ranks[1]["states"][2], ranks[0]["states"][0], rtol=0, atol=0)


def test_vae_cuts_its_rate_and_stops_on_the_same_epoch_on_every_rank(cli_runs):
    """Each rank prints the dev loss it read, the rate it cut to and where
    it stopped: the same on both ranks and in one process, so no rank waits
    at a collective that another left."""
    root, ranks, _, _ = cli_runs
    vae_call = CALLS.index("main_vae")

    def epochs(printed):
        return re.findall(r"ep (\d+): val_total=(\S+) .* lr=(\S+) ", printed)

    got = [epochs(r["printed"][vae_call]) for r in ranks]
    assert got[0] == got[1] and [ep for ep, _, _ in got[0]] == ["0", "1", "2"]
    for r in ranks:
        assert r["printed"][vae_call].count("plateau: lr reduced") == 2
        assert "Early stopping." in r["printed"][vae_call]
    history = load(entry_run(root, "main_vae", "single"), "loss_history.json")
    assert [val for _, val, _ in got[0]] == [f"{v:.6f}" for v in history["val_total"]]
    meta = load(entry_run(root, "main_vae", "mesh"), "training_meta.json")
    assert meta["epoch"] == 2 and meta["cur_lr"] == pytest.approx(1e-3 * 0.25)
