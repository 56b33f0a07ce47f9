"""The port's spatial sharding on the CPU, apart from the model steps
(``tests/test_torch_sp_models.py``): gloo ranks spawned as
``tests/_torch_dp_worker.py`` spawns them.

- The exchanges of ``parallel/spatial.py`` on two and four ranks against
  the whole computation, forward and backward: the halo of 1 and 3 rows at
  the zero and the replicated edges, the real and the complex row sums,
  the row gather; the block kernel's backward (``fno_block_vjp``) on a
  rank's rows against the whole grid's.
- The FNO's step on a 66-row grid over two ranks (33 rows a rank) against
  one process.
- (The split block kernel, through its CPU emulation and on the card, is
  in ``tests/test_torch_kernels.py``, which imports no JAX.)
- ``main_auto --mesh_shape 1x2 --shard_spatial 1`` against one process:
  the test scores (whole rows, rel 1e-4), the dev scores (rel 1e-4), the
  losses (rel 1e-5) and the weights (1e-5 of the largest); ``--resume``
  across the layouts both ways; ``--shard_spatial 1`` on one process.
- The refusals: rows that do not split (next to JAX's own), a pooling
  across ranks, and the flags left for ROADMAP.md A15e and C; the U-Net's
  levels that leave a rank without a row, accepted.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfdbench_tpu.models.resnet import ResNet as JaxResNet
from cfdbench_tpu.parallel.mesh import batch_sharding_spatial
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.models.common import MaxPool2
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import init_spectral_weights
from cfdbench_tpu_torch.parallel.mesh import DataMesh, ModelAxis
from cfdbench_tpu_torch.parallel.spatial import Rows
from cfdbench_tpu_torch.training import checkpoints as ckpt
from cfdbench_tpu_torch.training.trainer_auto import check_spatial
from tests import _torch_dp_worker as worker
from tests.test_torch_train import port_tree, train_argv  # noqa: F401

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
SCORE_RTOL = 1e-4
WEIGHT_RTOL = 1e-5  # of the largest weight
HALOS = [(1, False), (1, True), (3, True), (3, False)]
FNO_WIDTHS = dict(num_layers=2, hidden_dim=8, modes1=4, modes2=4)


# --- the exchanges -----------------------------------------------------------

def ops_job(M, rng, H=16, cases=None):
    """A spatial_ops job over M model ranks on a float64 field of H rows."""
    B, W, C = 2, 5, 3
    x = rng.standard_normal((B, H, W, C))
    h = H // M
    job = dict(kind="spatial_ops", mesh=f"1x{M}", x=x, halos=HALOS,
               c=rng.standard_normal((B, H, W, C)),
               halo_grads=[[rng.standard_normal((B, h + 2 * k, W, C)) for _ in range(M)]
                           for k, _ in HALOS],
               sum_grads=[[rng.standard_normal((B, W, C)) for _ in range(3)] for _ in range(M)],
               cases=cases or {})
    gen = torch.Generator().manual_seed(1)
    job["vjp"] = dict(x=rng.standard_normal((2, H, 12, 4)).astype(np.float32),
                      weights=(init_spectral_weights(gen, 4, 4, 4, 4) * 4).numpy(),
                      w0=(torch.randn((4, 4), generator=gen) / 2).numpy(),
                      b0=(torch.randn(4, generator=gen) * 0.1).numpy(),
                      grad=rng.standard_normal((2, H, 12, 4)).astype(np.float32), modes=4)
    return job


@pytest.fixture(scope="module")
def ops_ranks(tmp_path_factory):
    """The exchanges on two ranks (and the FNO's step on a 66-row grid) and
    on four, where the middle ranks have two neighbours."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("sp_ops")
    model = worker.make_task("fno", FNO_WIDTHS).model
    fno66 = dict(model="fno", widths=FNO_WIDTHS, min_size=1024, lr=1e-3, spatial=True,
                 batch=worker.global_batch(rng, 4, 66, 20, valid=3), state=model.state_dict())
    jobs = {M: ops_job(M, rng, cases={"fno66": fno66} if M == 2 else None) for M in (2, 4)}
    ranks = {M: worker.spawn(job, root / str(M), world=M) for M, job in jobs.items()}
    one = worker.split_step(fno66, DataMesh())
    return jobs, ranks, one


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("i", range(len(HALOS)), ids=[f"k{k}-{'replicate' if r else 'zeros'}"
                                                        for k, r in HALOS])
def test_halo_matches_the_padded_field(ops_ranks, M, i):
    """Each rank's rows with k rows more on each side are its window of the
    whole field padded by k rows (zeros or the edge row); the gradient that
    reaches each rank's rows is the whole field's, each rank's window
    carrying its own upstream gradient."""
    jobs, ranks, _ = ops_ranks
    job = jobs[M]
    k, replicate = HALOS[i]
    x = torch.from_numpy(job["x"]).requires_grad_(True)
    padded = F.pad(x.permute(0, 3, 1, 2), (0, 0, k, k),
                   mode="replicate" if replicate else "constant").permute(0, 2, 3, 1)
    h = x.shape[1] // M
    loss = sum((padded[:, j * h: j * h + h + 2 * k] * torch.from_numpy(job["halo_grads"][i][j]))
               .sum() for j in range(M))
    loss.backward()
    for j, result in enumerate(ranks[M]):
        y, grad = result["halos"][i]
        torch.testing.assert_close(y, padded[:, j * h: j * h + h + 2 * k].detach(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(grad, x.grad[:, j * h:(j + 1) * h], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("M", [2, 4])
def test_row_sums_and_gather_match_the_whole(ops_ranks, M):
    """The real and the complex sums of the ranks' partial row sums equal the
    whole field's on every rank, and their backward brings every rank's
    upstream gradient to every rank's rows; the gather is the whole field."""
    jobs, ranks, _ = ops_ranks
    job = jobs[M]
    x = torch.from_numpy(job["x"]).requires_grad_(True)
    c = torch.from_numpy(job["c"])
    real, imag = (x * c).sum(1), (x * x).sum(1)
    g = [sum(torch.from_numpy(job["sum_grads"][j][n]) for j in range(M)) for n in range(3)]
    ((real * g[0]).sum() + (real * g[1] + imag * g[2]).sum()).backward()
    h = x.shape[1] // M
    for j, result in enumerate(ranks[M]):
        got_real, got_cplx, grad = result["sums"]
        torch.testing.assert_close(got_real, real.detach(), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_cplx, torch.complex(real, imag).detach(), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(grad, x.grad[:, j * h:(j + 1) * h], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(result["gathered"], x.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("M", [2, 4])
def test_block_vjp_on_a_ranks_rows_matches_the_whole(ops_ranks, M):
    """The block kernel's backward on each rank's rows, from the summed
    spectrum: the ranks' rows of dx are the whole grid's, and their partial
    weight gradients sum to the whole grid's."""
    jobs, ranks, _ = ops_ranks
    v = {k: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for k, a in jobs[M]["vjp"].items()}
    xm, pre = fk.fno_block_saved_reference(v["x"], v["weights"], v["w0"], v["b0"], v["modes"],
                                           v["modes"])
    want = fk.fno_block_vjp(v["grad"], v["x"], xm, pre, v["weights"], v["w0"], v["modes"],
                            v["modes"])
    got = [result["vjp"] for result in ranks[M]]
    dx = torch.cat([g[0] for g in got], 1)
    assert (dx - want[0]).abs().max().item() <= 1e-5 * want[0].abs().max().item()
    for n in (1, 2, 3):
        total = sum(g[n] for g in got)
        assert (total - want[n]).abs().max().item() <= 1e-5 * want[n].abs().max().item(), n


def test_fno_step_on_66_rows_over_two_ranks(ops_ranks):
    """A 66-row grid over two ranks, 33 rows a rank (not a multiple of the
    kernel's 8-row tiles): one step against one process."""
    _, ranks, one = ops_ranks
    for result in ranks[2]:
        got = result["steps"]["fno66"]
        assert math.isclose(got["scores"][0]["nmse"], one["scores"][0]["nmse"],
                            rel_tol=LOSS_RTOL)
        assert (got["preds"] - one["preds"]).abs().max().item() <= 2e-5
        top = max(g.abs().max().item() for g in one["grads"].values())
        for k, g in one["grads"].items():
            assert (got["grads"][k] - g).abs().max().item() <= 1e-5 * top, k
        for k, p in one["params"].items():
            assert (got["params"][k] - p).abs().max().item() <= 1e-5, k


# --- main_auto ---------------------------------------------------------------

WIDE = ["--fno_hidden_dim", "32", "--plot_train_examples", "0"]


def sp_argv(data_root, epochs, out, mesh="1x2", mode="train"):
    argv = train_argv(data_root, epochs) + WIDE + ["--output_dir", str(out), "--mode", mode,
                                                   "--mesh_shape", mesh]
    return argv + (["--shard_spatial", "1"] if mesh != "1" else [])


def fno_run(out):
    return out / "auto" / "cavity_prop_bc_geo" / "dt0.1" / "fno" / "lr0.0001_d2_h32_m14_m24"


@pytest.fixture(scope="module")
def sp_runs(port_tree, tmp_path_factory):  # noqa: F811
    """Two epochs and the test in one process and on 1x2 under sp (its
    example plot of whole frames on); one epoch under sp then --resume in
    one process; one epoch in one process then --resume under sp; one epoch
    of one process with --shard_spatial 1."""
    root = tmp_path_factory.mktemp("sp_cli")
    cli.main_auto(sp_argv(port_tree, 2, root / "straight", "1", "train_test"), device="cpu")
    cli.main_auto(sp_argv(port_tree, 1, root / "from_one", "1"), device="cpu")
    cli.main_auto(sp_argv(port_tree, 1, root / "one_sp", "1") + ["--shard_spatial", "1"],
                  device="cpu")
    sp = sp_argv(port_tree, 2, root / "sp", mode="train_test")
    sp[sp.index("--plot_train_examples") + 1] = "1"
    calls = [("main_auto", sp), ("main_auto", sp_argv(port_tree, 1, root / "from_mesh")),
             ("main_auto", sp_argv(port_tree, 2, root / "from_one") + ["--resume", "1"])]
    ranks = worker.spawn(dict(kind="cli", calls=calls), root / "ranks")
    cli.main_auto(sp_argv(port_tree, 2, root / "from_mesh", "1") + ["--resume", "1"],
                  device="cpu")
    return root, ranks


def assert_weights_close(got_run, want_run, ep):
    got = torch.load(got_run / f"ckpt-{ep}" / ckpt.MODEL_FILE, weights_only=True)
    want = torch.load(want_run / f"ckpt-{ep}" / ckpt.MODEL_FILE, weights_only=True)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    top = max(v.abs().max().item() for v in want.values())
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= WEIGHT_RTOL * top, (ep, k)


def assert_losses_close(got_run, want_run):
    got = json.loads((got_run / "train_losses.json").read_text())
    want = json.loads((want_run / "train_losses.json").read_text())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert math.isclose(g, w, rel_tol=LOSS_RTOL), (g, w)


def test_main_auto_sp_matches_one_process(sp_runs):
    """``main_auto --mesh_shape 1x2 --shard_spatial 1 --mode train_test``:
    the losses, each epoch's dev scores and weights, and the test scores
    (run on whole rows) against one process; every rank launched the
    kernels' counts it printed alike, and rank 0 drew the example."""
    root, ranks = sp_runs
    got, want = fno_run(root / "sp"), fno_run(root / "straight")
    assert_losses_close(got, want)
    for ep in (0, 1):
        assert_weights_close(got, want, ep)
        g, w = (json.loads((r / f"ckpt-{ep}" / "dev_scores.json").read_text())["mean"]
                for r in (got, want))
        for k in w:
            assert math.isclose(g[k], w[k], rel_tol=SCORE_RTOL), (ep, k)
    g, w = (json.loads((r / "test" / "scores.json").read_text())["mean"] for r in (got, want))
    for k in w:
        assert math.isclose(g[k], w[k], rel_tol=SCORE_RTOL), k
    assert (got / "example.png").exists()
    assert ranks[0]["printed"][0].count("model=2") and "Model has" in ranks[1]["printed"][0]


@pytest.mark.parametrize("first", ["from_mesh", "from_one"])
def test_resume_across_sp_and_one_process(sp_runs, first):
    """One epoch in one layout, the second resumed in the other, against two
    epochs in one process: the losses and both checkpoints' weights."""
    root = sp_runs[0]
    got, want = fno_run(root / first), fno_run(root / "straight")
    assert_losses_close(got, want)
    for ep in (0, 1):
        assert_weights_close(got, want, ep)


def test_shard_spatial_on_one_process_is_plain(sp_runs):
    """``--shard_spatial 1`` without a model axis splits nothing, as
    ``P(data, model)`` on a model axis of one: the run equals one without
    the flag, bit for bit."""
    root = sp_runs[0]
    got, want = fno_run(root / "one_sp"), fno_run(root / "from_one")
    assert json.loads((got / "ckpt-0" / "train_loss.json").read_text()) == json.loads(
        (want / "ckpt-0" / "train_loss.json").read_text())
    g, w = (torch.load(r / "ckpt-0" / ckpt.MODEL_FILE, weights_only=True) for r in (got, want))
    for k in w:
        assert torch.equal(g[k], w[k]), k


# --- refusals ----------------------------------------------------------------

def axis_mesh(M):
    """A mesh of one data rank and a model axis of M (no group: only its
    sizes are read)."""
    return DataMesh(model=ModelAxis(M))


def test_rows_that_do_not_split_are_refused_as_jax_refuses_them():
    """66 rows over a model axis of 4: JAX's ``device_put`` of the spatial
    placement raises ValueError, and so does the port, naming H, M and
    --shard_spatial; 66 rows over 2 split (33 a rank)."""
    batch = {"inputs": jnp.zeros((4, 66, 65, 2)), "weights": jnp.ones((4,))}
    with pytest.raises(ValueError):
        jax.block_until_ready(jax.device_put(batch, batch_sharding_spatial(
            jax_make_mesh("1x4", tune_spectral=False), batch)))
    model = worker.make_task("fno", FNO_WIDTHS).model
    with pytest.raises(ValueError, match=r"--shard_spatial 1: a grid of H=66 rows .* M=4 ranks"):
        check_spatial(model, axis_mesh(4), (66, 65))
    check_spatial(model, axis_mesh(2), (66, 65))


@pytest.mark.parametrize("H,M,every_level_on_every_rank",
                         [(16, 2, False), (32, 4, False), (32, 2, True), (64, 4, True)])
def test_unet_rows_that_do_not_pool_are_refused(H, M, every_level_on_every_rank):
    """Every row count that divides runs, as XLA computes it: the U-Net's
    four poolings, each on rows resharded to whole pairs, leave a rank none
    of the bottleneck's rows at 16 rows over 2 ranks or 32 over 4 (a level
    of 1 row a rank), which ``check_spatial`` accepts all the same
    (``tests/test_torch_sp_empty.py`` runs them). Its MaxPool2 refuses a
    split whose ranks do not hold whole row pairs."""
    model = worker.make_task("unet", dict(dim=4)).model
    check_spatial(model, axis_mesh(M), (H, H))
    levels = Rows.even(H, ModelAxis(M)).halvings(4, ceil=False)
    assert all(b1 > b0 for r in levels for b0, b1 in zip(r.bounds, r.bounds[1:])) == (
        every_level_on_every_rank)


@pytest.mark.parametrize("kernel_size,padding", [(5, 1), (3, 2)])
def test_resnet_conv_that_resizes_the_grid_fails_in_jax_and_is_refused(kernel_size, padding):
    """A ``--resnet_kernel_size``/``--resnet_padding`` pair whose 2 padding
    is not k - 1 resizes the grid at each convolution: JAX's ResNet adds its
    block's output to the input's 1x1 projection
    (``cfdbench_tpu/models/resnet.py:38-56``) and fails on the shapes, and
    so does the port's on whole rows; under sp its ``Conv`` refuses such a
    convolution by name (ROADMAP.md C)."""
    widths = dict(hidden_chan=8, num_blocks=1, kernel_size=kernel_size, padding=padding)
    x, cp, mask = jnp.zeros((1, 8, 8, 2)), jnp.zeros((1, 5)), jnp.ones((1, 8, 8, 1))
    with pytest.raises(TypeError, match="broadcast"):
        JaxResNet(in_chan=2, out_chan=2, n_case_params=5, **widths).init(
            jax.random.PRNGKey(0), x, cp, mask)
    model = worker.make_task("resnet", widths).model.eval()
    with pytest.raises(RuntimeError, match="size of tensor"):
        model(torch.zeros((1, 8, 8, 2)), torch.zeros((1, 5)), torch.ones((1, 8, 8, 1)))
    conv = model.blocks[0].conv1
    conv.sp = ModelAxis(2)
    with pytest.raises(ValueError, match=f"padding {padding} on a rank's rows.*ROADMAP.md C"):
        conv(torch.zeros((1, 4, 8, conv.weight.shape[1])))


def test_maxpool_refuses_an_odd_row_count_under_sp():
    pool = MaxPool2()
    pool.sp = ModelAxis(2)
    with pytest.raises(ValueError, match="odd count"):
        pool(torch.zeros((1, 5, 4, 1)))


@pytest.mark.parametrize("entry,flags,error", [
    # Every model, --pp_microbatches and --use_mixed_precision are taken
    # (tests/test_torch_sp_*.py, the latent models in test_torch_sp_latent.py);
    # the cases that pinned the latent models keep their ids and pin what a
    # latent model is still refused with: pipeline stages (the FNO alone).
    *[pytest.param("main_auto", ["--model", m, "--pp_microbatches", "2"], "ROADMAP.md A15e",
                   id=f"main_auto-flags{i}-ROADMAP.md A15d2")
      for i, m in enumerate(("latent_diffusion", "latent_diffusion2", "latent_diffusion_lite",
                             "latent_diffusion2_lite"), start=5)],
    pytest.param("main_train", ["--model", "ffn"], "the JAX main_train ignores it .ROADMAP.md C",
                 id="main_train-flags11-the JAX main_train ignores it .ROADMAP.md C"),
    pytest.param("main_gencast", [], "the JAX main_gencast ignores it .ROADMAP.md C",
                 id="main_gencast-flags12-the JAX main_gencast ignores it .ROADMAP.md C"),
])
def test_shard_spatial_refused_by_name(tmp_path, entry, flags, error):
    argv = train_argv(tmp_path / "data", 1) + ["--output_dir", str(tmp_path / "out"),
                                               "--shard_spatial", "1"] + flags
    with pytest.raises(NotImplementedError, match=error):
        getattr(cli, entry)(argv, device="cpu")
    assert not (tmp_path / "out").exists()
