"""Tensor parallelism in the port's other trainers on the CPU: gloo ranks
spawned as ``tests/_torch_dp_worker.py`` spawns them, at ``--mesh_shape
1x2`` and ``2x2``, against the JAX package's step on one device and
against the port's one process, from the same weights and with JAX's
draws.

- One step of each trainer, the sharding rules at the ``min_size`` JAX's
  own tp tests take (1024), so that the narrow networks split: GenCast's
  four micro-steps at ``--gradient_accumulation_steps 2`` through
  ``GenCastAdamW`` (its second update clipped), the VAE's, and the
  unconditional DDPM's with its EMA, each network split by
  ``trainer_auto.split_module`` and gathering at use; ``main_train``'s FFN
  on a replicated model axis. The scores (rel 1e-5), the gradients and the
  parameters after the steps (1e-5 of the largest; Adam's first step
  moves an element of rounding-level gradient by up to lr either way,
  ``test_torch_parallel_trainers.assert_step_close``), equal on every rank
  in the one-process layout; each rank holds its slices and their moments.
- Each model rank's gradients of the whole parameters off by its own
  rounding: main_train's and GenCast's replicas stay equal, bit for bit.
- ``GenCastAdamW``'s global norm under tp: equal on every rank, within
  1e-6 of one process's; a clipped step, and a NaN in one model rank's
  slice that skips the update on every rank; its flat moments carried in
  the one-process layout (``ShardedLayout.flat_to_std``).
"""

import math

import numpy as np
import pytest
import torch

from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch.parallel import mesh as port_mesh
from cfdbench_tpu_torch.training import trainer_uncond
from cfdbench_tpu_torch.training.optim import CLIP_NORM
from tests import _torch_dp_worker as worker
from tests.test_torch_parallel import jax_data_shards  # noqa: F401  (a fixture)
from tests.test_torch_parallel_trainers import (
    LR,
    assert_step_close,
    four_groups,
    gencast_case,
    jax_steps,
    nonauto_case,
    uncond_case,
    vae_case,
)

torch.set_num_threads(1)

MIN_SIZE = 1024  # the rules' threshold in JAX's own tp tests
MESHES = {"1x2": 2, "2x2": 4}
CASES = ["ffn", "gencast", "vae", "uncond"]
SPLIT = ["gencast", "vae", "uncond"]  # the trainers whose network splits
# The trainers that average the gradients of their whole parameters over the
# model ranks themselves: main_train's step and GenCastAdamW (the VAE and
# the DDPM through trainer_auto.reduce_gradients, which test_torch_tp.py's
# perturbed U-Net holds).
REPLICATED = ["ffn", "gencast"]
NORM_RTOL = 1e-6


def tp_gate_case(rng):
    """Four GenCastAdamW steps on two Dense layers whose weights split at
    ``min_size`` 64 (their biases stay whole): a small gradient, a large
    one (clipped), one with a NaN in the rows model rank 1 holds of the
    first weight, a small one."""
    dims = [(4, 64), (64, 8)]
    shapes = {"0.weight": (64, 4), "0.bias": (64,), "1.weight": (8, 64), "1.bias": (8,)}

    def draw(scale):
        return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}

    grads = [draw(1e-2), draw(1.0), draw(1e-2), draw(1e-2)]
    grads[2]["0.weight"][40, 1] = np.nan
    return dict(dims=dims, min_size=64, lr=1e-2, start=draw(0.3), grads=grads,
                kw=dict(total_steps=8, warmup_steps=1, weight_decay=1e-2))


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory, jax_data_shards):  # noqa: F811
    """Each case's steps on 1x2 and 2x2, in the port's one process, and in
    JAX on one device; the gate on both meshes and in one process."""
    rng = np.random.default_rng(0)
    cases = {"ffn": nonauto_case("ffn", rng, 6, 5), "gencast": gencast_case(rng),
             "vae": vae_case(rng), "uncond": uncond_case(rng)}
    for case in cases.values():
        case["min_size"] = MIN_SIZE
    gate = tp_gate_case(rng)
    # The trainers whose whole parameters each model rank updates itself, with
    # each model rank's gradients off by its own rounding.
    perturbed = {f"{name}_perturbed": dict(cases[name], perturb=True) for name in REPLICATED}
    root = tmp_path_factory.mktemp("tp_trainer_steps")
    ranks = {mesh: worker.spawn(dict(kind="trainer_steps", mesh=mesh,
                                     cases=dict(cases, **perturbed), tp_gate=gate),
                                root / mesh, world=world)
             for mesh, world in MESHES.items()}
    single = {name: worker.trainer_step(case, port_mesh.SINGLE) for name, case in cases.items()}
    single["tp_gate"] = worker.tp_gate(gate, port_mesh.SINGLE)
    mesh = jax_make_mesh("1", tune_spectral=False)
    with pytest.MonkeyPatch.context() as mp:
        four_groups(mp)
        jax_results = {name: jax_steps(case, mesh) for name, case in cases.items()}
    return cases, ranks, single, jax_results


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_trainer_step_matches_jax_on_one_device(tp_steps, mesh, name):
    """Every rank against the JAX trainer's steps on one device from the
    same weights and draws: the scores, the gradients (GenCast's first
    micro-batch's), the parameters after the steps."""
    _, ranks, _, jax_results = tp_steps
    want = jax_results[name]
    for r, result in enumerate(ranks[mesh]):
        assert_step_close(result[name], want, want["grads"], LR, (mesh, name, r))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_trainer_step_matches_one_process(tp_steps, mesh, name):
    """Every rank against the port's one process on the whole global batch:
    the scores, the network's output (gathered over the data ranks), the
    gradients and the parameters after the steps; the parameters equal on
    every rank, bit for bit."""
    _, ranks, single, _ = tp_steps
    want = single[name]
    for r, result in enumerate(ranks[mesh]):
        assert_step_close(result[name], want, want["grads"], LR, (mesh, name, r), want["output"])
        for k, p in result[name]["params"].items():
            assert torch.equal(p, ranks[mesh][0][name]["params"][k]), (mesh, name, r, k)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_ranks_hold_their_slices(tp_steps, mesh, name):
    """The PUNetG's and the VAE's split parameters hold 1/M of their
    elements on each rank, and so do their optimizer moments (two a
    parameter element); the FFN's model axis is replicated: each rank holds
    the whole model."""
    cases, ranks, _, _ = tp_steps
    M = int(mesh.split("x")[1])
    for result in ranks[mesh]:
        got = result[name]
        assert got["opt_elems"] == 2 * got["local_params"]
        if name not in SPLIT:
            assert got["local_params"] == got["whole_params"]
            continue
        assert got["whole_params"] / M < got["local_params"] < got["whole_params"] / 1.5


@pytest.mark.parametrize("name", REPLICATED)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicas_stay_equal_when_model_ranks_round_apart(tp_steps, mesh, name):
    """Each model rank's gradients of the whole parameters off by its own
    rounding: main_train's FFN (replicated whole) and GenCast's PUNetG (its
    unsplit parameters, through ``GenCastAdamW``) still end their steps with
    every rank's parameters and optimizer moments equal, bit for bit, and
    the FFN's gradients too, because each averages those gradients over the
    model ranks; the perturbation did reach the gradients."""
    _, ranks, _, _ = tp_steps
    first = ranks[mesh][0][f"{name}_perturbed"]
    for r, result in enumerate(ranks[mesh]):
        got = result[f"{name}_perturbed"]
        for k, p in got["params"].items():
            assert torch.equal(p, first["params"][k]), (mesh, name, r, k)
        for i, st in got["moments"].items():
            for k, v in st.items():
                assert torch.equal(v, first["moments"][i][k]), (mesh, name, r, i, k)
        if name == "ffn":  # GenCast's worker reads a world average of the gradients
            for k, g in got["grads"].items():
                assert torch.equal(g, first["grads"][k]), (mesh, name, r, k)
    moved = [k for k, g in first["grads"].items()
             if not torch.equal(g, ranks[mesh][0][name]["grads"][k])]
    assert moved, "the perturbation changed no gradient"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ddpm_tp_ema_matches_jax(tp_steps, mesh):
    """The DDPM's EMA after the step, gathered into the one-process layout,
    against ``d·start + (1 − d)·params`` of JAX's updated parameters (1e-5
    of the largest), and alike on every rank."""
    cases, ranks, _, jax_results = tp_steps
    d = trainer_uncond.EMA_DECAY
    start = cases["uncond"]["state"]
    want = {k: d * start[k] + (1 - d) * p for k, p in jax_results["uncond"]["params"].items()}
    top = max(w.abs().max().item() for w in want.values())
    for result in ranks[mesh]:
        ema = result["uncond"]["ema"]
        for k, w in want.items():
            assert (ema[k] - w).abs().max().item() <= 1e-5 * top, k
            assert torch.equal(ema[k], ranks[mesh][0]["uncond"]["ema"][k]), k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gencast_tp_norm_is_the_whole_trees(tp_steps, mesh):
    """Each GenCast micro-step's global gradient norm, which the clip and the
    non-finite gate read: equal on every rank, bit for bit, and within 1e-6
    of one process's; above the clip's bound, so the update was clipped."""
    _, ranks, single, _ = tp_steps
    want = single["gencast"]["norms"]
    for result in ranks[mesh]:
        got = result["gencast"]["norms"]
        assert got == ranks[mesh][0]["gencast"]["norms"]
        for g, w in zip(got, want):
            assert math.isclose(g, w, rel_tol=NORM_RTOL), (g, w)
    assert min(want) > CLIP_NORM


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gencast_tp_gate_skips_on_every_rank(tp_steps, mesh):
    """A NaN in the slice that model rank 1 holds skips the update on every
    rank, as in one process; the large gradient is clipped; each step's
    parameters and norm are equal on every rank and within 1e-6 of one
    process's."""
    _, ranks, single, _ = tp_steps
    want = single["tp_gate"]
    for result in ranks[mesh]:
        got = result["tp_gate"]
        for step, (g, w) in enumerate(zip(got["history"], want["history"])):
            for k in w:
                assert torch.equal(g[k], ranks[mesh][0]["tp_gate"]["history"][step][k])
                torch.testing.assert_close(g[k], w[k], rtol=NORM_RTOL, atol=0)
        assert np.array_equal(got["norms"], ranks[mesh][0]["tp_gate"]["norms"], equal_nan=True)
        for step, (g, w) in enumerate(zip(got["norms"], want["norms"])):
            if step == 2:
                assert math.isnan(g) and math.isnan(w)
            else:
                assert math.isclose(g, w, rel_tol=NORM_RTOL), (step, g, w)
        for k in got["history"][2]:
            assert torch.equal(got["history"][2][k], got["history"][1][k])
        assert not torch.equal(got["history"][3]["0.weight"], got["history"][2]["0.weight"])
    assert want["norms"][0] < CLIP_NORM < want["norms"][1]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gencast_tp_flat_state_in_one_process_layout(tp_steps, mesh):
    """``checkpoints.optimizer_to_std`` of a ``GenCastAdamW``: the flat
    moments gathered over the model ranks into one process's order, against
    one process's; the counters alike."""
    _, ranks, single, _ = tp_steps
    want = single["tp_gate"]["opt_state"]
    for result in ranks[mesh]:
        got = result["tp_gate"]["opt_state"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-12)
