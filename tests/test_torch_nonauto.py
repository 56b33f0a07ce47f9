"""The port's non-autoregressive FFN and DeepONet against the JAX package:
the scale-invariant activation and ``Mlp``'s options, both models against
the golden torch-reference outputs and live JAX (forwards, gradients,
parameter counts), and the trainer's query sampler. Their entry points
are ``tests/test_torch_nonauto_cli.py``'s."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.models import common as jax_common
from cfdbench_tpu.models import init_nonauto_model as jax_init_nonauto_model
from cfdbench_tpu.utils.torch_import import import_state_dict
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import common, init_nonauto_model
from cfdbench_tpu_torch.training import trainer_nonauto
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from tests._golden import trees_from_flat
from tests.test_torch_train import GOLDEN

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

ATOL = 2e-5  # f32 forward parity, the JAX package's own golden bound
GRAD_RTOL = 1e-5  # each gradient's max abs diff over its max |grad|

# The golden fixtures' configurations (tests/test_golden_parity.py:211-235).
NONAUTO_FLAGS = {
    "ffn": ["--model", "ffn", "--ffn_width", "16", "--ffn_depth", "3"],
    "deeponet": ["--model", "deeponet", "--deeponet_width", "16", "--branch_depth", "3",
                 "--trunk_depth", "3"],
}
GOLDEN_FIXTURES = {"ffn": "ffn_nonauto", "deeponet": "deeponet_nonauto"}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def lattice(H, W):
    return np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"),
                    -1).reshape(-1, 2).astype(np.float32)


def both_models(name, flags=(), P=5):
    argv = NONAUTO_FLAGS[name] + list(flags)
    port = init_nonauto_model(Args.parse_args(argv), n_case_params=P,
                              generator=torch.Generator().manual_seed(0))
    return port, jax_init_nonauto_model(JaxArgs.parse_args(argv), n_case_params=P)


def live_inputs(rng, B=3, P=5, H=16, W=16):
    return (rng.standard_normal((B, P)).astype(np.float32),
            rng.uniform(0, 10, (B, 1)).astype(np.float32), lattice(H, W))


# --------------------------------------------------------------- the models


@pytest.mark.parametrize("shape", [(4, 7), (3, 5, 6)], ids=["2d", "3d"])
def test_norm_act_matches_jax(rng, shape):
    """Per sample over all its non-batch axes, unbiased std."""
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    want = jax_common.norm_act(jax.nn.relu, jnp.asarray(x))
    got = common.norm_act(torch.nn.ReLU(), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("act,act_norm,act_on_output",
                         [("relu", True, False), ("gelu", True, True), ("tanh", False, True)])
def test_mlp_options_match_jax(rng, act, act_norm, act_on_output):
    dims = [6, 16, 16, 4]
    port = common.Mlp(dims, act, act_norm, act_on_output,
                      generator=torch.Generator().manual_seed(0))
    # Parameters only at the even slots: the reference Ffn's keys.
    assert sorted({k.split(".")[1] for k in port.state_dict()}) == ["0", "2", "4"]
    assert len(port.layers) == 5 + act_on_output
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    # An Mlp's keys under ``ffn.`` are the AutoFfn's, whose tree is one Mlp.
    params = params_to_flax({f"ffn.{k}": v for k, v in port.state_dict().items()})["Mlp_0"]
    want = jax_common.Mlp(dims, act_name=act, act_norm=act_norm,
                          act_on_output=act_on_output).apply({"params": params}, x)
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(NONAUTO_FLAGS))
def test_forward_matches_golden_and_reference_keys(name):
    """The golden fixture's weights through params_from_flax, and as the
    reference torch model's own state dict (load_state_dict, strict):
    the reference's outputs at 2e-5, and back to the same flax tree."""
    data = dict(np.load(GOLDEN / f"{GOLDEN_FIXTURES[name]}.npz"))
    params = trees_from_flat(data, ["P"])["P"]
    port, _ = both_models(name, ["--act_scale_invariant", "1"])
    sd = params_from_flax(params)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(t(data["case_params"]), t(data["t"]), t(data["query_xy"]))
    np.testing.assert_allclose(got.numpy(), data["expected"], rtol=0, atol=ATOL)
    back = params_to_flax(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    ref = import_state_dict(name, {k: v.numpy() for k, v in sd.items()})["params"]
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(NONAUTO_FLAGS))
def test_forward_and_counts_match_live_jax_at_default_widths(rng, name):
    """Default widths (FFN 100 x 8; DeepONet 100, depths 8, the
    scale-invariant act): the parameter count and tree, and a forward on
    the whole 16x16 lattice from the same weights."""
    argv = ["--model", name]
    port = init_nonauto_model(Args.parse_args(argv), n_case_params=5,
                              generator=torch.Generator().manual_seed(1))
    jm = jax_init_nonauto_model(JaxArgs.parse_args(argv), n_case_params=5)
    cp, tt, q = live_inputs(rng)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), cp, tt, q))["params"]
    params = params_to_flax(port.state_dict())
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: a.shape, shapes)
    assert sum(p.numel() for p in port.parameters()) == sum(
        math.prod(a.shape) for a in jax.tree.leaves(shapes))
    want = jax.jit(jm.apply)({"params": params}, cp, tt, q)
    with torch.no_grad():
        got = port(t(cp), t(tt), t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(NONAUTO_FLAGS))
def test_grads_match_jax(rng, name):
    """The nmse of sampled points against labels: every gradient within
    1e-5 of its max |grad| of jax.grad's, from the same weights."""
    from cfdbench_tpu import metrics as jax_metrics
    from cfdbench_tpu_torch import metrics

    port, jm = both_models(name, ["--act_on_output", "1"])
    cp, tt, _ = live_inputs(rng)
    q = rng.integers(0, 16, (40, 2)).astype(np.float32)
    labels = rng.standard_normal((3, 40)).astype(np.float32)
    loss = metrics.loss_name_to_fn("nmse")
    out = port(t(cp), t(tt), t(q))
    loss(out, t(labels))["nmse"].backward()
    jax_loss = jax_metrics.loss_name_to_fn("nmse")
    want = jax.jit(jax.grad(
        lambda p: jax_loss(jm.apply({"params": p}, cp, tt, q), labels)["nmse"]))(
        params_to_flax(port.state_dict()))
    got = params_to_flax({k: p.grad for k, p in port.named_parameters()})
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max()


def test_deeponet_prediction_depends_on_the_query_set(rng):
    """The trunk's scale-invariant act normalises a sample over all its
    queries (ROADMAP.md C), in both packages: the same point asked alone
    and within the lattice gives different values; the FFN's rows do not
    see each other."""
    cp, tt, q = live_inputs(rng)
    for name, depends in (("deeponet", True), ("ffn", False)):
        port, jm = both_models(name, ["--act_scale_invariant", "1"])
        params = params_to_flax(port.state_dict())
        with torch.no_grad():
            whole = port(t(cp), t(tt), t(q))[:, :4]
            part = port(t(cp), t(tt), t(q[:4]))
        jax_part = np.asarray(jax.jit(jm.apply)({"params": params}, cp, tt, q[:4]))
        np.testing.assert_allclose(part.numpy(), jax_part, rtol=0, atol=ATOL)
        assert (not torch.allclose(whole, part, atol=1e-4)) == depends, name


def test_query_sampler_is_a_function_of_seed_and_step():
    a = trainer_nonauto.sample_query_idxs(0, 5, 1000, 18, 17)
    assert a.shape == (1000, 2) and a.dtype == torch.int64
    assert 0 <= a[:, 0].min() and a[:, 0].max() == 17 and a[:, 1].max() == 16
    assert torch.equal(a, trainer_nonauto.sample_query_idxs(0, 5, 1000, 18, 17))
    assert not torch.equal(a, trainer_nonauto.sample_query_idxs(0, 6, 1000, 18, 17))
    assert not torch.equal(a, trainer_nonauto.sample_query_idxs(1, 5, 1000, 18, 17))
