"""The port's pixel-diffusion and GenCast pieces against the JAX package:
the DDPM scheduler (the golden fixture and the JAX tables), the sampler
(an oracle denoiser, and JAX's own noise), the timestep embedding, PUNetG
forwards and gradients at 16x16 and the odd 18x17, both tasks' losses and
gradients with JAX's draws injected (noise, timesteps, dropout masks),
GenCast's generation and two-frame rollout, gradient checkpointing, and
the GenCast optimizer against optax.

torch cannot draw JAX's threefry or RBG bits, so every draw of the port
goes through a module-level function keyed by a tuple (``utils/rng.py``);
:func:`inject_jax_draws` puts functions in their place that return what
the JAX package draws from the matching key."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from cfdbench_tpu.metrics import loss_name_to_fn as jax_loss_name_to_fn
from cfdbench_tpu.models import diffusion as jax_diffusion
from cfdbench_tpu.models import punetg as jax_punetg
from cfdbench_tpu.models.punetg import PUNetGCFD as JaxPUNetG
from cfdbench_tpu.models.punetg import timestep_embedding as jax_timestep_embedding
from cfdbench_tpu.ops import diffusion as jax_ops
from cfdbench_tpu.training.trainer_gencast import make_gencast_tx as jax_make_gencast_tx
from cfdbench_tpu.utils.rng import fast_train_key
from cfdbench_tpu_torch.metrics import loss_name_to_fn
from cfdbench_tpu_torch.models import diffusion, punetg
from cfdbench_tpu_torch.models.common import num_groups_for
from cfdbench_tpu_torch.models.punetg import PUNetGCFD, timestep_embedding
from cfdbench_tpu_torch.ops import diffusion as ops
from cfdbench_tpu_torch.training.optim import make_gencast_tx
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from cfdbench_tpu_torch.utils import rng as port_rng
from cfdbench_tpu_torch.utils.rng import EVAL_KEY, train_key
from tests.test_torch_train import GOLDEN

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

ATOL = 2e-5  # f32 forward parity, over max |out|
GRAD_RTOL = 1e-5  # each gradient's max abs diff over its max |grad|
SAMPLE_RTOL = 1e-5  # a sampled frame, over its max |value|
# The narrow PUNetG of these tests, as task keywords of both packages.
SMALL = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1, dropout=0.1,
             noise_scheduler_timesteps=20)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# --- JAX's draws, keyed as the port keys its own --------------------------

def jax_key(key):
    """The JAX key that the port's key tuple stands for (``utils/rng.py``)."""
    tag, *rest = key
    if tag == port_rng.EVAL_TAG:
        return jax.random.PRNGKey(*rest)
    if tag == port_rng.TRAIN_TAG:
        seed, step = rest
        return jax.random.fold_in(fast_train_key(seed), step)
    offsets = {port_rng.VAE_TAG: 31337, port_rng.UNCOND_TAG: 99}
    if tag in offsets:
        seed, step = rest
        return jax.random.fold_in(jax.random.PRNGKey(seed + offsets[tag]), step)
    halves = {port_rng.LATENT_NOISE_TAG: 0, port_rng.LATENT_POSTERIOR_TAG: 1}
    if tag in halves:  # rng, vkey = split(rng)
        return jax.random.split(jax_key(tuple(rest)))[halves[tag]]
    assert tag == port_rng.ROLLOUT_TAG, key
    seed, step, steps = rest
    return jax.random.split(jax.random.PRNGKey(seed), steps)[step]


def jax_train_noise_and_t(key, shape, num_train_timesteps, device):
    """``_DiffusionTaskBase._sample_noise_and_t`` of the key's JAX key."""
    nkey, tkey = jax.random.split(jax_key(key))
    noise = jax.random.normal(nkey, tuple(shape), jnp.float32)
    steps = jax.random.randint(tkey, (shape[0],), 0, num_train_timesteps)
    return (t(noise).to(device),
            torch.from_numpy(np.asarray(steps).astype(np.int64)).to(device))


def jax_ddpm_noise(key, index, shape, device):
    """Draw ``index`` of ``ddpm_sample``'s key chain: 0 the initial
    noise, i + 1 the noise of step i."""
    k, init = jax.random.split(jax_key(key))
    if index == 0:
        return t(jax.random.normal(init, tuple(shape), jnp.float32)).to(device)
    for _ in range(index):
        k, step_key = jax.random.split(k)
    return t(jax.random.normal(step_key, tuple(shape), jnp.float32)).to(device)


class _SowingDropout(nn.Dropout):
    """flax's Dropout, which also sows its keep mask. It keeps the class
    name, so its auto-name and its rng (folded from the module path) are
    the original's."""

    @nn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        deterministic = nn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = jax.random.bernoulli(self.make_rng(self.rng_collection), 1.0 - self.rate,
                                    inputs.shape)
        self.sow("intermediates", "keep", keep)
        return jax.lax.select(keep, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))


_SowingDropout.__name__ = "Dropout"


def jax_dropout_masks(unet: JaxPUNetG, n_case_params: int = 5, dropout_key=None):
    """A replacement for ``punetg.dropout_keep_masks`` that returns the keep
    masks the JAX package's ``loss_scores`` draws for ``unet`` under the
    key's JAX key (``fold_in(rng, "drop")``; ``dropout_key(key)`` when
    given), in FilmResBlock order."""
    if dropout_key is None:
        def dropout_key(key):
            return jax.random.fold_in(jax_key(key), 0x64726F70)

    cache = {}

    def masks(key, shapes, rate, device):
        B, H, W = shapes[0][:3]
        x_shape = (B, H, W, unet.in_channels)
        if x_shape not in cache:
            args = (jnp.zeros(x_shape), jnp.zeros((B,), jnp.int32), jnp.zeros((B, n_case_params)))
            # The masks depend on the shapes and the key alone: zero weights do.
            variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                                     jax.eval_shape(unet.init, jax.random.PRNGKey(0), *args))

            def sown(drop):
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(nn, "Dropout", _SowingDropout)
                    _, state = unet.apply(variables, *args, train=True, rngs={"dropout": drop},
                                          mutable=["intermediates"])
                return state["intermediates"]

            cache[x_shape] = jax.jit(sown)
        inter = cache[x_shape](dropout_key(key))
        n = len([k for k in inter if k.startswith("FilmResBlock_")])
        got = [np.asarray(inter[f"FilmResBlock_{i}"]["Dropout_0"]["keep"][0]) for i in range(n)]
        assert [m.shape for m in got] == [tuple(s) for s in shapes]
        return [torch.from_numpy(m).to(device) for m in got]

    return masks


def inject_jax_draws(monkeypatch, unet: JaxPUNetG = None):
    """Every draw of the port from JAX's key stream: the training noise and
    timesteps, the sampler's noise and, given the JAX network, the
    dropout masks."""
    monkeypatch.setattr(diffusion, "train_noise_and_t", jax_train_noise_and_t)
    monkeypatch.setattr(ops, "ddpm_noise", jax_ddpm_noise)
    if unet is not None:
        monkeypatch.setattr(diffusion, "dropout_keep_masks", jax_dropout_masks(unet))


# --- scheduler and sampler ------------------------------------------------

def test_scheduler_matches_golden():
    """The golden tables, spacing, three deterministic ancestral steps and
    their posterior std, at ``test_generative.py``'s tolerances."""
    g = np.load(GOLDEN / "ddpm_scheduler.npz")
    s = ops.make_ddpm_scheduler(1000)
    np.testing.assert_allclose(s.betas.numpy(), g["betas_T1000"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(s.alphas_cumprod.numpy(), g["alphas_cumprod_T1000"],
                               rtol=2e-5, atol=1e-10)
    np.testing.assert_allclose(ops.make_ddpm_scheduler(100).betas.numpy(), g["betas_T100"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(s.spaced_timesteps(50), g["timesteps_50"])
    x, eps = t(g["sample"]), t(g["eps"])
    for i, (ts, prev) in enumerate(zip(g["step_ts"], g["step_prev_ts"])):
        x = s.step(eps, int(ts), x, int(prev))
        np.testing.assert_allclose(x.numpy(), g["step_outs"][i], rtol=2e-4, atol=2e-5)
        sigma = s.step_coefficients(int(ts), int(prev))[-1]
        np.testing.assert_allclose(float(sigma), g["step_sigmas"][i], rtol=1e-4)


@pytest.mark.parametrize("T", [1000, 20])
def test_scheduler_matches_jax(rng, T):
    """Tables, spacing, add_noise and every deterministic step of a 5-step
    spacing (the last one to prev_t = -1) against the JAX scheduler."""
    s, js = ops.make_ddpm_scheduler(T), jax_ops.make_ddpm_scheduler(T)
    np.testing.assert_array_equal(s.betas.numpy(), np.asarray(js.betas))
    np.testing.assert_array_equal(s.alphas.numpy(), np.asarray(js.alphas))
    # A product of T float32 factors, sequential here and a tree in XLA.
    np.testing.assert_allclose(s.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(s.spaced_timesteps(5), js.spaced_timesteps(5))
    x0, noise = (rng.standard_normal((3, 4, 5, 2)).astype(np.float32) for _ in range(2))
    steps = np.array([0, T // 2, T - 1])
    np.testing.assert_allclose(
        s.add_noise(t(x0), t(noise), torch.from_numpy(steps)).numpy(),
        np.asarray(js.add_noise(x0, noise, jnp.asarray(steps))), rtol=0, atol=2e-6)
    x = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    for ts in js.spaced_timesteps(5).tolist():
        eps = 1.5 * rng.standard_normal(x.shape).astype(np.float32)
        prev = ts - T // 5
        got = s.step(t(eps), ts, t(x), prev).numpy()
        want = np.asarray(js.step(jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(x),
                                  jnp.asarray(prev)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_ddpm_sample_oracle_denoiser(rng):
    """With the exact noise of a fixed x0 (|x0| <= 1: clipping inactive),
    sampling lands on x0 (``test_generative.py:93-108``)."""
    s = ops.make_ddpm_scheduler(1000)
    x0 = t(0.5 * np.sign(rng.standard_normal((1, 4, 4, 1))))

    def oracle(x_t, steps):
        acp = s.alphas_cumprod[steps].reshape(-1, 1, 1, 1)
        return (x_t - acp.sqrt() * x0) / (1 - acp).sqrt()

    out = ops.ddpm_sample(s, oracle, x0.shape, EVAL_KEY, num_inference_steps=50)
    assert (out - x0).abs().max().item() < 0.05


@pytest.mark.parametrize("steps", [2, 5])
def test_ddpm_sample_matches_jax_with_its_noise(rng, monkeypatch, steps):
    """The same denoiser in both packages and JAX's noise: the sampled
    frames within rel 1e-5."""
    inject_jax_draws(monkeypatch)
    s, js = ops.make_ddpm_scheduler(20), jax_ops.make_ddpm_scheduler(20)
    w = rng.standard_normal((2, 2)).astype(np.float32) * 0.5

    def port_denoise(x, ts):
        return x @ t(w) + 0.02 * ts.float().reshape(-1, 1, 1, 1)

    def jax_denoise(x, ts):
        return x @ w + 0.02 * ts.astype(jnp.float32).reshape(-1, 1, 1, 1)

    shape = (3, 6, 5, 2)
    got = ops.ddpm_sample(s, port_denoise, shape, EVAL_KEY, steps).numpy()
    want = np.asarray(jax_ops.ddpm_sample(js, jax_denoise, shape, jax.random.PRNGKey(0), steps))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_RTOL * np.abs(want).max())


# --- network --------------------------------------------------------------

@pytest.mark.parametrize("dim", [8, 9, 64])
def test_timestep_embedding_matches_jax(dim):
    """sin and cos of t·f within two ulps of their argument (XLA's exp and
    torch's round f apart by one ulp, which t multiplies) and 4e-6 (XLA's
    own sin at arguments near 1000); the odd dim's last column is 0."""
    steps = np.array([0, 1, 7, 500, 999])
    got = timestep_embedding(torch.from_numpy(steps), dim).numpy()
    want = np.asarray(jax_timestep_embedding(jnp.asarray(steps), dim))
    assert got.shape == want.shape == (5, dim)
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) / (half - 1) * np.arange(half))
    arg = np.abs(steps[:, None] * freqs[None])
    bound = 4e-6 + 2.0 ** -23 * np.concatenate([arg, arg] + [np.zeros((5, dim % 2))], -1)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    if dim % 2:
        assert not got[:, -1].any()


def named_grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


def assert_grads_close(got_sd, want_tree, exact_sd=None):
    """Every gradient within GRAD_RTOL of its own max. With ``exact_sd``,
    the same gradients in float64: a tensor whose gradient is 0 in exact
    arithmetic (below 1e-9 of the largest there; a bias that a GroupNorm of
    one channel a group, or a softmax, cancels) is rounding in both
    packages, and is held to GRAD_RTOL of the model's largest gradient."""
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_flax(got_sd)))
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert len(got) == len(want)
    top = max(np.abs(np.asarray(w)).max() for _, w in want)
    zero = set()
    if exact_sd is not None:
        exact = jax.tree_util.tree_leaves_with_path(params_to_flax(exact_sd))
        top64 = max(np.abs(e).max() for _, e in exact)
        zero = {path for path, e in exact if np.abs(e).max() <= 1e-9 * top64}
    for path, w in want:
        w = np.asarray(w)
        scale = top if path in zero else np.abs(w).max()
        np.testing.assert_allclose(got[path], w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("H,W,in_chan,mults,nres", [
    (16, 16, 2, (1, 2), 1),  # pixel diffusion
    (18, 17, 6, (1, 2, 4), 2),  # GenCast's input on an odd grid: the upsample crops
])
def test_punetg_matches_jax(rng, H, W, in_chan, mults, nres):
    """Forward within 2e-5 of max |out| and every gradient within 1e-5 of
    its max, from one set of weights (the port's init carried across);
    the weights round-trip and the parameter counts agree. Four groups a
    GroupNorm, so that each group holds several channels, as at the
    default widths, and no gradient is 0 in exact arithmetic."""
    model = PUNetGCFD(in_chan, 2, 8, 5, mults, nres, 0.0, num_groups_norm=4,
                      generator=torch.Generator().manual_seed(0))
    params = params_to_flax(model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    torch.testing.assert_close(params_from_flax(params), model.state_dict(), rtol=0, atol=0)
    x = rng.standard_normal((2, H, W, in_chan)).astype(np.float32)
    steps = np.array([3, 17])
    cp = rng.standard_normal((2, 5)).astype(np.float32)
    w = rng.standard_normal((2, H, W, 2)).astype(np.float32)
    unet = JaxPUNetG(in_channels=in_chan, out_channels=2, base_channels=8, channel_mults=mults,
                     num_res_blocks=nres, dropout=0.0, num_groups_norm=4)

    def jax_loss(p):
        out = unet.apply({"params": p}, x, steps, cp)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    out = model(t(x), torch.from_numpy(steps), t(cp))
    (out * t(w)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=ATOL * np.abs(want).max())
    assert_grads_close(named_grads(model), grads)


# --- tasks ----------------------------------------------------------------

def task_batch(rng, B=2, H=16, W=16, gencast=False):
    batch = dict(inputs=rng.standard_normal((B, H, W, 2)),
                 labels=rng.standard_normal((B, H, W, 2)),
                 mask=(rng.uniform(size=(B, H, W, 1)) > 0.2),
                 case_params=rng.standard_normal((B, 5)),
                 weights=np.array([1.0] * (B - 1) + [0.0]))
    if gencast:
        batch["inputs_prev"] = rng.standard_normal((B, H, W, 2))
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


STATS = dict(residual_mean=np.array([0.1, -0.2], np.float32),
             residual_std=np.array([0.5, 2.0], np.float32))


def both_tasks(name, loss="nmse", dropout=0.1):
    """The port's task from a seeded init and the JAX task with the same
    weights (as flax params)."""
    kw = dict(SMALL, dropout=dropout)
    gen = torch.Generator().manual_seed(0)
    if name == "pixel":
        port = diffusion.PixelDiffusionCfdModel(loss_name_to_fn(loss), 2, 5, generator=gen, **kw)
        jax_task = jax_diffusion.PixelDiffusionCfdModel(jax_loss_name_to_fn(loss), 2, 5, 16, **kw)
    else:
        port = diffusion.GenCastCfdModel(loss_name_to_fn(loss), STATS["residual_mean"],
                                         STATS["residual_std"], generator=gen, **kw)
        jax_task = jax_diffusion.GenCastCfdModel(jax_loss_name_to_fn(loss), **STATS, **kw)
    return port, jax_task, params_to_flax(port.model.state_dict())


def four_groups(monkeypatch):
    """Both packages' PUNetG with four groups a GroupNorm, as
    ``test_punetg_matches_jax`` builds it: at base 8 and 32 groups a group
    holds one channel and removes per-channel constants, so several biases
    have gradients that are 0 or a near-cancellation in exact arithmetic."""
    monkeypatch.setattr(jax_punetg, "_num_groups", lambda groups, c: num_groups_for(4, c))
    monkeypatch.setattr(punetg, "num_groups_for", lambda groups, c: num_groups_for(4, c))


@pytest.mark.parametrize("name", ["pixel", "gencast"])
def test_task_losses_match_jax(rng, monkeypatch, name):
    """``loss_scores`` of a train step (its train key, dropout on) with
    JAX's draws injected, four groups a GroupNorm: every score within rel
    1e-5 and every gradient within 1e-5 of its max. (Evaluation's draws,
    from no key, are held to JAX in the trainers' dev scores,
    ``test_torch_generative_cli.py``.)"""
    four_groups(monkeypatch)
    port, jax_task, params = both_tasks(name)
    inject_jax_draws(monkeypatch, jax_task.unet)
    host = task_batch(rng, gencast=name == "gencast")
    batch = {k: t(v) for k, v in host.items()}
    key = train_key(7, 3)

    def jax_loss(p, rng_key):
        return jax_task.loss_scores(p, host, train=True, rng=rng_key)

    (_, (want, _)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params, jax_key(key))
    loss, got = port.loss_scores(batch, key)
    loss.backward()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5, err_msg=k)
    assert_grads_close(named_grads(port.model), grads)


def test_pixel_predict_frame_matches_jax(rng, monkeypatch):
    """A 3-step DDPM frame from the evaluation key, with JAX's noise."""
    port, jax_task, params = both_tasks("pixel")
    inject_jax_draws(monkeypatch)
    port.num_inference_steps = jax_task.num_inference_steps = 3
    host = task_batch(rng)
    got = port.predict_frame(t(host["inputs"]), t(host["case_params"]), t(host["mask"])).numpy()
    want = np.asarray(jax_task.predict_frame(params, host["inputs"], host["case_params"],
                                             host["mask"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_RTOL * np.abs(want).max())


def test_gencast_generate_and_rollout_match_jax(rng, monkeypatch):
    """``generate`` from the evaluation key and a 3-step rollout keeping
    the two-frame window (keys split from seed 0), with JAX's noise."""
    port, jax_task, params = both_tasks("gencast")
    inject_jax_draws(monkeypatch)
    port.num_inference_steps = jax_task.num_inference_steps = 2
    host = task_batch(rng, gencast=True)
    args = (host["inputs"], host["inputs_prev"], host["case_params"], host["mask"])
    got = port.generate(*map(t, args)).numpy()
    want = np.asarray(jax_task.generate(params, *args))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_RTOL * np.abs(want).max())
    got = port.rollout(*map(t, args), steps=3).numpy()
    want = np.asarray(jax_task.rollout(params, *args, steps=3))
    assert got.shape == want.shape == (3, 2, 16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["pixel", "gencast"])
def test_gradient_checkpointing_changes_nothing(rng, name):
    """With dropout on, the checkpointed loss and every gradient equal the
    plain ones: the masks are drawn once, before the recomputed forward."""
    port, _, _ = both_tasks(name)
    batch = {k: t(v) for k, v in task_batch(rng, gencast=name == "gencast").items()}
    runs = []
    for remat in (False, True):
        port.use_gradient_checkpointing = remat
        port.model.zero_grad()
        loss, _ = port.loss_scores(batch, train_key(0, 5))
        loss.backward()
        runs.append((loss.detach(), {k: g.clone() for k, g in named_grads(port.model).items()}))
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)
    assert runs[0][0].item() > 0


# --- optimizer ------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_make_gencast_tx_matches_optax(rng, k):
    """12 micro-steps through optax's chain (MultiSteps, apply_if_finite,
    clip, AdamW, warmup-cosine) and through the port's optimizer, one
    gradient with a NaN among them: the parameters within rel 1e-5 after
    every step, and with k > 1 no update after the NaN (optax keeps it in
    its accumulator)."""
    shapes = [(3, 4), (5,), (2, 2, 3)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (0.3 if i % 2 else 2.0)
              for s in shapes] for i in range(12)]
    nan_step = 4 if k == 1 else 9
    grads[nan_step][1][2] = np.nan
    kw = dict(total_steps=12, warmup_steps=2, weight_decay=1e-2, grad_accum_steps=k)
    tx = jax_make_gencast_tx(1e-2, **kw)
    want = [jnp.asarray(a) for a in start]
    state = tx.init(want)
    update = jax.jit(tx.update)
    params = [torch.nn.Parameter(t(a)) for a in start]
    opt = make_gencast_tx(params, 1e-2, **kw)
    history = []
    for g in grads:
        updates, state = update([jnp.asarray(a) for a in g], state, want)
        want = optax.apply_updates(want, updates)
        for p, a in zip(params, g):
            p.grad = t(a)
        opt.step()
        for p, w in zip(params, want):
            w = np.asarray(w)
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5, atol=0)
        history.append(params[0].detach().clone())
    assert not torch.equal(history[0], history[-1])
    if k > 1:
        assert torch.equal(history[nan_step], history[-1])
