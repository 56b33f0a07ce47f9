"""Random draws of the port (counterpart of ``cfdbench_tpu/utils/rng.py``).

The JAX package draws its training randomness from RBG keys
(``fast_train_key``), a TPU speed-up for the dropout masks of the
diffusion models; evaluation uses threefry ``PRNGKey(0)``. torch can draw
neither stream, so the port replaces every key with a tuple of ints and
every draw with one from a ``torch.Generator`` seeded by that tuple alone
(``generator``). Each tuple opens with the word of its purpose, so no two
purposes share a key, and mirrors how the JAX package derives its key, so
a test can map it back to JAX's key and inject JAX's own draws:

- ``train_key(seed, step)``: a train step's draws, JAX's
  ``fold_in(base, step)`` of the trainer's RBG base key
  ``fast_train_key(seed)``;
- ``rollout_key(seed, step, steps)``: step ``step`` of a stochastic
  rollout of ``steps`` steps, JAX's ``split(PRNGKey(seed), steps)[step]``;
- ``EVAL_KEY``: evaluation and generation without a key, JAX's
  ``PRNGKey(0)``;
- ``vae_key(seed, step)``: the VAE trainer's posterior sample at train
  step ``step``, JAX's ``fold_in(PRNGKey(seed + 31337), step)``
  (``trainer_vae.py:43, 58``);
- ``latent_keys(key)``: a latent diffusion loss's two keys, ``(noise key,
  posterior key)``, JAX's ``rng, vkey = split(rng)`` of the loss's key
  (``diffusion.py:438, 624``): the noise and timesteps come from the first,
  the frozen VAE's posterior sample from the second;
- ``uncond_key(seed, step)``: the unconditional DDPM trainer's step,
  JAX's ``fold_in(PRNGKey(seed + 99), step)``, which it splits in three:
  noise, timesteps and dropout (``trainer_uncond.py:87, 94-95``).

A draw derived from a key appends a word of its own that is not 0 (the
dropout masks ``DROPOUT_TAG``; the sampler's noise ``SAMPLER_TAG`` and
its index), so the zeros that ``numpy.random.SeedSequence`` pads short
keys with cannot make two keys meet either.

Nothing else of the RBG decision carries over: the draws are made on the
device that uses them, and a run that resumes at a step draws what a
straight run drew there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Key = Tuple[int, ...]
TRAIN_TAG = 0x7472616E  # "tran"
ROLLOUT_TAG = 0x726F6C6C  # "roll"
EVAL_TAG = 0x6576616C  # "eval"
EVAL_KEY: Key = (EVAL_TAG, 0)
VAE_TAG = 0x7661655F  # "vae_"
LATENT_NOISE_TAG = 0x6C6E6F69  # "lnoi"
LATENT_POSTERIOR_TAG = 0x6C706F73  # "lpos"
UNCOND_TAG = 0x756E636F  # "unco"


def train_key(seed: int, step: int) -> Key:
    return (TRAIN_TAG, seed, step)


def rollout_key(seed: int, step: int, steps: int) -> Key:
    return (ROLLOUT_TAG, seed, step, steps)


def vae_key(seed: int, step: int) -> Key:
    return (VAE_TAG, seed, step)


def latent_keys(key: Key) -> Tuple[Key, Key]:
    return (LATENT_NOISE_TAG, *key), (LATENT_POSTERIOR_TAG, *key)


def uncond_key(seed: int, step: int) -> Key:
    return (UNCOND_TAG, seed, step)


def generator(key: Key, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``key`` alone."""
    state = np.random.SeedSequence(list(key)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step ``step``'s random draws (the ResNet's
    dropout masks), a function of ``(seed, step)`` alone."""
    return generator(train_key(seed, step), device)
