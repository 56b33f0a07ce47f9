"""Autoregressive multi-step rollout and its per-step metrics (port of
``cfdbench_tpu/training/rollout.py``).

All cases roll out together along the batch axis; the rollout is a
Python loop (:func:`unroll`) that feeds each prediction back and stacks
the frames into a ``(steps, B, H, W, C)`` tensor, without writing into
any tensor in place, so that ``torch.export`` traces the same loop
(``utils/export.py``); ``make_rollout_fn`` runs it under
``torch.inference_mode``. The
masked-u metrics run on the device in float32; the averages over cases
are taken on the host in float64, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..utils.rng import rollout_key


def make_rollout_fn(
    apply_fn: Callable,
    steps: int,
    include_initial: bool = False,
    stochastic: bool = False,
    seed: int = 0,
) -> Callable:
    """Build ``rollout(frame0, case_params, mask) → (steps, B, H, W, C)``.

    ``apply_fn(frame, case_params, mask) -> next_frame`` keeps the
    frame's shape. With ``include_initial`` the frames are
    ``[frame0, pred_1, ..., pred_{steps-1}]`` (the ResNet family's
    alignment), so the last prediction is never computed.

    ``stochastic=True`` calls ``apply_fn(frame, case_params, mask, key)``
    with prediction i's key ``rollout_key(seed, i, steps)``, fresh noise each step
    (``utils/rng.py``; the JAX package splits ``PRNGKey(seed)`` into one
    key per step): the diffusion models, whose prediction is a DDPM
    sampling run (``src/models/pixel_diffusion.py:139-154``).
    """

    def step(carry, case_params, mask, i):
        if stochastic:
            return apply_fn(carry, case_params, mask, rollout_key(seed, i, steps))
        return apply_fn(carry, case_params, mask)

    def rollout(frame0, case_params, mask):
        with torch.inference_mode():
            return unroll(step, frame0, case_params, mask, steps, include_initial)

    return rollout


def unroll(step: Callable, frame0, case_params, mask, steps: int,
           include_initial: bool = False) -> torch.Tensor:
    """The frames of ``steps`` self-fed calls ``step(frame, case_params,
    mask, i)``, the i-th prediction from the one before it, stacked as
    ``(steps, B, H, W, C)``; with ``include_initial`` the first frame is
    ``frame0`` and the last prediction is never computed. Each prediction
    is carried in ``frame0``'s dtype, as the JAX scan carries it: a
    bfloat16 rollout stays bfloat16 where a model returns float32 (the
    point models, the FFNO)."""
    frames = [frame0] if include_initial else []
    carry = frame0
    for i in range(steps - len(frames)):
        carry = step(carry, case_params, mask, i).to(frame0.dtype)
        frames.append(carry)
    return torch.stack(frames)


def _per_step_metrics(preds_u, labels_u, mask):
    """Masked-u mse / nmse / mae per (case, step) over the full grid."""
    p = preds_u * mask
    lab = labels_u * mask
    err = p - lab
    mse = err.square().mean(dim=(-2, -1))
    nmse = mse / lab.square().mean(dim=(-2, -1))
    mae = err.abs().mean(dim=(-2, -1))
    return mse, nmse, mae


def multistep_metrics(
    pred_frames: torch.Tensor,  # (steps, B, H, W, C)
    label_frames: np.ndarray,  # (B, steps, H, W, >=1) ground truth
    mask: np.ndarray,  # (B, H, W) or (B, H, W, 1)
    case_weights: np.ndarray = None,  # (B,) 1 = real case, 0 = padding
) -> List[Dict[str, float]]:
    """Per-step metric dicts: the (``case_weights``-weighted) mean over
    cases of each case's mse, nmse and mae."""
    device = pred_frames.device
    with torch.inference_mode():
        preds_u = pred_frames[..., 0].float().transpose(0, 1)  # (B, S, H, W)
        labels_u = torch.as_tensor(
            np.ascontiguousarray(label_frames[..., 0]), dtype=torch.float32,
            device=device,
        )
        m = np.asarray(mask)
        if m.ndim == 4:
            m = m[..., 0]
        m = torch.as_tensor(m, dtype=torch.float32, device=device)[:, None]
        mse, nmse, mae = (
            t.cpu().numpy() for t in _per_step_metrics(preds_u, labels_u, m)
        )
    w = None if case_weights is None else np.asarray(case_weights, np.float64)
    return [
        dict(
            mse=float(np.average(mse[:, s], weights=w)),
            nmse=float(np.average(nmse[:, s], weights=w)),
            mae=float(np.average(mae[:, s], weights=w)),
        )
        for s in range(preds_u.shape[1])
    ]


def pad_case_features(all_features: List[np.ndarray], steps: int) -> np.ndarray:
    """Stack per-case (T, H, W, 3) arrays into (B, steps, H, W, 3),
    repeating the final frame of short cases (steady state)."""
    padded = []
    for feats in all_features:
        T = feats.shape[0]
        if T < steps:
            reps = np.repeat(feats[-1:], steps - T, axis=0)
            feats = np.concatenate([feats, reps], axis=0)
        padded.append(feats[:steps])
    return np.stack(padded)
