"""The frozen plain reference against the program's models, at a tiny size on
the CPU, on the benchmark's seeded weights."""

import numpy as np
import pytest
import torch

from portbench import fields
from portbench.reference import fno, models, unet, weights

from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.cli import make_auto_task
from cfdbench_tpu_torch.training.rollout import make_rollout_fn

P = 5
# The U-Net on 32x32: on 16x16 its bottleneck holds one cell a sample, where
# BatchNorm divides rounding by a variance of nearly nought.
GRID = dict(fno=16, unet=32)
FNO = dict(model="fno", in_chan=2, out_chan=2, fno_depth=2, fno_hidden_dim=8, fno_modes_x=4,
           fno_modes_y=3)
UNET = dict(model="unet", in_chan=2, out_chan=2, unet_dim=4)


def program(args: dict, seed: int):
    H = GRID[args["model"]]
    task = make_auto_task(Args(**args), P, (H, H), "cpu")
    shapes = {n: tuple(p.shape) for n, p in task.model.named_parameters()}
    w = weights.draw(shapes, seed, "cpu")
    with torch.no_grad():
        for n, p in task.model.named_parameters():
            p.copy_(w[n])
    return task, w


def inputs(B: int, seed: int, H: int):
    g = fields.generator(seed, 1, "cpu")
    x, y = fields.flow_pairs(B, H, H, 2, g, "cpu")
    return x, y, fields.masks(B, H, H, g, "cpu"), fields.case_params(B, P, g, "cpu")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("args", [FNO, UNET], ids=["fno", "unet"])
def test_init_rule_bounds_the_programs_own_init(args):
    H = GRID[args["model"]]
    task = make_auto_task(Args(**args), P, (H, H), "cpu")
    params = dict(task.model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    for n, p in params.items():
        lo, hi = weights.bounds(n, shapes)
        assert lo - 1e-7 <= float(p.detach().min()) and float(p.detach().max()) <= hi + 1e-7, n


def test_draw_repeats_for_a_seed_and_differs_between_seeds():
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "n.weight": (4,), "n.bias": (4,)}
    a, b, c = (weights.draw(shapes, s, "cpu") for s in (2 ** 40 + 7, 2 ** 40 + 7, 5))
    assert torch.equal(a["a.weight"], b["a.weight"])
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert torch.equal(a["n.weight"], torch.ones(4)) and torch.equal(a["n.bias"], torch.zeros(4))
    assert float(a["a.weight"].abs().max()) <= 3 ** -0.5


def test_fno_forward_and_rollout():
    task, w = program(FNO, 11)
    task.model.eval()
    x, _, mask, cp = inputs(3, 12, 16)
    cfg = dict(model="fno", args=FNO)
    with torch.no_grad():
        assert rel(task.predict_frame(x, cp, mask), models.predict(cfg, w, {}, x, cp, mask)) < 1e-5
    frames = make_rollout_fn(task.predict_frame, steps=4)(x, cp, mask)
    assert rel(frames, models.rollout(cfg, w, x, cp, mask, 4)) < 1e-5


def test_fno_spectral_conv_is_the_dense_dft():
    # the retained corners through an explicit DFT, against rfft2
    x = torch.randn(2, 8, 8, 3, dtype=torch.float64)
    wts = torch.rand(2, 2, 3, 4, 2, 2, dtype=torch.float64)
    got = fno.spectral_conv(x, wts, 2, 2)
    k1 = torch.tensor([0, 1, 6, 7], dtype=torch.float64)
    h = torch.arange(8, dtype=torch.float64)
    e1 = torch.exp(-2j * np.pi * k1[:, None] * h[None] / 8)
    e2 = torch.exp(-2j * np.pi * h[:2, None] * h[None] / 8)
    xm = torch.einsum("kh,mw,bhwc->bkmc", e1, e2, x.to(torch.complex128))
    wc = torch.complex(wts[:, 0], wts[:, 1])
    ym = torch.cat([torch.einsum("bkmi,iokm->bkmo", xm[:, :2], wc[0]),
                    torch.einsum("bkmi,iokm->bkmo", xm[:, 2:], wc[1])], 1)
    out = torch.zeros(2, 8, 5, 4, dtype=torch.complex128)
    out[:, k1.long(), :2] = ym
    assert torch.allclose(got, torch.fft.irfft2(out, s=(8, 8), dim=(1, 2)), atol=1e-12)


def test_unet_eval_forward_and_rollout():
    task, w = program(UNET, 21)
    task.model.eval()
    x, _, mask, cp = inputs(3, 22, 32)
    cfg = dict(model="unet", args=UNET)
    with torch.no_grad():
        got = task.predict_frame(x, cp, mask)
        assert rel(got, models.predict(cfg, w, unet.initial_stats(cfg, w), x, cp, mask)) < 1e-5
        frames = make_rollout_fn(task.predict_frame, steps=4)(x, cp, mask)
    assert rel(frames, models.rollout(cfg, w, x, cp, mask, 4)) < 1e-5
