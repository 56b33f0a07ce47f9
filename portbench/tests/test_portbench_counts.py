"""The counts of work at the flagship shapes, against hand-worked numbers."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import counts, models, peaks, unet, weights


def test_block_at_the_flagship():
    w = counts.fno_block(128, 64, 64, 32, 12, 12)
    # forward along W and inverse along W: 128*64*32*64*12*2 each; along H:
    # 128*32*12*24*64*4 each; mixing 128*24*12*32*32*4; bypass 128*64*64*32*32
    assert w.macs == 2 * 402_653_184 + 2 * 301_989_888 + 150_994_944 + 536_870_912
    assert w.macs == 2_097_152_000
    # x and the output 2 * 67_108_864; spectral weights 2*2*32*32*12*12*4;
    # w0 32*32*4; b0 32*4
    assert w.bytes == 134_217_728 + 2_359_296 + 4_096 + 128
    assert w.bound_by() == "bytes"
    assert w.bound_s() == pytest.approx(136_581_248 / 3.35e12)
    assert w.bound_s() * 1e3 == pytest.approx(0.0408, abs=5e-5)


def test_head_at_the_flagship():
    w = counts.fno_head(128, 64, 64, 32, 128, 2)
    assert w.macs == 524_288 * 32 * 128 + 524_288 * 128 * 2 == 2_281_701_376
    # x, mask, output; w1, b1, w2, b2
    assert w.bytes == 4 * (524_288 * (32 + 1 + 2) + 128 * 32 + 128 + 2 * 128 + 2) == 73_418_248
    assert w.bound_by() == "bytes"
    assert w.bound_s() * 1e3 == pytest.approx(0.0219, abs=5e-5)


def test_fno_step_at_the_flagship():
    lift = 524_288 * (2 + 1 + 2 + 5) * 32
    assert counts.fno_step_macs(128, 64, 64, 2, 5, 32, 4, 12, 12, 128, 2) == (
        lift + 4 * 2_097_152_000 + 2_281_701_376) == 10_838_081_536


def test_modes_clamp_to_the_grid():
    assert counts.clamp_modes(8, 8, 12, 12) == (4, 5)
    assert counts.fno_block(1, 8, 8, 1, 12, 12).macs == counts.fno_block(1, 8, 8, 1, 4, 5).macs


def test_unet_by_hand():
    # in_conv 4096*(8*12 + 12*12)*9; each level down (h*w)*(c*2c + 2c*2c)*9 with
    # h*w*c constant; each level up: transposed conv, then (2c -> c, c -> c)*9
    down = 1024 * (12 * 24 + 24 * 24) * 9
    up = 64 * 192 * 96 + 64 * (192 * 96 + 96 * 96) * 9
    expected = 4096 * (8 * 12 + 12 * 12) * 9 + 4 * down + 4 * up + 4096 * 12 * 2
    assert counts.unet_forward_macs(64, 64, 2, 5, 12, 2) == expected == 109_215_744


def test_unet_against_torch_flop_counter():
    shapes = {n: tuple(t.shape) for n, t in _unet_weights().items()}
    P = weights.draw(shapes, 3, "cpu")
    cfg = dict(model="unet", args=dict(in_chan=2, out_chan=2, unet_dim=12), grid=[64, 64],
               n_case_params=5)
    S = unet.initial_stats(cfg, P)
    x = torch.zeros(1, 64, 64, 2)
    with FlopCounterMode(display=False) as fc:
        unet.predict(cfg, P, S, x, torch.zeros(1, 5), torch.ones(1, 64, 64, 1))
    assert fc.get_total_flops() == 2 * counts.unet_forward_macs(64, 64, 2, 5, 12, 2)
    assert models.forward_macs(cfg, 3) == 3 * counts.unet_forward_macs(64, 64, 2, 5, 12, 2)


def test_peaks_are_the_data_sheets():
    assert peaks.TF32_FLOPS == 495e12 and peaks.HBM_BYTES_PER_S == 3.35e12


def _unet_weights():
    from cfdbench_tpu_torch.models.unet import UNet

    model = UNet(n_case_params=5, dim=12, generator=torch.Generator().manual_seed(0))
    return dict(model.named_parameters())
