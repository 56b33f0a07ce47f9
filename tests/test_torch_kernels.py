"""The port's CUDA kernels against their plain PyTorch versions.

The kernels run only on a CUDA card: those tests carry the ``cuda``
marker and skip without one. This file imports no JAX, so on a machine
with a card and without JAX it runs on its own:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

On the CPU it checks the arithmetic the block kernel is built on: its
packed DFT factor tables, read the way ``csrc/fno_block.cu`` reads them,
reproduce the plain ``torch.fft`` spectral conv.
"""

import numpy as np
import pytest
import torch

from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import (
    _dft_factors_packed,
    clamp_modes,
    spectral_conv2d_fft,
)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def block_inputs(rng, B, H, W, C, modes):
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    # Spectral weights at C times their init scale, so the spectral path
    # carries as much of the output as the bypass.
    w = rng.uniform(0, 1.0 / C, (2, 2, C, C, modes, modes)).astype(np.float32)
    k0 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b0 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, w, k0, b0


@pytest.mark.parametrize(
    "H,W,modes",
    [(16, 16, 12), (18, 17, 4), (66, 65, 12)],
)
def test_packed_dft_tables_reproduce_spectral_conv(rng, H, W, modes):
    """The three passes of the block kernel, in float64 numpy: forward
    DFT onto the retained modes with E1c/E2c, per-mode mixing with the
    corner weights, inverse with Ac/Bc keeping the real part."""
    x, w, _, _ = block_inputs(rng, 2, H, W, 4, modes)
    m1, m2 = clamp_modes(H, W, modes, modes)
    K = 2 * m1
    E1c, E2c, Ac, Bc = (f.astype(np.float64) for f in _dft_factors_packed(H, W, m1, m2))
    E1 = E1c[:K] + 1j * E1c[K:]
    E2 = E2c[:m2, :W] + 1j * E2c[m2:, :W]
    A = Ac[:H, :K] + 1j * Ac[H:, :K]
    B = Bc[:, :m2] - 1j * Bc[:, m2:]
    X = np.einsum("kh,mw,bhwc->bkmc", E1, E2, x)
    corner = np.concatenate(  # (K, m2, Ci, Co): rows k < m1 are corner 0
        [w[c, 0, :, :, :m1, :m2] + 1j * w[c, 1, :, :, :m1, :m2] for c in (0, 1)],
        axis=2,
    ).transpose(2, 3, 0, 1)
    Y = np.einsum("bkmc,kmco->bkmo", X, corner)
    Z = np.einsum("hk,bkmo->bhmo", A, Y)
    got = np.einsum("wm,bhmo->bhwo", B, Z).real
    want = spectral_conv2d_fft(t(x), t(w), modes, modes).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,W,C,modes",
    [
        (4, 64, 64, 32, 12),  # flagship widths
        (4, 66, 65, 32, 12),  # tube/dam grid, odd W
        (3, 18, 17, 10, 4),   # ragged channel, mode and row tiles
        (17, 16, 16, 8, 12),  # clamped modes with the Nyquist column, B > 16
    ],
)
def test_kernels_match_plain_on_card(cuda_device, rng, B, H, W, C, modes):
    from cfdbench_tpu_torch.utils.device import set_f32_numerics

    set_f32_numerics()
    x, w, k0, b0 = block_inputs(rng, B, H, W, C, modes)
    x, w, w0, b0 = (t(a).to(cuda_device) for a in (x, w, k0.T, b0))
    before = fk.launch_counts()
    got = fk.fno_block(x, w, w0, b0, modes, modes)
    want = fk.fno_block_reference(x, w, w0, b0, modes, modes)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4

    n_out = 2 if C == 32 else 3  # the FNO's 2 outputs, and a run-time count
    w1 = t(rng.standard_normal((128, C)) / np.sqrt(C)).to(cuda_device)
    w2 = t(rng.standard_normal((n_out, 128)) / np.sqrt(128)).to(cuda_device)
    b1, b2 = t(np.full(128, 0.1)).to(cuda_device), t(np.full(n_out, 0.1)).to(cuda_device)
    mask = torch.ones((B, H, W, 1), device=cuda_device)
    mask[:, : H // 2] = 0
    got = fk.fno_head(x, w1, b1, w2, b2, mask)
    want = fk.fno_head_reference(x, w1, b1, w2, b2, mask)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    after = fk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fno_block": 1, "fno_head": 1}


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fno_block(x, x, x, x, 2, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fno_head(x, x, x, x, x, x)
