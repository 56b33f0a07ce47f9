"""Truncated-mode 2-D spectral convolution (the FNO's spectral conv).

Port of ``cfdbench_tpu/ops/spectral.py``: the same semantics as
``spectral_conv2d_fft`` — rfft2 over the spatial dims of an NHWC
tensor, complex per-mode channel mixing on the two low-frequency row
corners (rows ``[:m1]`` and ``[H-m1:]``, each with its own weights),
zeros elsewhere, irfft2 back. Weights keep the real-pair layout
``(corner, re/im, Cin, Cout, modes1, modes2)``, so one checkpoint
drives both packages.

The DFT factor tables (``_dft_factors``) are numpy, for the CUDA block
kernel (``ops/fno_kernels.py``), which projects onto the retained modes
with them instead of running an FFT.
The JAX package's DFT-matmul backends and their batch-size crossover
rule were TPU workarounds and are not ported: here ``torch.fft`` is
the plain version and the fused kernel is the fast one.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def clamp_modes(H: int, W: int, modes1: int, modes2: int):
    """Retained modes for an H×W grid, clamped to its half spectrum
    (the parameter shapes stay config-determined)."""
    return min(modes1, H // 2), min(modes2, W // 2 + 1)


@lru_cache(maxsize=None)
def _dft_factors(H: int, W: int, m1: int, m2: int):
    """Real/imag DFT factors restricted to the retained modes.

    Forward: E1[k, h] = exp(-2πi·K1[k]·h/H), K1 = [0..m1-1, H-m1..H-1];
    E2[m, w] = exp(-2πi·m·w/W). Inverse, with pocketfft C2R semantics
    (the imaginary part of the DC column, and of the Nyquist column when
    W is even, is dropped): A[h, k] = exp(+2πi·K1[k]·h/H)/H;
    B[w, m] = α_m·exp(+2πi·m·w/W)/W, where α doubles every column to
    stand in for its dropped conjugate except DC and the even-W Nyquist
    column, which are their own conjugates.
    """
    k1 = np.concatenate([np.arange(m1), np.arange(H - m1, H)])
    k2 = np.arange(m2)
    h = np.arange(H)
    w = np.arange(W)
    E1 = np.exp(-2j * np.pi * np.outer(k1, h) / H)
    E2 = np.exp(-2j * np.pi * np.outer(k2, w) / W)
    A = np.exp(2j * np.pi * np.outer(h, k1) / H) / H
    alpha = np.where((k2 == 0) | ((W % 2 == 0) & (k2 == W // 2)), 1.0, 2.0)
    B = alpha * np.exp(2j * np.pi * np.outer(w, k2) / W) / W

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    return (
        f32(E1.real), f32(E1.imag), f32(E2.real), f32(E2.imag),
        f32(A.real), f32(A.imag), f32(B.real), f32(B.imag),
    )


def spectral_conv2d_fft(
    x: torch.Tensor,  # (B, H, W, Cin) float32
    weights: torch.Tensor,  # (2, 2, Cin, Cout, modes1, modes2)
    modes1: int,
    modes2: int,
) -> torch.Tensor:
    """rfft2 → mix the retained corners → irfft2. Returns (B, H, W, Cout)."""
    B, H, W, _ = x.shape
    Cout = weights.shape[3]
    wf = W // 2 + 1
    m1, m2 = clamp_modes(H, W, modes1, modes2)

    x_ft = torch.fft.rfft2(x, dim=(1, 2))  # (B, H, wf, Cin) complex64
    w_c = torch.complex(
        weights[:, 0, :, :, :m1, :m2], weights[:, 1, :, :, :m1, :m2]
    )  # (2, Cin, Cout, m1, m2)
    out_ft = x_ft.new_zeros((B, H, wf, Cout))
    out_ft[:, :m1, :m2] = torch.einsum(
        "bxyi,ioxy->bxyo", x_ft[:, :m1, :m2], w_c[0]
    )
    out_ft[:, H - m1:, :m2] = torch.einsum(
        "bxyi,ioxy->bxyo", x_ft[:, H - m1:, :m2], w_c[1]
    )
    # irfft2 as its two halves, the C2R half on a spectrum made Hermitian
    # explicitly: the mixed DC (and even-W Nyquist) column is not, and
    # pocketfft drops its imaginary part while cuFFT's multi-dimensional
    # C2R leaves such input undefined. This pins both to pocketfft.
    z = torch.fft.ifft(out_ft, dim=1)
    z[:, :, 0].imag.zero_()
    if W % 2 == 0:
        z[:, :, W // 2].imag.zero_()
    return torch.fft.irfft(z, n=W, dim=2)


def init_spectral_weights(
    generator: torch.Generator, in_ch: int, out_ch: int, m1: int, m2: int
) -> torch.Tensor:
    """U(0, 1/(in·out)) per real/imag component, matching the reference's
    ``scale * torch.rand(..., dtype=cfloat)``."""
    scale = 1.0 / (in_ch * out_ch)
    w = torch.empty((2, 2, in_ch, out_ch, m1, m2), dtype=torch.float32)
    return w.uniform_(0.0, scale, generator=generator)
