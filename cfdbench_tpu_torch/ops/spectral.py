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
with them instead of running an FFT. :func:`spectral_conv2d_vjp` is the
conv's gradient written out in ``torch.fft``, from x's retained modes:
the block's backward on the card.
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
    return _c2r(torch.fft.ifft(out_ft, dim=1), W)


def _c2r(z: torch.Tensor, W: int) -> torch.Tensor:
    """irfft along W (dim 2) of a half spectrum, missing columns zero,
    made Hermitian explicitly first: a mixed DC (and even-W Nyquist)
    column is not, and pocketfft drops its imaginary part while cuFFT's
    C2R leaves such input undefined. This pins both to pocketfft."""
    z[:, :, 0].imag.zero_()
    if W % 2 == 0 and z.shape[2] > W // 2:
        z[:, :, W // 2].imag.zero_()
    return torch.fft.irfft(z, n=W, dim=2)


def _alpha(W: int, m2: int, device) -> torch.Tensor:
    """(m2,): how often each retained column counts in a real field of
    width W — 2 for a column that stands in for its dropped conjugate, 1
    for DC and the even-W Nyquist column."""
    m = torch.arange(m2, device=device)
    return torch.where((m == 0) | ((W % 2 == 0) & (m == W // 2)), 1.0, 2.0)


def _corner_weights(weights: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """The spectral weights as (2 m1, m2, Cin, Cout) complex, rows in the
    order of the retained spectrum rows [0, m1) then [H - m1, H)."""
    Ci, Co = weights.shape[2:4]
    w = torch.complex(weights[:, 0, :, :, :m1, :m2], weights[:, 1, :, :, :m1, :m2])
    return w.permute(0, 3, 4, 1, 2).reshape(2 * m1, m2, Ci, Co)


def retained_modes(x: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """rfft2 of x (B, H, W, C) on the retained rows [0, m1), [H - m1, H)
    and columns [0, m2): (B, 2 m1, m2, C) complex — what the block
    kernel's forward pass leaves in its scratch ``xm`` (real, imaginary)."""
    H = x.shape[1]
    x_ft = torch.fft.rfft2(x, dim=(1, 2))
    return torch.cat([x_ft[:, :m1, :m2], x_ft[:, H - m1:, :m2]], dim=1)


def spectral_conv2d_vjp(grad: torch.Tensor, modes: torch.Tensor, weights: torch.Tensor,
                        W: int, modes1: int, modes2: int):
    """``(dx, dweights)``: the gradient of :func:`spectral_conv2d_fft` at
    an x whose :func:`retained_modes` are ``modes`` (X), against ``grad``
    (B, H, W, Cout). With g = rfft2(grad) / (H W) on the retained modes,
    the gradient of the mixed modes Y (as d/dRe + i d/dIm) is alpha g,
    the adjoint of the C2R inverse (alpha: :func:`_alpha`). Then
    dw = the batch's sum of conj(X) alpha g per mode, and dx = Re of the
    sum over the retained modes of alpha g conj(w) e^{+i theta}, which is
    H W times the C2R inverse of g conj(w): the inverse's own alpha
    cancels the one in the gradient."""
    B, H, _, _ = grad.shape
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    g = torch.fft.fft(torch.fft.rfft(grad, dim=2)[:, :, :m2], dim=1)
    g = torch.cat([g[:, :m1], g[:, H - m1:]], dim=1) / (H * W)
    gw = torch.einsum("bkmi,bkmo->kmio", modes.conj(), g * _alpha(W, m2, g.device)[:, None])
    gx = torch.einsum("bkmo,kmio->bkmi", g, _corner_weights(weights, m1, m2).conj())
    dweights = torch.zeros_like(weights)
    gw = gw.reshape(2, m1, m2, *gw.shape[2:]).permute(0, 3, 4, 1, 2)  # (corner, i, o, m1, m2)
    dweights[:, 0, :, :, :m1, :m2] = gw.real
    dweights[:, 1, :, :, :m1, :m2] = gw.imag
    rows = gx.new_zeros((B, H, m2, gx.shape[-1]))
    rows[:, :m1], rows[:, H - m1:] = gx[:, :m1], gx[:, m1:]
    return _c2r(torch.fft.ifft(rows, dim=1), W) * (H * W), dweights


def init_spectral_weights(
    generator: torch.Generator, in_ch: int, out_ch: int, m1: int, m2: int
) -> torch.Tensor:
    """U(0, 1/(in·out)) per real/imag component, matching the reference's
    ``scale * torch.rand(..., dtype=cfloat)``."""
    scale = 1.0 / (in_ch * out_ch)
    w = torch.empty((2, 2, in_ch, out_ch, m1, m2), dtype=torch.float32)
    return w.uniform_(0.0, scale, generator=generator)


def spectral_conv1d(
    x: torch.Tensor,  # (B, H, W, C) float32
    weights: torch.Tensor,  # (2, C, C, modes): [re/im, in, out, mode]
    modes: int,
    axis: int,  # 1 (H) or 2 (W)
) -> torch.Tensor:
    """The FFNO's factorised 1-D spectral conv along one spatial axis
    (``spectral_conv1d_matmul`` of the JAX package): rfft along the axis,
    the first ``m = min(modes, N // 2)`` modes mixed over channels, irfft
    back to N points (the other modes zero). Since m <= N // 2, no retained mode is the even-N
    Nyquist one, and irfft drops the imaginary part of the DC mode as the
    JAX package's inverse factors do (their DC column is real), so this
    equals its DFT-matmul form."""
    if axis not in (1, 2):
        raise ValueError(f"axis {axis}: choose 1 (H) or 2 (W)")
    N = x.shape[axis]
    m = min(modes, N // 2)
    x_ft = torch.fft.rfft(x, dim=axis)
    w = torch.complex(weights[0, :, :, :m], weights[1, :, :, :m])  # (in, out, m)
    if axis == 1:
        y = torch.einsum("bkwi,iok->bkwo", x_ft[:, :m], w)
    else:
        y = torch.einsum("bhki,iok->bhko", x_ft[:, :, :m], w)
    # irfft zero-pads the m mixed modes to the N // 2 + 1 of the half spectrum.
    return torch.fft.irfft(y, n=N, dim=axis)


def init_spectral_weights_1d(generator: torch.Generator, ch: int, m: int) -> torch.Tensor:
    """U(0, 1/ch²) per real/imag component, ``(2, ch, ch, m)``."""
    w = torch.empty((2, ch, ch, m), dtype=torch.float32)
    return w.uniform_(0.0, 1.0 / (ch * ch), generator=generator)
