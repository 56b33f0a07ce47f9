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

Neither ``torch.fft`` nor cuFFT takes bfloat16, and the JAX package
never transforms in it: its DFT tables are float32, so a bfloat16 input
or weight is promoted to float32 in every product. The convs here do the
same (:func:`fft_dtype`): the 2-D conv rounds its output back to the
input's dtype, as the JAX one does (``out_dtype = x.dtype``); the 1-D
conv of the FFNO returns float32, as the JAX one does, which never casts
back.

The JAX package's DFT-matmul backends and their batch-size crossover
rule were TPU workarounds and are not ported: here ``torch.fft`` is
the plain version and the fused kernel is the fast one.

Under spatial sharding (``rows``, a model axis over which x's grid rows
are split: ``parallel/spatial.py``) the transforms along W stay
``torch.fft`` on the rank's rows, and those along H become products with
the truncated DFT's columns for the rank's rows (:func:`_row_factors`,
over the global H): the rank's partial spectrum is summed over the model
ranks (``spatial.row_sum``), mixed, and the inverse computed for the
rank's rows alone. The modes are clamped to the global grid.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..parallel.spatial import active, row_span, row_sum, row_sum_
from . import common_dtype


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


@lru_cache(maxsize=None)
def _row_factors(H: int, m1: int, r0: int, h: int, lead: bool):
    """The truncated H-DFT between the rows ``[r0, r0 + h)`` of an H-row grid
    and its retained spectrum rows, complex128: ``(E, A)``, the forward
    E[k, r] = exp(-2πi·K[k]·(r0 + r)/H) and the inverse A[r, k] =
    exp(+2πi·K[k]·(r0 + r)/H)/H. K is the FNO's two corners, [0..m1-1,
    H-m1..H-1]; with ``lead`` the first ``m1`` rows alone (the FFNO's row
    modes), the inverse then doubled for every mode but DC, which stands
    in for its dropped conjugate (irfft's C2R; no retained mode is the
    Nyquist one)."""
    k = np.arange(m1) if lead else np.concatenate([np.arange(m1), np.arange(H - m1, H)])
    r = np.arange(r0, r0 + h)
    E = np.exp(-2j * np.pi * np.outer(k, r) / H)
    A = np.exp(2j * np.pi * np.outer(r, k) / H) / H
    if lead:
        A = A * np.where(k == 0, 1.0, 2.0)
    return E, A


def _row_tables(h: int, axis, m1: int, lead: bool, work: torch.dtype, device):
    """:func:`_row_factors` of this rank's rows as complex tensors of the
    working precision ``work``."""
    r0, H = row_span(h, axis)
    ctype = torch.complex128 if work == torch.float64 else torch.complex64
    return tuple(torch.from_numpy(f).to(device=device, dtype=ctype)
                 for f in _row_factors(H, m1, r0, h, lead))


def fft_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The dtype a spectral conv transforms in: the tensors' common dtype,
    float32 at least."""
    return torch.promote_types(common_dtype(*tensors), torch.float32)


def spectral_conv2d_fft(
    x: torch.Tensor,  # (B, H, W, Cin)
    weights: torch.Tensor,  # (2, 2, Cin, Cout, modes1, modes2)
    modes1: int,
    modes2: int,
    rows=None,
) -> torch.Tensor:
    """rfft2 → mix the retained corners → irfft2. Returns (B, H, W, Cout)
    in x's dtype, transformed in :func:`fft_dtype`. With ``rows`` x is this
    rank's rows of the grid (see the module's docstring)."""
    out_dtype = x.dtype
    work = fft_dtype(x, weights)
    x, weights = x.to(work), weights.to(work)
    if active(rows):
        return _spectral_conv2d_rows(x, weights, modes1, modes2, rows).to(out_dtype)
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
    return _c2r(torch.fft.ifft(out_ft, dim=1), W).to(out_dtype)


def _spectral_conv2d_rows(x, weights, modes1: int, modes2: int, axis) -> torch.Tensor:
    """:func:`spectral_conv2d_fft` on a rank's rows: rfft along W, the
    rank's share of the retained spectrum (its rows against E's columns),
    summed over the model ranks, mixed, and the inverse H-DFT and C2R
    for its rows."""
    B, h, W, _ = x.shape
    H = row_span(h, axis)[1]
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    E, A = _row_tables(h, axis, m1, False, x.dtype, x.device)
    xm = row_sum(torch.einsum("kr,brmi->bkmi", E, torch.fft.rfft(x, dim=2)[:, :, :m2]), axis)
    ym = torch.einsum("bkmi,kmio->bkmo", xm, _corner_weights(weights, m1, m2))
    return _c2r(torch.einsum("rk,bkmo->brmo", A, ym), W)


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
                        W: int, modes1: int, modes2: int, rows=None):
    """``(dx, dweights)``: the gradient of :func:`spectral_conv2d_fft` at
    an x whose :func:`retained_modes` are ``modes`` (X), against ``grad``
    (B, H, W, Cout). With g = rfft2(grad) / (H W) on the retained modes,
    the gradient of the mixed modes Y (as d/dRe + i d/dIm) is alpha g,
    the adjoint of the C2R inverse (alpha: :func:`_alpha`). Then
    dw = the batch's sum of conj(X) alpha g per mode, and dx = Re of the
    sum over the retained modes of alpha g conj(w) e^{+i theta}, which is
    H W times the C2R inverse of g conj(w): the inverse's own alpha
    cancels the one in the gradient.

    With ``rows`` (spatial sharding) ``grad`` is this rank's rows, ``modes``
    the whole grid's: g and dweights are this rank's partials, and the
    gradient of the retained modes is summed over the model ranks before
    its inverse for the rank's rows."""
    B, h, _, _ = grad.shape
    H = row_span(h, rows)[1]
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    gr = torch.fft.rfft(grad, dim=2)[:, :, :m2]
    if active(rows):
        E, A = _row_tables(h, rows, m1, False, grad.dtype, grad.device)
        g = torch.einsum("kr,brmo->bkmo", E, gr) / (H * W)
    else:
        g = torch.fft.fft(gr, dim=1)
        g = torch.cat([g[:, :m1], g[:, H - m1:]], dim=1) / (H * W)
    gw = torch.einsum("bkmi,bkmo->kmio", modes.conj(), g * _alpha(W, m2, g.device)[:, None])
    gx = torch.einsum("bkmo,kmio->bkmi", g, _corner_weights(weights, m1, m2).conj())
    dweights = torch.zeros_like(weights)
    gw = gw.reshape(2, m1, m2, *gw.shape[2:]).permute(0, 3, 4, 1, 2)  # (corner, i, o, m1, m2)
    dweights[:, 0, :, :, :m1, :m2] = gw.real
    dweights[:, 1, :, :, :m1, :m2] = gw.imag
    if active(rows):
        gx = row_sum_(gx.contiguous(), rows)
        return _c2r(torch.einsum("rk,bkmi->brmi", A, gx), W) * (H * W), dweights
    full = gx.new_zeros((B, H, m2, gx.shape[-1]))
    full[:, :m1], full[:, H - m1:] = gx[:, :m1], gx[:, m1:]
    return _c2r(torch.fft.ifft(full, dim=1), W) * (H * W), dweights


def init_spectral_weights(
    generator: torch.Generator, in_ch: int, out_ch: int, m1: int, m2: int
) -> torch.Tensor:
    """U(0, 1/(in·out)) per real/imag component, matching the reference's
    ``scale * torch.rand(..., dtype=cfloat)``."""
    scale = 1.0 / (in_ch * out_ch)
    w = torch.empty((2, 2, in_ch, out_ch, m1, m2), dtype=torch.float32)
    return w.uniform_(0.0, scale, generator=generator)


def spectral_conv1d(
    x: torch.Tensor,  # (B, H, W, C)
    weights: torch.Tensor,  # (2, C, C, modes): [re/im, in, out, mode]
    modes: int,
    axis: int,  # 1 (H) or 2 (W)
    rows=None,
) -> torch.Tensor:
    """The FFNO's factorised 1-D spectral conv along one spatial axis
    (``spectral_conv1d_matmul`` of the JAX package): rfft along the axis,
    the first ``m = min(modes, N // 2)`` modes mixed over channels, irfft
    back to N points (the other modes zero). Since m <= N // 2, no retained mode is the even-N
    Nyquist one, and irfft drops the imaginary part of the DC mode as the
    JAX package's inverse factors do (their DC column is real), so this
    equals its DFT-matmul form. It transforms and returns
    :func:`fft_dtype`: float32 for a bfloat16 x or weight. With ``rows``
    (spatial sharding) x is this rank's rows: along H its modes are the
    rank's partial sums over the DFT's columns for its rows, summed over
    the model ranks, and the inverse is taken for its rows alone."""
    if axis not in (1, 2):
        raise ValueError(f"axis {axis}: choose 1 (H) or 2 (W)")
    work = fft_dtype(x, weights)
    x, weights = x.to(work), weights.to(work)
    if axis == 1 and active(rows):
        h = x.shape[1]
        m = min(modes, row_span(h, rows)[1] // 2)
        E, A = _row_tables(h, rows, m, True, work, x.device)
        w = torch.complex(weights[0, :, :, :m], weights[1, :, :, :m])
        xk = row_sum(torch.einsum("kr,brwi->bkwi", E, x.to(E.dtype)), rows)
        return torch.einsum("rk,bkwo->brwo", A, torch.einsum("bkwi,iok->bkwo", xk, w)).real
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
