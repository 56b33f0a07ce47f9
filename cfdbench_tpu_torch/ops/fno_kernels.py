"""The FNO's two hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

- :func:`fno_block` — the whole FnoBlock forward (spectral conv + 1×1
  bypass + exact GELU), ``csrc/fno_block.cu``; port of
  ``cfdbench_tpu/ops/pallas_fno.py::fused_fno_block``.
- :func:`fno_head` — fc1 → GELU → fc2 → ×mask, ``csrc/fno_head.cu``;
  port of ``cfdbench_tpu/ops/pallas_fno.py::fused_fno_head``.

A wrapper given CPU tensors returns its plain version
(``fno_block_reference`` / ``fno_head_reference``); given CUDA tensors
it launches its kernel or raises — there is no fallback. Weights are in
``nn.Linear`` layout (``(out, in)``). Each wrapper counts the calls in
which it launched its kernel in ``<wrapper>.launches``, so a run can
show that it went through the kernels (:func:`launch_counts`).

On the card the kernels run inside ``torch.autograd.Function``s
(:class:`FnoBlockFn`, :class:`FnoHeadFn`), so a forward under grad
carries gradients to every input. The TPU kernels are forward-only too
(the JAX package trains through XLA's gradient of the plain graph), so
the backwards are PyTorch ops: the block's is its explicit VJP
(:func:`fno_block_vjp`: ``torch.fft`` for the spectral adjoint, plain
products for the bypass) from the pre-activation and x's retained modes,
which the kernel writes under grad; the head's recomputes fc1 and GELU
from the saved x, as the JAX package's ``remat_head`` does, and
differentiates them.

Both kernels multiply on the tensor cores in split TF32 (``csrc/tf32.cuh``).
The block kernel's constant operands — the truncated DFT tables — are
split into TF32 high and low halves and laid out in ``mma.sync``
fragment order here, once per grid and mode count (:func:`_block_tables`).
``_block_call`` and ``_head_call`` take the library to launch, so the
tests can run them through the kernels' CPU emulation
(``ops/_build.py::load_emulation``).

The kernels' shared memory bounds the shapes they take; the library
says which it refuses and why (``fno_block_unsupported``,
``fno_head_unsupported``), and :func:`check_kernel_shapes` raises on
those before anything launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check_launch, load_library
from .spectral import (
    _dft_factors, clamp_modes, retained_modes, spectral_conv2d_fft, spectral_conv2d_vjp,
)

# Tiles of csrc/fno_block.cu that the host tables follow; the library's
# fno_block_tiles must give the same before a block launches (_check_tiles).
FWD_ROWS = 8    # kFwdRows: rows of x per group of the forward pass
FWD_MODES = 12  # kFwdModes: modes per forward block
FWD_K = 24      # kFwdK: spectrum rows per forward block
FWD_MT = 3      # kFwdMT: 16-row tiles of the forward H-stage (2 * FWD_K rows)
FWD_NW = 3      # kFwdNW: 8-column tiles of the forward W-stage (2 * FWD_MODES columns)
INV_ROWS = 8    # kInvRows: rows per inverse block

_LANE = np.arange(32)
_G, _T = _LANE // 4, _LANE % 4


def tf32_split(a: np.ndarray):
    """float32 ``a`` as ``(hi, lo)``: ``hi`` is ``a`` rounded to TF32 (10
    mantissa bits, nearest, ties away from zero), ``lo = a - hi`` exactly,
    which the tensor cores read truncated to TF32;
    ``csrc/tf32.cuh::split_tf32`` on the card."""
    a = np.ascontiguousarray(a, np.float32)
    bits = a.view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, a - hi


def _a_fragments(A: np.ndarray) -> np.ndarray:
    """(..., 16 Mt, 8 Kt) → (..., Mt, Kt, 32 lanes, 8): each lane's A
    fragment of ``mma.m16n8k8`` (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
    (g+8, t+4)), high halves then low halves."""
    *lead, M, Kd = A.shape
    A = A.reshape(*lead, M // 16, 16, Kd // 8, 8).swapaxes(-3, -2)
    frag = np.stack([A[..., _G, _T], A[..., _G + 8, _T],
                     A[..., _G, _T + 4], A[..., _G + 8, _T + 4]], -1)
    return np.concatenate(tf32_split(frag), -1)


def _b_fragments(Bm: np.ndarray) -> np.ndarray:
    """(..., 8 Kt, 8 Nt) → (..., Kt, Nt, 32 lanes, 4): each lane's B
    fragment (b0 (t, g), b1 (t+4, g)), high halves then low halves."""
    *lead, Kd, N = Bm.shape
    Bm = Bm.reshape(*lead, Kd // 8, 8, N // 8, 8).swapaxes(-3, -2)
    frag = np.stack([Bm[..., _T, _G], Bm[..., _T + 4, _G]], -1)
    return np.concatenate(tf32_split(frag), -1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _block_matrices(H: int, W: int, m1: int, m2: int):
    """The real matrices the block kernel multiplies by, zero-padded to
    its tiles (float64):

    - ``e1`` (n_kc, ceil(H/8), 48, 16): per chunk of ``FWD_K`` spectrum
      rows and group of 8 rows of x, the forward H-stage's
      ``[[E1r, -E1i], [E1i, E1r]]``: rows are the chunk's real then
      imaginary spectrum rows, columns T's real then imaginary parts of
      the group's rows;
    - ``e2`` (n_mc, 8 ceil(W/8), 24): per chunk of ``FWD_MODES`` modes,
      ``[E2r^T | E2i^T]`` (w × (re/im, mode));
    - ``a1`` (ceil(H/8), 16, 8 ceil(2K/8)): per tile of 8 output rows the
      inverse H-stage's ``[[Ar, -Ai], [Ai, Ar]]`` rows, real parts in
      rows 0-7 and imaginary parts in rows 8-15;
    - ``bw`` (16 ceil(W/16), KZ): ``[Br | -Bi]``, KZ = 2 m2 rounded up to 8.
    """
    E1r, E1i, E2r, E2i, Ar, Ai, Br, Bi = (
        f.astype(np.float64) for f in _dft_factors(H, W, m1, m2))
    K = 2 * m1
    n_kc, n_mc, ng = _ceil(K, FWD_K), _ceil(m2, FWD_MODES), _ceil(H, FWD_ROWS)
    e1r = np.zeros((K, ng * FWD_ROWS))
    e1i = np.zeros_like(e1r)
    e1r[:, :H], e1i[:, :H] = E1r, E1i
    e1 = np.zeros((n_kc, ng, 16 * FWD_MT, 2 * FWD_ROWS))
    for kc in range(n_kc):
        k0 = kc * FWD_K
        kn = min(FWD_K, K - k0)
        r = e1r[k0:k0 + kn].reshape(kn, ng, FWD_ROWS).transpose(1, 0, 2)
        i = e1i[k0:k0 + kn].reshape(kn, ng, FWD_ROWS).transpose(1, 0, 2)
        e1[kc, :, :kn] = np.concatenate([r, -i], -1)
        e1[kc, :, kn:2 * kn] = np.concatenate([i, r], -1)
    e2 = np.zeros((n_mc, 8 * _ceil(W, 8), 8 * FWD_NW))
    for mc in range(n_mc):
        m0 = mc * FWD_MODES
        mn = min(FWD_MODES, m2 - m0)
        e2[mc, :W, :mn] = E2r[m0:m0 + mn].T
        e2[mc, :W, mn:2 * mn] = E2i[m0:m0 + mn].T
    Ac = np.block([[Ar, -Ai], [Ai, Ar]])
    a1 = np.zeros((_ceil(H, INV_ROWS), 16, 8 * _ceil(2 * K, 8)))
    for ht in range(a1.shape[0]):
        hs = np.arange(ht * INV_ROWS, min(H, ht * INV_ROWS + INV_ROWS))
        a1[ht, :len(hs), :2 * K] = Ac[hs]
        a1[ht, 8:8 + len(hs), :2 * K] = Ac[H + hs]
    bw = np.zeros((16 * _ceil(W, 16), 8 * _ceil(2 * m2, 8)))
    bw[:W, :m2], bw[:W, m2:2 * m2] = Br, -Bi
    return e1, e2, a1, bw


@functools.lru_cache(maxsize=None)
def _block_tables(H: int, W: int, m1: int, m2: int):
    """:func:`_block_matrices` in float32, split and in fragment order,
    as ``csrc/fno_block.cu`` reads them: e1f (A), e2f (B), a1f (A), bwf (A)."""
    e1, e2, a1, bw = (m.astype(np.float32) for m in _block_matrices(H, W, m1, m2))
    return tuple(np.ascontiguousarray(f) for f in (
        _a_fragments(e1), _b_fragments(e2), _a_fragments(a1), _a_fragments(bw)))


@functools.lru_cache(maxsize=None)
def _check_tiles(lib) -> None:
    """Raise unless the library's kernel was built for the tiles that
    :func:`_block_matrices` lays the tables out for."""
    got = (ctypes.c_int * 6)()
    lib.fno_block_tiles(got)
    want = (FWD_ROWS, FWD_MODES, FWD_K, FWD_MT, FWD_NW, INV_ROWS)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/fno_block.cu has tiles {tuple(got)} (kFwdRows, kFwdModes, "
                           f"kFwdK, kFwdMT, kFwdNW, kInvRows); ops/fno_kernels.py lays its "
                           f"tables out for {want}")


def _refuse(why, what: str) -> None:
    if why:
        raise ValueError(f"{what}: {why.decode()}; larger shapes are ROADMAP.md B3")


def check_kernel_shapes(H: int, W: int, width: int, modes1: int, modes2: int,
                        hidden: int, n_out: int, lib=None) -> None:
    """Raise ValueError, naming the limit, if the kernels (``lib``, the
    card's by default) cannot take an FNO of this width, these modes and
    this head on an H x W grid."""
    lib = load_library() if lib is None else lib
    _, m2 = clamp_modes(H, W, modes1, modes2)
    _refuse(lib.fno_block_unsupported(W, width, m2),
            f"fno_block at W={W}, width {width}, {m2} modes along W")
    _refuse(lib.fno_head_unsupported(width, hidden, n_out),
            f"fno_head at width {width}, {hidden} hidden units, {n_out} outputs")


def fno_block_reference(x, weights, w0, b0, modes1: int, modes2: int):
    """Plain FnoBlock: ``GELU(spectral_conv(x) + x @ w0ᵀ + b0)``."""
    return F.gelu(
        spectral_conv2d_fft(x, weights, modes1, modes2) + F.linear(x, w0, b0)
    )


def fno_block_saved_reference(x, weights, w0, b0, modes1: int, modes2: int):
    """Plain versions of what the block kernel leaves for the backward:
    ``(xm, pre)``, x's retained modes (B, 2, 2 m1, m2, Ci; real,
    imaginary) and the pre-activation (B, H, W, Co)."""
    m1, m2 = clamp_modes(x.shape[1], x.shape[2], modes1, modes2)
    xm = retained_modes(x, m1, m2)
    pre = spectral_conv2d_fft(x, weights, modes1, modes2) + F.linear(x, w0, b0)
    return torch.stack([xm.real, xm.imag], 1), pre


def fno_head_reference(x, w1, b1, w2, b2, mask):
    """Plain head: ``(GELU(x @ w1ᵀ + b1) @ w2ᵀ + b2) * mask``."""
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2) * mask


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_f32(device: torch.device, **tensors) -> None:
    _check(device.type == "cuda",
           f"kernel wrappers take CPU or CUDA tensors, got {device}")
    for name, t in tensors.items():
        _check(t.device == device, f"{name} is on {t.device}, x on {device}")
        _check(t.dtype == torch.float32, f"{name} is {t.dtype}, not float32")
        _check(t.is_contiguous(), f"{name} is not contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=32)
def _table_tensors(H: int, W: int, m1: int, m2: int, device: torch.device):
    return tuple(torch.from_numpy(f).to(device) for f in _block_tables(H, W, m1, m2))


def _block_call(lib, x, weights, w0, b0, modes1, modes2, stream: int, keep: bool = False):
    """Allocate the block kernel's scratch and output and launch it
    through ``lib`` on ``stream``; the arguments are checked. Returns
    ``(out, xm, pre)``: the output, x's retained modes (B, 2, 2 m1, m2,
    Ci), which the first pass leaves in its scratch, and, with ``keep``,
    the pre-activation (B, H, W, Co), else None."""
    B, H, W, Ci = x.shape
    Co = weights.shape[3]
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    _check_tiles(lib)
    _refuse(lib.fno_block_unsupported(W, Ci, m2), f"fno_block at x {tuple(x.shape)}")
    tables = _table_tensors(H, W, m1, m2, x.device)
    xm = torch.empty((B, 2, 2 * m1, m2, Ci), device=x.device)
    ym = torch.empty((B, 2, 2 * m1, m2, Co), device=x.device)
    z = torch.empty((B, H, 2, m2, Co), device=x.device)
    out = torch.empty((B, H, W, Co), device=x.device)
    pre = torch.empty((B, H, W, Co), device=x.device) if keep else None
    err = lib.fno_block_forward(
        x.data_ptr(), weights.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        *(f.data_ptr() for f in tables),
        xm.data_ptr(), ym.data_ptr(), z.data_ptr(), out.data_ptr(),
        None if pre is None else pre.data_ptr(),
        B, H, W, Ci, Co, modes1, modes2, m1, m2, stream,
    )
    check_launch(lib, err, "fno_block")
    return out, xm, pre


def _head_call(lib, x, w1, b1, w2, b2, mask, stream: int):
    """Allocate the head kernel's output and launch it through ``lib``."""
    B, H, W, C = x.shape
    n_out = w2.shape[0]
    _refuse(lib.fno_head_unsupported(C, w1.shape[0], n_out),
            f"fno_head at x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    out = torch.empty((B, H, W, n_out), device=x.device)
    err = lib.fno_head_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B * H * W, C, w1.shape[0], n_out, stream,
    )
    check_launch(lib, err, "fno_head")
    return out


def fno_block_vjp(grad, x, xm, pre, weights, w0, modes1: int, modes2: int):
    """``(dx, dweights, dw0, db0)``: the FnoBlock's gradient against
    ``grad`` from what its kernel's forward leaves — x's retained modes
    ``xm`` (B, 2, 2 m1, m2, Ci; real, imaginary) and the pre-activation
    ``pre`` (B, H, W, Co). GELU' of ``pre``, the 1x1 bypass's products, and
    the spectral adjoint in ``torch.fft`` (``spectral_conv2d_vjp``)."""
    dy = torch.ops.aten.gelu_backward(grad, pre)
    dx, dweights = spectral_conv2d_vjp(dy, torch.complex(xm[:, 0], xm[:, 1]), weights,
                                       x.shape[2], modes1, modes2)
    flat = dy.reshape(-1, dy.shape[-1])
    return dx + dy @ w0, dweights, flat.T @ x.reshape(-1, x.shape[-1]), flat.sum(0)


class FnoBlockFn(torch.autograd.Function):
    """The block kernel launched through ``lib`` on ``stream``, with its
    gradient: ``apply(lib, stream, keep, x, weights, w0, b0, modes1,
    modes2)``. With ``keep`` (a forward under grad) the kernel also
    writes the pre-activation, and the Function saves it with x and x's
    retained modes for :func:`fno_block_vjp`; nothing is recomputed."""

    @staticmethod
    def forward(ctx, lib, stream, keep, x, weights, w0, b0, modes1, modes2):
        out, xm, pre = _block_call(lib, x, weights, w0, b0, modes1, modes2, stream, keep)
        fno_block.launches += 1
        if keep:
            ctx.save_for_backward(x, xm, pre, weights, w0)
            ctx.modes = (modes1, modes2)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, xm, pre, weights, w0 = ctx.saved_tensors
        grads = fno_block_vjp(grad.contiguous(), x, xm, pre, weights, w0, *ctx.modes)
        needs = ctx.needs_input_grad[3:7]
        return (None, None, None, *(g if n else None for g, n in zip(grads, needs)), None, None)


class FnoHeadFn(torch.autograd.Function):
    """The head kernel launched through ``lib`` on ``stream``, with the
    plain version's gradient: ``apply(lib, stream, x, w1, b1, w2, b2,
    mask)``. Saves x and the weights; the backward recomputes fc1 and
    GELU (the JAX package's ``remat_head``: the two (B, H, W, 128)
    intermediates are the model's largest) and backpropagates through
    fc2 and the mask."""

    @staticmethod
    def forward(ctx, lib, stream, x, w1, b1, w2, b2, mask):
        ctx.save_for_backward(x, w1, b1, w2, b2, mask)
        out = _head_call(lib, x, w1, b1, w2, b2, mask, stream)
        fno_head.launches += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:8]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = fno_head_reference(*inputs)
        wanted = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad.contiguous()))
        return (None, None, *(next(grads) if n else None for n in needs))


def fno_block(x, weights, w0, b0, modes1: int, modes2: int):
    """x (B, H, W, Cin); weights (2, 2, Cin, Cout, modes1, modes2);
    w0 (Cout, Cin); b0 (Cout,) → (B, H, W, Cout). On the card a shape
    whose rows do not fit the kernel's shared memory raises ValueError
    (:func:`check_kernel_shapes`); the result is differentiable
    (:class:`FnoBlockFn`)."""
    if x.device.type == "cpu":
        return fno_block_reference(x, weights, w0, b0, modes1, modes2)
    _check_cuda_f32(x.device, x=x, weights=weights, w0=w0, b0=b0)
    _check(x.dim() == 4 and x.numel() > 0, f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, Ci = x.shape
    _check(
        weights.dim() == 6 and weights.shape[:3] == (2, 2, Ci)
        and weights.shape[4:] == (modes1, modes2),
        f"weights {tuple(weights.shape)} is not (2, 2, {Ci}, Cout, "
        f"{modes1}, {modes2})",
    )
    Co = weights.shape[3]
    _check(tuple(w0.shape) == (Co, Ci) and tuple(b0.shape) == (Co,),
           f"w0 {tuple(w0.shape)} / b0 {tuple(b0.shape)} do not match "
           f"({Co}, {Ci}) / ({Co},)")
    _check(H >= 2 and W >= 2, f"grid {H}x{W} is too small for a spectral conv")
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in (x, weights, w0, b0))
    with torch.cuda.device(x.device):
        return FnoBlockFn.apply(load_library(), _stream(x.device), keep, x, weights, w0, b0,
                                modes1, modes2)


def fno_head(x, w1, b1, w2, b2, mask):
    """x (B, H, W, C); w1 (hidden, C); b1 (hidden,); w2 (out, hidden);
    b2 (out,); mask (B, H, W, 1) → (B, H, W, out), masked; on the card
    differentiable (:class:`FnoHeadFn`)."""
    if x.device.type == "cpu":
        return fno_head_reference(x, w1, b1, w2, b2, mask)
    _check_cuda_f32(x.device, x=x, w1=w1, b1=b1, w2=w2, b2=b2, mask=mask)
    _check(x.dim() == 4 and x.numel() > 0, f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    hidden, n_out = w1.shape[0], w2.shape[0]
    _check(
        tuple(w1.shape) == (hidden, C) and tuple(b1.shape) == (hidden,)
        and tuple(w2.shape) == (n_out, hidden) and tuple(b2.shape) == (n_out,),
        "head weights do not chain: "
        f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
        f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} for C={C}",
    )
    _check(tuple(mask.shape) == (B, H, W, 1),
           f"mask {tuple(mask.shape)} is not ({B}, {H}, {W}, 1)")
    with torch.cuda.device(x.device):
        return FnoHeadFn.apply(load_library(), _stream(x.device), x, w1, b1, w2, b2, mask)


fno_block.launches = 0
fno_head.launches = 0
KERNELS = {"fno_block": fno_block, "fno_head": fno_head}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
