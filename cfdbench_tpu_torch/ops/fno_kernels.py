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
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library
from .spectral import _dft_factors_packed, clamp_modes, spectral_conv2d_fft

# Largest widths the kernels are instantiated for (csrc/fno_head.cu).
HEAD_MAX_IN = 128
HEAD_MAX_OUT = 8


def fno_block_reference(x, weights, w0, b0, modes1: int, modes2: int):
    """Plain FnoBlock: ``GELU(spectral_conv(x) + x @ w0ᵀ + b0)``."""
    return F.gelu(
        spectral_conv2d_fft(x, weights, modes1, modes2) + F.linear(x, w0, b0)
    )


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
def _factor_tensors(H: int, W: int, m1: int, m2: int, device: torch.device):
    return tuple(
        torch.from_numpy(f).to(device)
        for f in _dft_factors_packed(H, W, m1, m2)
    )


def fno_block(x, weights, w0, b0, modes1: int, modes2: int):
    """x (B, H, W, Cin); weights (2, 2, Cin, Cout, modes1, modes2);
    w0 (Cout, Cin); b0 (Cout,) → (B, H, W, Cout)."""
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
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    factors = _factor_tensors(H, W, m1, m2, x.device)
    xm = torch.empty((B, 2 * m1, m2, Ci, 2), device=x.device)
    ym = torch.empty((B, 2 * m1, m2, Co, 2), device=x.device)
    out = torch.empty((B, H, W, Co), device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.fno_block_forward(
            x.data_ptr(), weights.data_ptr(), w0.data_ptr(), b0.data_ptr(),
            *(f.data_ptr() for f in factors),
            xm.data_ptr(), ym.data_ptr(), out.data_ptr(),
            B, H, W, Ci, Co, modes1, modes2, m1, m2, _stream(x.device),
        )
    check_launch(lib, err, "fno_block")
    fno_block.launches += 1
    return out


def fno_head(x, w1, b1, w2, b2, mask):
    """x (B, H, W, C); w1 (hidden, C); b1 (hidden,); w2 (out, hidden);
    b2 (out,); mask (B, H, W, 1) → (B, H, W, out), masked."""
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
    _check(C <= HEAD_MAX_IN and n_out <= HEAD_MAX_OUT,
           f"fno_head kernel takes C <= {HEAD_MAX_IN} and out <= "
           f"{HEAD_MAX_OUT}, got C={C}, out={n_out}")
    out = torch.empty((B, H, W, n_out), device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.fno_head_forward(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B * H * W, C, hidden, n_out, _stream(x.device),
        )
    check_launch(lib, err, "fno_head")
    fno_head.launches += 1
    return out


fno_block.launches = 0
fno_head.launches = 0
KERNELS = {"fno_block": fno_block, "fno_head": fno_head}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
