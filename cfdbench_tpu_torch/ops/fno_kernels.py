"""The FNO's two hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

- :func:`fno_block` — the whole FnoBlock forward (spectral conv + 1×1
  bypass + exact GELU), ``csrc/fno_block.cu``; port of
  ``cfdbench_tpu/ops/pallas_fno.py::fused_fno_block``.
- :func:`fno_head` — fc1 → GELU → fc2 → ×mask, ``csrc/fno_head.cu``;
  port of ``cfdbench_tpu/ops/pallas_fno.py::fused_fno_head``.

A wrapper given CPU tensors computes its plain version
(``fno_block_reference`` / ``fno_head_reference``); given CUDA tensors
it launches its kernel or raises — there is no fallback. Weights are in
``nn.Linear`` layout (``(out, in)``). Each launch from a wrapper's path —
its operator's CUDA kernel or its autograd Function — adds one to
``<wrapper>.launches`` (and, in TF32 mode, to
``<wrapper>.tf32_launches``), so a run can show that it went through the
kernels (:func:`launch_counts`); ``_block_call``/``_head_call``, which
the comparisons call directly, count nothing.

Without a gradient to carry, each wrapper calls its registered operator,
``torch.ops.cfdbench_tpu_torch.fno_block`` / ``fno_head``
(``torch.library.custom_op``): its CUDA kernel launches the hand-written
kernel, its CPU kernel is the plain version, and its fake returns the
output's shape after the argument checks and, for a CUDA tensor, the
library's shape check — so ``torch.export`` keeps both kernels in a
served program as opaque nodes, counts their launches when it runs, and
refuses a shape the kernels refuse when the program is exported
(``utils/export.py``).

Under grad the kernels run inside ``torch.autograd.Function``s
(:class:`FnoBlockFn`, :class:`FnoHeadFn`) on the card, so a forward
carries gradients to every input; on the CPU autograd differentiates
the plain versions. The TPU kernels are forward-only too
(the JAX package trains through XLA's gradient of the plain graph), so
the backwards are PyTorch ops: the block's is its explicit VJP
(:func:`fno_block_vjp`: ``torch.fft`` for the spectral adjoint, plain
products for the bypass) from the pre-activation and x's retained modes,
which the kernel writes under grad; the head's recomputes fc1 and GELU
from the saved x, as the JAX package's ``remat_head`` does, and
differentiates them.

Both kernels multiply on the tensor cores in split TF32 (``csrc/tf32.cuh``),
or, with ``tf32`` (``--matmul_precision high``, which JAX runs as TF32
on an NVIDIA card), in one TF32 product a tile: each operand rounded to
TF32. The mode is an argument of every wrapper, Function and registered
operator, so an exported program carries it; on the CPU it changes
nothing (the plain float32 version runs), as JAX's precision changes
nothing on its CPU backend. Each plain version takes the mode too: in
TF32 mode it rounds every product's operands as the kernel does
(:func:`round_tf32`) and multiplies in float32, so it differs from the
kernel only in the order of its sums (and, for the head, in its GELU's
erf: the kernel computes the TPU kernel's rational erf, within 1.5e-7 of
the exact one). The backwards are PyTorch ops in
either mode, and follow cuBLAS's setting (``utils/device.py::set_numerics``).
The block kernel's constant operands — the truncated DFT tables — are
split into TF32 high and low halves here, once per grid and mode count
(:func:`_block_tables`): in ``mma.sync`` fragment order for the sm_80
route's passes, and as ``wgmma``'s K-major B planes (:func:`_b_planes`)
for the Hopper route's; in TF32 mode the kernels read only the high halves.
The library picks each kernel's route by shape before a launch
(``fno_block_route``, :func:`block_route`, :func:`route_name`;
``fno_head_route``, :func:`head_route`, :func:`head_route_name`, the
CUDA kernels of each in :func:`route_kernels` and
:func:`head_route_kernels`): the Hopper route where the channel counts
are multiples of 4 and its tables fit — the block on ``wgmma`` fed by TMA
through ``mbarrier`` rings, the inverse's row spectra kept on chip; the
head's fc1 on ``wgmma`` fed by TMA, three consumer warpgroups taking
turns on the tensor cores while the others run the GELU and fc2
epilogue, w1 split once a block or, where it does not fit, once a call
into scratch (:func:`_head_plan`) and streamed — and the sm_80 route
(``mma.sync``, ``cp.async``) elsewhere; a failure raises, it never gives
way to the other route.
``_block_call`` and ``_head_call`` take the library to launch, so the
tests can run them through the kernels' CPU emulation
(``ops/_build.py::load_emulation``).

Under spatial sharding (``rows``: the model axis over which x's grid rows
are split, ``parallel/spatial.py``) the block runs on a rank's rows. Its
first pass, the projection onto the retained modes, is a sum over rows:
the host launches it (``fno_block_spectrum_on``), sums the ranks' partial
spectra over the model group, and launches the other passes
(``fno_block_finish``) for the rank's rows, whose tables hold the DFT's
columns and rows for them (:func:`_block_matrices`). The two halves count
as one ``fno_block`` launch. The backward keeps the same split
(:func:`fno_block_vjp`). The head is per pixel and runs on the rank's
rows unchanged.

The kernels take every positive size: where the Hopper route's tables do
not fit, the sm_80 route runs; where its tables and whole rows do not fit
a block's shared memory, its inverse-columns pass runs tiled over the
columns and its K, and the head streams fc1 over the channels
(``csrc/*.cu``). The library says what it refuses and why
(``fno_block_unsupported``, ``fno_head_unsupported``: a size that is not
positive), and :func:`check_kernel_shapes` raises on that before
anything launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spatial import active, row_span, row_sum_
from ..utils.device import float32_products
from . import promote
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
HOP_ROWS = 8    # kHopRows: output rows per item of the Hopper route's inverse
HOP_W = 64      # kHopW: columns per tile of the Hopper route's inverse
SPEC_ROWS = 8   # kSpecRows: rows per group of the Hopper route's pass 1
SPEC_MODES = 12  # kSpecModes: modes each way the Hopper route's pass 1 takes at most

# fno_block_route's bits: which passes run on the Hopper route at a shape.
ROUTE_FINISH, ROUTE_SPECTRUM = 1, 2
# fno_head_route's bits: the Hopper route; w1 streamed rather than resident.
HEAD_HOPPER, HEAD_STREAMED = 1, 2


def route_kernels(route: int) -> tuple:
    """The CUDA kernels (by name) that one block call launches on ``route``."""
    spectrum = ("dft_forward_hopper_kernel" if route & ROUTE_SPECTRUM
                else "dft_forward_kernel",)
    finish = (("mode_mix_hopper_kernel", "inverse_hopper_kernel") if route & ROUTE_FINISH
              else ("mode_mix_kernel", "inverse_rows_kernel", "inverse_cols_kernel"))
    return spectrum + finish


def route_name(route: int) -> str:
    """``fno_block_route``'s answer in words."""
    spectrum = ("pass 1 on wgmma and TMA" if route & ROUTE_SPECTRUM
                else "pass 1 on mma.sync and cp.async")
    finish = ("pass 2 and the fused inverse on wgmma and TMA" if route & ROUTE_FINISH
              else "passes 2-4 on mma.sync and cp.async")
    return f"route {route}: {spectrum}; {finish}"

def head_route_kernels(route: int) -> tuple:
    """The CUDA kernels (by name) that one head launch group runs on
    ``route`` (:func:`head_route`)."""
    if route & HEAD_HOPPER:
        return (("fno_head_split_kernel", "fno_head_hopper_kernel") if route & HEAD_STREAMED
                else ("fno_head_hopper_kernel",))
    return ("fno_head_streamed_kernel",) if route & HEAD_STREAMED else ("fno_head_kernel",)


def head_route_name(route: int) -> str:
    """``fno_head_route``'s answer in words."""
    if route & HEAD_HOPPER:
        w1 = ("w1 split once a call and streamed beside x" if route & HEAD_STREAMED
              else "w1 split once a block")
        return f"route {route}: fc1 on wgmma fed by TMA, ping-pong epilogue; {w1}"
    w1 = "w1 streamed over the channels" if route & HEAD_STREAMED else "w1 resident"
    return f"route {route}: fc1 on mma.sync and cp.async; {w1}"


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


def products(tf32: bool) -> int:
    """The TF32 products a tile of the kernels runs: 1 in TF32 mode, 3
    (split TF32) otherwise; ``csrc/tf32.cuh::mma_tf32x``."""
    return 1 if tf32 else 3


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 as ``csrc/tf32.cuh::tf32_bits`` rounds
    an operand (10 mantissa bits, nearest, ties away from zero, the low 13
    bits zero), in float32: :func:`tf32_split`'s high part."""
    _check(t.dtype == torch.float32, f"round_tf32 takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


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
def _block_matrices(H: int, W: int, m1: int, m2: int, r0: int = 0, h: int = None):
    """The real matrices the block kernel multiplies by, for the rows
    ``[r0, r0 + h)`` (all H by default) of an H x W grid, zero-padded to
    its tiles (float64):

    - ``e1`` (n_kc, ceil(h/8), 48, 16): per chunk of ``FWD_K`` spectrum
      rows and group of 8 rows of x, the forward H-stage's
      ``[[E1r, -E1i], [E1i, E1r]]``: rows are the chunk's real then
      imaginary spectrum rows, columns T's real then imaginary parts of
      the group's rows (E1's columns r0 .. r0 + h - 1);
    - ``e2`` (n_mc, 8 ceil(W/8), 24): per chunk of ``FWD_MODES`` modes,
      ``[E2r^T | E2i^T]`` (w × (re/im, mode));
    - ``a1`` (ceil(h/8), 16, 8 ceil(2K/8)): per tile of 8 output rows the
      inverse H-stage's ``[[Ar, -Ai], [Ai, Ar]]`` rows (A's rows r0 ..
      r0 + h - 1), real parts in rows 0-7 and imaginary parts in rows 8-15;
    - ``bw`` (64 ceil(W/64), KZ): ``[Br | -Bi]``, KZ = 2 m2 rounded up to 8;
      in fragment order its 16-row tiles lead, so the inverse-columns
      pass finds a 64-column tile's fragments, and a chunk of its K in
      each, at fixed strides, resident or tiled (the Hopper route's
      inverse reads a tile's four as one warpgroup's A).
    """
    h = H - r0 if h is None else h
    E1r, E1i, E2r, E2i, Ar, Ai, Br, Bi = (
        f.astype(np.float64) for f in _dft_factors(H, W, m1, m2))
    K = 2 * m1
    n_kc, n_mc, ng = _ceil(K, FWD_K), _ceil(m2, FWD_MODES), _ceil(h, FWD_ROWS)
    e1r = np.zeros((K, ng * FWD_ROWS))
    e1i = np.zeros_like(e1r)
    e1r[:, :h], e1i[:, :h] = E1r[:, r0:r0 + h], E1i[:, r0:r0 + h]
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
    a1 = np.zeros((_ceil(h, INV_ROWS), 16, 8 * _ceil(2 * K, 8)))
    for ht in range(a1.shape[0]):
        hs = r0 + np.arange(ht * INV_ROWS, min(h, ht * INV_ROWS + INV_ROWS))
        a1[ht, :len(hs), :2 * K] = Ac[hs]
        a1[ht, 8:8 + len(hs), :2 * K] = Ac[H + hs]
    bw = np.zeros((HOP_W * _ceil(W, HOP_W), 8 * _ceil(2 * m2, 8)))
    bw[:W, :m2], bw[:W, m2:2 * m2] = Br, -Bi
    return e1, e2, a1, bw


@functools.lru_cache(maxsize=None)
def _hopper_matrix(H: int, W: int, m1: int, m2: int, r0: int = 0, h: int = None):
    """``a1h`` (ceil(h/8), 16, KY), the Hopper route's inverse H-stage per
    item of ``HOP_ROWS`` output rows (float64): row ``8 ri + r`` is row
    ``ri H + r0 + 8 rt + r`` of ``[[Ar, -Ai], [Ai, Ar]]`` (ri 0 the real
    part, 1 the imaginary), zero past the ``h`` rows; KY = 2 K rounded up
    to 16 (pairs of k-steps), zero past 2 K."""
    h = H - r0 if h is None else h
    _, _, _, _, Ar, Ai, _, _ = (f.astype(np.float64) for f in _dft_factors(H, W, m1, m2))
    K = 2 * m1
    Ac = np.block([[Ar, -Ai], [Ai, Ar]])
    a1h = np.zeros((_ceil(h, HOP_ROWS), 2 * HOP_ROWS, 16 * _ceil(2 * K, 16)))
    for rt in range(a1h.shape[0]):
        hs = r0 + np.arange(rt * HOP_ROWS, min(h, rt * HOP_ROWS + HOP_ROWS))
        a1h[rt, :len(hs), :2 * K] = Ac[hs]
        a1h[rt, HOP_ROWS:HOP_ROWS + len(hs), :2 * K] = Ac[H + hs]
    return a1h


def _b_planes(Bm: np.ndarray) -> np.ndarray:
    """(..., N, Kd) → (..., 2, Kd/4, N, 4): a K-major B operand of
    ``wgmma`` in the layout ``csrc/hopper.cuh`` describes (core matrices of
    8 rows by 4 floats; element (n, k) at (k/4, n, k%4)), its high half
    then its low half (:func:`tf32_split`)."""
    *lead, N, Kd = Bm.shape
    planes = np.stack(tf32_split(Bm), -3)
    return planes.reshape(*lead, 2, N, Kd // 4, 4).swapaxes(-3, -2)


@functools.lru_cache(maxsize=None)
def _spectrum_matrices(H: int, W: int, m1: int, m2: int, r0: int = 0, h: int = None):
    """The Hopper route's pass-1 matrices for the rows ``[r0, r0 + h)``
    (float64), at most ``SPEC_MODES`` modes each way:

    - ``e1h`` (ceil(h/8), 48, 16): per group of ``SPEC_ROWS`` rows, the
      H-stage's ``[[E1r, -E1i], [E1i, E1r]]``: row ``24 ri + k`` (ri 0 the
      real part; zero past 2 m1), column ``8 ri' + r`` (T's real then
      imaginary parts of the group's row r; zero past the h rows);
    - ``e2h`` (24, 64 ceil(W/64)): the W-stage's ``[E2r; E2i]``: row ``12
      ri' + m`` (zero past m2), column w (zero past W).
    """
    h = H - r0 if h is None else h
    E1r, E1i, E2r, E2i = (f.astype(np.float64) for f in _dft_factors(H, W, m1, m2)[:4])
    K, n_k = 2 * m1, 2 * SPEC_MODES
    e1h = np.zeros((_ceil(h, SPEC_ROWS), 2 * n_k, 2 * SPEC_ROWS))
    for gi in range(e1h.shape[0]):
        hs = r0 + np.arange(gi * SPEC_ROWS, min(h, gi * SPEC_ROWS + SPEC_ROWS))
        n = len(hs)
        e1h[gi, :K, :n], e1h[gi, :K, SPEC_ROWS:SPEC_ROWS + n] = E1r[:, hs], -E1i[:, hs]
        e1h[gi, n_k:n_k + K, :n] = E1i[:, hs]
        e1h[gi, n_k:n_k + K, SPEC_ROWS:SPEC_ROWS + n] = E1r[:, hs]
    e2h = np.zeros((2 * SPEC_MODES, HOP_W * _ceil(W, HOP_W)))
    e2h[:m2, :W], e2h[SPEC_MODES:SPEC_MODES + m2, :W] = E2r, E2i
    return e1h, e2h


@functools.lru_cache(maxsize=None)
def _block_tables(H: int, W: int, m1: int, m2: int, r0: int = 0, h: int = None):
    """:func:`_block_matrices` in float32, split and in fragment order,
    as ``csrc/fno_block.cu`` reads them: e1f (A), e2f (B), a1f (A), bwf (A);
    then the Hopper route's a1h (:func:`_hopper_matrix`) and, at most
    ``SPEC_MODES`` modes each way, e1h and e2h (:func:`_spectrum_matrices`),
    else empty, as ``wgmma``'s B planes (:func:`_b_planes`)."""
    e1, e2, a1, bw = (m.astype(np.float32) for m in _block_matrices(H, W, m1, m2, r0, h))
    a1h = _hopper_matrix(H, W, m1, m2, r0, h).astype(np.float32)
    spec = (_spectrum_matrices(H, W, m1, m2, r0, h) if max(m1, m2) <= SPEC_MODES
            else (np.zeros((0, 8)), np.zeros((0, 8))))
    e1h, e2h = (_b_planes(m.astype(np.float32)) for m in spec)
    return tuple(np.ascontiguousarray(f) for f in (
        _a_fragments(e1), _b_fragments(e2), _a_fragments(a1), _a_fragments(bw), _b_planes(a1h),
        e1h, e2h))


@functools.lru_cache(maxsize=None)
def _check_tiles(lib) -> None:
    """Raise unless the library's kernel was built for the tiles that
    :func:`_block_matrices` lays the tables out for."""
    got = (ctypes.c_int * 10)()
    lib.fno_block_tiles(got)
    want = (FWD_ROWS, FWD_MODES, FWD_K, FWD_MT, FWD_NW, INV_ROWS, HOP_ROWS, HOP_W, SPEC_ROWS,
            SPEC_MODES)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/fno_block.cu has tiles {tuple(got)} (kFwdRows, kFwdModes, "
                           f"kFwdK, kFwdMT, kFwdNW, kInvRows, kHopRows, kHopW, kSpecRows, "
                           f"kSpecModes); ops/fno_kernels.py lays its tables out for {want}")


def _refuse(why, what: str) -> None:
    if why:
        raise ValueError(f"{what}: {why.decode()}")


def _check_block_shape(lib, W: int, width: int, m2: int) -> None:
    _refuse(lib.fno_block_unsupported(W, width, m2),
            f"fno_block at W={W}, width {width}, {m2} modes along W")


def _check_head_shape(lib, width: int, hidden: int, n_out: int) -> None:
    _refuse(lib.fno_head_unsupported(width, hidden, n_out),
            f"fno_head at width {width}, {hidden} hidden units, {n_out} outputs")


@functools.lru_cache(maxsize=64)
def block_route(lib, H: int, W: int, Ci: int, Co: int, modes1: int, modes2: int) -> int:
    """The routes the block kernel takes for a grid of H x W (the whole
    grid's H) with Ci input and Co output channels and these modes, from
    the library, by the shape alone: ``ROUTE_FINISH`` set, passes 2-4 on
    the Hopper route; ``ROUTE_SPECTRUM`` set, pass 1 (:func:`route_name`).
    Raises on a shape no route takes."""
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    route = lib.fno_block_route(W, Ci, Co, m1, m2)
    _check(route >= 0, f"fno_block takes no route at W={W}, {Ci} -> {Co} channels, "
                       f"{m1}x{m2} modes")
    return route


@functools.lru_cache(maxsize=64)
def head_route(lib, C: int, hidden: int, n_out: int) -> int:
    """The route the head kernel takes at C channels, ``hidden`` hidden
    units and ``n_out`` outputs, from the library, by the shape alone:
    ``HEAD_HOPPER`` set, the Hopper route; ``HEAD_STREAMED`` set, w1
    streamed (:func:`head_route_name`). Raises on widths no route takes."""
    route = lib.fno_head_route(C, hidden, n_out)
    _check(route >= 0, f"fno_head takes no route at C={C}, {hidden} hidden units, "
                       f"{n_out} outputs")
    return route


def check_kernel_shapes(H: int, W: int, width: int, modes1: int, modes2: int,
                        hidden: int, n_out: int, lib=None) -> None:
    """Raise ValueError, naming the size, if the kernels (``lib``, the
    card's by default) cannot take an FNO of this width, these modes and
    this head on an H x W grid: only a size that is not positive."""
    lib = load_library() if lib is None else lib
    _check_block_shape(lib, W, width, clamp_modes(H, W, modes1, modes2)[1])
    _check_head_shape(lib, width, hidden, n_out)


def kernel_library(device: torch.device):
    """The library whose kernels run on ``device``: the card's for a CUDA
    device; None for the CPU, where the plain versions take any shape."""
    return load_library() if device.type == "cuda" else None


def fno_block_reference(x, weights, w0, b0, modes1: int, modes2: int, rows=None,
                        tf32: bool = False):
    """Plain FnoBlock: ``GELU(spectral_conv(x) + x @ w0ᵀ + b0)``, in the
    common dtype of x and the weights (bfloat16 in the JAX package's
    bfloat16 numerics; the kernels take float32 only); with ``rows``, on a
    rank's rows of the grid (``spectral_conv2d_fft``). With ``tf32``
    (float32 only) the kernel's TF32 mode: :func:`_block_tf32`."""
    if tf32:
        return F.gelu(_block_tf32(x, weights, w0, b0, modes1, modes2, rows)[1])
    return F.gelu(
        spectral_conv2d_fft(x, weights, modes1, modes2, rows)
        + F.linear(*promote(x, w0, b0))
    )


def _block_tf32(x, weights, w0, b0, modes1: int, modes2: int, rows=None):
    """The block kernel's TF32 mode in plain ops: ``(xm, pre)``, x's
    retained modes (summed over the model ranks with ``rows``) and the
    pre-activation. The kernel's products on the same tables
    (``_dft_factors``), each operand rounded to TF32 (:func:`round_tf32`)
    and multiplied in float32: the truncated DFT along W, then along H
    (its input rounded again), the per-mode mixing in float32, the inverse
    along H, then along W with the 1x1 bypass and the bias."""
    _check(x.dtype == torch.float32, f"the TF32 block takes float32, got {x.dtype}")
    B, h, W, Ci = x.shape
    r0, H = row_span(h, rows) if active(rows) else (0, h)
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    e1r, e1i, e2r, e2i, ar, ai, br, bi = (
        round_tf32(torch.from_numpy(f).to(x.device)) for f in _dft_factors(H, W, m1, m2))
    e1r, e1i, ar, ai = e1r[:, r0:r0 + h], e1i[:, r0:r0 + h], ar[r0:r0 + h], ai[r0:r0 + h]
    wk = torch.cat([weights[0, ..., :m1, :m2], weights[1, ..., :m1, :m2]], -2)
    with float32_products():
        xt = round_tf32(x)
        tr, ti = (round_tf32(torch.einsum("bhwc,mw->bhmc", xt, e)) for e in (e2r, e2i))
        xr = torch.einsum("kh,bhmc->bkmc", e1r, tr) - torch.einsum("kh,bhmc->bkmc", e1i, ti)
        xi = torch.einsum("kh,bhmc->bkmc", e1i, tr) + torch.einsum("kh,bhmc->bkmc", e1r, ti)
        xm = row_sum_(torch.stack([xr, xi], 1), rows)
        xr, xi = xm[:, 0], xm[:, 1]
        mix, rows_inv, cols_inv = "bkmi,iokm->bkmo", "hk,bkmo->bhmo", "wm,bhmo->bhwo"
        yr = round_tf32(torch.einsum(mix, xr, wk[0]) - torch.einsum(mix, xi, wk[1]))
        yi = round_tf32(torch.einsum(mix, xr, wk[1]) + torch.einsum(mix, xi, wk[0]))
        zr = round_tf32(torch.einsum(rows_inv, ar, yr) - torch.einsum(rows_inv, ai, yi))
        zi = round_tf32(torch.einsum(rows_inv, ai, yr) + torch.einsum(rows_inv, ar, yi))
        pre = (torch.einsum(cols_inv, br, zr) - torch.einsum(cols_inv, bi, zi)
               + F.linear(xt, round_tf32(w0)) + b0)
    return xm, pre


def fno_block_saved_reference(x, weights, w0, b0, modes1: int, modes2: int,
                              tf32: bool = False):
    """Plain versions of what the block kernel leaves for the backward:
    ``(xm, pre)``, x's retained modes (B, 2, 2 m1, m2, Ci; real,
    imaginary) and the pre-activation (B, H, W, Co); with ``tf32``, its
    TF32 mode's (:func:`_block_tf32`)."""
    if tf32:
        return _block_tf32(x, weights, w0, b0, modes1, modes2)
    m1, m2 = clamp_modes(x.shape[1], x.shape[2], modes1, modes2)
    xm = retained_modes(x, m1, m2)
    pre = spectral_conv2d_fft(x, weights, modes1, modes2) + F.linear(x, w0, b0)
    return torch.stack([xm.real, xm.imag], 1), pre


def fno_head_reference(x, w1, b1, w2, b2, mask, tf32: bool = False):
    """Plain head: ``(GELU(x @ w1ᵀ + b1) @ w2ᵀ + b2) * mask``, in the
    common dtype of its operands. With ``tf32`` (float32 only) the
    kernel's TF32 mode: fc1's operands rounded to TF32 (:func:`round_tf32`),
    every product in float32."""
    if tf32:
        with float32_products():
            h = F.gelu(F.linear(round_tf32(x), round_tf32(w1), b1))
            return F.linear(h, w2, b2) * mask
    h = F.gelu(F.linear(*promote(x, w1, b1)))
    return F.linear(*promote(h, w2, b2)) * mask


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# The argument checks below build their messages only on a failure: they
# run on every launch, and formatting them took tens of microseconds of a
# call's host time.
def _check_cuda_f32(device: torch.device, **tensors) -> None:
    if device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=32)
def _table_tensors(H: int, W: int, m1: int, m2: int, r0: int, h: int, device: torch.device):
    return tuple(torch.from_numpy(f).to(device) for f in _block_tables(H, W, m1, m2, r0, h))


def _block_plan(lib, x, modes1, modes2, span):
    """``(m1, m2, tables)`` of a block launch on x's rows, which are
    the rows ``[r0, r0 + h)`` of an H-row grid (``span`` (r0, H); the
    whole grid when None); the library's tiles and shape limits checked."""
    B, h, W, Ci = x.shape
    r0, H = (0, h) if span is None else span
    return _shape_plan(lib, H, W, Ci, modes1, modes2, r0, h, x.device)


@functools.lru_cache(maxsize=64)
def _shape_plan(lib, H: int, W: int, Ci: int, modes1: int, modes2: int, r0: int, h: int,
                device: torch.device):
    """:func:`_block_plan` for one shape, kept: a launch's host time is part
    of every rollout step's (a refusal raises and is not kept)."""
    m1, m2 = clamp_modes(H, W, modes1, modes2)
    _check_tiles(lib)
    _refuse(lib.fno_block_unsupported(W, Ci, m2), f"fno_block at x (B, {h}, {W}, {Ci})")
    return m1, m2, _table_tensors(H, W, m1, m2, r0, h, device)


def _block_spectrum(lib, x, modes1, modes2, stream: int, span=None, tf32: bool = False,
                    route=None):
    """The block kernel's first pass on x's rows (``span``:
    :func:`_block_plan`): their share of the retained modes, (B, 2, 2 m1,
    m2, Ci), real then imaginary parts; in TF32 mode with ``tf32``.
    ``route``: the shape's (:func:`block_route`) unless given (without
    ``ROUTE_SPECTRUM`` the old pass at any shape, to time both routes)."""
    B, h, W, Ci = x.shape
    m1, m2, tables = _block_plan(lib, x, modes1, modes2, span)
    H = h if span is None else span[1]
    route = block_route(lib, H, W, Ci, Ci, modes1, modes2) if route is None else route
    hopper = bool(route & ROUTE_SPECTRUM)
    if hopper:
        _check_aligned(x)
    e1, e2 = (tables[5], tables[6]) if hopper else (tables[0], tables[1])
    xm = torch.empty((B, 2, 2 * m1, m2, Ci), device=x.device)
    err = lib.fno_block_spectrum_on(x.data_ptr(), e1.data_ptr(), e2.data_ptr(), xm.data_ptr(),
                                    B, h, W, Ci, m1, m2, products(tf32), int(hopper), stream)
    check_launch(lib, err, "fno_block (spectrum)")
    return xm


def _check_aligned(x) -> None:
    if x.data_ptr() % 16:
        raise ValueError("the kernels' Hopper routes read x by TMA from a 16-byte aligned "
                         f"address, got {x.data_ptr():#x}")


def _block_finish(lib, x, xm, weights, w0, b0, modes1, modes2, stream: int,
                  keep: bool = False, span=None, tf32: bool = False, route=None):
    """The block kernel's passes 2-4 for x's rows from the whole retained
    spectrum ``xm``: ``(out, pre)``, the output and, with ``keep``, the
    pre-activation (B, h, W, Co), else None; in TF32 mode with ``tf32``.
    ``route``: the shape's (:func:`block_route`) unless given (without
    ``ROUTE_FINISH`` the old passes at any shape, to time both routes)."""
    B, h, W, Ci = x.shape
    Co = weights.shape[3]
    m1, m2, tables = _block_plan(lib, x, modes1, modes2, span)
    H = h if span is None else span[1]
    route = block_route(lib, H, W, Ci, Co, modes1, modes2) if route is None else route
    hopper = bool(route & ROUTE_FINISH)
    if hopper:
        _check_aligned(x)
        ym = torch.empty((B, _ceil(Co, 32), _ceil(m2, 2), 16 * _ceil(4 * m1, 16), 64),
                         device=x.device)
        z = None
    else:
        ym = torch.empty((B, 2, 2 * m1, m2, Co), device=x.device)
        z = torch.empty((B, h, 2, m2, Co), device=x.device)
    out = torch.empty((B, h, W, Co), device=x.device)
    pre = torch.empty((B, h, W, Co), device=x.device) if keep else None
    err = lib.fno_block_finish(
        x.data_ptr(), xm.data_ptr(), weights.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        tables[2].data_ptr(), tables[3].data_ptr(), tables[4].data_ptr(), ym.data_ptr(),
        None if z is None else z.data_ptr(), out.data_ptr(),
        None if pre is None else pre.data_ptr(),
        B, h, W, Ci, Co, modes1, modes2, m1, m2, products(tf32), int(hopper), stream,
    )
    check_launch(lib, err, "fno_block")
    return out, pre


def _block_call(lib, x, weights, w0, b0, modes1, modes2, stream: int, keep: bool = False,
                rows=None, tf32: bool = False, route=None):
    """Allocate the block kernel's scratch and output and launch it
    through ``lib`` on ``stream``; the arguments are checked. Returns
    ``(out, xm, pre)``: the output, x's retained modes (B, 2, 2 m1, m2,
    Ci), which the first pass leaves in its scratch, and, with ``keep``,
    the pre-activation (B, H, W, Co), else None. With ``rows`` (spatial
    sharding) x is this rank's rows: the first pass's partial modes are
    summed over the model ranks before the other passes run for its rows,
    and ``xm`` is the sum. ``tf32``: the kernel's TF32 mode; ``route``: as
    for :func:`_block_finish`."""
    span = row_span(x.shape[1], rows) if active(rows) else None
    xm = row_sum_(_block_spectrum(lib, x, modes1, modes2, stream, span, tf32, route), rows)
    out, pre = _block_finish(lib, x, xm, weights, w0, b0, modes1, modes2, stream, keep, span,
                             tf32, route)
    return out, xm, pre


@functools.lru_cache(maxsize=64)
def _head_plan(lib, C: int, hidden: int, n_out: int, route=None):
    """``(route, scratch)`` of a head launch at these widths, kept: the
    route (:func:`head_route` unless given; 0 runs the ``mma.sync`` route
    at any shape, to time both) and the floats of scratch it needs (the
    streamed Hopper route's split w1 planes). A launch's host time is part
    of every rollout step's (a refusal raises and is not kept)."""
    _refuse(lib.fno_head_unsupported(C, hidden, n_out),
            f"fno_head at C={C}, {hidden} hidden units, {n_out} outputs")
    route = head_route(lib, C, hidden, n_out) if route is None else route
    return route, lib.fno_head_scratch(C, hidden, route & HEAD_HOPPER)


def _head_call(lib, x, w1, b1, w2, b2, mask, stream: int, tf32: bool = False, route=None):
    """Allocate the head kernel's output (and scratch) and launch it
    through ``lib``, in TF32 mode with ``tf32``; ``route``: as for
    :func:`_head_plan`."""
    B, H, W, C = x.shape
    n_out = w2.shape[0]
    route, scratch = _head_plan(lib, C, w1.shape[0], n_out, route)
    hopper = route & HEAD_HOPPER
    if hopper:
        _check_aligned(x)
    planes = torch.empty(scratch, device=x.device) if scratch else None
    out = torch.empty((B, H, W, n_out), device=x.device)
    err = lib.fno_head_forward_on(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if planes is None else planes.data_ptr(),
        B * H * W, C, w1.shape[0], n_out, products(tf32), hopper, stream,
    )
    check_launch(lib, err, "fno_head")
    return out


def fno_block_vjp(grad, x, xm, pre, weights, w0, modes1: int, modes2: int, rows=None):
    """``(dx, dweights, dw0, db0)``: the FnoBlock's gradient against
    ``grad`` from what its kernel's forward leaves — x's retained modes
    ``xm`` (B, 2, 2 m1, m2, Ci; real, imaginary) and the pre-activation
    ``pre`` (B, H, W, Co). GELU' of ``pre``, the 1x1 bypass's products, and
    the spectral adjoint in ``torch.fft`` (``spectral_conv2d_vjp``). With
    ``rows`` (spatial sharding; ``xm`` the summed modes) the weights'
    gradients are this rank's partials, of its rows, and the gradient of
    the retained modes is summed over the model ranks before it reaches
    the rank's rows of x."""
    dy = torch.ops.aten.gelu_backward(grad, pre)
    dx, dweights = spectral_conv2d_vjp(dy, torch.complex(xm[:, 0], xm[:, 1]), weights,
                                       x.shape[2], modes1, modes2, rows)
    flat = dy.reshape(-1, dy.shape[-1])
    return dx + dy @ w0, dweights, flat.T @ x.reshape(-1, x.shape[-1]), flat.sum(0)


class FnoBlockFn(torch.autograd.Function):
    """The block kernel launched through ``lib`` on ``stream``, with its
    gradient: ``apply(lib, stream, keep, x, weights, w0, b0, modes1,
    modes2, rows, tf32)``, in TF32 mode with ``tf32``. With ``keep`` (a
    forward under grad) the kernel also writes the pre-activation, and the
    Function saves it with x and x's retained modes (under spatial
    sharding, ``rows``, the summed ones) for :func:`fno_block_vjp`;
    nothing is recomputed."""

    @staticmethod
    def forward(ctx, lib, stream, keep, x, weights, w0, b0, modes1, modes2, rows=None,
                tf32=False):
        out, xm, pre = _block_call(lib, x, weights, w0, b0, modes1, modes2, stream, keep, rows,
                                   tf32)
        _count(fno_block, tf32)
        if keep:
            ctx.save_for_backward(x, xm, pre, weights, w0)
            ctx.modes, ctx.rows = (modes1, modes2), rows
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, xm, pre, weights, w0 = ctx.saved_tensors
        grads = fno_block_vjp(grad.contiguous(), x, xm, pre, weights, w0, *ctx.modes,
                              rows=ctx.rows)
        needs = ctx.needs_input_grad[3:7]
        return (None, None, None, *(g if n else None for g, n in zip(grads, needs)),
                None, None, None, None)


class FnoHeadFn(torch.autograd.Function):
    """The head kernel launched through ``lib`` on ``stream``, with the
    plain version's gradient: ``apply(lib, stream, x, w1, b1, w2, b2,
    mask, tf32)``, in TF32 mode with ``tf32``. Saves x and the weights;
    the backward recomputes fc1 and GELU (the JAX package's
    ``remat_head``: the two (B, H, W, 128) intermediates are the model's
    largest) and backpropagates through fc2 and the mask."""

    @staticmethod
    def forward(ctx, lib, stream, x, w1, b1, w2, b2, mask, tf32=False):
        ctx.save_for_backward(x, w1, b1, w2, b2, mask)
        out = _head_call(lib, x, w1, b1, w2, b2, mask, stream, tf32)
        _count(fno_head, tf32)
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
        return (None, None, *(next(grads) if n else None for n in needs), None)


def _check_block_args(x, weights, w0, b0, modes1: int, modes2: int) -> None:
    if not (x.dim() == 4 and x.numel() > 0):
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, Ci = x.shape
    if not (weights.dim() == 6 and weights.shape[:3] == (2, 2, Ci)
            and weights.shape[4:] == (modes1, modes2)):
        raise ValueError(f"weights {tuple(weights.shape)} is not (2, 2, {Ci}, Cout, "
                         f"{modes1}, {modes2})")
    Co = weights.shape[3]
    if not (w0.shape == (Co, Ci) and b0.shape == (Co,)):
        raise ValueError(f"w0 {tuple(w0.shape)} / b0 {tuple(b0.shape)} do not match "
                         f"({Co}, {Ci}) / ({Co},)")
    if not (H >= 2 and W >= 2):
        raise ValueError(f"grid {H}x{W} is too small for a spectral conv")


def _check_head_args(x, w1, b1, w2, b2, mask) -> None:
    if not (x.dim() == 4 and x.numel() > 0):
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    hidden, n_out = w1.shape[0], w2.shape[0]
    if not (w1.shape == (hidden, C) and b1.shape == (hidden,)
            and w2.shape == (n_out, hidden) and b2.shape == (n_out,)):
        raise ValueError("head weights do not chain: "
                         f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} for C={C}")
    if mask.shape != (B, H, W, 1):
        raise ValueError(f"mask {tuple(mask.shape)} is not ({B}, {H}, {W}, 1)")


@torch.library.custom_op("cfdbench_tpu_torch::fno_block", mutates_args=(), device_types="cuda")
def fno_block_op(x: torch.Tensor, weights: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                 modes1: int, modes2: int, tf32: bool = False) -> torch.Tensor:
    """The block kernel on the current stream of x's card, in TF32 mode
    with ``tf32``."""
    _check_cuda_f32(x.device, x=x, weights=weights, w0=w0, b0=b0)
    _check_block_args(x, weights, w0, b0, modes1, modes2)
    with torch.cuda.device(x.device):
        out = _block_call(load_library(), x, weights, w0, b0, modes1, modes2,
                          _stream(x.device), tf32=tf32)[0]
    _count(fno_block, tf32)
    return out


@fno_block_op.register_kernel("cpu")
def _(x, weights, w0, b0, modes1, modes2, tf32=False):
    # The float32 plain version in either mode (the mode is the card's).
    # Contiguous, as the kernel writes it (the inverse FFT leaves its
    # channels outermost).
    return fno_block_reference(x, weights, w0, b0, modes1, modes2).contiguous()


@fno_block_op.register_fake
def _(x, weights, w0, b0, modes1, modes2, tf32=False):
    _check_block_args(x, weights, w0, b0, modes1, modes2)
    if x.device.type == "cuda":
        _check_cuda_f32(x.device, x=x, weights=weights, w0=w0, b0=b0)
    lib = kernel_library(x.device)
    if lib is not None:
        _check_block_shape(lib, x.shape[2], x.shape[3],
                           clamp_modes(x.shape[1], x.shape[2], modes1, modes2)[1])
    return x.new_empty((*x.shape[:3], weights.shape[3]))


@torch.library.custom_op("cfdbench_tpu_torch::fno_head", mutates_args=(), device_types="cuda")
def fno_head_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, mask: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The head kernel on the current stream of x's card, in TF32 mode
    with ``tf32``."""
    _check_cuda_f32(x.device, x=x, w1=w1, b1=b1, w2=w2, b2=b2, mask=mask)
    _check_head_args(x, w1, b1, w2, b2, mask)
    with torch.cuda.device(x.device):
        out = _head_call(load_library(), x, w1, b1, w2, b2, mask, _stream(x.device), tf32)
    _count(fno_head, tf32)
    return out


@fno_head_op.register_kernel("cpu")
def _(x, w1, b1, w2, b2, mask, tf32=False):
    return fno_head_reference(x, w1, b1, w2, b2, mask)  # float32 in either mode


@fno_head_op.register_fake
def _(x, w1, b1, w2, b2, mask, tf32=False):
    _check_head_args(x, w1, b1, w2, b2, mask)
    if x.device.type == "cuda":
        _check_cuda_f32(x.device, x=x, w1=w1, b1=b1, w2=w2, b2=b2, mask=mask)
    lib = kernel_library(x.device)
    if lib is not None:
        _check_head_shape(lib, x.shape[3], w1.shape[0], w2.shape[0])
    return x.new_empty((*x.shape[:3], w2.shape[0]))


def _wants_grad(x, *tensors) -> bool:
    """Whether a call must carry a gradient; raises unless x lies on the
    CPU or a card."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    return torch.is_grad_enabled() and any(t.requires_grad for t in (x, *tensors))


def fno_block(x, weights, w0, b0, modes1: int, modes2: int, rows=None, tf32: bool = False):
    """x (B, H, W, Cin); weights (2, 2, Cin, Cout, modes1, modes2);
    w0 (Cout, Cin); b0 (Cout,) → (B, H, W, Cout). Under grad the result is
    differentiable (:class:`FnoBlockFn`), else it comes from the
    registered operator (:func:`fno_block_op`). With ``rows``, a model
    axis of more than one rank (spatial sharding), x is this rank's rows
    of the grid and the block runs split around the sum of its spectrum
    over the ranks (:func:`_block_call`), on the CPU its plain version.
    ``tf32``: on the card the kernel's TF32 mode; on the CPU nothing."""
    rows = rows if active(rows) else None
    wants_grad = _wants_grad(x, weights, w0, b0)
    if not wants_grad and rows is None:
        return fno_block_op(x, weights, w0, b0, modes1, modes2, tf32)
    if x.device.type == "cpu":
        return fno_block_reference(x, weights, w0, b0, modes1, modes2, rows)
    _check_cuda_f32(x.device, x=x, weights=weights, w0=w0, b0=b0)
    _check_block_args(x, weights, w0, b0, modes1, modes2)
    with torch.cuda.device(x.device):
        return FnoBlockFn.apply(load_library(), _stream(x.device), wants_grad, x, weights, w0,
                                b0, modes1, modes2, rows, tf32)


def fno_head(x, w1, b1, w2, b2, mask, tf32: bool = False):
    """x (B, H, W, C); w1 (hidden, C); b1 (hidden,); w2 (out, hidden);
    b2 (out,); mask (B, H, W, 1) → (B, H, W, out), masked; under grad
    on the card differentiable (:class:`FnoHeadFn`), else from the
    registered operator (:func:`fno_head_op`). ``tf32``: on the card the
    kernel's TF32 mode; on the CPU nothing."""
    if not _wants_grad(x, w1, b1, w2, b2, mask):
        return fno_head_op(x, w1, b1, w2, b2, mask, tf32)
    if x.device.type == "cpu":
        return fno_head_reference(x, w1, b1, w2, b2, mask)
    _check_cuda_f32(x.device, x=x, w1=w1, b1=b1, w2=w2, b2=b2, mask=mask)
    _check_head_args(x, w1, b1, w2, b2, mask)
    with torch.cuda.device(x.device):
        return FnoHeadFn.apply(load_library(), _stream(x.device), x, w1, b1, w2, b2, mask, tf32)


KERNELS = {"fno_block": fno_block, "fno_head": fno_head}


def _count(fn, tf32: bool) -> None:
    """One launch of ``fn``'s kernel, and of its TF32 mode with ``tf32``."""
    fn.launches += 1
    fn.tf32_launches += bool(tf32)


def launch_counts(tf32: bool = False) -> dict:
    """Each kernel's launches since the last reset; with ``tf32``, those
    in its TF32 mode alone."""
    return {name: fn.tf32_launches if tf32 else fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = fn.tf32_launches = 0


reset_launch_counts()
