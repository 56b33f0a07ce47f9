"""Fourier Neural Operator, the flagship autoregressive model (port of
``cfdbench_tpu/models/fno.py``).

Input channels are [u, v] ‖ mask ‖ (x, y) coordinates ‖ case-parameter
planes; a 1×1 lift to ``hidden_dim``; ``num_layers`` FnoBlocks
(spectral conv + 1×1 bypass + GELU); the head fc1(→128) → GELU →
fc2(→out_chan), multiplied by the mask.

On CUDA tensors every FnoBlock is one call of the fused block kernel and
the head one call of the fused head kernel (``ops/fno_kernels.py``) —
what the JAX package's ``fno2d_apply_pallas`` and
``fno2d_apply_pallas_head`` did with its two Pallas kernels, here on
every forward, in training too: the kernels' autograd Functions carry
the gradient. On CPU tensors both run their plain PyTorch versions.
The lift stays plain ``torch.matmul``.

Under tensor parallelism (``--mesh_shape NxM``, :attr:`Fno2d.tp` the
mesh's model axis, set with the parameters sharded by
``parallel/sharding_rules.py``) a block whose spectral weight holds this
rank's ``Cout/M`` output channels runs column-parallel: the block kernel on
that slice (``w0`` and ``b0`` replicated, their rows of it), its outputs
gathered into the whole for the next block (``parallel/tensor.py``); a
head whose ``fc1`` holds this rank's ``128/M`` hidden units runs
row-parallel: the head kernel on them (``b1``'s and ``fc2``'s columns of
them, ``b2`` on model rank 0 alone), its partial outputs summed over the
model ranks. GELU is per hidden unit and the mask linear, so the sum is the
head's output up to the order of fc2's partial sums. The lift runs
replicated (its weight, and fc2's, gathered at use where the rules split
them: a wide model). The replicated parameters used in part on a rank
(:meth:`Fno2d.tp_summed`) get their gradients summed over the model ranks.

Under spatial sharding (``--shard_spatial 1``, :attr:`Fno2d.sp` the
model axis over which the grid rows split) a rank runs the model on its
rows: the lift on its rows of the global coordinates, each block's
kernel split around the sum of its retained spectrum over the model
ranks (``ops/fno_kernels.py``), the head kernel on its rows. A padded
model pads every rank's columns and the last rank's rows
(:func:`padded_rows`: 64 rows padded by 9 at ``1x2`` split 32 and 41 of
73), its blocks run on that uneven split, and the crop drops those columns
and rows again. Its
parameters, split by the same rules as under tp, are gathered whole at
use (``parallel/tensor.py::gather_at_use``); the column- and
row-parallel paths are not used.

With ``padding=p`` (the JAX model's domain padding; no entry point of
either package sets it, so a user reaches it through the library) the
lifted field, bias included, gains ``p`` zero rows at the bottom and ``p``
zero columns at the right; every block runs on the (H+p, W+p) grid, its
modes clamped to that grid, and the field is cropped back to (H, W) before
the head, as ``cfdbench_tpu/models/fno.py:147-153`` does. The crop is a
strided view, and the head kernel reads a dense field, so the head takes a
contiguous copy of it. Tensor parallelism and spatial sharding hold a
padded model as they hold the unpadded one; pipeline parallelism refuses
it, as the JAX pipeline asserts (``cfdbench_tpu/parallel/pipeline.py:192``).

With ``tf32`` (:func:`use_tf32`; ``--matmul_precision high`` and its
aliases, ``init_auto_model``) both kernels run in their TF32 mode on
the card: each block, whole, column-parallel, split over rows or on a
pipeline stage, and the head. On CPU tensors the mode changes nothing.

In bfloat16 (``--use_mixed_precision``'s train forward, the bfloat16
rollout) the model runs the plain versions on either device, in the JAX
package's bfloat16 numerics: its Pallas kernels are float32 only and its
bfloat16 paths never reach them (``cfdbench_tpu/cli.py:580-593``). The
kernels take float32 only and raise on anything else. Under tensor or
pipeline parallelism a bfloat16 forward runs the same split blocks and
head as the float32 one, each on the plain version of its kernel at the
rank's slice.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import promote
from ..ops.fno_kernels import (
    fno_block,
    fno_block_reference,
    fno_head,
    fno_head_reference,
)
from ..ops.spectral import init_spectral_weights
from ..parallel.spatial import Rows, active
from ..parallel.tensor import GatherShard, copy_to_model, gather_channels, reduce_model
from .common import Dense, coord_channels, ensure_mask

HEAD_WIDTH = 128
# The flagship configuration (ROADMAP.md, main path): depth 4, width 32,
# 12x12 modes.
FLAGSHIP = dict(num_layers=4, hidden_dim=32, modes1=12, modes2=12)


def lift(fc0: Dense, inputs, case_params, mask, rows=None):
    """``fc0`` over [inputs ‖ mask ‖ coords ‖ params] as summed partial
    products on the weight's column slices: the concatenated input is
    never built, and the coordinate and case-parameter terms are
    broadcast, not full-field. Each product is taken in the common dtype
    of its operands, as in the JAX package (a float32 mask lifts a
    bfloat16 model to float32). With ``rows`` (spatial sharding) the
    inputs are a rank's rows, and so are the coordinates."""
    _, H, W, C = inputs.shape
    k = fc0.weight  # (hidden, C + 3 + P)
    P = case_params.shape[-1]
    coords = coord_channels(1, H, W, dtype=inputs.dtype, device=inputs.device, rows=rows)

    def mm(a, w):
        a, w = promote(a, w)
        return a @ w.T

    return (
        mm(inputs, k[:, :C])
        + mm(mask, k[:, C:C + 1])
        + mm(coords, k[:, C + 1:C + 3])
        + mm(case_params, k[:, C + 3:C + 3 + P])[:, None, None, :]
        + fc0.bias
    )


def padded_rows(h: int, padding: Optional[int], axis):
    """Under spatial sharding over ``axis``, the split of the grid that
    :func:`pad` pads, of which this rank holds ``h`` rows of the even split:
    the last rank gains the pad rows (``Rows.resized``, the rule of
    ``models/diffusion.py::padded_rows`` too). ``axis`` itself without
    padding or without a split."""
    if padding is None or not active(axis):
        return axis
    rows = Rows.of(h, axis)
    return rows.resized(rows.H + padding)


def pad(x, padding: Optional[int], rows=None):
    """``padding`` zero rows at the bottom and zero columns at the right of
    the lifted field (B, H, W, C); x itself for None. With ``rows``
    (:func:`padded_rows`) x is a rank's rows: the columns are padded on
    every rank, the rows on the last alone."""
    if padding is None:
        return x
    ph = padding if rows is None else rows.h - x.shape[1]
    return F.pad(x, (0, 0, 0, padding, 0, ph))


def crop(x, padding: Optional[int], h: int):
    """The field's first ``h`` rows (the rows before :func:`pad`, a rank's
    under spatial sharding) without the pad's columns, contiguous, as the
    head kernel reads it."""
    return x if padding is None else x[:, :h, :-padding].contiguous()


def block_call(x, weights, w0, b0, modes1: int, modes2: int, rows=None, tf32: bool = False):
    """One FnoBlock: the block kernel, or its plain version on a bfloat16
    input (the kernels take float32 only); ``rows``, ``tf32``:
    ``fno_block``'s."""
    if x.dtype == torch.bfloat16:
        return fno_block_reference(x, weights, w0, b0, modes1, modes2, rows)
    return fno_block(x, weights, w0, b0, modes1, modes2, rows, tf32)


def head_call(x, w1, b1, w2, b2, mask, tf32: bool = False):
    """The head: the head kernel (in TF32 mode with ``tf32``), or its plain
    version on a bfloat16 input."""
    if x.dtype == torch.bfloat16:
        return fno_head_reference(x, w1, b1, w2, b2, mask)
    return fno_head(x, w1, b1, w2, b2, mask, tf32)


def head(fc1: Dense, fc2: Dense, x, mask, tf32: bool = False):
    """The head, fc1 → GELU → fc2 → ×mask: one call of the head kernel."""
    return head_call(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias, mask, tf32)


def use_tf32(model: nn.Module, on: bool) -> None:
    """Run ``model``'s kernels in their TF32 mode (``on``) or in split TF32:
    the ``tf32`` of the model and of each of its blocks."""
    for module in model.modules():
        if isinstance(module, (Fno2d, FnoBlock)):
            module.tf32 = on


class FnoBlock(nn.Module):
    """GELU(spectral conv + 1×1 bypass), one fused kernel on the card.

    ``weights`` are the spectral conv's (the JAX ``SpectralConv2d``'s),
    in the real-pair layout ``(corner, re/im, in, out, modes1, modes2)``.
    """

    def __init__(self, channels: int, modes1: int, modes2: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.weights = nn.Parameter(init_spectral_weights(
            generator, channels, channels, modes1, modes2
        ))
        self.w0 = Dense(channels, channels, generator=generator)

    sp = None  # the model axis the grid rows split over
    tf32 = False  # the kernel's TF32 mode (use_tf32)

    def forward(self, x, rows=None):
        """``rows``: x's split under spatial sharding where it is not the
        even one (a padded grid's, :func:`padded_rows`)."""
        return block_call(x, self.weights, self.w0.weight, self.w0.bias,
                          self.modes1, self.modes2, self.sp if rows is None else rows,
                          self.tf32)


class Fno2d(nn.Module):
    """Autoregressive FNO: ``forward(inputs, case_params, mask) → preds``.

    inputs (B, H, W, in_chan); case_params (B, P); mask (B, H, W, 1),
    (B, H, W) or None. Returns (B, H, W, out_chan), masked. A bfloat16
    input runs the plain versions of both kernels (:func:`block_call`,
    :func:`head_call`), whole or split: no kernel. ``padding``: the blocks
    run on the grid padded by that many rows and columns (:func:`pad`).
    ``tf32``: both kernels in their TF32 mode (:func:`use_tf32`).
    Parameters are drawn from ``generator`` on the CPU, then moved to
    ``device``.
    """

    def __init__(self, in_chan: int = 2, out_chan: int = 2,
                 n_case_params: int = 5, num_layers: int = 4,
                 modes1: int = 12, modes2: int = 12, hidden_dim: int = 32,
                 padding: Optional[int] = None, tf32: bool = False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if padding is not None and padding < 1:
            # The JAX model crops ``x[:, :-0]``, an empty field, at 0.
            raise ValueError(f"padding {padding}: pad by at least 1, or pass None")
        self.out_chan, self.padding = out_chan, padding
        self.fc0 = Dense(in_chan + 3 + n_case_params, hidden_dim,
                         generator=generator)
        self.blocks = nn.ModuleList(
            FnoBlock(hidden_dim, modes1, modes2, generator=generator)
            for _ in range(num_layers)
        )
        self.fc1 = Dense(hidden_dim, HEAD_WIDTH, generator=generator)
        self.fc2 = Dense(HEAD_WIDTH, out_chan, generator=generator)
        use_tf32(self, tf32)
        self.to(device)

    tp = None  # the model axis under tensor parallelism
    sp = None  # the model axis the grid rows split over under spatial sharding
    tf32 = False  # the head kernel's TF32 mode (use_tf32)

    def forward(self, inputs, case_params, mask=None):
        B, H, W, _ = inputs.shape
        mask = ensure_mask(mask, B, H, W, device=inputs.device)
        split_blocks, split_head = self._tp_split()
        rows = padded_rows(H, self.padding, self.sp)
        x = pad(lift(self._tp_whole(self.fc0), inputs, case_params, mask, self.sp),
                self.padding, rows)
        for block in self.blocks:
            x = self._tp_block(block, x) if split_blocks else block(x, rows)
        x = crop(x, self.padding, H)
        fc2 = self._tp_whole(self.fc2, used_in_part=split_head)
        if split_head:
            return self._tp_head(x, fc2, mask)
        return head(self.fc1, fc2, x, mask, self.tf32)

    def _tp_whole(self, dense, used_in_part: bool = False):
        """``dense`` itself, or with its output rows gathered where the
        rules split them (a wide model). ``used_in_part``: each rank uses
        only its columns of the gathered weight (the row-parallel head's
        fc2), so its gradient is summed over the model ranks before each
        rank takes its rows."""
        if dense.weight.shape[0] == dense.bias.shape[0]:
            return dense
        weight = GatherShard.apply(dense.weight, 0, self.tp)
        if used_in_part:
            weight = copy_to_model(weight, self.tp)
        return SimpleNamespace(weight=weight, bias=dense.bias)

    def _tp_split(self):
        """Whether the blocks and the head hold this rank's slice of their
        spectral weights and fc1 (``sharding_rules.shard_params``)."""
        if self.tp is None:
            return False, False
        blk = self.blocks[0]
        return (blk.weights.shape[3] != blk.weights.shape[2],  # Cout against Cin
                self.fc1.weight.shape[0] != self.fc2.weight.shape[1])

    def tp_summed(self):
        """The replicated parameters that this rank uses in part under
        tensor parallelism, whose gradients sum over the model ranks."""
        split_blocks, split_head = self._tp_split()
        out = []
        if split_blocks:
            for b in self.blocks:
                out += [b.w0.bias] + ([] if self._w0_split(b) else [b.w0.weight])
        if split_head:
            fc2_split = self.fc2.weight.shape[0] != self.fc2.bias.shape[0]
            out += [self.fc1.bias, self.fc2.bias] + ([] if fc2_split else [self.fc2.weight])
        return out

    @staticmethod
    def _w0_split(block) -> bool:
        """Whether ``w0`` holds this rank's rows (a bypass of at least the
        rules' ``min_size`` elements), as the spectral weight its columns."""
        return block.w0.weight.shape[0] == block.weights.shape[3]

    def _tp_block(self, block, x):
        n = block.weights.shape[3]
        rows = slice(self.tp.rank * n, (self.tp.rank + 1) * n)
        w0 = block.w0.weight if self._w0_split(block) else block.w0.weight[rows]
        y = block_call(copy_to_model(x, self.tp), block.weights, w0, block.w0.bias[rows],
                       block.modes1, block.modes2, tf32=block.tf32)
        return gather_channels(y, self.tp)

    def _tp_head(self, x, fc2, mask):
        n = self.fc1.weight.shape[0]
        cols = slice(self.tp.rank * n, (self.tp.rank + 1) * n)
        b2 = fc2.bias * float(self.tp.rank == 0)
        part = head_call(copy_to_model(x, self.tp), self.fc1.weight, self.fc1.bias[cols],
                         fc2.weight[:, cols].contiguous(), b2, mask, self.tf32)
        return reduce_model(part, self.tp)


def fno2d_reference(model: Fno2d, inputs, case_params, mask=None):
    """``model``'s forward with both kernels replaced by their plain
    PyTorch versions, on whatever device the tensors are on: what the
    kernel path is held to on the card."""
    B, H, W, _ = inputs.shape
    mask = ensure_mask(mask, B, H, W, device=inputs.device)
    x = pad(lift(model.fc0, inputs, case_params, mask), model.padding)
    for blk in model.blocks:
        x = fno_block_reference(x, blk.weights, blk.w0.weight, blk.w0.bias,
                                blk.modes1, blk.modes2)
    x = crop(x, model.padding, H)
    return fno_head_reference(x, model.fc1.weight, model.fc1.bias,
                              model.fc2.weight, model.fc2.bias, mask)


class PlainFno2d(nn.Module):
    """``model`` behind :func:`fno2d_reference`: the same weights, both
    kernels replaced by their plain versions and differentiated by
    autograd; the yardstick of the kernel path in training."""

    def __init__(self, model: Fno2d):
        super().__init__()
        self.model, self.out_chan = model, model.out_chan

    def forward(self, inputs, case_params, mask=None):
        return fno2d_reference(self.model, inputs, case_params, mask)
