"""The work of each measured operation, counted from its shapes by the
operation's own definition, whatever implements it.

- Bytes: every input and output byte once, at float32.
- Operations: every multiply-add of the definition once (two FLOPs). The
  spectral convolution is defined as the truncated DFT over the retained
  modes (a real input along W, complex along H), the per-mode complex
  channel mixing, and the inverse truncated DFT back to a real field; a
  complex product is four real multiply-adds, a real-by-complex one two.
  GELU, the mask, BatchNorm, ReLU and pooling are not counted.

A kernel's bound is the larger of its bytes over the HBM bandwidth and its
FLOPs over the dense TF32 rate (``peaks.py``); the model's FLOPs of a step
are the ``*_mfu`` numerators.
"""

from __future__ import annotations

from dataclasses import dataclass

from .peaks import HBM_BYTES_PER_S, TF32_FLOPS

F32 = 4


@dataclass(frozen=True)
class Work:
    macs: int  # multiply-adds
    bytes: int  # input and output bytes, each once

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the memory and
        the compute time."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / TF32_FLOPS)

    def bound_by(self) -> str:
        return "bytes" if self.bytes / HBM_BYTES_PER_S >= self.flops / TF32_FLOPS else "operations"


def clamp_modes(H: int, W: int, m1: int, m2: int):
    """The retained modes on an H x W grid: at most half its spectrum."""
    return min(m1, H // 2), min(m2, W // 2 + 1)


def fno_block(B: int, H: int, W: int, C: int, m1: int, m2: int) -> Work:
    """One FNO block, GELU(spectral conv(x) + x w0^T + b0), C channels in and
    out: the forward DFT along W (real x by complex factor), along H (complex,
    onto 2 m1 rows), the mixing (complex, per retained mode), the inverse along
    H (complex) and along W (complex to real), and the 1x1 bypass."""
    m1, m2 = clamp_modes(H, W, m1, m2)
    k = 2 * m1
    macs = (B * H * C * W * m2 * 2        # forward along W
            + B * C * m2 * k * H * 4      # forward along H
            + B * k * m2 * C * C * 4      # mode mixing
            + B * C * m2 * k * H * 4      # inverse along H
            + B * H * C * W * m2 * 2      # inverse along W
            + B * H * W * C * C)          # 1x1 bypass
    nbytes = F32 * (2 * B * H * W * C      # x in, block out
                    + 2 * 2 * C * C * m1 * m2  # spectral weights: 2 corners, re/im
                    + C * C + C)           # w0, b0
    return Work(macs, nbytes)


def fno_head(B: int, H: int, W: int, C: int, hidden: int, n_out: int) -> Work:
    """The FNO head, (GELU(x w1^T + b1) w2^T + b2) * mask."""
    px = B * H * W
    macs = px * C * hidden + px * hidden * n_out
    nbytes = F32 * (px * C + px + px * n_out + hidden * C + hidden + n_out * hidden + n_out)
    return Work(macs, nbytes)


def fno_lift(B: int, H: int, W: int, n_in: int, C: int) -> Work:
    """The lift, [inputs | mask | coordinates | case parameters] w^T + b."""
    px = B * H * W
    return Work(px * n_in * C, F32 * (px * n_in + n_in * C + C + px * C))


def fno_step_macs(B: int, H: int, W: int, in_chan: int, n_case_params: int, C: int,
                  depth: int, m1: int, m2: int, hidden: int, n_out: int) -> int:
    """Multiply-adds of one FNO forward of B cases: lift, blocks, head."""
    n_in = in_chan + 1 + 2 + n_case_params
    return (fno_lift(B, H, W, n_in, C).macs + depth * fno_block(B, H, W, C, m1, m2).macs
            + fno_head(B, H, W, C, hidden, n_out).macs)


def _conv(px_out: int, c_in: int, c_out: int, k: int) -> int:
    return px_out * c_in * c_out * k * k


def unet_forward_macs(H: int, W: int, in_chan: int, n_case_params: int, dim: int,
                      out_chan: int) -> int:
    """Multiply-adds of one sample through CFDBench's U-Net with the case
    parameters as input channels: DoubleConvs of 3x3 convolutions down four
    levels and up four (each up a 2x2 stride-2 transposed convolution, then a
    DoubleConv over the skip and the upsampled field), and a 1x1 output."""
    first = in_chan + 1 + n_case_params
    widths = [dim, 2 * dim, 4 * dim, 8 * dim, 16 * dim]
    sizes = [(H, W)]
    for _ in range(4):
        h, w = sizes[-1]
        sizes.append((h // 2, w // 2))
    px = [h * w for h, w in sizes]
    macs = _conv(px[0], first, dim, 3) + _conv(px[0], dim, dim, 3)
    for lvl in range(1, 5):
        c_in, c_out = widths[lvl - 1], widths[lvl]
        macs += _conv(px[lvl], c_in, c_out, 3) + _conv(px[lvl], c_out, c_out, 3)
    for lvl in range(4, 0, -1):
        c_in, c_out = widths[lvl], widths[lvl - 1]
        # transposed conv c_in -> c_in // 2: one 2x2 tap per output pixel
        macs += px[lvl - 1] * c_in * (c_in // 2)
        macs += _conv(px[lvl - 1], c_in, c_out, 3) + _conv(px[lvl - 1], c_out, c_out, 3)
    return macs + px[0] * dim * out_chan
