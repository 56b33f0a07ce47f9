"""The FNO block kernel's Hopper route against the plain version.

``csrc/fno_block.cu`` runs the block on Hopper's machinery where the shape
allows (``fno_block_route``): pass 1 and pass 2 on ``wgmma`` and the
inverse (passes 3 and 4 fused, z kept in shared memory) on ``wgmma`` fed by
TMA through ``mbarrier`` rings. On the CPU these tests run that route
through the kernels' emulation (``csrc/emulate/emu.h``: the products read
through the descriptors' layout, TMA boxes with the card's swizzle and zero
fill, barriers with a phase), in both product modes, on a rank's rows and on
a padded grid's uneven rows; they hold the host's new tables to the DFT
matrices; and the ``cuda``-marked test runs the flagship shape on the card.
This file imports no JAX:

    python -m pytest tests/test_torch_block_hopper.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from cfdbench_tpu_torch.ops import _build
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import clamp_modes

torch.set_num_threads(1)

BLOCK_ATOL = 1e-4  # float32: output and pre-activation against the plain version
XM_RTOL = 1e-5     # float32: the retained modes, of their largest
# TF32 mode (tests/test_torch_precision.py's gates): of the largest output
# or mode, and the least distance of a TF32 run from float32.
TF32_RTOL, TF32_XM_RTOL, RAN_TF32 = 1e-4, 2e-4, 5e-5
BOTH = fk.ROUTE_FINISH | fk.ROUTE_SPECTRUM


def emulation():
    try:
        return _build.load_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def block_inputs(B, H, W, C, modes, seed=0, pad=0, device="cpu"):
    """x, the spectral weights at C times their init scale (so that the
    spectral path carries as much of the output as the bypass), w0 and b0,
    drawn with numpy; with ``pad`` the last rows and columns of x zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if pad:
        x[:, H - pad:], x[:, :, W - pad:] = 0, 0
    w = rng.uniform(0, 1.0 / C, (2, 2, C, C, modes, modes)).astype(np.float32)
    w0 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b0 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, w0, b0)) + (modes, modes)


def check(block, out, xm, pre, tf32):
    """The block's output, pre-activation and retained modes against the
    plain version of the mode (the TF32 mode also away from float32)."""
    want = fk.fno_block_reference(*block, tf32=tf32)
    want_xm, want_pre = fk.fno_block_saved_reference(*block, tf32=tf32)
    top = want.abs().max().item()
    atol, xm_rtol = (TF32_RTOL * top, TF32_XM_RTOL) if tf32 else (BLOCK_ATOL, XM_RTOL)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() <= atol
    assert (pre - want_pre).abs().max().item() <= atol
    assert (xm - want_xm).abs().max().item() <= xm_rtol * want_xm.abs().max().item()
    if tf32:
        assert (out - fk.fno_block_reference(*block)).abs().max().item() > RAN_TF32 * top


@pytest.mark.parametrize("tf32", [False, True], ids=["split_tf32", "tf32"])
@pytest.mark.parametrize(
    "B,H,W,modes",
    # 16x16 at 4 modes; 19x19 (odd, ragged W tile and row group) at 4; and
    # 12 modes clamped to 8 x 9 with the Nyquist column
    [(1, 16, 16, 4), (2, 19, 19, 4), (1, 16, 16, 12)],
)
def test_hopper_route_matches_plain_in_emulation(B, H, W, modes, tf32):
    lib = emulation()
    block = block_inputs(B, H, W, 32, modes)
    assert fk.block_route(lib, H, W, 32, 32, modes, modes) == BOTH
    out, xm, pre = fk._block_call(lib, *block, stream=0, keep=True, tf32=tf32)
    check(block, out, xm, pre, tf32)


def split_call(lib, block, bounds, tf32):
    """The block split at the rows ``bounds`` of x, as spatial sharding runs
    it: pass 1 on each rank's rows, the partial spectra summed, passes 2-4
    on each rank's rows."""
    x, w, w0, b0, m, _ = block
    H = x.shape[1]
    spans = list(zip(bounds, bounds[1:]))
    rows = [x[:, a:b].contiguous() for a, b in spans]
    xm = sum(fk._block_spectrum(lib, r, m, m, 0, (a, H), tf32) for r, (a, _) in zip(rows, spans))
    outs = [fk._block_finish(lib, r, xm, w, w0, b0, m, m, 0, True, (a, H), tf32)
            for r, (a, _) in zip(rows, spans)]
    return torch.cat([o for o, _ in outs], 1), xm, torch.cat([p for _, p in outs], 1)


@pytest.mark.parametrize(
    "H,W,bounds,pad,tf32",
    [
        (32, 16, (0, 16, 32), 0, False),  # two ranks' 16 rows
        (19, 19, (0, 8, 19), 3, False),   # a padded grid's uneven rows, the last rank's pad
        (19, 19, (0, 8, 19), 3, True),
    ],
    ids=["rank_rows", "padded_rows", "padded_rows_tf32"],
)
def test_hopper_route_on_split_rows_in_emulation(H, W, bounds, pad, tf32):
    lib = emulation()
    block = block_inputs(1, H, W, 32, 4, pad=pad)
    out, xm, pre = split_call(lib, block, bounds, tf32)
    check(block, out, xm, pre, tf32)


def test_route_is_chosen_by_shape():
    lib = emulation()
    route = lib.fno_block_route
    assert route(64, 32, 32, 12, 12) == BOTH        # the flagship
    assert route(64, 256, 256, 12, 12) == BOTH      # width 256
    assert route(512, 32, 32, 12, 12) == BOTH       # a 512-wide grid
    assert route(1024, 32, 32, 12, 12) == fk.ROUTE_FINISH  # pass 1's W-stage table too large
    assert route(256, 32, 32, 32, 32) == fk.ROUTE_FINISH  # more than 12 modes: the old pass 1
    assert route(17, 10, 10, 4, 4) == 0             # 10 channels: no 16-byte TMA strides
    assert route(64, 32, 10, 12, 12) == fk.ROUTE_SPECTRUM  # 10 output channels
    assert route(0, 32, 32, 12, 12) == -1
    assert fk.block_route(lib, 64, 64, 32, 32, 12, 12) == BOTH
    with pytest.raises(ValueError, match="no route"):
        fk.block_route(lib, 64, 64, 32, 0, 12, 12)
    assert "pass 1 on wgmma and TMA" in fk.route_name(BOTH)
    assert "passes 2-4 on mma.sync" in fk.route_name(fk.ROUTE_SPECTRUM)


def test_old_route_still_runs_where_the_hopper_route_is_taken():
    """``route=0`` runs the sm_80-style passes at a Hopper shape (what
    scripts/bench_torch_kernels.py times beside the new route)."""
    lib = emulation()
    block = block_inputs(1, 16, 16, 32, 4)
    out, xm, pre = fk._block_call(lib, *block, stream=0, keep=True, route=0)
    check(block, out, xm, pre, False)


def planes_back(f: np.ndarray) -> np.ndarray:
    """(..., 2, Kd/4, N, 4) B planes → (..., N, Kd): high plus low half."""
    hi, lo = f[..., 0, :, :, :], f[..., 1, :, :, :]
    assert not (hi.view(np.uint32) & 0x1FFF).any()  # the high half is TF32
    both = hi + lo
    return both.swapaxes(-3, -2).reshape(*both.shape[:-3], both.shape[-2], -1)


@pytest.mark.parametrize("H,W,m1,m2,r0,h", [(18, 17, 6, 4, 0, None), (19, 70, 5, 7, 8, 11)])
def test_hopper_tables_are_the_matrices_split_in_b_layout(H, W, m1, m2, r0, h):
    """a1h, e1h and e2h, each half added back in hopper.cuh's K-major B
    layout (element (n, k) at [k/4, n, k%4]), are their float32 matrices;
    the matrices are the DFT factors at the rows they name."""
    tables = fk._block_tables(H, W, m1, m2, r0, h)
    a1h = fk._hopper_matrix(H, W, m1, m2, r0, h)
    e1h, e2h = fk._spectrum_matrices(H, W, m1, m2, r0, h)
    for f, mat in zip(tables[4:], (a1h, e1h, e2h)):
        np.testing.assert_array_equal(planes_back(f), mat.astype(np.float32))
    E1r, E1i, E2r, E2i, Ar, Ai, _, _ = fk._dft_factors(H, W, m1, m2)
    rows = r0 + np.arange(H - r0 if h is None else h)
    K = 2 * m1
    # e1h group 0, row (ri 1, k 1), column (ri' 0, r 2): E1i[1, r0 + 2]
    assert e1h[0, 2 * fk.SPEC_MODES + 1, 2] == pytest.approx(E1i[1, rows[2]])
    assert e1h[0, 1, fk.SPEC_ROWS + 2] == pytest.approx(-E1i[1, rows[2]])
    np.testing.assert_allclose(e2h[fk.SPEC_MODES:fk.SPEC_MODES + m2, :W], E2i)
    # a1h tile 0, row (ri 1, r 1): [Ai | Ar] at row r0 + 1
    np.testing.assert_allclose(a1h[0, fk.HOP_ROWS + 1, :K], Ai[rows[1]])
    np.testing.assert_allclose(a1h[0, fk.HOP_ROWS + 1, K:2 * K], Ar[rows[1]])


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True], ids=["split_tf32", "tf32"])
def test_flagship_takes_the_hopper_route_on_card(cuda_device, tf32):
    from cfdbench_tpu_torch.utils.device import set_numerics

    set_numerics()
    lib = _build.load_library()
    block = block_inputs(4, 64, 64, 32, 12, device=cuda_device)
    assert fk.block_route(lib, 64, 64, 32, 32, 12, 12) == BOTH
    out, xm, pre = fk._block_call(lib, *block, torch.cuda.current_stream().cuda_stream,
                                  keep=True, tf32=tf32)
    torch.cuda.synchronize()
    check(block, out, xm, pre, tf32)
    assert clamp_modes(64, 64, 12, 12) == (12, 12)
