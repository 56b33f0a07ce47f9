"""The port's CUDA kernels against their plain PyTorch versions.

The kernels run only on a CUDA card: those tests carry the ``cuda``
marker and skip without one. This file imports no JAX, so on a machine
with a card and without JAX it runs on its own:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

On the CPU it checks the arithmetic the block kernel is built on — the
matrices its tables hold, run through its four passes in float64, give
the plain ``torch.fft`` spectral conv; the tables are those matrices
split and in ``mma.sync`` fragment order — and it runs both kernels
through their CPU emulation (``ops/_build.py::load_emulation``, built
with the host's C++ compiler) against the plain versions.
"""

import numpy as np
import pytest
import torch

from cfdbench_tpu_torch.ops import _build
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import clamp_modes, spectral_conv2d_fft

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)


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
    # clamped modes with the Nyquist column; odd W; the flagship's 12 modes
    # on the tube grid; and more modes than one block takes (chunked).
    [(16, 16, 12), (18, 17, 4), (66, 65, 12), (32, 34, 16)],
)
def test_packed_dft_tables_reproduce_spectral_conv(rng, H, W, modes):
    """The block kernel's four passes, in float64 numpy, on the matrices
    its tables hold: the forward DFT onto the retained modes in row
    groups and mode / spectrum-row chunks, the per-mode mixing with the
    corner weights, the inverse column DFT per tile of rows, and the
    inverse row DFT keeping the real part."""
    B, C = 2, 4
    x, w, _, _ = block_inputs(rng, B, H, W, C, modes)
    m1, m2 = clamp_modes(H, W, modes, modes)
    K = 2 * m1
    e1, e2, a1, bw = fk._block_matrices(H, W, m1, m2)
    ng, wp = e1.shape[1], e2.shape[1]
    xp = np.zeros((B, ng * fk.FWD_ROWS, wp, C))
    xp[:, :H, :W] = x
    xm = np.zeros((B, 2, K, m2, C))
    for mc in range(e2.shape[0]):
        m0 = mc * fk.FWD_MODES
        mn = min(fk.FWD_MODES, m2 - m0)
        T = np.einsum("bhwc,wn->bhnc", xp, e2[mc])
        for kc in range(e1.shape[0]):
            k0 = kc * fk.FWD_K
            kn = min(fk.FWD_K, K - k0)
            for gi in range(ng):
                rows = slice(gi * fk.FWD_ROWS, (gi + 1) * fk.FWD_ROWS)
                tj = np.concatenate([T[:, rows, :mn], T[:, rows, mn:2 * mn]], axis=1)
                out = np.einsum("rj,bjmc->brmc", e1[kc, gi], tj)
                xm[:, 0, k0:k0 + kn, m0:m0 + mn] += out[:, :kn]
                xm[:, 1, k0:k0 + kn, m0:m0 + mn] += out[:, kn:2 * kn]
    corner = np.concatenate(  # (K, m2, Ci, Co): rows k < m1 are corner 0
        [w[c, 0, :, :, :m1, :m2] + 1j * w[c, 1, :, :, :m1, :m2] for c in (0, 1)],
        axis=2,
    ).transpose(2, 3, 0, 1)
    Y = np.einsum("bkmc,kmco->bkmo", xm[:, 0] + 1j * xm[:, 1], corner)
    ym = np.stack([Y.real, Y.imag], 1).reshape(B, 2 * K, m2 * C)
    z = np.zeros((B, H, 2, m2 * C))
    for ht in range(a1.shape[0]):
        hs = np.arange(ht * fk.INV_ROWS, min(H, (ht + 1) * fk.INV_ROWS))
        zt = np.einsum("rk,bkn->brn", a1[ht, :, :2 * K], ym)
        z[:, hs, 0], z[:, hs, 1] = zt[:, :len(hs)], zt[:, 8:8 + len(hs)]
    got = np.einsum("wk,bhko->bhwo", bw[:W, :2 * m2], z.reshape(B, H, 2 * m2, C))
    want = spectral_conv2d_fft(t(x), t(w), modes, modes).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_block_tables_are_the_matrices_split_in_fragment_order():
    """Each table, its high and low halves added, is its float32 matrix
    element for element, read the way csrc/tf32.cuh lays fragments out;
    the high halves are TF32 (low 13 bits zero)."""
    g, tt = np.arange(32) // 4, np.arange(32) % 4
    mats = fk._block_matrices(18, 17, 6, 4)
    for f, mat, kind in zip(fk._block_tables(18, 17, 6, 4), mats, "ABAA"):
        mat = mat.astype(np.float32)
        hi, lo = np.split(f, 2, axis=-1)
        assert not (hi.view(np.uint32) & 0x1FFF).any()
        frag = hi + lo
        back = np.zeros_like(mat)
        if kind == "A":  # (..., Mt, Kt, 32, 4): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
            for mt in range(frag.shape[-4]):
                for kt in range(frag.shape[-3]):
                    r, c = mt * 16 + g, kt * 8 + tt
                    for i, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                        back[..., r + dr, c + dc] = frag[..., mt, kt, :, i]
        else:  # (..., Kt, Nt, 32, 2): b0 (t, g), b1 (t+4, g)
            for kt in range(frag.shape[-4]):
                for nt in range(frag.shape[-3]):
                    back[..., kt * 8 + tt, nt * 8 + g] = frag[..., kt, nt, :, 0]
                    back[..., kt * 8 + tt + 4, nt * 8 + g] = frag[..., kt, nt, :, 1]
        np.testing.assert_array_equal(back, mat)


def kernel_case(rng, B, H, W, C, modes, n_out, device):
    """Block and head inputs at one shape, and the plain versions' outputs."""
    x, w, k0, b0 = block_inputs(rng, B, H, W, C, modes)
    x, w, w0, b0 = (t(a).to(device) for a in (x, w, k0.T, b0))
    w1 = t(rng.standard_normal((128, C)) / np.sqrt(C)).to(device)
    w2 = t(rng.standard_normal((n_out, 128)) / np.sqrt(128)).to(device)
    b1, b2 = t(np.full(128, 0.1)).to(device), t(np.full(n_out, 0.1)).to(device)
    mask = torch.ones((B, H, W, 1), device=device)
    mask[:, : H // 2] = 0
    block = (x, w, w0, b0, modes, modes)
    head = (x, w1, b1, w2, b2, mask)
    return block, head


@pytest.mark.parametrize(
    "B,H,W,C,modes,n_out",
    [
        (2, 16, 16, 8, 4, 2),
        (3, 18, 17, 10, 4, 3),   # ragged channel, mode and row tiles; a run-time output count
        (3, 16, 16, 8, 12, 2),   # clamped modes with the Nyquist column
        (1, 66, 65, 32, 12, 2),  # flagship widths, tube/dam grid: two column chunks
        (40, 8, 8, 8, 4, 2),     # two image tiles of the mixing pass
        (2, 8, 136, 8, 4, 2),    # three column chunks of the forward pass, E2 streamed
        # width 128: four channel tiles of the mixing and inverse-columns
        # passes, one row per item of the latter, the head single-buffered
        (1, 4, 80, 128, 12, 2),
    ],
)
def test_kernels_match_plain_in_emulation(rng, B, H, W, C, modes, n_out):
    lib = emulation()
    block, head = kernel_case(rng, B, H, W, C, modes, n_out, "cpu")
    check_block_with_saved(lambda *a, **k: fk._block_call(lib, *a, stream=0, **k), block)
    got = fk._head_call(lib, *head, stream=0)
    assert (got - fk.fno_head_reference(*head)).abs().max().item() <= 1e-5


def check_block_with_saved(launch, block):
    """The block kernel's output, and what it leaves for the backward (the
    pre-activation and x's retained modes), against the plain versions."""
    got, xm, pre = launch(*block, keep=True)
    assert torch.isfinite(got).all()
    assert (got - fk.fno_block_reference(*block)).abs().max().item() <= 1e-4
    want_xm, want_pre = fk.fno_block_saved_reference(*block)
    assert (pre - want_pre).abs().max().item() <= 1e-4
    # Sums over the whole grid: held relative to the largest mode.
    assert (xm - want_xm).abs().max().item() <= 1e-5 * want_xm.abs().max().item()


def emulation():
    try:
        return _build.load_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))


@pytest.mark.parametrize(
    "H,W,width,modes,hidden,n_out,what",
    [
        (64, 512, 32, 12, 128, 2, "fno_block at W=512, width 32,"),  # x rows of pass 4
        (128, 128, 160, 12, 128, 2, "fno_block at W=128, width 160,"),
        (256, 256, 32, 32, 128, 2, "fno_block at W=256, width 32, 32 modes"),  # its W-stage table
        (64, 64, 160, 12, 128, 2, "fno_head at width 160, 128 hidden units"),  # fc1's weights
        (64, 64, 32, 12, 128, 9, "fno_head at width 32, 128 hidden units, 9 outputs"),
    ],
)
def test_kernel_limits_raise_and_name_themselves(H, W, width, modes, hidden, n_out, what):
    lib = emulation()
    with pytest.raises(ValueError, match="ROADMAP.md B3") as e:
        fk.check_kernel_shapes(H, W, width, modes, modes, hidden, n_out, lib=lib)
    assert str(e.value).startswith(what)


@pytest.mark.parametrize(
    "H,W,width",
    # the flagship, the tube/dam grid, up to 144 channels (the head's most) and grids to 256
    [(64, 64, 32), (66, 65, 144), (64, 64, 128), (128, 128, 128), (256, 256, 64)],
)
def test_kernels_take_the_widths_users_run(H, W, width):
    fk.check_kernel_shapes(H, W, width, 12, 12, 128, 2, lib=emulation())


def test_block_wrapper_refuses_a_library_with_other_tiles(monkeypatch):
    lib = emulation()
    fk._check_tiles.__wrapped__(lib)
    monkeypatch.setattr(fk, "FWD_K", 16)
    with pytest.raises(RuntimeError, match="tables out for"):
        fk._check_tiles.__wrapped__(lib)


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
        (4, 64, 136, 32, 12),  # three column chunks of the forward pass
        (4, 66, 80, 128, 12),  # width 128: channel tiles, one row per item, head single-buffered
    ],
)
def test_kernels_match_plain_on_card(cuda_device, rng, B, H, W, C, modes):
    from cfdbench_tpu_torch.utils.device import set_f32_numerics

    set_f32_numerics()
    n_out = 2 if C == 32 else 3  # the FNO's 2 outputs, and a run-time count
    block, head = kernel_case(rng, B, H, W, C, modes, n_out, cuda_device)
    before = fk.launch_counts()
    got = fk.fno_block(*block)
    want = fk.fno_block_reference(*block)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    check_block_with_saved(lambda *a, **k: fk._block_call(lib, *a, stream, **k), block)
    got = fk.fno_head(*head)
    want = fk.fno_head_reference(*head)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    after = fk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fno_block": 1, "fno_head": 1}


@pytest.mark.cuda
def test_kernel_forward_carries_gradients_on_card(cuda_device, rng):
    # A forward under grad through both kernels reaches every parameter
    # with the plain path's gradient (flagship widths, 64x64).
    from cfdbench_tpu_torch.models.fno import FLAGSHIP, Fno2d, fno2d_reference
    from cfdbench_tpu_torch.utils.device import set_f32_numerics

    set_f32_numerics()
    model = Fno2d(n_case_params=5, **FLAGSHIP, generator=torch.Generator().manual_seed(0),
                  device=cuda_device)
    inputs = t(rng.standard_normal((2, 64, 64, 2))).to(cuda_device)
    cp = t(rng.standard_normal((2, 5))).to(cuda_device)

    def grads(forward):
        model.zero_grad(set_to_none=True)
        forward(inputs, cp).square().mean().backward()
        return {k: p.grad for k, p in model.named_parameters()}

    before = fk.launch_counts()
    got = grads(model)
    after = fk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fno_block": 4, "fno_head": 1}
    want = grads(lambda i, c: fno2d_reference(model, i, c))
    for k, w in want.items():
        assert got[k] is not None, k
        assert (got[k] - w).abs().max().item() <= 1e-4 * w.abs().max().item(), k


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fno_block(x, x, x, x, 2, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fno_head(x, x, x, x, x, x)
