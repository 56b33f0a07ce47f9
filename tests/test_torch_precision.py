"""``--matmul_precision`` in the port: the values JAX accepts, mapped to the
precision JAX gives them on an NVIDIA card (TF32 products for ``high``,
``tensorfloat32`` and ``TF32_TF32_F32``; float32 for ``default``,
``highest``, ``float32``, ``F32_F32_F32`` and ``TF32_TF32_F32_X3``; the
others refused by name), and the FNO kernels' one-product TF32 mode.

On the CPU the flag changes nothing, as in JAX: a port forward under
``high`` equals one under ``highest`` bit for bit and JAX's under
``jax.default_matmul_precision("high")`` within 2e-5. The TF32 plain
versions (``fno_block_reference``/``fno_head_reference`` with ``tf32``)
are held to a numpy emulation of TF32 products, and both kernels' TF32
mode, run through their CPU emulation (``ops/_build.py::load_emulation``),
to those plain versions. A predict exported under ``high`` carries the
mode as an argument of the registered operators. The ``cuda``-marked tests
run the card's kernels in TF32 mode; this file imports JAX only inside the
tests that compare with it, so on a machine with a card and without JAX

    python -m pytest tests/test_torch_precision.py -q -m cuda --noconftest

runs them.

Gates of the TF32 mode against its plain version: the kernel and the plain
version sum in different orders, so where an intermediate that both round
to TF32 (the forward DFT's row sums, the mixed modes, the inverse's row
sums) lies next to a rounding boundary they may round it to neighbouring
TF32 values, 2^-11 of it apart. The block's output and pre-activation are
held within 1e-4 of the largest output, its retained modes within 2e-4 of
their largest (a grid of 8 rows read 1.2e-4 in the emulation); the head,
whose only TF32 operands are its inputs, within 1e-5, the split mode's
bound. A TF32 run must also lie further from the float32 plain version than
5e-5 of the largest output (the split mode reads 3e-7 there): it ran in
TF32.
"""

import numpy as np
import pytest
import torch
from scipy.special import erf

from cfdbench_tpu_torch.cli import check_runtime_flags
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models import init_auto_model
from cfdbench_tpu_torch.models.fno import Fno2d
from cfdbench_tpu_torch.ops import _build
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import _dft_factors, clamp_modes, init_spectral_weights
from cfdbench_tpu_torch.utils.device import (
    F32_PRECISIONS, TF32_PRECISIONS, set_numerics, uses_tf32)

torch.set_num_threads(1)

B, H, W, P = 2, 16, 16, 5
FNO_FLAGS = ["--model", "fno", "--fno_depth", "2", "--fno_hidden_dim", "8",
             "--fno_modes_x", "4", "--fno_modes_y", "4"]
# JAX's other values (jax/_src/config.py's jax_default_matmul_precision).
REFUSED = ("bfloat16", "ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY",
           "ANY_F8_ANY_F8_ANY_FAST_ACCUM", "F16_F16_F16", "F16_F16_F32", "BF16_BF16_BF16",
           "BF16_BF16_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "BF16_BF16_F32_X9",
           "F64_F64_F64")
BLOCK_RTOL = 1e-4  # of the largest output: output and pre-activation
XM_RTOL = 2e-4  # of the largest retained mode
HEAD_ATOL = 1e-5
RAN_TF32 = 5e-5  # the least distance of a TF32 run from float32, of the largest output


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def np_tf32(a):
    """``a`` rounded to TF32 in float64: its significand to 11 bits, to
    nearest with ties away from zero (an emulation independent of the
    kernels' bit trick)."""
    m, e = np.frexp(np.asarray(a, np.float64))
    return np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11, e)


def kernel_case(rng, B, H, W, C, modes, n_out=2):
    """Block and head inputs, the spectral weights at C times their init
    scale so that the spectral path carries as much as the bypass."""
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    x = torch.randn((B, H, W, C), generator=gen)
    w = init_spectral_weights(gen, C, C, modes, modes) * C
    w0, b0 = torch.randn((C, C), generator=gen) / C ** 0.5, torch.randn(C, generator=gen) * 0.1
    w1, b1 = torch.randn((128, C), generator=gen) / C ** 0.5, torch.randn(128, generator=gen) * 0.1
    w2 = torch.randn((n_out, 128), generator=gen) / 128 ** 0.5
    b2 = torch.randn(n_out, generator=gen) * 0.1
    mask = torch.ones((B, H, W, 1))
    mask[:, : H // 3] = 0
    return (x, w, w0, b0, modes, modes), (x, w1, b1, w2, b2, mask)


# --- the flag ---------------------------------------------------------------

@pytest.mark.parametrize("value", TF32_PRECISIONS + F32_PRECISIONS)
def test_each_jax_value_maps_to_its_precision_on_a_card(value):
    tf32 = value in TF32_PRECISIONS
    assert uses_tf32(value) is tf32
    check_runtime_flags(Args.parse_args(FNO_FLAGS + ["--matmul_precision", value]))
    set_numerics(value)
    try:
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.get_float32_matmul_precision() == ("high" if tf32 else "highest")
    finally:
        set_numerics()
    model = init_auto_model(Args.parse_args(FNO_FLAGS + ["--matmul_precision", value]),
                            n_case_params=P, field_shape=(H, W))
    assert model.tf32 is tf32 and all(b.tf32 is tf32 for b in model.blocks)


@pytest.mark.parametrize("value", REFUSED)
def test_other_jax_values_are_refused_by_name(value):
    with pytest.raises(NotImplementedError, match=f"{value}.*A17"):
        check_runtime_flags(Args.parse_args(FNO_FLAGS + ["--matmul_precision", value]))
    with pytest.raises(ValueError, match=value):
        uses_tf32(value)


def test_the_tables_hold_every_value_jax_accepts():
    """Each value of the three tables is one that JAX's config takes, and JAX
    takes no other (its refusal lists them)."""
    import re

    import jax

    values = TF32_PRECISIONS + F32_PRECISIONS + REFUSED
    for value in values:
        with jax.default_matmul_precision(value):
            pass
    with pytest.raises(ValueError) as refusal:
        with jax.default_matmul_precision("no_such_precision"):
            pass
    listed = re.search(r"\[(.*?)\]", str(refusal.value)).group(1)
    assert set(re.findall(r"'(\w+)'", listed)) == set(values)


# --- the CPU: no effect, as in JAX ---------------------------------------------

def fno_inputs(rng, channels=2):
    mask = np.ones((B, H, W, 1), np.float32)
    mask[:, 4:8, 5:9] = 0
    return (torch.from_numpy(rng.standard_normal((B, H, W, channels)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, P)).astype(np.float32)),
            torch.from_numpy(mask))


def test_high_equals_highest_on_the_cpu(rng):
    """The port's FNO built for ``high`` and for ``highest`` from one seed:
    the same forward, bit for bit, and the registered operators' CPU
    kernels the same in either mode."""
    frame, cp, mask = fno_inputs(rng)
    outs = {}
    for value in ("high", "highest"):
        set_numerics(value)
        model = init_auto_model(Args.parse_args(FNO_FLAGS + ["--matmul_precision", value]),
                                n_case_params=P, field_shape=(H, W))
        with torch.inference_mode():
            outs[value] = model(frame, cp, mask)
    set_numerics()
    assert torch.equal(outs["high"], outs["highest"])
    block, head = kernel_case(rng, B, H, W, 8, 4)
    assert torch.equal(fk.fno_block_op(*block, True), fk.fno_block_op(*block, False))
    assert torch.equal(fk.fno_head_op(*head, True), fk.fno_head_op(*head, False))
    assert fk.launch_counts(tf32=True) == {"fno_block": 0, "fno_head": 0}


def test_fno_under_high_matches_jax_under_high(rng):
    import jax

    from cfdbench_tpu.config import Args as JaxArgs
    from cfdbench_tpu.models import init_auto_model as jax_init_auto_model
    from cfdbench_tpu_torch.utils.flax_import import params_from_flax

    argv = FNO_FLAGS + ["--matmul_precision", "high"]
    frame, cp, mask = fno_inputs(rng)
    jax_model = jax_init_auto_model(JaxArgs.parse_args(argv), n_case_params=P,
                                    field_shape=(H, W))
    with jax.default_matmul_precision("high"):
        params = jax_model.init(jax.random.PRNGKey(0), frame.numpy(), cp.numpy(),
                                mask.numpy())["params"]
        want = jax_model.apply({"params": params}, frame.numpy(), cp.numpy(), mask.numpy())
    model = init_auto_model(Args.parse_args(argv), n_case_params=P, field_shape=(H, W))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    assert model.tf32
    with torch.inference_mode():
        got = model(frame, cp, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# --- the TF32 plain versions -------------------------------------------------

def test_round_tf32_matches_numpy_emulation(rng):
    a = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-6, 6, 100_000)).astype(np.float32)
    # Ties: the 14th significand bit set and nothing below, either sign.
    ties = (rng.integers(1 << 10, 1 << 11, 64) * 2 + 1).astype(np.float64) * 2.0 ** -12
    a = np.concatenate([a, ties, -ties, [0.0, -0.0]]).astype(np.float32)
    got = fk.round_tf32(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np_tf32(a).astype(np.float32))
    np.testing.assert_array_equal(got, fk.tf32_split(a)[0])
    assert not (got.view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("H_,W_,C,modes", [(16, 16, 8, 4), (18, 17, 10, 12)])
def test_tf32_block_reference_matches_numpy_emulation(rng, H_, W_, C, modes):
    """The block's TF32 plain version against its products in float64, each
    operand rounded to TF32 by the numpy emulation, intermediates too."""
    block, _ = kernel_case(rng, 2, H_, W_, C, modes)
    x, w, w0, b0 = (a.double().numpy() for a in block[:4])
    m1, m2 = clamp_modes(H_, W_, modes, modes)
    e1r, e1i, e2r, e2i, ar, ai, br, bi = (np_tf32(f) for f in _dft_factors(H_, W_, m1, m2))
    xt = np_tf32(x)
    tr, ti = (np_tf32(np.einsum("bhwc,mw->bhmc", xt, e)) for e in (e2r, e2i))
    xr = np.einsum("kh,bhmc->bkmc", e1r, tr) - np.einsum("kh,bhmc->bkmc", e1i, ti)
    xi = np.einsum("kh,bhmc->bkmc", e1i, tr) + np.einsum("kh,bhmc->bkmc", e1r, ti)
    wk = np.concatenate([w[0, ..., :m1, :m2], w[1, ..., :m1, :m2]], -2)
    yr = np_tf32(np.einsum("bkmi,iokm->bkmo", xr, wk[0]) - np.einsum("bkmi,iokm->bkmo", xi, wk[1]))
    yi = np_tf32(np.einsum("bkmi,iokm->bkmo", xr, wk[1]) + np.einsum("bkmi,iokm->bkmo", xi, wk[0]))
    zr = np_tf32(np.einsum("hk,bkmo->bhmo", ar, yr) - np.einsum("hk,bkmo->bhmo", ai, yi))
    zi = np_tf32(np.einsum("hk,bkmo->bhmo", ai, yr) + np.einsum("hk,bkmo->bhmo", ar, yi))
    pre = (np.einsum("wm,bhmo->bhwo", br, zr) - np.einsum("wm,bhmo->bhwo", bi, zi)
           + xt @ np_tf32(w0).T + b0)
    want = 0.5 * pre * (1 + erf(pre / np.sqrt(2)))
    got = fk.fno_block_reference(*block, tf32=True).double().numpy()
    assert np.abs(got - want).max() <= BLOCK_RTOL * np.abs(want).max()
    xm, got_pre = fk.fno_block_saved_reference(*block, tf32=True)
    assert np.abs(got_pre.double().numpy() - pre).max() <= BLOCK_RTOL * np.abs(want).max()
    want_xm = np.stack([xr, xi], 1)
    assert np.abs(xm.double().numpy() - want_xm).max() <= XM_RTOL * np.abs(want_xm).max()
    f32 = fk.fno_block_reference(*block).double().numpy()
    assert np.abs(f32 - want).max() > RAN_TF32 * np.abs(want).max()


def test_tf32_head_reference_matches_numpy_emulation(rng):
    _, head = kernel_case(rng, 2, 16, 16, 8, 4)
    x, w1, b1, w2, b2, mask = (a.double().numpy() for a in head)
    h = np_tf32(x) @ np_tf32(w1).T + b1
    want = ((0.5 * h * (1 + erf(h / np.sqrt(2)))) @ w2.T + b2) * mask
    got = fk.fno_head_reference(*head, tf32=True).double().numpy()
    assert np.abs(got - want).max() <= HEAD_ATOL
    assert np.abs(fk.fno_head_reference(*head).double().numpy() - want).max() > 10 * HEAD_ATOL


# --- both kernels' TF32 mode, emulated on the CPU -----------------------------

def emulation():
    try:
        return _build.load_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))


def check_tf32_block(launch, block, xm_rtol=XM_RTOL):
    """A TF32 block launch's output, pre-activation and retained modes
    against the TF32 plain version, and its distance from the float32 one."""
    got, xm, pre = launch(*block)
    want = fk.fno_block_reference(*block, tf32=True)
    top = want.abs().max().item()
    want_xm, want_pre = fk.fno_block_saved_reference(*block, tf32=True)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= BLOCK_RTOL * top
    assert (pre - want_pre).abs().max().item() <= BLOCK_RTOL * top
    assert (xm - want_xm).abs().max().item() <= xm_rtol * want_xm.abs().max().item()
    assert (got - fk.fno_block_reference(*block)).abs().max().item() > RAN_TF32 * top


@pytest.mark.parametrize(
    "B_,H_,W_,C,modes,n_out",
    [
        (2, 16, 16, 8, 4, 2),   # the resident passes, modes clamped
        (1, 8, 136, 8, 4, 2),   # three column chunks of the forward pass, E2 streamed
        # width 128: channel tiles, the inverse-columns pass tiled, the head streamed
        (1, 4, 80, 128, 12, 2),
        (1, 5, 73, 20, 3, 9),   # odd sizes, 4-byte copies, 9 outputs in two head launches
    ],
)
def test_tf32_kernels_match_plain_in_emulation(rng, B_, H_, W_, C, modes, n_out):
    lib = emulation()
    block, head = kernel_case(rng, B_, H_, W_, C, modes, n_out)
    check_tf32_block(lambda *a: fk._block_call(lib, *a, stream=0, keep=True, tf32=True), block)
    got = fk._head_call(lib, *head, stream=0, tf32=True)
    assert (got - fk.fno_head_reference(*head, tf32=True)).abs().max().item() <= HEAD_ATOL
    assert (got - fk.fno_head_reference(*head)).abs().max().item() > 10 * HEAD_ATOL


def test_tf32_split_block_matches_the_whole_in_emulation(rng):
    """The TF32 halves around the spectrum's row sum, as spatial sharding runs
    them, at two ranks' 32 of 64 rows, against the whole TF32 plain block."""
    lib = emulation()
    block, _ = kernel_case(rng, 1, 64, 20, 32, 4)
    x, w, w0, b0, m, _ = block

    def split(*_):
        halves = [x[:, :32].contiguous(), x[:, 32:].contiguous()]
        xm = sum(fk._block_spectrum(lib, r, m, m, 0, (a, 64), tf32=True)
                 for r, a in zip(halves, (0, 32)))
        outs = [fk._block_finish(lib, r, xm, w, w0, b0, m, m, 0, True, (a, 64), tf32=True)
                for r, a in zip(halves, (0, 32))]
        return torch.cat([o for o, _ in outs], 1), xm, torch.cat([p for _, p in outs], 1)

    check_tf32_block(split, block)


def test_library_refuses_other_product_counts():
    """1 (TF32) and 3 (split TF32) products a tile, nothing else."""
    assert (fk.products(True), fk.products(False)) == (1, 3)
    lib = emulation()
    x = torch.zeros((1, 8, 8, 8))
    xm = torch.empty((1, 2, 8, 4, 8))
    tables = fk._block_plan(lib, x, 4, 4, None)[2]
    for products in (0, 2):
        assert lib.fno_block_spectrum(x.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
                                      xm.data_ptr(), 1, 8, 8, 8, 4, 4, products, None) != 0
    with pytest.raises(ValueError, match="float32"):
        fk.round_tf32(torch.zeros(2, dtype=torch.float64))


# --- serving -----------------------------------------------------------------

@pytest.mark.parametrize("value", ["high", "highest"])
def test_export_under_high_carries_the_tf32_mode(tmp_path, value):
    from cfdbench_tpu_torch.cli import make_auto_task
    from cfdbench_tpu_torch.utils.export import export_predict, load_exported

    args = Args.parse_args(FNO_FLAGS + ["--matmul_precision", value])
    task = make_auto_task(args, P, (H, W), "cpu")
    export_predict(task, tmp_path / "p.pt2", B, H, W, P, device="cpu")
    graph = load_exported(tmp_path / "p.pt2").program.graph
    ops = {torch.ops.cfdbench_tpu_torch.fno_block.default: 2,
           torch.ops.cfdbench_tpu_torch.fno_head.default: 1}
    for op, count in ops.items():
        nodes = [n for n in graph.nodes if n.target == op]
        assert len(nodes) == count
        # The mode is the operator's last argument (left out at its default).
        modes = [n.args[len(n.args) - 1] if len(n.args) == len(op._schema.arguments) else False
                 for n in nodes]
        assert modes == [value == "high"] * count, nodes


# --- on the card ----------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B_,H_,W_,C,modes", [(4, 64, 64, 32, 12), (2, 66, 65, 10, 4),
                                              (2, 8, 136, 128, 12)])
def test_tf32_kernels_match_plain_on_card(cuda_device, rng, B_, H_, W_, C, modes):
    set_numerics("high")  # the plain versions hold cuBLAS to float32 themselves
    try:
        block, head = kernel_case(rng, B_, H_, W_, C, modes)
        block = tuple(a.to(cuda_device) if torch.is_tensor(a) else a for a in block)
        head = tuple(a.to(cuda_device) for a in head)
        lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
        check_tf32_block(lambda *a: fk._block_call(lib, *a, stream, keep=True, tf32=True), block)
        got = fk.fno_head(*head, tf32=True)
        assert (got - fk.fno_head_reference(*head, tf32=True)).abs().max().item() <= HEAD_ATOL
    finally:
        set_numerics()


@pytest.mark.cuda
def test_fno_under_high_runs_the_tf32_kernels_on_card(cuda_device, rng):
    """An FNO built for ``high`` launches both kernels in TF32 mode, forward
    and under grad, and its output lies within TF32's reach of the float32
    plain forward."""
    frame, cp, mask = (a.to(cuda_device) for a in fno_inputs(rng))
    model = Fno2d(n_case_params=P, num_layers=2, modes1=4, modes2=4, hidden_dim=8, tf32=True,
                  generator=torch.Generator().manual_seed(0), device=cuda_device)
    set_numerics("high")
    try:
        fk.reset_launch_counts()
        with torch.inference_mode():
            got = model(frame, cp, mask)
        model(frame, cp, mask).square().mean().backward()
        assert fk.launch_counts() == fk.launch_counts(tf32=True) == {"fno_block": 4,
                                                                     "fno_head": 2}
        set_numerics()
        from cfdbench_tpu_torch.models.fno import fno2d_reference
        with torch.inference_mode():
            want = fno2d_reference(model, frame, cp, mask)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert 1e-6 < rel < 1e-2
    finally:
        set_numerics()
