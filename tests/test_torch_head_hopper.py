"""The FNO head kernel's Hopper route against the plain version.

``csrc/fno_head.cu`` runs the head on Hopper's machinery where the shape
allows (``fno_head_route``): fc1 on ``wgmma`` fed by TMA through an
``mbarrier`` ring, three consumer warpgroups taking turns on the tensor
cores while the others run the GELU and fc2 epilogue, w1 split once a block
or, past 128 channels, once a call into scratch and streamed beside x. On
the CPU these tests run that route through the kernels' emulation
(``csrc/emulate/emu.h``: the products read through the descriptors' layout,
TMA boxes with the card's swizzle and zero fill, barriers with a phase,
named barriers), in both product modes; one case holds it to the JAX
package's Pallas head in interpret mode; and the ``cuda``-marked test runs
the flagship shape and width 256 on the card:

    python -m pytest tests/test_torch_head_hopper.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from cfdbench_tpu_torch.ops import _build
from cfdbench_tpu_torch.ops import fno_kernels as fk

torch.set_num_threads(1)

HEAD_ATOL = 1e-5  # float32 against the plain version; TF32 against the TF32 plain version
HOPPER, STREAMED = fk.HEAD_HOPPER, fk.HEAD_HOPPER | fk.HEAD_STREAMED


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


def head_inputs(B, H, W, C, hidden=128, n_out=2, b2_zero=False, seed=0, device="cpu"):
    """x, w1, b1, w2, b2 and a mask with a zero block, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C))
    w1 = rng.standard_normal((hidden, C)) / np.sqrt(C)
    b1 = rng.standard_normal(hidden) * 0.1
    w2 = rng.standard_normal((n_out, hidden)) / np.sqrt(128)
    b2 = np.zeros(n_out) if b2_zero else rng.standard_normal(n_out) * 0.1
    mask = np.ones((B, H, W, 1))
    mask[:, H // 3:H // 2 + 1, W // 4:W // 2 + 1] = 0
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (x, w1, b1, w2, b2, mask))


def check(got, head, tf32):
    """The head's output against the plain version of its mode (the TF32
    mode also further than 10 HEAD_ATOL from float32)."""
    want = fk.fno_head_reference(*head, tf32=tf32)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= HEAD_ATOL
    if tf32:
        assert (got - fk.fno_head_reference(*head)).abs().max().item() > 10 * HEAD_ATOL


@pytest.mark.parametrize("tf32", [False, True], ids=["split_tf32", "tf32"])
@pytest.mark.parametrize(
    "shape,kw,route",
    [
        ((1, 8, 16, 32), {}, HOPPER),                    # two tiles
        ((1, 5, 7, 32), {}, HOPPER),                     # one ragged tile
        ((2, 16, 16, 32), {}, HOPPER),                   # 8 tiles: every warpgroup's turn, twice
        ((1, 8, 16, 64), {}, HOPPER),                    # two channel units a tile
        ((1, 8, 16, 160), {}, STREAMED),                 # w1's planes streamed, 5 units a tile
        ((1, 8, 16, 32), dict(n_out=9), HOPPER),         # two launches, 8 and 1 outputs
        ((1, 8, 16, 32), dict(hidden=64), HOPPER),       # the row-parallel head's widths,
        ((1, 8, 16, 32), dict(hidden=32, b2_zero=True), HOPPER),  # b2 zeros off rank 0
    ],
    ids=["two_tiles", "ragged", "eight_tiles", "C64", "C160_streamed", "nine_outputs",
         "hidden64", "hidden32_b2_zero"],
)
def test_hopper_head_matches_plain_in_emulation(shape, kw, route, tf32):
    lib = emulation()
    head = head_inputs(*shape, **kw)
    C, hidden, n_out = shape[3], head[1].shape[0], head[3].shape[0]
    assert fk.head_route(lib, C, hidden, n_out) == route
    check(fk._head_call(lib, *head, stream=0, tf32=tf32), head, tf32)


def test_head_route_is_chosen_by_shape():
    lib = emulation()
    route = lib.fno_head_route
    assert route(32, 128, 2) == HOPPER      # the flagship
    assert route(32, 64, 2) == HOPPER       # the row-parallel head
    assert route(8, 128, 2) == HOPPER       # phase 2's 8 channels: zeros past C in the box
    assert route(128, 128, 2) == HOPPER     # w1's planes still fit beside the ring
    assert route(160, 128, 2) == STREAMED   # they no longer do
    assert route(256, 128, 2) == STREAMED   # width 256
    assert route(10, 128, 3) == 0           # no 16-byte TMA strides
    assert route(6, 128, 2) == 0
    assert route(198, 128, 3) == fk.HEAD_STREAMED  # the sm_80 route, w1 streamed
    assert route(0, 128, 2) == -1
    assert fk.head_route(lib, 32, 128, 2) == HOPPER
    with pytest.raises(ValueError, match="no route"):
        fk.head_route(lib, 32, 0, 2)
    assert fk.head_route_kernels(HOPPER) == ("fno_head_hopper_kernel",)
    assert fk.head_route_kernels(STREAMED) == ("fno_head_split_kernel", "fno_head_hopper_kernel")
    assert fk.head_route_kernels(0) == ("fno_head_kernel",)
    assert fk.head_route_kernels(fk.HEAD_STREAMED) == ("fno_head_streamed_kernel",)
    assert "wgmma" in fk.head_route_name(HOPPER)
    assert "mma.sync" in fk.head_route_name(0)


def test_streamed_route_takes_scratch_for_w1_planes():
    """The split planes: 2 halves x 32 channels x 128 hidden units a unit,
    units of (128 hidden units, 32 channels); only the streamed route."""
    lib = emulation()
    assert lib.fno_head_scratch(256, 128, 1) == 8 * 2 * 32 * 128
    assert lib.fno_head_scratch(160, 200, 1) == 5 * 2 * 2 * 32 * 128
    assert lib.fno_head_scratch(32, 128, 1) == 0
    assert lib.fno_head_scratch(256, 128, 0) == 0
    assert fk._head_plan(lib, 256, 128, 2) == (STREAMED, 8 * 2 * 32 * 128)


@pytest.mark.parametrize("tf32", [False, True], ids=["split_tf32", "tf32"])
def test_old_route_still_runs_where_the_hopper_route_is_taken(tf32):
    """``route=0`` runs the ``mma.sync`` kernels at a Hopper shape (what
    scripts/bench_torch_kernels.py times beside the new route)."""
    lib = emulation()
    head = head_inputs(1, 8, 16, 32)
    assert fk._head_plan(lib, 32, 128, 2, 0) == (0, 0)
    check(fk._head_call(lib, *head, stream=0, tf32=tf32, route=0), head, tf32)


def test_old_streamed_kernel_in_tf32_mode():
    """C not a multiple of 4 and past the resident kernel's shared memory:
    ``fno_head_streamed_kernel``, one TF32 product a k-step."""
    lib = emulation()
    head = head_inputs(1, 4, 8, 198, n_out=3)
    assert fk.head_route(lib, 198, 128, 3) == fk.HEAD_STREAMED
    check(fk._head_call(lib, *head, stream=0, tf32=True), head, True)


@pytest.mark.parametrize("C", [32, 160, 198])
def test_forward_entry_takes_every_width_without_scratch(C):
    """``fno_head_forward`` (no scratch argument) runs the Hopper route where
    it needs no scratch and the ``mma.sync`` route at the widths where the
    Hopper route would stream w1's planes (C 160) or cannot run (C 198)."""
    lib = emulation()
    head = head_inputs(1, 4, 8, C)
    out = torch.empty((1, 4, 8, 2))
    assert lib.fno_head_forward(*(t.data_ptr() for t in head), out.data_ptr(), 32, C, 128, 2,
                                fk.products(False), None) == 0
    check(out, head, False)


def test_hopper_head_refuses_x_off_16_bytes():
    lib = emulation()
    x, *rest = head_inputs(1, 8, 16, 32)
    flat = torch.zeros(x.numel() + 1)
    shifted = flat[1:].view(x.shape)  # contiguous, 4 bytes past an aligned start
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fk._head_call(lib, shifted, *rest, stream=0)


def test_hopper_head_matches_pallas_head_in_emulation():
    """The JAX package's Pallas head in interpret mode and the Hopper route
    on the same numpy-seeded inputs, the weights carried across (``w1`` is
    ``k1ᵀ``, ``w2`` is ``k2ᵀ``); 2e-6, the JAX package's own bound for this
    kernel against XLA."""
    import jax.numpy as jnp

    from cfdbench_tpu.ops.pallas_fno import fused_fno_head

    lib = emulation()
    rng = np.random.default_rng(3)
    B, H, W, C = 1, 16, 16, 32
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k1 = (rng.standard_normal((C, 128)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(128) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((128, 2)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(2) * 0.1).astype(np.float32)
    m = np.ones((B, H, W, 1), np.float32)
    m[:, 2:4] = 0
    want = fused_fno_head(*map(jnp.asarray, (x, k1, b1, k2, b2, m)), interpret=True)
    t = torch.from_numpy
    assert fk.head_route(lib, C, 128, 2) == HOPPER
    got = fk._head_call(lib, t(x), t(np.ascontiguousarray(k1.T)), t(b1),
                        t(np.ascontiguousarray(k2.T)), t(b2), t(m), stream=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True], ids=["split_tf32", "tf32"])
@pytest.mark.parametrize("C,route", [(32, HOPPER), (256, STREAMED), (198, fk.HEAD_STREAMED)],
                         ids=["flagship", "width256", "sm80_streamed"])
def test_head_on_card(cuda_device, C, route, tf32):
    from cfdbench_tpu_torch.utils.device import set_numerics

    set_numerics()
    lib = _build.load_library()
    head = head_inputs(128, 64, 64, C, device=cuda_device)
    assert fk.head_route(lib, C, 128, 2) == route
    got = fk._head_call(lib, *head, torch.cuda.current_stream().cuda_stream, tf32)
    torch.cuda.synchronize()
    check(got, head, tf32)
