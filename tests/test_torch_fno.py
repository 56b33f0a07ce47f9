"""The PyTorch port's FNO pieces against the JAX package on the same
numpy-seeded inputs and weights: spectral conv, both kernels' plain
versions (against the Pallas kernels in interpret mode), the whole
``Fno2d`` (against the golden torch-reference outputs and live JAX), and
the weight mapping between the two packages. The kernels themselves run
only on a CUDA card (``tests/test_torch_kernels.py``)."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.ops.pallas_fno import fused_fno_block, fused_fno_head
from cfdbench_tpu.ops.spectral import spectral_conv2d_fft as jax_spectral_fft
from cfdbench_tpu_torch.models.fno import Fno2d, fno2d_reference
from cfdbench_tpu_torch.ops import fno_kernels as fk
from cfdbench_tpu_torch.ops.spectral import spectral_conv2d_fft
from cfdbench_tpu_torch.utils.flax_import import params_from_flax, params_to_flax
from tests._golden import trees_from_flat
from tests.test_torch_kernels import block_inputs, t

# Small shapes on a few shared cores, in several test workers: one
# thread a worker keeps torch's parallel regions from waiting on each
# other's descheduled threads.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
ATOL = 2e-5  # f32 forward parity, the JAX package's own golden bound


@pytest.mark.parametrize(
    "H,W,modes",
    [
        (16, 16, 4),   # no Nyquist column retained
        (16, 16, 12),  # clamps to m1=8, m2=9: Nyquist kept, corners meet
        (18, 17, 4),   # odd W
    ],
)
def test_spectral_conv_matches_jax(rng, H, W, modes):
    x, w, _, _ = block_inputs(rng, 2, H, W, 8, modes)
    want = jax_spectral_fft(jnp.asarray(x), jnp.asarray(w), modes, modes)
    got = spectral_conv2d_fft(t(x), t(w), modes, modes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("H,W", [(16, 16), (18, 17)])
def test_fno_block_reference_matches_pallas_block(rng, H, W):
    x, w, k0, b0 = block_inputs(rng, 2, H, W, 8, 4)
    want = fused_fno_block(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(k0), jnp.asarray(b0),
        modes1=4, modes2=4, interpret=True,
    )
    # The port's wrapper on CPU tensors is its plain version.
    got = fk.fno_block(t(x), t(w), t(k0.T), t(b0), 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fno_head_reference_matches_pallas_head(rng):
    B, H, W, C = 2, 16, 16, 8
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k1 = (rng.standard_normal((C, 128)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(128) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((128, 2)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(2) * 0.1).astype(np.float32)
    m = np.ones((B, H, W, 1), np.float32)
    m[:, 2:4] = 0
    want = fused_fno_head(*map(jnp.asarray, (x, k1, b1, k2, b2, m)), interpret=True)
    got = fk.fno_head(t(x), t(k1.T), t(b1), t(k2.T), t(b2), t(m))
    # 2e-6: the JAX package's own bound for this kernel against XLA.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def golden_fno():
    data = dict(np.load(GOLDEN / "fno.npz"))
    params = trees_from_flat(data, ["P"])["P"]
    return params, data


def small_fno(params):
    model = Fno2d(in_chan=2, out_chan=2, n_case_params=5, num_layers=2,
                  modes1=4, modes2=4, hidden_dim=8,
                  generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(params))
    return model.eval()


def test_fno2d_matches_golden_and_live_jax():
    params, data = golden_fno()
    model = small_fno(params)
    with torch.inference_mode():
        got = model(t(data["input"]), t(data["case_params"]), t(data["mask"]))
    np.testing.assert_allclose(got.numpy(), data["expected"], atol=ATOL)

    jax_model = JaxFno2d(in_chan=2, out_chan=2, n_case_params=5, num_layers=2,
                         modes1=4, modes2=4, hidden_dim=8)
    want = jax_model.apply({"params": params}, data["input"],
                           data["case_params"], data["mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_params_round_trip():
    params, _ = golden_fno()
    back = params_to_flax(params_from_flax(params))
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_fno2d_reference_matches_golden():
    params, data = golden_fno()
    with torch.inference_mode():
        got = fno2d_reference(small_fno(params), t(data["input"]),
                              t(data["case_params"]), t(data["mask"]))
    np.testing.assert_allclose(got.numpy(), data["expected"], atol=ATOL)


PORT_SCRIPTS = ("chip_smoke.py", "test_multistep_torch.py", "train_auto_torch.py",
                "train_torch.py", "train_gencast_torch.py", "scripts/profile_torch_rollout.py",
                "scripts/bench_torch_kernels.py")
# Modules the walk below must find, so that it cannot pass by finding none.
PORT_MODULES = ("data.datasets", "data.pipeline", "metrics", "training.optim",
                "training.trainer_auto", "training.trainer_nonauto", "training.checkpoints",
                "models.unet", "models.resnet", "models.point", "models.nonauto",
                "models.ffno", "utils.flax_import", "models.punetg", "models.diffusion",
                "ops.diffusion", "training.trainer_gencast", "data.wrapper", "utils.rng")
JAX_ROOTS = {"jax", "flax", "optax", "orbax", "cfdbench_tpu"}


def import_statements(path: Path):
    """Every import statement in a file, at any depth, with the top-level
    name of each module it imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield node, [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, [node.module.split(".")[0]]


def test_port_imports_no_jax():
    # The port's scripts import only the port, never the JAX package
    # itself; and once every module of the port and chip_smoke are
    # imported, neither jax nor any module of the JAX package is loaded.
    port_imports = []
    for script in PORT_SCRIPTS:
        for node, roots in import_statements(REPO / script):
            assert not JAX_ROOTS & set(roots), (script, ast.unparse(node))
            if "cfdbench_tpu_torch" in roots:
                port_imports.append(ast.unparse(node))
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "import cfdbench_tpu_torch, chip_smoke",
        "mods = [m.name for m in pkgutil.walk_packages(",
        "    cfdbench_tpu_torch.__path__, 'cfdbench_tpu_torch.')]",
        f"assert not {set('cfdbench_tpu_torch.' + m for m in PORT_MODULES)} - set(mods), mods",
        "for m in mods:",
        "    importlib.import_module(m)",
        *port_imports,
        "roots = ('jax', 'flax', 'optax', 'orbax', 'cfdbench_tpu')",
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]",
        "assert not bad, bad",
    ])
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
