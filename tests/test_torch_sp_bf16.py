"""Spatial sharding under ``--use_mixed_precision`` and with
``--pp_microbatches`` (``--shard_spatial 1``), on gloo ranks spawned as
``tests/_torch_dp_worker.py`` spawns them.

- The bfloat16 train step (``models/common.py::cast_call`` on a rank's rows)
  of the FNO, the FFNO, the U-Net and the ResNet at ``1x2`` and ``2x2``,
  from one set of weights, against the port's one-process bfloat16 step and
  against JAX's bfloat16 step, spatial (``batch_sharding_spatial`` on
  ``make_mesh("1x2")``) and on one device, within the model axis's bfloat16
  gates: the loss rel 1e-3, the train forward 3e-2 of its largest value
  (PERF.md §2). Each rank rounds its own partial sums to bfloat16, one
  process its sums over all rows. That bfloat16 ran shows in the forward's
  dtype (the FNO's, the U-Net's and the ResNet's; the FFNO's spectral convs
  return float32, as JAX's do) and in the forward off the float32 one by more
  than 1e-3 of its largest value.
- The FNO under ``--pp_microbatches 2 --shard_spatial 1`` at ``1x2``: every
  stage runs whole rows, as JAX's pipeline takes its batch as ``P(data)``,
  so the step equals pp alone bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdbench_tpu.models.ffno import Ffno2d as JaxFfno2d
from cfdbench_tpu.models.fno import Fno2d as JaxFno2d
from cfdbench_tpu.models.resnet import ResNet as JaxResNet
from cfdbench_tpu.models.unet import UNet as JaxUNet
from cfdbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cfdbench_tpu_torch.parallel.mesh import make_mesh
from tests import _torch_dp_worker as worker
from tests.test_torch_sp_point import jax_step, spawn_meshes, step_case

torch.set_num_threads(1)

BF16_LOSS_RTOL = 1e-3
BF16_FRAME_RTOL = 3e-2  # of the largest |value| of the forward
RAN_BF16 = 1e-3  # the bfloat16 forward off the float32 one, of its largest value
MESHES = ("1x2", "2x2")
FNO = dict(num_layers=2, hidden_dim=8, modes1=4, modes2=4)
MODELS = {
    "fno": (FNO, 16, JaxFno2d),
    "ffno": (FNO, 16, JaxFfno2d),
    "unet": (dict(dim=4), 32, JaxUNet),
    "resnet": (dict(hidden_chan=8, num_blocks=1), 16, JaxResNet),
}
BF16_OUTPUT = {"fno", "unet", "resnet"}


@pytest.fixture(scope="module")
def bf16_steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {name: step_case(name, widths, grid, rng, dropout=0.0,
                             compute_dtype=torch.bfloat16)
             for name, (widths, grid, _) in MODELS.items()}
    ranks = spawn_meshes(cases, tmp_path_factory.mktemp("sp_bf16"))
    one = make_mesh("1")
    float32 = {name: worker.split_step({k: v for k, v in case.items() if k != "compute_dtype"},
                                       one) for name, case in cases.items()}
    jax_mesh = jax_make_mesh("1x2", tune_spectral=False)
    refs = {}
    for name, (widths, _, cls) in MODELS.items():
        model = cls(in_chan=2, out_chan=2, n_case_params=5, **widths)
        train = name != "resnet"  # the ResNet has no norm: train=False is it without dropout
        refs[name] = {ref: jax_step(cases[name], model, mesh, train, jnp.bfloat16)
                      for ref, mesh in (("one device", None), ("spatial 1x2", jax_mesh))}
    return ranks, float32, refs


def frame_err(got, want) -> float:
    w = want.float()
    return (got.float() - w).abs().max().item() / w.abs().max().item()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_sp_bf16_step_matches_one_process_and_jax(bf16_steps, name, mesh):
    """The bfloat16 step on ``mesh``'s ranks against the port's one-process
    bfloat16 step and JAX's two: the loss and the train forward."""
    ranks, float32, refs = bf16_steps
    one = ranks["1"][0][name]
    wants = {"one process": (one["scores"][0]["nmse"], one["preds"])}
    wants.update({ref: (r["loss"], r["preds"]) for ref, r in refs[name].items()})
    for r, result in enumerate(ranks[mesh]):
        got = result[name]
        assert (got["preds"].dtype == torch.bfloat16) == (name in BF16_OUTPUT), (name, mesh)
        assert frame_err(got["preds"], float32[name]["preds"]) > RAN_BF16, (name, mesh)
        for ref, (loss, preds) in wants.items():
            what = (name, mesh, ref, r)
            assert math.isclose(got["scores"][0]["nmse"], loss, rel_tol=BF16_LOSS_RTOL), what
            assert got["preds"].shape == preds.shape, what
            assert frame_err(got["preds"], preds) <= BF16_FRAME_RTOL, what
        for k, v in got["params"].items():
            assert torch.equal(v, ranks[mesh][0][name]["params"][k]), (name, mesh, k)


@pytest.fixture(scope="module")
def pp_steps(tmp_path_factory):
    rng = np.random.default_rng(1)
    pp_sp = step_case("fno", FNO, 16, rng, pp=2)
    cases = {"pp": dict(pp_sp, spatial=False), "pp_sp": pp_sp}
    return worker.spawn(dict(kind="split_steps", mesh="1x2", cases=cases),
                        tmp_path_factory.mktemp("sp_pp"), world=2)


def test_sp_with_pp_equals_pp(pp_steps):
    """``--pp_microbatches 2`` with and without ``--shard_spatial 1`` at
    ``1x2``: the scores, the predictions, the gradients and the parameters
    after the step, bit for bit on every rank."""
    for r, result in enumerate(pp_steps):
        got, want = result["pp_sp"], result["pp"]
        assert got["scores"] == want["scores"], r
        assert torch.equal(got["preds"], want["preds"]), r
        for part in ("grads", "params"):
            assert got[part].keys() == want[part].keys()
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), (r, part, k)
