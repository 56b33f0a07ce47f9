"""Reference CFDBench checkpoints imported into the port
(``utils/torch_import.py``, ``scripts/import_reference_checkpoint_torch.py``).

Every golden fixture the JAX package's importer is tested on
(``tests/test_torch_import.py``) becomes a reference ``state_dict``
through that file's inverse helpers; the port imports it and its forward
gives the fixture's reference outputs within 2e-5. The script writes a
``ckpt-{ep}/`` that the port's ``main_multistep`` rolls out as it does
the same weights in the port's own layout.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models.fno import Fno2d
from cfdbench_tpu_torch.training import checkpoints
from cfdbench_tpu_torch.utils.flax_import import params_from_flax
from cfdbench_tpu_torch.utils.torch_import import (
    import_state_dict,
    to_reference,
    verify_state_dict,
)
from tests.test_torch_import import CASES, fno_state_dict, load_tree, resnet_state_dict
from tests.test_torch_models import port_model
from tests.test_torch_nonauto import both_models as nonauto_models

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
ATOL = 2e-5  # f32 forward parity, the JAX package's own golden bound
FNO_FLAGS = ["--fno_depth", "2", "--fno_hidden_dim", "8", "--fno_modes_x", "4",
             "--fno_modes_y", "4"]
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def golden_port_model(model_name: str, fixture: str, field_shape):
    """The port model of a golden fixture's configuration."""
    if model_name == "fno":
        return Fno2d(in_chan=2, out_chan=2, n_case_params=5, num_layers=2, modes1=4,
                     modes2=4, hidden_dim=8, generator=torch.Generator().manual_seed(0))
    if model_name in ("ffn", "deeponet"):
        return nonauto_models(model_name, ["--act_scale_invariant", "1"])[0]
    return port_model(fixture[:-len(".npz")], field_shape, None)


@pytest.mark.parametrize("model_name,fixture,inverse", CASES,
                         ids=[c[1][:-len(".npz")] for c in CASES])
def test_imported_reference_checkpoint_gives_the_reference_outputs(model_name, fixture,
                                                                     inverse):
    data = dict(np.load(GOLDEN / fixture))
    reference = inverse(load_tree(GOLDEN / fixture))
    sd = import_state_dict(model_name, reference)
    field = data["input"].shape[1:3] if "input" in data else None
    model = golden_port_model(model_name, fixture, field)
    verify_state_dict(sd, model.state_dict())
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        if model_name in ("ffn", "deeponet"):
            got = model(t(data["case_params"]), t(data["t"]), t(data["query_xy"]))
        else:
            got = model(t(data["input"]), t(data["case_params"]), t(data["mask"]))
    got = got.numpy().reshape(data["expected"].shape)  # point models give (B, H*W)
    np.testing.assert_allclose(got, data["expected"], rtol=0, atol=ATOL)


def test_fno_relayout_round_trips():
    """The port's FNO state dict in the reference's layout is what the
    JAX package's tests build from the same golden tree, and imports back
    bit for bit."""
    tree = load_tree(GOLDEN / "fno.npz")
    port = params_from_flax(tree["params"])
    reference = to_reference("fno", port)
    want = fno_state_dict(tree)
    assert sorted(reference) == sorted(want)
    for k, v in want.items():
        assert reference[k].shape == v.shape and reference[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(reference[k].numpy(), v, err_msg=k)
    back = import_state_dict("fno", reference)
    assert sorted(back) == sorted(port)
    for k in port:
        assert torch.equal(back[k], port[k]), k


def test_resnet_import_drops_the_batch_norms_the_reference_never_calls():
    tree = load_tree(GOLDEN / "resnet.npz")
    reference = resnet_state_dict(tree)
    for name in ("blocks.0.bn1", "blocks.1.bn2"):
        reference.update({f"{name}.weight": np.ones(8, np.float32),
                          f"{name}.bias": np.zeros(8, np.float32),
                          f"{name}.running_mean": np.zeros(8, np.float32),
                          f"{name}.running_var": np.ones(8, np.float32),
                          f"{name}.num_batches_tracked": np.array(3)})
    sd = import_state_dict("resnet", reference)
    assert not any(".bn" in k for k in sd)
    verify_state_dict(sd, golden_port_model("resnet", "resnet.npz", (16, 16)).state_dict())


def test_verify_names_every_mismatched_key():
    model = golden_port_model("fno", "fno.npz", None)
    sd = import_state_dict("fno", fno_state_dict(load_tree(GOLDEN / "fno.npz")))
    sd["fc0.weight"] = torch.zeros(3, 3)
    del sd["blocks.1.weights"]
    sd["blocks.7.w0.bias"] = torch.zeros(8)
    with pytest.raises(ValueError, match="does not match the model") as e:
        verify_state_dict(sd, model.state_dict())
    msg = str(e.value)
    assert "shape mismatch at fc0.weight: imported (3, 3) vs model (8, 10)" in msg
    assert "missing in import: blocks.1.weights (2, 2, 8, 8, 4, 4)" in msg
    assert "unexpected in import: blocks.7.w0.bias (8,)" in msg
    with pytest.raises(ValueError, match="no reference importer for model 'gencast'"):
        import_state_dict("gencast", {})


def test_load_params_refuses_a_reference_fno_checkpoint(tmp_path):
    reference = {k: torch.from_numpy(v)
                 for k, v in fno_state_dict(load_tree(GOLDEN / "fno.npz")).items()}
    torch.save(reference, tmp_path / "model.pt")
    with pytest.raises(ValueError, match="scripts/import_reference_checkpoint_torch.py") as e:
        checkpoints.load_params(tmp_path)
    assert "blocks.0.conv0.weights1" in str(e.value)


@pytest.fixture()
def import_script():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import import_reference_checkpoint_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return import_reference_checkpoint_torch.main


def test_import_script_then_main_multistep(tmp_path, import_script):
    """A reference FNO checkpoint through the script into a result tree;
    main_multistep on it gives the per-step metrics of the same weights
    saved in the port's own layout. Wrong flags name the mismatch; a stub
    that would outrank scored checkpoints is refused before any write."""
    from cfdbench_tpu_torch.cli import main_multistep, run_dir
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    generate_problem(tmp_path / "data", "cavity", cases_per_subset=4, num_frames=12, grid=16,
                     seed=0)
    tree = load_tree(GOLDEN / "fno.npz")
    src = tmp_path / "ref" / "ckpt-7"
    src.mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in fno_state_dict(tree).items()},
               src / "model.pt")
    model_flags = ["--model", "fno", "--data_name", "cavity_prop_bc_geo", "--data_dir",
                   str(tmp_path / "data")] + FNO_FLAGS
    imported = model_flags + ["--output_dir", str(tmp_path / "imported")]
    native = model_flags + ["--output_dir", str(tmp_path / "native")]

    ckpt = import_script(["--torch_ckpt", str(src / "model.pt")] + imported)
    assert ckpt == run_dir(Args.parse_args(imported)) / "ckpt-7"
    assert json.loads((ckpt / "scores.json").read_text())["dev_loss"] == 0.0
    checkpoints.save_checkpoint(params_from_flax(tree["params"]),
                                run_dir(Args.parse_args(native)) / "ckpt-0", ep=0, dev_loss=0.0)
    runs = {}
    for name, argv in (("imported", imported), ("native", native)):
        main_multistep(argv, device="cpu")
        runs[name] = json.loads(
            (run_dir(Args.parse_args(argv)) / "multistep_metrics.json").read_text())
    assert len(runs["imported"]) == 20
    assert all(math.isfinite(v) for m in runs["imported"] for v in m.values())
    assert runs["imported"] == runs["native"]

    deeper = ["--torch_ckpt", str(src / "model.pt")] + imported + ["--fno_depth", "3"]
    with pytest.raises(ValueError, match="missing in import: blocks.2.weights"):
        import_script(deeper)
    local = ckpt.parent / "ckpt-3"
    local.mkdir()
    (local / "scores.json").write_text(json.dumps(dict(ep=3, train_loss=0.1, dev_loss=0.05,
                                                       time=1.0)))
    with pytest.raises(SystemExit, match="--force"):
        import_script(["--torch_ckpt", str(src / "model.pt"), "--as_epoch", "3"] + imported)
    assert sorted(p.name for p in local.iterdir()) == ["scores.json"]
