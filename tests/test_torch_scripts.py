"""The port's counterparts of the JAX package's data and VAE scripts
(``scripts/*_torch.py``, importing only ``cfdbench_tpu_torch``) against the
JAX scripts on the same synthetic tree: ``check_dataset``'s and
``locate_cylinder``'s reports equal (the read timings and the JAX script's
timings aside, their keys compared), defects included; ``get_stats`` within 1e-6,
its printed figures the JAX script's to their rounding and its float32 sums;
``plot_mask_overlay``'s file written; ``vae_diagnostics``' per-dimension KL
and latent statistics within 1e-5 on the same weights (carried to flax by
``utils/flax_import.py``), and its ``main`` on a ``main_vae``-style weights
directory."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cfdbench_tpu.config import Args as JaxArgs
from cfdbench_tpu.data import get_auto_dataset as jax_get_auto_dataset
from cfdbench_tpu.data.vae_data import build_vae_dataset as jax_build_vae_dataset
from cfdbench_tpu.models.vae import make_cfd_vae as jax_make_cfd_vae
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.models.vae import make_cfd_vae
from cfdbench_tpu_torch.training.checkpoints import save_params
from cfdbench_tpu_torch.utils.flax_import import params_to_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# Keys of check_dataset's report that measure this machine's reads: both
# reports must hold them, their values are not compared.
UNCOMPARED = {"read_mb_s_numpy", "est_full_read_s_numpy", "read_mb_s_native",
              "est_full_read_s_native"}
STATS_ATOL = 1e-6
# One unit of the fourth decimal that get_stats prints, and float32's rounding
# of it.
PRINTED_ATOL = 1e-4 + 1e-9
DIAG_ATOL = 1e-5
DIAGNOSTIC_FILES = ("latent_embedding.png", "latent_histograms.png", "latent_traversals.png",
                    "reconstructions.png", "latent_interpolation.png", "diagnostics.json",
                    "diagnostics.npz")


def run_script(*args):
    return subprocess.run([sys.executable, *map(str, args)], capture_output=True, text=True,
                          cwd=REPO, timeout=300)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(root, *flags):
    """Both scripts' ``--json`` reports and exit codes on ``root``."""
    out = {}
    for script in ("check_dataset", "check_dataset_torch"):
        p = run_script(f"scripts/{script}.py", root, "--json", *flags)
        assert p.returncode in (0, 1), p.stderr
        report = json.loads(p.stdout)
        for r in report["problems"]:
            assert r.get("est_full_read_s_numpy", 0) is not None
            for k in UNCOMPARED & r.keys():
                r[k] = "measured"
        out[script] = p.returncode, report
    return out


def test_check_dataset_like_jax_on_a_clean_tree(synth_root):
    got = reports(synth_root, "--sample", "4")
    assert got["check_dataset_torch"] == got["check_dataset"]
    assert got["check_dataset_torch"][0] == 0


def test_check_dataset_like_jax_on_defects(synth_root, tmp_path):
    """The corruptions of ``tests/test_scripts.py``: a NaN field, a missing
    v.npy, a missing required key, a single-frame case; a missing problem."""
    root = tmp_path / "data"
    shutil.copytree(synth_root / "tube", root / "tube")
    cases = sorted((root / "tube" / "prop").glob("case*"))
    u = np.load(cases[0] / "u.npy")
    u[0, 0, 0] = np.nan
    np.save(cases[0] / "u.npy", u)
    (cases[1] / "v.npy").unlink()
    cj = json.loads((cases[2] / "case.json").read_text())
    del cj["vel_in"]
    (cases[2] / "case.json").write_text(json.dumps(cj))
    np.save(cases[3] / "u.npy", u[:1])
    got = reports(root, "--problems", "tube,cavity", "--sample", "999")
    assert got["check_dataset_torch"] == got["check_dataset"]
    code, report = got["check_dataset_torch"]
    assert code == 1
    errors = "\n".join(e for r in report["problems"] for e in r["errors"])
    for what in ("NaN", "missing v.npy", "vel_in", "no autoregressive pair",
                 "directory missing"):
        assert what in errors, what


@pytest.mark.parametrize("subset", ["prop", "geo"])
def test_locate_cylinder_like_jax(synth_root, subset):
    case = sorted((synth_root / "cylinder" / subset).glob("case*"))[0]
    got, want = (run_script(f"scripts/{s}.py", case)
                 for s in ("locate_cylinder_torch", "locate_cylinder"))
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert "analytic center" in got.stdout and got.stdout == want.stdout


def printed_stats(out: str) -> tuple:
    """The frame count and the mean and std lists of a get_stats report."""
    lines = dict(line.split(": ", 1) for line in out.splitlines() if ": " in line)
    return (int(lines["# frames"]), json.loads(lines["channel mean (u, v)"]),
            json.loads(lines["channel std  (u, v)"]))


@pytest.mark.parametrize("data_name", ["cavity_prop", "tube_prop_bc"])
def test_get_stats_like_jax(synth_root, data_name, capsys, monkeypatch):
    """The train frames' statistics after the 64x64 resize (tube's 18x17
    grid is resized, as 66x65 is), both reduced in float64, as the port's
    script reduces; and the printed report against the JAX script's: the
    same frame count, each figure within one unit of its fourth decimal
    beyond the JAX script's own float32 error on its frames (numpy's
    float32 sums over the frame axes stray by up to 9e-4 on these)."""
    argv = ["--data_name", data_name, "--data_dir", str(synth_root)]
    script = load_script("get_stats_torch")
    n, mean, std = script.frame_stats(Args.parse_args(argv))
    jargs = JaxArgs.parse_args(argv)
    train, _, _ = jax_get_auto_dataset(data_dir=synth_root, data_name=data_name,
                                       delta_time=jargs.delta_time, norm_props=True,
                                       norm_bc=True, load_splits=["train"], seed=0)
    frames32 = jax_build_vae_dataset(train, normalize=False).frames
    frames = frames32.astype(np.float64)
    assert n == frames.shape[0]
    np.testing.assert_allclose(mean, frames.mean(axis=(0, 1, 2)), rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(std, frames.std(axis=(0, 1, 2)), rtol=0, atol=STATS_ATOL)
    f32_error = np.abs([frames32.mean(axis=(0, 1, 2)) - frames.mean(axis=(0, 1, 2)),
                        frames32.std(axis=(0, 1, 2)) - frames.std(axis=(0, 1, 2))])
    script.main(argv)
    got = printed_stats(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["get_stats.py"] + argv)
    load_script("get_stats").main()
    want = printed_stats(capsys.readouterr().out)
    assert got[0] == want[0] == n
    assert (np.abs(np.subtract(got[1:], want[1:])) <= f32_error + PRINTED_ATOL).all(), (
        got, want, f32_error)


def test_plot_mask_overlay_writes_its_file(synth_root, tmp_path):
    case = sorted((synth_root / "cylinder" / "geo").glob("case*"))[0]
    out = tmp_path / "overlay.png"
    p = run_script("scripts/plot_mask_overlay_torch.py", case, "cylinder", out)
    assert p.returncode == 0, p.stderr
    assert out.stat().st_size > 0 and f"wrote {out}" in p.stdout


class JittedVae:
    """The JAX VAE behind jitted ``encode`` and ``decode`` applies: the JAX
    script applies its VAE eagerly, op by op, a minute on the CPU."""

    def __init__(self, vae):
        self.encode, self.decode = vae.encode, vae.decode
        self._apply = {m: jax.jit(lambda v, x, m=m: vae.apply(v, x, method=m))
                       for m in (vae.encode, vae.decode)}

    def apply(self, variables, x, method):
        return self._apply[method](variables, x)


def test_vae_diagnostics_like_jax(tmp_path):
    """``write_diagnostics`` of both scripts on a lite VAE of the same
    weights and the same frames: the summary's statistics, and the files."""
    jax_script, port_script = load_script("vae_diagnostics"), load_script("vae_diagnostics_torch")
    frames = np.random.default_rng(0).standard_normal((6, 64, 64, 2)).astype(np.float32)
    vae = make_cfd_vae("lite", 2, 2, 2, generator=torch.Generator().manual_seed(0)).eval()
    jax_vae, params = jax_make_cfd_vae("lite", 2, 2, 2), params_to_flax(vae.state_dict())
    # Two latent channels, three traversal steps and three reconstruction
    # pairs: few subplots, and decodes of three and six latents alone.
    sizes = dict(n_traversal_steps=3, n_recon_pairs=3)
    want = jax_script.write_diagnostics(JittedVae(jax_vae), params, frames, tmp_path / "jax",
                                        **sizes)
    got = port_script.write_diagnostics(vae, frames, tmp_path / "port", **sizes)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["per_dim_kl"], want["per_dim_kl"], rtol=0, atol=DIAG_ATOL)
    for k in ("latent_mean", "latent_std"):
        assert abs(got[k] - want[k]) <= DIAG_ATOL, k
    assert got["scaling_factor"] == pytest.approx(want["scaling_factor"], rel=DIAG_ATOL)
    assert got["collapsed_dims"] == want["collapsed_dims"]
    assert got["embedding_method"] == want["embedding_method"]
    for name in DIAGNOSTIC_FILES:
        assert (tmp_path / "port" / name).stat().st_size > 0, name
    assert json.loads((tmp_path / "port" / "diagnostics.json").read_text()) == got


def test_vae_diagnostics_without_matplotlib_writes_its_arrays(tmp_path, monkeypatch):
    """As on a card's machine without matplotlib: the summary and the
    arrays the plots would show, and no plot."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    vae = make_cfd_vae("lite", 2, 2, 2, generator=torch.Generator().manual_seed(0)).eval()
    frames = np.random.default_rng(0).standard_normal((3, 32, 32, 2)).astype(np.float32)
    summary = load_script("vae_diagnostics_torch").write_diagnostics(
        vae, frames, tmp_path, n_traversal_steps=3, n_recon_pairs=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["diagnostics.json", "diagnostics.npz"]
    assert json.loads((tmp_path / "diagnostics.json").read_text()) == summary
    with np.load(tmp_path / "diagnostics.npz") as arrays:
        assert arrays["latent_means"].shape == (3, 4, 4, 2)
        assert arrays["embedding"].shape == (3, 2)
        assert arrays["traversals"].shape == (2, 3, 32, 32, 2)
        assert arrays["reconstructions"].shape == (2, 32, 32, 2)
        assert arrays["interpolation"].shape == (6, 32, 32, 2)


def test_vae_diagnostics_main_reads_the_ports_weights(tmp_path):
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    generate_problem(tmp_path / "data", "cavity", cases_per_subset=4, num_frames=4, grid=16,
                     seed=0)
    vae = make_cfd_vae("lite", 2, 2, 4, generator=torch.Generator().manual_seed(3))
    save_params(vae.state_dict(), tmp_path / "weights")
    summary = load_script("vae_diagnostics_torch").main([
        "--data_name", "cavity_prop_bc_geo", "--data_dir", str(tmp_path / "data"),
        "--ldm_vae_weights_path", str(tmp_path / "weights"), "--output_dir",
        str(tmp_path / "diag"), "--device", "cpu"])
    assert len(summary["per_dim_kl"]) == 4 and np.isfinite(summary["per_dim_kl"]).all()
    assert np.isfinite([summary["latent_mean"], summary["latent_std"]]).all()
    for name in DIAGNOSTIC_FILES:
        assert (tmp_path / "diag" / name).exists(), name
