"""The port's own copies of the JAX package's host code against the
originals: the flag parser, the result-dir layout of both kinds of run,
the synthetic case generator, the auto datasets (test split, features,
case-parameter vectors) and the non-auto frame datasets must agree bit
for bit, so that both packages read the same cases into the same arrays
and write to the same run directory; so must the batches, padded for a
data-parallel mesh, the legacy Kármán loader, a reference ``*.pt`` cache
read as an ``AutoDataset``, and the Fluent and ICEM generators' output."""

import dataclasses

import numpy as np
import pytest
import torch

from cfdbench_tpu import config as jax_config
from cfdbench_tpu import data as jax_data
from cfdbench_tpu.data import pipeline as jax_pipeline
from cfdbench_tpu.data import synthetic as jax_synthetic
from cfdbench_tpu.data.compat import auto_dataset_from_reference_cache as jax_from_cache
from cfdbench_tpu.data.karman import build_karman_dataset as jax_build_karman
from cfdbench_tpu.generation import fluent as jax_fluent
from cfdbench_tpu.generation import icem as jax_icem
from cfdbench_tpu.utils import artifacts as jax_artifacts
from cfdbench_tpu_torch import cli, config, data
from cfdbench_tpu_torch.data import core, pipeline, synthetic
from cfdbench_tpu_torch.data.compat import auto_dataset_from_reference_cache
from cfdbench_tpu_torch.data.karman import build_karman_dataset, load_karman_data
from cfdbench_tpu_torch.generation import fluent, icem
from cfdbench_tpu_torch.utils import artifacts

ARGVS = [
    [],  # every default
    ["--model", "fno", "--data_name", "cavity_prop_bc_geo", "--data_dir", "d",
     "--output_dir", "r", "--fno_depth", "4", "--fno_hidden_dim", "32",
     "--fno_modes_x", "12", "--fno_modes_y", "12"],
    ["--model", "unet", "--data_name", "tube_prop", "--lr", "3e-4", "--seed", "7",
     "--use_mixed_precision", "--resume", "1", "--ch_mult", "1", "2",
     "--unet_attention_resolutions", "--mesh_shape", "4x2", "--delta_time", "0.2"],
    ["--model", "auto_deeponet", "--use_gradient_checkpointing", "false",
     "--norm_props", "0", "--act_fn", "gelu", "--data_name", "dam_bc_geo"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "flagship", "unet", "deeponet"])
def test_args_parse_like_jax(argv):
    got = config.Args.parse_args(argv)
    want = jax_config.Args.parse_args(argv)
    assert vars(got) == vars(want)


@pytest.mark.parametrize("argv", ARGVS[1:], ids=["flagship", "unet", "deeponet"])
def test_output_dir_like_jax(argv):
    got = artifacts.get_output_dir(config.Args.parse_args(argv), is_auto=True)
    want = jax_artifacts.get_output_dir(jax_config.Args.parse_args(argv), is_auto=True)
    assert got == want


@pytest.mark.parametrize("argv", ARGVS[1:], ids=["flagship", "unet", "deeponet"])
def test_nonauto_output_dir_like_jax(argv):
    got = artifacts.get_output_dir(config.Args.parse_args(argv), is_auto=False)
    want = jax_artifacts.get_output_dir(jax_config.Args.parse_args(argv), is_auto=False)
    assert got == want and got.parts[1] == "non-auto"


@pytest.mark.parametrize("model", ["ffn", "deeponet"])
def test_nonauto_run_dir_like_jax(model):
    # The non-auto models' own hparams name their run directory.
    argv = ["--model", model, "--ffn_width", "24", "--deeponet_width", "12", "--act_fn",
            "gelu", "--act_scale_invariant", "0", "--act_on_output", "1", "--lr", "3e-4"]
    got = cli.run_dir(config.Args.parse_args(argv))
    want = jax_artifacts.get_output_dir(jax_config.Args.parse_args(argv), is_auto=False)
    assert got == want and got.parts[1] == "non-auto"


def test_synthetic_tree_like_jax(tmp_path):
    synthetic.generate_all(tmp_path / "port", cases_per_subset=2, num_frames=5,
                           grid=8, seed=3)
    jax_synthetic.generate_all(tmp_path / "jax", cases_per_subset=2, num_frames=5,
                               grid=8, seed=3)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 4 * 3 * 2 * 3
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def auto_datasets(module, root, data_name, **kw):
    # One raw frame per step: cylinder's frames are 0.001 apart.
    dt = 0.001 if data_name.startswith("cylinder") else 0.1
    return module.get_auto_dataset(
        data_dir=root, data_name=data_name, delta_time=dt, norm_props=True,
        norm_bc=True, seed=0, **kw,
    )


@pytest.mark.parametrize("problem", ["cavity", "tube", "dam", "cylinder"])
def test_auto_dataset_like_jax(synth_root, problem):
    data_name = f"{problem}_prop_bc_geo"
    got = auto_datasets(data, synth_root, data_name)
    want = auto_datasets(jax_data, synth_root, data_name)
    problem_dir = synth_root / problem
    dirs = core.collect_case_dirs(problem_dir, "prop_bc_geo")
    assert [[str(d) for d in s] for s in core.split_cases(dirs, seed=0)] == [
        [str(d) for d in s] for s in jax_data.split_cases(dirs, seed=0)
    ]
    for g, w in zip(got, want):
        for name in ("inputs", "labels", "masks", "case_params", "case_ids"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert len(g.all_features) == len(w.all_features)
        for fg, fw in zip(g.all_features, w.all_features):
            np.testing.assert_array_equal(fg, fw)
        assert g.case_params_list == w.case_params_list
        for pg, pw in zip(g.case_params_list, w.case_params_list):
            np.testing.assert_array_equal(core.params_to_vector(pg),
                                          jax_data.core.params_to_vector(pw))


def test_load_test_cases_like_jax_split(synth_root, tmp_path):
    argv = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(synth_root),
            "--cache_dir", str(tmp_path / "cache")]
    args = config.Args.parse_args(argv)
    _, _, test = auto_datasets(jax_data, synth_root, "cavity_prop_bc_geo",
                               load_splits=["test"])
    for _ in range(2):  # builds the npz cache, then reads it back
        features, case_params = data.load_test_cases(args, steps=20)
        assert features.shape[:2] == (len(test.all_features), 20)
        for f, w in zip(features, test.all_features):
            np.testing.assert_array_equal(f[: len(w)], w[:20])
        np.testing.assert_array_equal(case_params, np.stack(
            [jax_data.core.params_to_vector(p) for p in test.case_params_list]))
    assert len(list((tmp_path / "cache").glob("cavity-*.npz"))) == 1


@pytest.mark.parametrize("problem", ["cavity", "tube", "dam", "cylinder"])
def test_frame_dataset_like_jax(synth_root, problem):
    """The non-auto splits: frames, frame_t, case parameters (in the
    frame datasets' key order), case ids and the normalised parameter
    dicts."""
    kw = dict(data_name=f"{problem}_prop_bc_geo", data_dir=synth_root, norm_props=True,
              norm_bc=True, seed=0)
    got, want = data.get_dataset(**kw), jax_data.get_dataset(**kw)
    for g, w in zip(got, want):
        for name in ("frames", "frame_t", "case_params", "case_ids"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
            assert getattr(g, name).dtype == getattr(w, name).dtype
        assert g.case_params_list == w.case_params_list
        assert g.n_case_params == (8 if problem == "cylinder" else 5)


def test_point_examples_like_jax(synth_root, rng):
    got = data.get_dataset("dam_prop_bc_geo", synth_root, True, True)[0]
    want = jax_data.get_dataset("dam_prop_bc_geo", synth_root, True, True)[0]
    idxs = rng.integers(0, got.num_points, 64)
    assert got.num_points == want.num_points
    for a, b in zip(got.point_examples(idxs), want.point_examples(idxs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", [0, 1])
def test_gencast_triples_and_residual_stats_like_jax(synth_root, tmp_path, split):
    """``wrap_gencast``'s (X_{t-2}, X_{t-1}, X_t) triples and the residual
    statistics, bit for bit, and their npz round trip."""
    from cfdbench_tpu.data import wrapper as jax_wrapper
    from cfdbench_tpu_torch.data import wrapper

    got = wrapper.wrap_gencast(auto_datasets(data, synth_root, "cavity_prop_bc_geo")[split])
    want = jax_wrapper.wrap_gencast(
        auto_datasets(jax_data, synth_root, "cavity_prop_bc_geo")[split])
    for name in ("inputs", "inputs_prev", "labels", "masks", "case_params"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    stats, want_stats = wrapper.compute_residual_stats(got), jax_wrapper.compute_residual_stats(want)
    assert stats.keys() == want_stats.keys()
    for k in stats:
        assert stats[k].dtype == want_stats[k].dtype == np.float32
        np.testing.assert_array_equal(stats[k], want_stats[k])
    wrapper.save_residual_stats(stats, tmp_path / "run" / "residual_stats.npz")
    back = jax_wrapper.load_residual_stats(tmp_path / "run" / "residual_stats.npz")
    for k in stats:
        np.testing.assert_array_equal(back[k], stats[k])


@pytest.mark.parametrize("model", ["pixel_diffusion", "gencast"])
def test_diffusion_run_dir_like_jax(model):
    argv = ["--model", model, "--lr", "3e-4", "--ldm_noise_scheduler_timesteps", "100"]
    got = cli.run_dir(config.Args.parse_args(argv))
    want = jax_artifacts.get_output_dir(jax_config.Args.parse_args(argv), is_auto=True)
    assert got == want and got.parts[-2:] == (model, "lr0.0003_steps100")


@pytest.mark.parametrize("shape", [(3, 16, 16, 2), (3, 66, 65, 2), (2, 64, 64, 2), (2, 17, 70, 2)],
                         ids=["16x16", "66x65", "64x64", "17x70"])
def test_vae_resize_like_jax_image_resize(rng, shape):
    """``jax.image.resize(…, "bilinear")`` to 64x64, antialiased where it
    shrinks (66x65, and 70 columns), within 1e-6 of the largest value."""
    import jax

    from cfdbench_tpu_torch.data.vae_data import resize_bilinear

    frames = (2.0 + rng.standard_normal(shape)).astype(np.float32)
    got = resize_bilinear(frames, (64, 64))
    want = np.asarray(jax.image.resize(frames, (shape[0], 64, 64, 2), method="bilinear"))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("problem,grid", [("cavity", 64), ("tube", 16)])
def test_build_vae_dataset_like_jax(tmp_path, problem, grid):
    """The VAE's normalised 64x64 label frames: bit for bit where no
    resize runs (a 64x64 cavity), within 1e-6 where one does (tube's
    grid + (2, 1), resized up)."""
    from cfdbench_tpu.data.vae_data import build_vae_dataset as jax_build
    from cfdbench_tpu_torch.data.vae_data import build_vae_dataset

    synthetic.generate_problem(tmp_path, problem, cases_per_subset=4, num_frames=3, grid=grid,
                               seed=1)
    kw = dict(data_name=f"{problem}_prop_bc_geo", delta_time=0.1, norm_props=True,
              norm_bc=True, seed=0, load_splits=["train"])
    got = build_vae_dataset(data.get_auto_dataset(tmp_path, **kw)[0]).frames
    want = jax_build(jax_data.get_auto_dataset(tmp_path, **kw)[0]).frames
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1:] == (64, 64, 2) and len(got) > 0
    if grid == 64 and problem == "cavity":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("model", ["latent_diffusion", "latent_diffusion2_lite"])
def test_latent_run_dir_like_jax(model):
    argv = ["--model", model, "--lr", "3e-4", "--ldm_latent_dim", "8",
            "--ldm_noise_scheduler_timesteps", "100"]
    got = cli.run_dir(config.Args.parse_args(argv))
    want = jax_artifacts.get_output_dir(jax_config.Args.parse_args(argv), is_auto=True)
    assert got == want and got.parts[-1] == "lr0.0003_latentdim8_steps100"


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch_size,pad_multiple", [(4, 2), (3, 2), (5, 4), (6, 3), (4, 8)])
def test_padded_batches_like_jax(rng, shuffle, batch_size, pad_multiple):
    """``batches(pad_multiple=)`` (a data-parallel mesh's padding: each
    batch rounded up to a multiple of the rank count with weight-0 rows),
    over sizes that do and do not divide the 11 rows and the multiple."""
    arrays = dict(inputs=rng.standard_normal((11, 3, 2)).astype(np.float32),
                  case_params=rng.standard_normal((11, 5)).astype(np.float32))
    got = list(pipeline.batches(arrays, batch_size, shuffle, np.random.default_rng(7),
                                pad_multiple=pad_multiple))
    want = list(jax_pipeline.batches(arrays, batch_size, shuffle, np.random.default_rng(7),
                                     pad_multiple=pad_multiple))
    assert len(got) == len(want) == pipeline.num_batches(11, batch_size)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["weights"].size % pad_multiple == 0 and g["weights"].size >= batch_size
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def assert_same(got, want):
    """Equal structures of arrays, bit for bit, and of everything else."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_karman_loader_like_jax(tmp_path):
    """The legacy Kármán dataset (``src/dataset/base.py:10-87``) on the
    files of ``tests/test_data.py::test_karman_legacy_loader``."""
    from cfdbench_tpu.data.karman import load_karman_data as jax_load_karman

    rng = np.random.default_rng(7)
    T, H, W = 25, 6, 8
    np.save(tmp_path / "u.npy", rng.standard_normal((T, H, W)))
    np.save(tmp_path / "v.npy", rng.standard_normal((T, H, W)))
    np.save(tmp_path / "mask.npy", rng.integers(0, 2, (H, W)).astype(np.float64))
    assert_same(load_karman_data(tmp_path), jax_load_karman(tmp_path))
    for step in (1, 10):
        got = build_karman_dataset(tmp_path, time_step_size=step)
        assert_same(got, jax_build_karman(tmp_path, time_step_size=step))
        assert len(got) == T - step


def test_reference_cache_like_jax(synth_root, tmp_path):
    """A cache written as the reference writes it (``cylinder.py:477-541``;
    ``tests/test_data.py::test_reference_pt_cache_roundtrip``'s layout),
    read by both packages, and equal to the dataset built from the tree."""
    from cfdbench_tpu_torch.data.core import collect_case_dirs
    from cfdbench_tpu_torch.data.datasets import build_auto_dataset

    ds = build_auto_dataset("cylinder", collect_case_dirs(synth_root / "cylinder", "prop"),
                            norm_props=True, norm_bc=True, delta_time=0.002)
    d = tmp_path / "cache" / "train"
    d.mkdir(parents=True)
    nchw = lambda a: torch.tensor(a.transpose(0, 3, 1, 2))  # noqa: E731
    torch.save(nchw(np.concatenate([ds.inputs, ds.masks], -1)), d / "inputs.pt")
    torch.save(nchw(np.concatenate([ds.labels, ds.masks], -1)), d / "labels.pt")
    torch.save(list(map(int, ds.case_ids)), d / "case_ids.pt")
    torch.save(ds.case_params_list, d / "case_params.pt")
    torch.save([f.transpose(0, 3, 1, 2) for f in ds.all_features], d / "all_features.pt")

    got = auto_dataset_from_reference_cache(d)
    assert_same(got, jax_from_cache(d))
    for k in ("inputs", "labels", "masks", "case_ids", "case_params"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ds, k), err_msg=k)
    for a, b in zip(got.all_features, ds.all_features):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [
    "expand_template", "cavity_sweep", "step_sweep", "build_cases", "icem_mesh_params",
    "expand_rpl"])
def test_generators_like_jax(case):
    """The six cases of ``tests/test_generation.py``, each on both
    packages' generators, and the rest of their sweeps and grids."""
    def run(fl, ic):
        if case == "expand_template":
            return fl.expand_template(
                "read {mesh}\nset rho {density}\nsave {save_path}/{case_name}\n {unknown}",
                dict(mesh="m.msh", density=1.5, save_path="/x", case_name="c.h5"))
        if case == "cavity_sweep":
            return fl.cavity_sweep(), fl.laminar_sweep()
        if case == "step_sweep":
            return fl.step_sweep(), sorted(fl.SWEEPS), fl.TEMPLATE_KEYS
        if case == "build_cases":
            return [fl.build_cases(p, "/m/case{case}.msh", "/out", count=c, start=s)
                    for p, c, s in (("cavity", 3, 0), ("tube", None, 0), ("dam", 5, 168))]
        if case == "icem_mesh_params":
            return [ic.mesh_params(h, w) for h, w in ic.barrier_grid()], ic.barrier_grid()
        return [ic.expand_rpl("point {point7}\nnx {nodes_x1} ny {nodes_y2}\nname {project_name}",
                              h, w, f"proj{i}") for i, (h, w) in enumerate(ic.barrier_grid())]

    assert_same(run(fluent, icem), run(jax_fluent, jax_icem))


def test_write_case_journals_like_jax(tmp_path):
    template = tmp_path / "t.scm"
    template.write_text("read {mesh}\n  set {velocity}\nsave {save_path}\n")
    cases = fluent.build_cases("step", "/m/case{case}.msh", "/out", count=4)
    assert fluent.write_case_journals(template, tmp_path / "a.jou", cases) == 4
    assert jax_fluent.write_case_journals(template, tmp_path / "b.jou", cases) == 4
    assert (tmp_path / "a.jou").read_text() == (tmp_path / "b.jou").read_text()
