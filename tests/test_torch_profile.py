"""``--profile_dir`` on the CPU: each entry point writes a ``torch.profiler``
Chrome trace of its run into the directory, one file a call named by rank
(``utils/profiling.py``), when it returns and when it raises. The JAX
package starts a ``jax.profiler`` trace at the same point
(``cfdbench_tpu/cli.py:57-61``)."""

import json

import pytest
import torch

from cfdbench_tpu_torch import cli
from cfdbench_tpu_torch.data.synthetic import generate_problem
from cfdbench_tpu_torch.utils import profiling

torch.set_num_threads(1)

FNO_FLAGS = ["--model", "fno", "--data_name", "cavity_prop_bc_geo", "--fno_hidden_dim", "8",
             "--fno_modes_x", "4", "--fno_modes_y", "4", "--fno_depth", "2"]


def events(path):
    """The trace's events, after checking that it parses as a Chrome trace."""
    trace = json.loads(path.read_text())
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    return trace["traceEvents"]


def test_main_auto_and_main_multistep_write_a_trace_a_call(tmp_path):
    data = tmp_path / "data"
    generate_problem(data, "cavity", cases_per_subset=4, num_frames=6, grid=16, seed=0)
    trace = tmp_path / "trace"
    argv = FNO_FLAGS + ["--data_dir", str(data), "--output_dir", str(tmp_path / "out"),
                        "--profile_dir", str(trace)]
    cli.main_auto(argv + ["--mode", "train", "--num_epochs", "1", "--batch_size", "8",
                          "--eval_interval", "1"], device="cpu")
    assert sorted(p.name for p in trace.iterdir()) == ["rank0.0.pt.trace.json"]
    names = {e.get("name") for e in events(trace / "rank0.0.pt.trace.json")}
    assert "Optimizer.step#Adam.step" in names  # the training steps ran inside it
    for _ in range(2):  # a main called twice in one process writes two traces
        cli.main_multistep(argv, device="cpu")
    assert sorted(p.name for p in trace.iterdir()) == [
        f"rank0.{n}.pt.trace.json" for n in range(3)]
    for n in (1, 2):
        names = {e.get("name") for e in events(trace / f"rank0.{n}.pt.trace.json")}
        assert "cfdbench_tpu_torch::fno_block" in names  # the rollout's block operator
        assert "cfdbench_tpu_torch::fno_head" in names
        assert "profile_trace warm-up" not in names  # the warm-up is the card's alone


def test_the_warm_up_grows_with_the_process_age(monkeypatch):
    """The CUDA warm-up launches WARMUP_KERNELS and half a kernel more for
    each second of the process's age, which ``/proc`` gives."""
    assert 0 < profiling.process_age() < 24 * 3600
    for age, want in ((0.0, 64), (13.0, 71), (1000.0, 564)):
        monkeypatch.setattr(profiling, "process_age", lambda age=age: age)
        assert profiling.warmup_kernels() == want


@pytest.mark.parametrize("entry", ["main_train", "main_gencast", "main_vae", "main_uncond"])
def test_other_entry_points_write_their_trace_when_they_raise(tmp_path, entry):
    """On a data directory that holds no cases each entry point fails while
    loading its data, after its trace started: the trace is written."""
    model = {"main_train": ["--model", "ffn"], "main_gencast": ["--model", "gencast"]}
    argv = model.get(entry, []) + ["--data_name", "cavity_prop_bc_geo", "--data_dir",
                                   str(tmp_path / "empty"), "--output_dir",
                                   str(tmp_path / "out"), "--profile_dir", str(tmp_path / "t")]
    with pytest.raises(Exception):
        getattr(cli, entry)(argv, device="cpu")
    assert [p.name for p in (tmp_path / "t").iterdir()] == ["rank0.0.pt.trace.json"]
    events(tmp_path / "t" / "rank0.0.pt.trace.json")
