"""A run of each cell, the look for a card skipped, at a small size on the
CPU: sound, it comes out correct; with each fault that the cell can have
planted under its timed path, not correct. And the traced run's readers."""

import pytest
import torch

from portbench import harness, variants

CELLS = ["fno-rollout-b128", "unet-rollout-b256"]
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, name):
    r = harness.run_cell(small_cell(name), SEED, 0.3, False, torch.device("cpu"))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in harness.find_cell(
        harness.load_manifest(), name).end_to_end}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", variants.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_is_not_correct(small_cell, name, fault):
    r = harness.run_cell(small_cell(name), SEED, 0.3, False, torch.device("cpu"),
                         plant=variants.VARIANTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_reads_the_host_ranges(small_cell, name):
    r = harness.run_cell(small_cell(name), SEED + 1, 0.3, True, torch.device("cpu"))
    assert r["correct"]
    # on the CPU no kernel runs on a card: the device's readers find nothing
    assert set(r["metrics"]) == {"host_ms.rollout", "rollout_mfu"}
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert r["breakdown"]["device_ops"] == [] and r["breakdown"]["idle_gaps"]


def test_the_same_seed_makes_the_same_inputs(small_cell):
    cell = small_cell("fno-rollout-b128")
    driver = harness.traffic_driver("rollout")
    states = [driver.setup(harness.Run(cell, SEED, torch.device("cpu"), harness.Tracer()))
              for _ in range(2)]
    for a, b in zip(states[0]["sets"], states[1]["sets"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert states[0]["checked"] == states[1]["checked"]


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_measures_an_untraced_window_first(small_cell, name):
    # rates and host times come from the untraced window; the checked calls
    # are that window's, whatever the traced window adds
    cell = small_cell(name)
    driver = harness.traffic_driver(cell.mix["kind"])
    run = harness.Run(cell, SEED, torch.device("cpu"), harness.Tracer())
    state = driver.setup(run)
    run.main = harness.measure(driver, run, state, 0.3, profiled=False)
    kept = dict(state["kept"])
    run.traced = harness.measure(driver, run, state, 0.2, profiled=True)
    assert run.main.seconds >= 0.3 and 0.2 <= run.traced.seconds < run.main.seconds
    assert run.main.attempted > 0 and run.traced.attempted > 0
    assert state["kept"].keys() == kept.keys()
    assert len(run.main.spans["pb.rollout"]) == run.main.attempted
    assert len(run.traced.spans["pb.rollout"]) == run.traced.attempted
