"""``BENCHMARK.json`` keeps to its contract, and the harness finds every
configuration, cell, traffic kind and metric reader by name."""

import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits(manifest):
    s = manifest["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and LINE.match(c["source"])
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])


def test_names_and_units(manifest):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in manifest[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in manifest["workloads"]:
        cell = harness.find_cell(manifest, w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert harness.reports(e2e[m["moves"]], w["name"]), (m["name"], w["name"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cells_drivers_and_readers_are_found_by_name(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    assert {w["name"] for w in manifest["workloads"]} == {"fno-rollout-b128", "unet-rollout-b256"}
    for w in manifest["workloads"]:
        cell = harness.find_cell(manifest, w["name"])
        assert cell.config["name"] == w["config"]
        driver = harness.traffic_driver(cell.mix["kind"])
        for fn in ("setup", "window", "release", "readings"):
            assert callable(getattr(driver, fn))
        assert cell.spec["limits"]
    for m in manifest["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_an_unknown_cell_is_refused(manifest):
    with pytest.raises(KeyError):
        harness.find_cell(manifest, "no-such-cell")


def test_each_configuration_finds_its_reference_by_model(manifest):
    from portbench.reference import models

    for c in manifest["configs"]:
        config = harness.load_json(harness.ROOT / c["file"])
        ref = models.of(config)
        assert ref.__name__ == f"portbench.reference.{config['model']}"
        for fn in ("initial_stats", "predict", "forward_macs"):
            assert callable(getattr(ref, fn)), (c["name"], fn)
        assert models.forward_macs(config, 2) == 2 * models.forward_macs(config, 1) > 0
    with pytest.raises(ValueError):
        models.of(dict(model="no_such_model"))
