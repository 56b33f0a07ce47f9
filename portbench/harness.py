"""One run of one cell of ``BENCHMARK.json``: set up, measure a window,
judge the window's outputs against the plain reference, and report one JSON
line.

Everything a cell needs is found by name: its configuration (the file that
``BENCHMARK.json`` names), its traffic mix (``traffic/<traffic>.json``, whose
``kind`` names the driver ``traffic/<kind>.py``), its limits
(``workloads/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``). A driver provides ``setup``, ``window``,
``release`` and ``readings`` (see ``traffic/rollout.py``).

A traced run (``--trace 1``) measures the same untraced window first, then
a second window under the profiler (``trace_seconds`` of the mix, else
:data:`TRACE_SECONDS`, at most the run's seconds): the readers take rates
and host times from the first, where the profiler does not slow the host,
and device times from the second.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from .tracing import Tracer, process_age

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_SECONDS = 10.0
# Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "cfdbench_tpu")


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def check_modules(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"{when}: forbidden modules loaded: {', '.join(found)}")


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, or those it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    mix: dict  # traffic/<traffic>.json
    spec: dict  # workloads/<cell>.json: the limits of its comparison
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"], config=load_json(root / entry["file"]),
        mix=load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        spec=load_json(root / "portbench" / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)])


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_driver(kind: str):
    return load_file_module(BENCH / "traffic" / f"{kind}.py", f"portbench.traffic.{kind}")


def metric_reader(name: str):
    return load_file_module(BENCH / "metrics" / f"{name}.py", f"portbench.metrics.{name}")


@dataclass
class Window:
    """What a driver's ``window`` measured: its seconds, the calls attempted
    and failed, the work done (a rollout's ``calls`` and ``frames``), the
    end-to-end metrics by name, and (filled by the harness) each host range's
    durations."""
    seconds: float
    attempted: int
    failed: int
    work: Dict[str, float]
    measured: Dict[str, float]
    spans: Dict[str, List[float]] = field(default_factory=dict)


@dataclass
class Run:
    """What a driver gets, and what the readers read. ``plant``
    (``variants.py``), never set by ``run.py``, is applied to the program once
    it is built: a control or a fault, for the checks of the comparison."""
    cell: Cell
    seed: int
    device: Any
    tracer: Tracer
    plant: Optional[Callable] = None
    setup_s: float = 0.0
    main: Optional[Window] = None  # the untraced window
    traced: Optional[Window] = None  # the profiled window of a traced run
    trace: Any = None  # its reduction (tracing.Trace)


def measure(driver, run: Run, state, seconds: float, profiled: bool) -> Window:
    with run.tracer.window(run.device, profiled):
        w = driver.window(run, state, seconds)
    w.spans = dict(run.tracer.spans)
    return w


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             plant: Optional[Callable] = None) -> dict:
    """The result of one run (the dict printed as the last line)."""
    import torch

    cuda = device.type == "cuda"
    driver = traffic_driver(cell.mix["kind"])
    run = Run(cell, seed, device, Tracer(), plant)
    state = driver.setup(run)
    check_modules("after set-up")
    run.setup_s = process_age()
    run.main = measure(driver, run, state, seconds, profiled=False)
    windows = [run.main]
    if trace:
        run.traced = measure(driver, run, state,
                             min(seconds, cell.mix.get("trace_seconds", TRACE_SECONDS)),
                             profiled=True)
        windows.append(run.traced)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release(run, state)
    readings = driver.readings(run, state)
    checks = {k: {"value": readings.get(k, math.nan), "limit": v}
              for k, v in cell.spec["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else device.type,
               count=cell.chips if cuda else 0, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=sum(w.attempted for w in windows),
                  failed=sum(w.failed for w in windows))
    if trace:
        run.trace = run.tracer.reduce()
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result.update(metrics=metrics, device=dev,
                      breakdown=dict(device_ops=run.trace.device_ops(),
                                     idle_gaps=run.trace.idle_gaps()))
    else:
        measured = dict(run.main.measured, setup_s=run.setup_s)
        result.update(metrics={m["name"]: dict(value=measured[m["name"]], unit=m["unit"])
                               for m in cell.end_to_end}, device=dev)
    result["checks"] = checks
    check_modules("after the window and the comparison")
    return result


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
