"""Traffic kind ``rollout``: a closed loop of one caller, each call the
program's autoregressive rollout of a batch of cases followed by a
synchronize, as ``main_multistep`` scores a test split: the model built by
``cli.make_auto_task``, rolled out by ``training/rollout.py::make_rollout_fn
(task.predict_frame, steps)``.

The mix (``traffic/<mix>.json``): ``batch`` cases a call, ``steps`` frames a
call, ``input_sets`` batches of cases made from the seed, which the calls
take in turn in an order drawn from the seed, and ``checked`` calls, drawn
from the seed among the window's first ``checked_among``, whose frames are
kept and, once the window has closed, compared with the plain reference's
rollout of the same inputs on the same weights (``frame_gap``: the largest
gap of a frame's value over the largest value of that call's reference
frames).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from cfdbench_tpu_torch.cli import make_auto_task
from cfdbench_tpu_torch.config import Args
from cfdbench_tpu_torch.training.rollout import make_rollout_fn
from cfdbench_tpu_torch.utils.device import set_numerics

from portbench import fields
from portbench.harness import Window
from portbench.reference import models as ref_models
from portbench.reference import precision
from portbench.reference import weights as ref_weights
from portbench.stats import percentile, rate


def build_program(run):
    """The program's model, built through its entry wiring, on the seed's
    weights; and those weights, the benchmark's own copy."""
    cfg = run.cell.config
    args = Args(**cfg["args"])
    set_numerics(args.matmul_precision)
    task = make_auto_task(args, cfg["n_case_params"], tuple(cfg["grid"]), run.device)
    shapes = {n: tuple(p.shape) for n, p in task.model.named_parameters()}
    weights = ref_weights.draw(shapes, run.seed, run.device)
    with torch.no_grad():
        for n, p in task.model.named_parameters():
            p.copy_(weights[n])
    return task, weights


def setup(run):
    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    H, W = cfg["grid"]
    B = mix["batch"]
    task, weights = build_program(run)
    task.model.eval()
    if run.plant is not None:
        run.plant(task)
    rollout = make_rollout_fn(task.predict_frame, steps=mix["steps"])
    g = fields.generator(run.seed, 1, dev)
    sets = []
    for _ in range(mix["input_sets"]):
        frame0, _ = fields.flow_pairs(B, H, W, cfg["args"]["in_chan"], g, dev)
        sets.append((frame0, fields.case_params(B, cfg["n_case_params"], g, dev),
                     fields.masks(B, H, W, g, dev)))
    rng = np.random.default_rng([ref_weights.seed_of(run.seed), 2])
    order = rng.permutation(len(sets))
    checked = set(rng.choice(mix["checked_among"], size=mix["checked"], replace=False).tolist())
    for _ in range(2):  # the first call builds the kernels' tables and the libraries' handles
        rollout(*sets[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(task=task, rollout=rollout, weights=weights, sets=sets, order=order,
                checked=checked, kept={}, calls=0)


def window(run, state, seconds):
    """Calls for ``seconds``; the calls are counted on across windows, so the
    checked ones are the first window's."""
    cuda = run.device.type == "cuda"
    rollout, sets, order, kept = state["rollout"], state["sets"], state["order"], state["kept"]
    span = run.tracer.span
    marks = []
    first = state["calls"]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        n = state["calls"]
        which = int(order[n % len(order)])
        if cuda:
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
        else:
            begin = time.perf_counter()
        with span("pb.rollout"):
            frames = rollout(*sets[which])
        if cuda:
            end.record()
        with span("pb.sync"):
            if cuda:
                torch.cuda.synchronize(run.device)
        if not cuda:
            end = time.perf_counter()
        marks.append((begin, end))
        if n in state["checked"]:
            kept[n] = (which, frames)
        state["calls"] += 1
    t1 = time.perf_counter()
    latency_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in marks]
    B, steps = run.cell.mix["batch"], run.cell.mix["steps"]
    n = state["calls"] - first
    return Window(seconds=t1 - t0, attempted=n, failed=0,
                  work=dict(calls=n, frames=B * steps * n),
                  measured=dict(rollout_fps=rate(B * steps * n, t1 - t0),
                                rollout_p95_ms=percentile(latency_ms, 95)))


def release(run, state):
    for k in ("task", "rollout"):
        state.pop(k, None)


def readings(run, state):
    gaps = []
    with precision.float32():
        for n, (which, frames) in sorted(state["kept"].items()):
            frame0, case_params, mask = state["sets"][which]
            ref = ref_models.rollout(run.cell.config, state["weights"], frame0, case_params,
                                     mask, run.cell.mix["steps"])
            gaps.append(float((frames.float() - ref).abs().max() / ref.abs().max()))
    return {"frame_gap": max(gaps)} if gaps else {}
