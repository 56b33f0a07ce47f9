"""Host ranges around each call into a layer, and for the traced run
(``--trace 1``) ``torch.profiler`` over a second window, and its reduction to
what the per-layer readers read.

The harness's own files put ranges around each call into a layer
(:meth:`Tracer.span`): each range's duration by the host's clock, in every
window, and a ``record_function`` range in a profiled one, whose whole is
the range ``pb.window``. From the profiler's events the reduction takes the
device's busy time (the union of every kernel, copy and fill on the card
within the window), each kernel's time and the registered operator
(``cfdbench_tpu_torch::...``) that launched it, found by the launching call's
time inside the operator's range on the same host thread, the host ranges'
durations, and the idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import os
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

OPERATOR_PREFIX = "cfdbench_tpu_torch::"
WINDOW = "pb.window"
# The profiler loses the records of a session's first kernels on the card,
# about one more for every 13 s the process has run: a warm-up of tiny
# kernels takes that loss before the window, sized 6x above what was seen.
WARMUP_KERNELS = 64
WARMUP_PER_SECOND = 0.5


def process_age() -> float:
    """Seconds since this process started (Linux's ``/proc``)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def warm_up(device: torch.device) -> None:
    x = torch.zeros(1, device=device)
    with record_function("pb.profiler_warm_up"):
        for _ in range(WARMUP_KERNELS + math.ceil(WARMUP_PER_SECOND * process_age())):
            x.add_(1)
        torch.cuda.synchronize(device)


@dataclass
class Trace:
    """What the readers read from a traced window (seconds throughout)."""
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)  # by kernel name
    operator_calls: Dict[str, int] = field(default_factory=dict)  # registered op -> calls
    operator_device_s: Dict[str, float] = field(default_factory=dict)  # its kernels' time
    outside_device_s: float = 0.0  # kernels, copies, fills launched outside them
    spans: Dict[str, List[float]] = field(default_factory=dict)  # host range -> durations
    gaps: List[Tuple[float, str]] = field(default_factory=list)  # (seconds, host doing)

    def device_ops(self, n: int = 10):
        return [[k, v] for k, v in sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        total = Counter()
        for s, what in self.gaps:
            total[what] += s
        return [[k, v] for k, v in total.most_common(n)]


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    return name[:96]


class Tracer:
    """Host ranges for the harness's calls, the durations of a window's ranges
    (``spans``: name -> seconds), and the profiler session over a profiled
    window."""

    def __init__(self):
        self.prof = None
        self.profiling = False
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with record_function(name):
                yield
        else:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def window(self, device: torch.device, profiled: bool):
        """A window; ``spans`` holds its ranges' durations afterwards."""
        self.spans = defaultdict(list)
        if not profiled:
            yield
            return
        cuda = device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self.profiling = True
        try:
            if cuda:
                warm_up(device)
            with record_function(WINDOW):
                yield
            if cuda:
                torch.cuda.synchronize(device)
        finally:
            self.profiling = False
            self.prof.stop()

    def reduce(self) -> Trace:
        return reduce_events(self.prof.profiler.kineto_results.events())


def _containing(starts, items, t):
    """The latest-starting of ``items`` (sorted by start, ``starts`` their
    starts) whose range holds ``t``, looking back at most 256 of them."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 257), -1):
        s, e = items[j][0], items[j][1]
        if s <= t <= e:
            return items[j]
    return None


def reduce_events(events) -> Trace:
    CPU = torch.autograd.DeviceType.CPU
    window = None
    device, host, launches, annotations = [], [], {}, []
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() != CPU:
            if not e.is_user_annotation():
                device.append((start, end, name, e.correlation_id()))
            continue
        if e.is_user_annotation():
            if name == WINDOW:
                window = (start, end)
            annotations.append((start, end, name))
        elif name.startswith("cu"):  # CUDA runtime and driver calls
            launches[e.correlation_id()] = (start, e.start_thread_id())
            host.append((start, end, name, e.start_thread_id()))
        else:
            host.append((start, end, name, e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    device = [d for d in device if d[1] > w0 and d[0] < w1]

    # Registered operators by host thread, for the launches inside them.
    ops = defaultdict(list)
    for s, e, name, tid in host:
        if name.startswith(OPERATOR_PREFIX) and w0 <= s <= w1:
            ops[tid].append((s, e, name))
    op_starts = {}
    for tid in ops:
        ops[tid].sort()
        op_starts[tid] = [o[0] for o in ops[tid]]
    calls = Counter(o[2] for lst in ops.values() for o in lst)

    kernel_s, op_dev, outside = Counter(), Counter(), 0.0
    intervals = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        dur = (e - s) / 1e9
        intervals.append((s, e))
        kernel_s[short_name(name)] += dur
        op = None
        launch = launches.get(corr)
        if launch is not None and launch[1] in ops:
            op = _containing(op_starts[launch[1]], ops[launch[1]], launch[0])
        if op is None:
            outside += dur
        else:
            op_dev[op[2]] += dur

    intervals.sort()
    busy, gaps_at, cursor = 0, [], w0
    for s, e in intervals:
        if s > cursor:
            gaps_at.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps_at.append((cursor, w1))

    annotations.sort()
    spans = defaultdict(list)
    for s, e, name in annotations:
        if name != WINDOW and w0 <= s <= w1:
            spans[name].append((e - s) / 1e9)
    ann_items = [a for a in annotations if a[2] != WINDOW]
    ann_starts = [a[0] for a in ann_items]
    host.sort()
    host_starts = [h[0] for h in host]
    gaps = []
    for s, e in gaps_at:
        mid = (s + e) // 2
        ann = _containing(ann_starts, ann_items, mid)
        op = _containing(host_starts, host, mid)
        what = (ann[2] if ann else "outside any range") + (f" > {op[2]}" if op else "")
        gaps.append(((e - s) / 1e9, what))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, kernel_s=dict(kernel_s),
                 operator_calls=dict(calls), operator_device_s=dict(op_dev),
                 outside_device_s=outside, spans=dict(spans), gaps=gaps)
