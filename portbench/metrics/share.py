"""What the readers of shares have in common: a registered operator's
roofline share, the model's FLOPs against the dense TF32 peak, and the
device's idle share."""

from portbench.reference import counts, models, peaks


def roofline(trace, operator: str, work) -> float:
    calls = trace.operator_calls.get(operator, 0)
    device_s = trace.operator_device_s.get(operator, 0.0)
    if not calls or device_s <= 0:
        return None
    return 100.0 * work.bound_s() / (device_s / calls)


def forward_macs(config: dict, batch: int) -> int:
    """Multiply-adds of one forward of ``batch`` cases of the configuration."""
    return models.forward_macs(config, batch)


def mfu(run, flops: float) -> float:
    """``flops`` done in the untraced window over its seconds times the peak."""
    return 100.0 * flops / (run.main.seconds * peaks.TF32_FLOPS)


def idle_share(run, unit: str) -> float:
    """The untraced window's idle share: the device time a ``unit`` of work
    (a call) took in the traced window, times the untraced window's
    units, against its seconds. The profiler slows the host, not the card,
    so the traced window's own idle share overstates what a host-paced loop
    leaves idle."""
    t, traced, main = run.trace, run.traced, run.main
    if t.busy_s <= 0 or not traced.work.get(unit) or not main.work.get(unit):
        return None
    return 100.0 * (1.0 - t.busy_s / traced.work[unit] * main.work[unit] / main.seconds)
