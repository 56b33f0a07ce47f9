"""host_ms.rollout (ms): host time to enqueue one rollout call, before its
synchronize (the ``pb.rollout`` ranges of the untraced window, by the host's
clock)."""


def read(run):
    spans = run.main.spans.get("pb.rollout")
    return 1e3 * sum(spans) / len(spans) if spans else None
