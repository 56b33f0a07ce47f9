"""rollout_mfu (%): the model FLOPs of every rollout call completed in the
untraced window (one forward of the batch a frame) over the window's seconds
times the dense TF32 peak."""

from portbench.metrics import share


def read(run):
    calls = run.main.work.get("calls")
    if not calls:
        return None
    macs = share.forward_macs(run.cell.config, run.cell.mix["batch"])
    return share.mfu(run, 2 * macs * run.cell.mix["steps"] * calls)
