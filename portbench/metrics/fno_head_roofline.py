"""fno_head_roofline (%): the bound of one call of the registered operator
``cfdbench_tpu_torch::fno_head`` at the cell's shapes (``reference/counts.py``)
over the device time per call of the kernels that operator launched."""

from portbench.metrics import share

OPERATOR = "cfdbench_tpu_torch::fno_head"


def read(run):
    cfg = run.cell.config
    a, (H, W) = cfg["args"], cfg["grid"]
    work = share.counts.fno_head(run.cell.mix["batch"], H, W, a["fno_hidden_dim"],
                                 cfg["head_width"], a["out_chan"])
    return share.roofline(run.trace, OPERATOR, work)
