"""fno_block_roofline (%): the bound of one call of the registered operator
``cfdbench_tpu_torch::fno_block`` at the cell's shapes (``reference/counts.py``)
over the device time per call of the kernels that operator launched."""

from portbench.metrics import share

OPERATOR = "cfdbench_tpu_torch::fno_block"


def read(run):
    a, (H, W) = run.cell.config["args"], run.cell.config["grid"]
    work = share.counts.fno_block(run.cell.mix["batch"], H, W, a["fno_hidden_dim"],
                                  a["fno_modes_x"], a["fno_modes_y"])
    return share.roofline(run.trace, OPERATOR, work)
