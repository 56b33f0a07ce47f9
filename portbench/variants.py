"""The control and the faults that the comparison has to catch, planted into
the program once it is built (``harness.Run.plant``). ``calibrate.py`` reads
them on the card and the tests on the CPU; a benchmark run never plants
anything.

- ``tf32``, the control: the program's own lower-precision path, TF32
  products in cuBLAS and cuDNN and the FNO kernels' one-product TF32 mode
  (``--matmul_precision high``), where the configuration states float32.
- ``frozen``: a step that returns its state unchanged (a rollout step
  returns its input frame).
- ``half_batch``: half of the batch left out (a rollout step computes half
  the cases and repeats them).
- ``altered``: an answer altered where it is produced (one value of each
  predicted frame, by 1 % of the frame's largest).
"""

from __future__ import annotations

import torch


def tf32(task):
    from cfdbench_tpu_torch.models.fno import use_tf32
    from cfdbench_tpu_torch.utils.device import set_numerics

    set_numerics("high")
    use_tf32(task.model, True)


def frozen(task):
    task.predict_frame = lambda inputs, case_params, mask: inputs[..., :task.feedback_channels]


def half_batch(task):
    predict = task.predict_frame

    def repeated(inputs, case_params, mask):
        h = (inputs.shape[0] + 1) // 2
        out = predict(inputs[:h], case_params[:h], mask[:h])
        return torch.cat([out, out[: inputs.shape[0] - h]])

    task.predict_frame = repeated


def altered(task):
    predict = task.predict_frame

    def changed(inputs, case_params, mask):
        out = predict(inputs, case_params, mask).clone()
        out[0, 0, 0, 0] += 0.01 * out.abs().max()
        return out

    task.predict_frame = changed


VARIANTS = dict(tf32=tf32, frozen=frozen, half_batch=half_batch, altered=altered)
FAULTS = ("frozen", "half_batch", "altered")
