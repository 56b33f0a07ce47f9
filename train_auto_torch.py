#!/usr/bin/env python
"""Autoregressive training with the PyTorch/CUDA port (counterpart of
``train_auto.py``).

Usage:
    python train_auto_torch.py --model fno --data_name cavity_prop_bc_geo \
        --data_dir <root> --output_dir <result root> --mode train_test

``--model`` is fno, ffno, unet, resnet, auto_ffn, auto_deeponet,
auto_edeeponet, auto_deeponet_cnn or pixel_diffusion (ffn and deeponet
train with ``train_torch.py``, GenCast with ``train_gencast_torch.py``). It runs on the CUDA card and fails without one.
To run on the CPU (the FNO through its kernels' plain PyTorch versions),
call ``cfdbench_tpu_torch.cli.main_auto(argv, device="cpu")``.

Data parallelism over N cards: ``torchrun --nproc_per_node N
train_auto_torch.py ... --mesh_shape N`` (each rank on ``cuda:LOCAL_RANK``,
``--batch_size`` global).
"""

from cfdbench_tpu_torch.cli import main_auto

if __name__ == "__main__":
    main_auto()
