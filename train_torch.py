#!/usr/bin/env python
"""Non-autoregressive training with the PyTorch/CUDA port (counterpart of
``train.py``).

Usage:
    python train_torch.py --model deeponet --data_name cavity_prop_bc_geo \
        --data_dir <root> --output_dir <result root> --mode train_test

``--model`` is ffn or deeponet. Runs land under
``<result root>/non-auto/<data>/dt<delta_time>/<model>/...``; roll a run
out with ``test_multistep_torch.py`` and the same flags. It runs on the
CUDA card and fails without one. To run on the CPU, call
``cfdbench_tpu_torch.cli.main_train(argv, device="cpu")``.

Data parallelism over N cards: ``torchrun --nproc_per_node N
train_torch.py ... --mesh_shape N`` (each rank on ``cuda:LOCAL_RANK``,
``--batch_size`` global).
"""

from cfdbench_tpu_torch.cli import main_train

if __name__ == "__main__":
    main_train()
