#!/usr/bin/env python
"""GenCast residual-diffusion training with the PyTorch/CUDA port
(counterpart of ``train_gencast.py``).

Usage:
    python train_gencast_torch.py --data_name cavity_prop_bc_geo \
        --data_dir <root> --output_dir <result root> --mode train_test \
        [--gradient_accumulation_steps 2 --use_gradient_checkpointing 1]

It runs on the CUDA card and fails without one. To run on the CPU, call
``cfdbench_tpu_torch.cli.main_gencast(argv, device="cpu")``. Roll the
trained model out with ``python test_multistep_torch.py --model gencast``
and the same flags.
"""

from cfdbench_tpu_torch.cli import main_gencast

if __name__ == "__main__":
    main_gencast()
