#!/usr/bin/env python
"""Unconditional DDPM with an EMA on the CUDA card (the PyTorch port's
``train_diffusion_uncond.py``).

Usage:
    python train_diffusion_uncond_torch.py --data_name cavity_prop_bc_geo \
        --data_dir <root> --num_epochs 50

Data parallelism over N cards: ``torchrun --nproc_per_node N
train_diffusion_uncond_torch.py ... --mesh_shape N`` (each rank on ``cuda:LOCAL_RANK``,
``--batch_size`` global).
"""

from cfdbench_tpu_torch.cli import main_uncond

if __name__ == "__main__":
    main_uncond()
