#!/usr/bin/env python
"""VAE training on the CUDA card (the PyTorch port's ``train_vae.py``).

Usage:
    python train_vae_torch.py --data_name cavity_prop_bc_geo --data_dir <root> \
        --ldm_vae_weights_path weights/vaelite_002 [--mode train_anneal]

Then train a latent diffusion model on it with ``train_ldm_torch.py``.

Data parallelism over N cards: ``torchrun --nproc_per_node N
train_vae_torch.py ... --mesh_shape N`` (each rank on ``cuda:LOCAL_RANK``,
``--batch_size`` global).
"""

from cfdbench_tpu_torch.cli import main_vae

if __name__ == "__main__":
    main_vae()
