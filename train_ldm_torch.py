#!/usr/bin/env python
"""Latent-diffusion training on the CUDA card (the PyTorch port's
``train_ldm.py``); ``--model latent_diffusion2`` unless one is given.

Two stages: train the VAE (``train_vae_torch.py``), then:
    python train_ldm_torch.py --data_name cavity_prop_bc_geo --data_dir <root> \
        --ldm_vae_weights_path weights/vaelite_002 --mode train_test
"""

import sys

from cfdbench_tpu_torch.cli import main_auto

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not any(a.startswith("--model") for a in argv):
        argv = ["--model", "latent_diffusion2"] + argv
    main_auto(argv)
