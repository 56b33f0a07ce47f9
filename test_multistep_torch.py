#!/usr/bin/env python
"""Multi-step rollout evaluation with the PyTorch/CUDA port
(counterpart of ``test_multistep.py``).

Usage:
    python test_multistep_torch.py --model fno --data_name cavity_prop_bc_geo \
        --data_dir <root> --output_dir <result root>

``--model`` is fno, ffno, unet, resnet, auto_ffn, auto_deeponet,
auto_edeeponet (auto_deeponet_cnn has no rollout) or pixel_diffusion, or
gencast (its two-frame window), or the non-autoregressive ffn or
deeponet, which generate each step's frame. It runs on the CUDA card and
fails without one.
To run on the CPU (the FNO through its kernels' plain PyTorch versions),
call ``cfdbench_tpu_torch.cli.main_multistep(argv, device="cpu")``.
"""

from cfdbench_tpu_torch.cli import main_multistep

if __name__ == "__main__":
    main_multistep()
