"""``chip_smoke.py`` phase 15c's latent runs alone: the three latent
diffusion models under ``main_auto --mesh_shape 1x2 --shard_spatial 1`` at
default widths (and Lite on the TUBE_GRID tree), each epoch against one
process and its controls (the permuted-row controls and the float64 run),
a float64 step of each, and a rank's memory of a ``latent_diffusion2``
step (``chip_smoke.spatial_rest`` restricted to SP_LATENT and
``memory_latent``). The VAE is phase 10's: ``main_vae --mode
train_anneal`` for 2 epochs, then a third resumed, on phase 6's tree;
the data is phase 13's tree.

Usage, from the checkout's root:

    python3 scripts/sp_latent_check_torch.py        # on a machine with one CUDA card
    python3 scripts/sp_latent_check_torch.py cpu    # Lite on TUBE_GRID alone, one control
                                                    # seed and the float64 run, a seeded
                                                    # VAE, no memory record

Prints ``[sp]`` and ``[dp]`` lines, then one ``[latent]`` JSON line of the
launches by path, the memory records and the seconds; exits non-zero if a
gate fails. Writes under ``build/chip_smoke/``.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cpu = sys.argv[1:] == ["cpu"]
    t0 = time.perf_counter()
    from cfdbench_tpu_torch.cli import main_vae
    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.models import make_cfd_vae
    from cfdbench_tpu_torch.training import checkpoints

    if cpu:
        device, card = torch.device("cpu"), "cpu"
        checkpoints.save_params(make_cfd_vae("lite", generator=torch.Generator().manual_seed(3))
                                .state_dict(), cs.WORK / "vae_weights")
        keep = {"latent_diffusion_lite66"}
        cs.SP_CONTROL_SEEDS = cs.SP_CONTROL_SEEDS[:1]
        cs.SP_MEMORY = {}
    else:
        from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics

        device = require_cuda()
        set_numerics()
        card = cs.host_facts()
        train_root = cs.WORK / "train_data"
        generate_problem(train_root, "cavity", cases_per_subset=4, num_frames=6, grid=cs.GRID,
                         seed=cs.SEED)
        common = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(train_root),
                  "--output_dir", str(cs.WORK / "latent_result"), "--ldm_vae_weights_path",
                  str(cs.WORK / "vae_weights"), "--batch_size", "16"]
        main_vae(common + ["--mode", "train_anneal", "--num_epochs", "2"])
        main_vae(common + ["--mode", "train_anneal", "--num_epochs", "3", "--resume", "1"])
        keep = set(cs.SP_LATENT)
        cs.SP_MEMORY = {"memory_latent": cs.SP_MEMORY["memory_latent"]}
    data_root = cs.WORK / "dp_data"
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=cs.STEPS + 1,
                     grid=cs.GRID, seed=cs.SEED)
    cs.SP_CONTROLLED = tuple(n for n in cs.SP_CONTROLLED if n in keep)
    cs.SP_LATENT = {k: v for k, v in cs.SP_LATENT.items() if k in keep}
    jobs = cs.sp_rest_jobs

    def latent_jobs(*args):
        return [j for j in jobs(*args)
                if j[0].removesuffix("_step") in keep or j[0] in cs.SP_MEMORY]

    cs.sp_rest_jobs = latent_jobs
    t1 = time.perf_counter()
    counts, memory, _ = cs.spatial_rest(device, card, data_root, {"fno": None})
    print("[latent] " + json.dumps({"launches": counts, "memory": memory,
                                    "seconds_15c": time.perf_counter() - t1,
                                    "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
