"""``chip_smoke.py`` phase 14b's runs on the default algorithms alone: phase
13b's U-Net, GenCast and FFN runs at ``--mesh_shape 1x2`` on two gloo ranks
on one card, then ``chip_smoke.replicas_check`` (each rank's weights equal
to the others', bit for bit). Prints PASS, or FAIL with the tensor that
parted.

It runs the checkout that holds it, or the one given as the first
argument (a copy with a trainer's model-rank gradient average removed
shows whether the check catches the loss of that average on this card).
With ``--deterministic`` the runs take PyTorch's deterministic algorithms
instead.

Usage, on a machine with one CUDA card:

    python3 scripts/replicas_check_torch.py [CHECKOUT] [--deterministic]
"""

import argparse
import shutil
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("checkout", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--deterministic", action="store_true")
    opts = parser.parse_args()
    tree = Path(opts.checkout).resolve()
    sys.path.insert(0, str(tree))
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics

    device = require_cuda()
    set_numerics()
    print(cs.sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"))
    data_root = cs.WORK / "dp_data"
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=cs.STEPS + 1,
                     grid=cs.GRID, seed=cs.SEED)
    jobs = cs.tp_default_jobs(data_root)
    root = cs.WORK / "replica_ranks"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    ranks_jobs = (jobs, ()) if opts.deterministic else ((), jobs)
    mp.spawn(cs.dp_rank, args=(cs.TP_RANKS, str(root), ranks_jobs[0], str(device), ranks_jobs[1]),
             nprocs=cs.TP_RANKS, join=True)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=True) for r in range(cs.TP_RANKS)]
    what = f"{'deterministic' if opts.deterministic else 'default'} algorithms, {tree}"
    print(f"[replicas] {time.perf_counter() - t0:.1f} s")
    try:
        cs.replicas_check(ranks, jobs)
    except RuntimeError as e:
        print(f"[replicas] FAIL, {what}: {e}")
    else:
        print(f"[replicas] PASS, {what}")
