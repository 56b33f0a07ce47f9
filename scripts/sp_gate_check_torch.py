"""What ``chip_smoke.py`` phase 15c's checks make of a fault in the spatial
split of the point models: their one-epoch runs at ``--mesh_shape 1x2
--shard_spatial 1`` on two gloo ranks on one card against one process,
read against 15c's epoch gate (DP_DRIFT_FACTOR times the largest of the
permuted-row controls of SP_CONTROL_SEEDS, plus DP_RTOL, on the losses
and on the weights), and their float64 steps against ``dp_step_check``
(DP_RTOL).

``--fault`` picks what the ranks run: ``none`` (the split as it is),
``row_sum`` (``models/point.py::field_product`` without its sum over the
model ranks) or ``r0`` (every rank's query lattice from global row 0).
A fault is planted at import, from ``SP_FAULT`` in the environment, so
that the spawned ranks, which import this file again as their main
module, plant it too; no file changes. One process is never affected:
without a split the sum is the identity and every lattice starts at 0.

Usage, on a machine with one CUDA card, from the checkout's root:

    python3 scripts/sp_gate_check_torch.py [--fault none row_sum r0]

Prints one ``[gate]`` line a reading, with its gate and PASS or FAIL.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FAULTS = ("none", "row_sum", "r0")
FAULT = os.environ.get("SP_FAULT", "none")
if FAULT not in FAULTS:
    raise SystemExit(f"SP_FAULT={FAULT}: one of {FAULTS}")

import cfdbench_tpu_torch.models.point as point  # noqa: E402

if FAULT == "row_sum":
    point.row_sum = lambda x, axis: x
elif FAULT == "r0":
    _lattice = point.lattice_xy
    point.lattice_xy = lambda H, W, device=None, r0=0: _lattice(H, W, device=device)


def main() -> None:
    import argparse
    import shutil

    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from cfdbench_tpu_torch.cli import parse_args, run_dir
    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics

    parser = argparse.ArgumentParser()
    parser.add_argument("--fault", nargs="+", choices=FAULTS, default=list(FAULTS))
    opts = parser.parse_args()
    device = require_cuda()
    set_numerics()
    print(cs.sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"))
    data_root = cs.WORK / "dp_data"
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=cs.STEPS + 1,
                     grid=cs.GRID, seed=cs.SEED)
    names = set(cs.SP_POINT_MODELS) | {f"{n}_step" for n in cs.SP_POINT_MODELS}

    def jobs(out, mesh):
        return [j for j in cs.sp_rest_jobs(data_root, data_root, out, mesh) if j[0] in names]

    single = cs.WORK / "gate_single"
    one = jobs(single, "1")
    want = cs.dp_run(one, device)
    gates = {}
    for name in cs.SP_POINT_MODELS:
        argv = next(a for n, _, a in one if n == name)
        one_run = run_dir(parse_args(argv))
        ctl_loss = ctl_params = 0.0
        for seed in cs.SP_CONTROL_SEEDS:
            root = cs.WORK / f"gate_control{seed}"
            with cs.permuted_train_rows(seed):
                ctl = cs.dp_run([(name, "main_auto", [a.replace(str(single), str(root))
                                                      for a in argv])], device)[name]
            ctl_loss = max(ctl_loss, cs.losses_rel(root / one_run.relative_to(single), one_run))
            ctl_params = max(ctl_params, cs.dp_params(ctl["state"], want[name]["state"],
                                                      want[name]["names"], f"{name} control"))
        gates[name] = (cs.DP_DRIFT_FACTOR * ctl_loss + cs.DP_RTOL,
                       cs.DP_DRIFT_FACTOR * ctl_params + cs.DP_RTOL)
    for fault in opts.fault:
        os.environ["SP_FAULT"] = fault
        out = cs.WORK / f"gate_{fault}"
        mesh_jobs = jobs(out, "1x2")
        root = cs.WORK / f"gate_ranks_{fault}"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        mp.spawn(cs.dp_rank, args=(2, str(root), mesh_jobs, str(device)), nprocs=2, join=True)
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=True) for r in range(2)]
        for name, entry, argv in mesh_jobs:
            what = f"fault {fault}, {name}"
            if entry == "step":
                try:
                    cs.dp_step_check(name, ranks[0][name], want[name], what)
                    print(f"[gate] {what}: float64 step PASS")
                except RuntimeError as e:
                    print(f"[gate] {what}: float64 step FAIL ({e})")
                continue
            mesh_run = run_dir(parse_args(argv))
            loss = cs.losses_rel(mesh_run, single / mesh_run.relative_to(out))
            params = cs.dp_params(ranks[0][name]["state"], want[name]["state"],
                                  want[name]["names"], what)
            gate_loss, gate_params = gates[name]
            verdict = "PASS" if loss <= gate_loss and params <= gate_params else "FAIL"
            print(f"[gate] {what}: epoch losses {loss:.3e} (gate {gate_loss:.3e}), weights "
                  f"{params:.3e} of the largest (gate {gate_params:.3e}): {verdict}")


if __name__ == "__main__":
    main()
