"""What fills ``chip_smoke.py`` phase 15c's memory records: one train step
of pixel diffusion at SP_PIXEL_BATCH and of the U-Net at b128 on
TUBE_GRID (``chip_smoke.sp_memory``, SP_MEMORY), in one process under
float32 cuDNN convolutions (TF32 off, as every entry point sets it), with
TF32 on, without cuDNN, and on the default algorithms, then on rank 0 of
``--mesh_shape 1x2 --shard_spatial 1`` (two gloo ranks on the one card,
TF32 off). For each: the step's bytes against the first's, and the
allocations live at the step's peak, from the allocator's history,
summed by the line of the port that made them (autograd's backward has
no Python frame), with the backward's largest.

Usage, on a machine with one CUDA card, from the checkout's root:

    python3 scripts/sp_memory_check_torch.py

Prints ``[memory]`` lines.
"""

import collections
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cfdbench_tpu_torch.utils.device import set_numerics  # noqa: E402

BACKWARD = "<no Python frame: autograd's backward>"


def site(frames) -> str:
    """The innermost frame of the port among ``frames``, else the first."""
    for f in frames:
        name = f.get("filename", "")
        if "cfdbench_tpu_torch/" in name:
            return f"{name.split('cfdbench_tpu_torch/')[-1]}:{f.get('line')} {f.get('name')}"
    if not frames:
        return BACKWARD
    return f"{frames[0].get('filename', '').split('/')[-1]}:{frames[0].get('line')}"


def traced_memory(argv, device, *args, **kwargs) -> dict:
    """``chip_smoke.sp_memory`` under the allocator's history: its record,
    with the live allocations at the traced peak by site."""
    torch.cuda.memory._record_memory_history(max_entries=500_000, stacks="python")
    try:
        record = _sp_memory(argv, device, *args, **kwargs)
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at = {}, 0, 0, 0
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            cur -= live.pop(e["addr"])
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], site(e.get("frames", [])))
        elif e["action"] in ("free_requested", "free_completed"):
            live.pop(e["addr"], None)
    sites = collections.defaultdict(lambda: [0, 0])
    for size, where in live.values():
        sites[where][0] += size
        sites[where][1] += 1
    record["peak_site"] = site(trace[at].get("frames", []))
    record["sites"] = sorted(([w, b, n] for w, (b, n) in sites.items()), key=lambda t: -t[1])[:6]
    record["backward_largest"] = sorted((s for s, w in live.values() if w == BACKWARD),
                                        reverse=True)[:4]
    return record


_sp_memory = cs.sp_memory
cs.sp_memory = traced_memory
set_numerics()  # as the entry points set it; the spawned ranks too


def main() -> None:
    import shutil

    import torch.multiprocessing as mp

    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.utils.device import require_cuda

    device = require_cuda()
    print(cs.sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"))
    data_root = cs.WORK / "dp_data"
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=cs.STEPS + 1,
                     grid=cs.GRID, seed=cs.SEED)

    def jobs(mesh):
        return [j for j in cs.sp_rest_jobs(data_root, data_root, cs.WORK / "memory_check", mesh)
                if j[0] in cs.SP_MEMORY]

    cudnn = torch.backends.cudnn
    runs = {"one process": cs.dp_run(jobs("1"), device)}
    cudnn.allow_tf32 = True
    runs["one process, TF32 on"] = cs.dp_run(jobs("1"), device)
    cudnn.allow_tf32, cudnn.enabled = False, False
    runs["one process, no cuDNN"] = cs.dp_run(jobs("1"), device)
    cudnn.enabled = True
    runs["one process, default algorithms"] = cs.dp_run(jobs("1"), device, deterministic=False)
    root = cs.WORK / "memory_check_ranks"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    mp.spawn(cs.dp_rank, args=(2, str(root), jobs("1x2"), str(device)), nprocs=2, join=True)
    runs["1x2 rank 0"] = torch.load(root / "rank0.pt", weights_only=True)
    base = runs["one process"]
    for name in cs.SP_MEMORY:
        for what, res in runs.items():
            r = res[name]
            print(f"[memory] {name}, {what}: step {r['step_bytes']} B "
                  f"({r['step_bytes'] / base[name]['step_bytes']:.3f}), second step "
                  f"{r['step2_bytes']} B, parameters {r['param_bytes']} B, Adam "
                  f"{r['adam_bytes']} B; the peak at {r['peak_site']}; the backward's "
                  f"largest live {r['backward_largest']} B")
            for where, nbytes, n in r["sites"]:
                print(f"[memory]   {nbytes:>12d} B in {n:>4d} at {where}")


if __name__ == "__main__":
    main()
