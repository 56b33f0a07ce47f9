"""Whether the U-Net's one-process ``main_auto`` epoch of ``chip_smoke.py``
phase 13b (global batch 32, 12-case 64x64 tree) gives the same weights
twice on the card: twice with cuDNN's deterministic algorithms alone, then
twice under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
printing the ops it warns about. Phases 13b-14 run their comparisons with
one process under the second setting (``chip_smoke.py::dp_run``). Then
where the runs part: one float32 train step of that U-Net (phase 13b's
``step32``: seeded weights, a seeded padded batch of 32) twice under each
of the default algorithms, cuDNN's deterministic ones and every
deterministic algorithm, and which scores and which parameters' gradients
differ between the two.

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/determinism_check_torch.py
"""

import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cfdbench_tpu_torch.data.synthetic import generate_problem  # noqa: E402
from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics  # noqa: E402


def unet_epoch(data_root: Path, tag: str, device, every_algorithm: bool):
    """Phase 13b's one-process U-Net epoch into ``WORK/tag``, under every
    deterministic algorithm (``dp_run``) or cuDNN's alone: its weights and
    its run directory."""
    from cfdbench_tpu_torch import cli

    job = {n: (n, e, a) for n, e, a in cs.dp_jobs(data_root, cs.WORK / tag, "1")}["unet"]
    run = cs.trainer_run("main_auto", job[2])
    if every_algorithm:
        return cs.dp_run([job], device)["unet"], run
    torch.backends.cudnn.deterministic = True
    try:
        model = cli.main_auto(job[2], device=device).model
    finally:
        torch.backends.cudnn.deterministic = False
    return {"state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "names": [k for k, _ in model.named_parameters()]}, run


def step_twice(device, setting: str):
    """Phase 13b's float32 U-Net step twice under ``setting`` (``default``,
    ``cudnn`` or ``every``): whether the scores are equal, and the
    gradients that differ, each with its max diff over the largest
    gradient of the step."""
    every, cudnn = setting == "every", setting in ("cudnn", "every")
    saved = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(every, warn_only=True)
    torch.backends.cudnn.deterministic = cudnn
    try:
        a, b = (cs.dp_step(["--model", "unet", "--mesh_shape", "1"], device, torch.float32)
                for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=True)
        torch.backends.cudnn.deterministic = saved[1]
    top = max(g.abs().max().item() for g in a["grads"].values())
    parted = {k: (b["grads"][k] - g).abs().max().item() / top
              for k, g in a["grads"].items() if not torch.equal(b["grads"][k], g)}
    return a["scores"] == b["scores"], parted


def main() -> int:
    device = require_cuda()
    set_numerics()
    print(cs.sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"))
    data_root = cs.WORK / "dp_data"
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=cs.STEPS + 1,
                     grid=cs.GRID, seed=cs.SEED)
    for every in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (a, ra), (b, rb) = (unet_epoch(data_root, f"det_{every}_{i}", device, every)
                                for i in range(2))
        what = "every deterministic algorithm" if every else "cuDNN's deterministic algorithms"
        print(f"[det] {what}: parameters",
              cs.dp_params(b["state"], a["state"], a["names"], "second run against the first"),
              "of the largest, losses", cs.losses_rel(rb, ra))
        print(f"[det] {what}: {len(caught)} warnings",
              *sorted({str(w.message)[:160] for w in caught}), sep="\n[det]   ")
    for setting in ("default", "cudnn", "every"):
        same_scores, parted = step_twice(device, setting)
        print(f"[det] one step twice, {setting} algorithms: scores "
              f"{'equal' if same_scores else 'differ'}, {len(parted)} gradients differ",
              *(f"{k} {v:.3e} of the largest" for k, v in sorted(parted.items())),
              sep="\n[det]   ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
