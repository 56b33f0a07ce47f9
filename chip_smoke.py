#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cfdbench_tpu_torch``).

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

1. Prints the card (name, power limit), the PyTorch, CUDA and nvcc
   versions, whether Triton imports, and builds both kernels from
   ``cfdbench_tpu_torch/csrc`` (build time and ptxas report).
2. Holds each kernel to its plain PyTorch version on the card, in float32
   with TF32 off (the block's output, and what it keeps for the backward:
   the pre-activation and x's retained modes), at the flagship widths
   (B=8, 64x64, 32 channels, 12 modes), at 66x65 (odd W), at the ragged
   18x17 with 10 channels (4 modes, 3 head outputs) and 16x16 with 8
   channels (modes clamped), and at the kernels' wider tilings: 64x136
   (the forward pass in three column chunks) and 66x80 with 128 channels
   (channel tiles, one row per item of the inverse-columns pass, the
   head's x single-buffered).
3. Drives the main path through its entry point: a synthetic 64x64
   cavity tree, a seeded flagship FNO (depth 4, width 32, 12 modes)
   saved as ``ckpt-0/model.pt``, then
   ``cfdbench_tpu_torch.cli.main_multistep``. The launch counters must
   show every FnoBlock (4 x 20) and every head (20) on the kernels, and
   ``multistep_metrics.json`` 20 finite per-step dicts.
4. Rolls the same weights out on the same cases through the kernels and
   through the plain versions; the per-step metrics must agree.
5. Times, with CUDA events, the 20-step rollout at batch 128 on both
   paths and each kernel against its plain version at batch 128, and
   prints each kernel's bound: the least time the card could take for
   the same work, the larger of its bytes (each input read once, each
   output written once) over 3.35 TB/s and its operations at the rate of
   the unit that does them: the products the kernels run in split TF32
   as three TF32 products each at 495 TFLOP/s, the rest (the block's
   mode mixing, the head's fc2) as float32 multiply-adds at 67 TFLOP/s
   (an H100 SXM's published dense rates). No single PyTorch call
   computes either kernel's function, so neither has a library time.
6. Trains on the card. (a) The flagship's nmse and every parameter's
   gradient at B=8 through the kernels' autograd Functions, against
   autograd through the plain versions. (b) ``cli.main_auto --mode
   train_test`` on a synthetic 64x64 cavity tree, 2 epochs of a few
   steps: 4 block and 1 head launches per train-step forward, eval batch
   and test case, finite ``ckpt-*/scores.json``; then ``main_multistep``
   rolls out the checkpoint it wrote. (c) The float32 train step at
   batch 128 (``trainer_auto.train_step``) on the kernel path and the
   plain path in turns, each split into forward, backward and update,
   with its peak memory.
7. The conv and point families at their default widths. (a) ``main_auto
   --mode train_test`` and ``main_multistep`` for the U-Net, ResNet,
   Auto-FFN, Auto-DeepONet and Auto-EDeepONet on the phase-6 tree (the
   Auto-DeepONetCNN's rollout must refuse by name): finite scores, 20
   finite per-step metrics, no FNO kernel launch. (b) Each model's eval
   forward on the card against the CPU's, and the loss and gradients of a
   U-Net and an Auto-DeepONet train step. (c) The U-Net's and ResNet's
   batch-128 train step (split, peak memory) and 20-step rollout.
8. The non-autoregressive FFN and DeepONet and the FFNO at their default
   widths. (a) ``main_train --mode train_test`` then ``main_multistep``
   for the FFN and DeepONet, ``main_auto --mode train_test`` then
   ``main_multistep`` for the FFNO, on the phase-6 tree: finite
   ``ckpt-*/scores.json``, ``dev_loss.json`` and ``test/scores.json``, 20
   finite per-step metrics, no FNO kernel launch. (b) Eval forwards on
   the card against the CPU's, and the loss and every gradient of a
   DeepONet and an FFNO train step, at phase 6a's bounds. (c) The FFNO's
   batch-128 train step (split, peak memory) and 20-step rollout, and the
   FFN's and DeepONet's batch-128 train step at 1000 points a sample and
   20-step whole-lattice generation over 128 cases.
9. Pixel diffusion and GenCast (PUNetG, base 64, mults 1-2-4, 2 res
   blocks, 1000 train timesteps, 50 denoising steps). (a) ``main_auto
   --model pixel_diffusion --mode train_test`` then ``main_multistep``;
   ``main_gencast --mode train_test --gradient_accumulation_steps 2
   --use_gradient_checkpointing 1`` then ``main_multistep --model
   gencast``, on the phase-6 tree: finite checkpoints on the host, dev
   scores of generated frames (pixel diffusion's ``nmse``, GenCast's
   ``gen_frame_nmse``), finite test scores, 20 finite frames, no FNO
   kernel launch. (b) With dropout 0 and the same draws (made on the CPU)
   on both devices: the PUNetG eval forward, each task's loss and every
   gradient, and one 50-step DDPM frame, card against CPU, at phase 7b's
   and 6a's bounds. (c) At batch 8 and 32: each model's float32 train
   step (split, peak memory, device operations a step), one denoise call,
   one 50-step DDPM frame and the 20-step rollout in frames/s.

``launches`` in the kernels' record is phase 3's count (main_multistep),
``launches_by_path`` each main path's own: main_multistep's and
main_auto's, each read from counters set to 0 just before the run and
read just after it. The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 0
STEPS = 20
WIDTH, MODES = 32, 12  # the flagship's, for the kernel phases
GRID = 64
# Bounds against the plain versions (float32, different summation order:
# truncated-DFT sums against cuFFT, FMA chains against cuBLAS).
BLOCK_ATOL = 1e-4
HEAD_ATOL = 1e-5
XM_RTOL = 1e-5  # x's retained modes, sums over the grid: relative to the largest
ROLLOUT_RTOL = 1e-4
TIMING_BATCH = 128
# Phase 6: the train step's loss and gradients through the kernels'
# autograd Functions against autograd through the plain versions (the
# forwards differ by the kernels' float32 rounding, about 3e-6).
GRAD_BATCH = 8
GRAD_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # max abs diff of each gradient tensor over its max |grad|
TRAIN_EPOCHS = 2
TRAIN_REPS = 5
# Phase 7: the conv and point families at their default widths.
FAMILIES = ("unet", "resnet", "auto_ffn", "auto_deeponet", "auto_edeeponet",
            "auto_deeponet_cnn")
FAMILY_BATCH = 4
FAMILY_RTOL = 1e-4  # card against CPU forward: max abs diff over max |out|
# A bias that feeds a train-mode BatchNorm has no gradient in exact
# arithmetic (the batch mean removes it): on either device its gradient
# is rounding, held below this share of the model's largest gradient.
ZERO_GRAD_RTOL = 1e-5
# Phase 8: the non-autoregressive FFN and DeepONet, and the FFNO, at their
# default widths.
NONAUTO = ("ffn", "deeponet")
PHASE8 = NONAUTO + ("ffno",)
# Phase 9: pixel diffusion and GenCast at their default widths.
GENERATIVE = ("pixel_diffusion", "gencast")
GEN_BATCHES = (8, 32)  # the trainers' default batch, and a larger one
GEN_CHECK_BATCH = 2
# Residual statistics for the GenCast task outside main_gencast.
GEN_STATS = dict(residual_mean=[0.01, -0.02], residual_std=[0.1, 0.2])
# (B, H, W, channels, modes, head outputs) of phase 2.
CHECK_SHAPES = ((8, GRID, GRID, WIDTH, MODES, 2), (8, GRID + 2, GRID + 1, WIDTH, MODES, 2),
                (3, 18, 17, 10, 4, 3), (17, 16, 16, 8, MODES, 2),
                (4, GRID, 136, WIDTH, MODES, 2), (4, GRID + 2, 80, 128, MODES, 2))
# An H100 SXM's published peaks (NVIDIA's data sheet, dense rates): device
# memory bytes/s, TF32 FLOP/s on the tensor cores and float32 FLOP/s outside
# them. A split-TF32 product (csrc/tf32.cuh) is three TF32 products.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12
SPLIT_TF32_PRODUCTS = 3


def sh(*cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(plain, kernel, reps: int):
    """Warm up, then time in turns plain, kernel, kernel, plain; returns
    (plain_ms, kernel_ms), each the mean of its two turns."""
    plain(), kernel()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


def host_facts():
    from cfdbench_tpu_torch.ops import _build

    card = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print("nvcc:", sh(_build.find_nvcc(), "--version").splitlines()[-1])
    try:
        import triton

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    t0 = time.perf_counter()
    _build.build_library()
    _build.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    log = _build.BUILD_DIR / "nvcc.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
    return card


def kernel_inputs(B, H, W, C, gen, device, modes=MODES, n_out=2):
    from cfdbench_tpu_torch.ops.spectral import init_spectral_weights

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    # Spectral weights at C times their init scale, so the spectral path
    # is as large as the bypass and an error in it cannot hide.
    weights = (init_spectral_weights(gen, C, C, modes, modes) * C).to(device)
    mask = torch.ones((B, H, W, 1))
    mask[:, H // 3: H // 2, W // 4: W // 2] = 0
    return dict(
        x=rnd(B, H, W, C), weights=weights, w0=rnd(C, C, scale=C ** -0.5),
        b0=rnd(C, scale=0.1), w1=rnd(128, C, scale=C ** -0.5),
        b1=rnd(128, scale=0.1), w2=rnd(n_out, 128, scale=128 ** -0.5),
        b2=rnd(n_out, scale=0.1), mask=mask.to(device),
    )


def block_work(B, H, W, Ci, Co, modes):
    """(bytes, multiply-adds on the tensor cores, on the CUDA cores) of one
    FnoBlock call: x, the weights and the output once each; the truncated
    DFTs both ways and the 1x1 bypass (split TF32), the per-mode mixing
    (float32 FMA), at the clamped mode counts."""
    from cfdbench_tpu_torch.ops.spectral import clamp_modes

    m1, m2 = clamp_modes(H, W, modes, modes)
    K = 2 * m1
    nbytes = 4 * (B * H * W * Ci + 4 * Ci * Co * modes * modes + Co * Ci + Co + B * H * W * Co)
    tensor = (B * H * Ci * 2 * m2 * W + B * m2 * Ci * 2 * K * 2 * H    # forward: rows, columns
              + B * m2 * Co * 2 * H * 2 * K + B * H * W * Co * 2 * m2  # inverse: columns, rows
              + B * H * W * Ci * Co)                                   # 1x1 bypass
    return nbytes, tensor, B * K * m2 * 2 * Ci * 2 * Co  # per-mode complex mixing


def head_work(B, H, W, C, hidden, n_out):
    """(bytes, multiply-adds on the tensor cores, on the CUDA cores) of one
    head call: x, the mask, the weights and the output once each; fc1
    (split TF32) and fc2 (float32 FMA). The erf of GELU is not counted."""
    n = B * H * W
    nbytes = 4 * (n * C + n + hidden * C + hidden + n_out * hidden + n_out + n * n_out)
    return nbytes, n * C * hidden, n * hidden * n_out


def bound(nbytes: int, tensor_fma: int, core_fma: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations at their units' rates, split-TF32 products as three
    TF32 products on the tensor cores plus float32 FMA on the CUDA cores."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (SPLIT_TF32_PRODUCTS * 2 * tensor_fma / TF32_FLOP_PER_S
              + 2 * core_fma / F32_FLOP_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernels(device):
    """Phase 2: each kernel against its plain version; returns the max
    abs error per kernel over the shapes."""
    from cfdbench_tpu_torch.ops import fno_kernels as fk

    gen = torch.Generator().manual_seed(SEED)
    worst = {"fno_block": 0.0, "fno_head": 0.0}
    for B, H, W, C, modes, n_out in CHECK_SHAPES:
        t = kernel_inputs(B, H, W, C, gen, device, modes, n_out)
        block_args = (t["x"], t["weights"], t["w0"], t["b0"], modes, modes)
        head_args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["mask"])
        for name, kern, ref, args, atol in (
            ("fno_block", fk.fno_block, fk.fno_block_reference, block_args, BLOCK_ATOL),
            ("fno_head", fk.fno_head, fk.fno_head_reference, head_args, HEAD_ATOL),
        ):
            got, want = kern(*args), ref(*args)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {B}x{H}x{W}: shape {tuple(got.shape)} "
                                   f"vs {tuple(want.shape)} or non-finite output")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            print(f"[kernel] {name} B={B} {H}x{W} C={C} modes={modes}: max abs err {err:.3e} "
                  f"(bound {atol:.0e}), max rel err {rel:.3e}")
            if not err <= atol:
                raise RuntimeError(f"{name} {H}x{W} disagrees with its plain version: "
                                   f"{err:.3e} > {atol:.0e}")
            worst[name] = max(worst[name], err)
        check_saved(block_args)
    return worst


def check_saved(block_args):
    """What the block kernel leaves for the backward under grad — the
    pre-activation and x's retained modes — against the plain versions."""
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk

    x = block_args[0]
    _, xm, pre = fk._block_call(_build.load_library(), *block_args,
                                torch.cuda.current_stream().cuda_stream, keep=True)
    want_xm, want_pre = fk.fno_block_saved_reference(*block_args)
    err = (pre - want_pre).abs().max().item()
    rel = ((xm - want_xm).abs().max() / want_xm.abs().max()).item()
    print(f"[kernel] fno_block B={x.shape[0]} {x.shape[1]}x{x.shape[2]} saved for the backward: "
          f"pre-activation max abs err {err:.3e} (bound {BLOCK_ATOL:.0e}), retained modes max "
          f"err / max {rel:.3e} (bound {XM_RTOL:.0e})")
    if not (err <= BLOCK_ATOL and rel <= XM_RTOL):
        raise RuntimeError(f"fno_block's saved outputs disagree at {tuple(x.shape)}")


def flagship_model(device):
    from cfdbench_tpu_torch.models.fno import FLAGSHIP, Fno2d

    return Fno2d(n_case_params=5, **FLAGSHIP,
                 generator=torch.Generator().manual_seed(SEED), device=device)


def plain_rollout(model):
    from cfdbench_tpu_torch.models.fno import PlainFno2d
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn

    return make_rollout_fn(PlainFno2d(model), STEPS)


def main_path():
    """Phase 3: the port's main_multistep at the flagship width. Returns
    the launch counts of that run and the test split's arrays."""
    from cfdbench_tpu_torch.cli import main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.data import generate_all, load_test_cases
    from cfdbench_tpu_torch.models.fno import FLAGSHIP
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts
    from cfdbench_tpu_torch.training.checkpoints import save_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    data_root, out_root = WORK / "data", WORK / "result"
    t0 = time.perf_counter()
    # 30 cases per subset: the seeded 80/10/10 split leaves 9 test cases.
    generate_all(data_root, cases_per_subset=30, num_frames=STEPS + 1, grid=GRID, seed=SEED)
    argv = [
        "--model", "fno", "--data_name", "cavity_prop_bc_geo",
        "--data_dir", str(data_root), "--output_dir", str(out_root),
        "--fno_depth", str(FLAGSHIP["num_layers"]),
        "--fno_hidden_dim", str(FLAGSHIP["hidden_dim"]),
        "--fno_modes_x", str(FLAGSHIP["modes1"]), "--fno_modes_y", str(FLAGSHIP["modes2"]),
    ]
    args = parse_args(argv)
    save_checkpoint(flagship_model("cpu").state_dict(), run_dir(args) / "ckpt-0",
                    ep=0, dev_loss=0.0)
    print(f"[main] synthetic tree + checkpoint: {time.perf_counter() - t0:.2f} s")

    reset_launch_counts()
    t0 = time.perf_counter()
    main_multistep(argv)
    counts = launch_counts()
    print(f"[main] main_multistep: {time.perf_counter() - t0:.2f} s, launches {counts}")
    want = {"fno_block": FLAGSHIP["num_layers"] * STEPS, "fno_head": STEPS}
    if counts != want:
        raise RuntimeError(f"main path launches {counts}, expected {want}")
    metrics = json.loads((run_dir(args) / "multistep_metrics.json").read_text())
    if len(metrics) != STEPS or not all(
        set(m) == {"mse", "nmse", "mae"} and all(math.isfinite(v) for v in m.values())
        for m in metrics
    ):
        raise RuntimeError(f"multistep_metrics.json is not {STEPS} finite dicts: {metrics}")
    print(f"[main] multistep_metrics.json: {STEPS} finite steps, "
          f"step-1 nmse {metrics[0]['nmse']:.6g}, step-20 nmse {metrics[-1]['nmse']:.6g}")
    features, case_params = load_test_cases(args, STEPS)
    return counts, features, torch.from_numpy(case_params)


def compare_rollouts(device, features, case_params):
    """Phase 4: the same weights rolled out through the kernels and
    through the plain versions give the same per-step metrics."""
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn, multistep_metrics

    model = flagship_model(device).eval()
    frame0 = torch.from_numpy(features[:, 0, :, :, :2].copy()).to(device)
    mask_np = features[:, 0, :, :, 2:3]
    mask = torch.from_numpy(mask_np.copy()).to(device)
    cp = case_params.to(device)
    runs, frames = {}, {}
    for name, roll in (("kernel", make_rollout_fn(model, STEPS)), ("plain", plain_rollout(model))):
        frames[name] = roll(frame0, cp, mask)
        runs[name] = multistep_metrics(frames[name], features, mask_np)
    # The frames themselves, relative to their largest value: random
    # weights predict small fields, which the metrics alone barely see.
    frame_rel = ((frames["kernel"] - frames["plain"]).abs().max()
                 / frames["plain"].abs().max()).item()
    print(f"[rollout] kernel vs plain frames after {STEPS} steps: max abs diff / max "
          f"|frame| {frame_rel:.3e} (bound {ROLLOUT_RTOL:.0e})")
    if not frame_rel <= ROLLOUT_RTOL:
        raise RuntimeError(f"rollout frames disagree: {frame_rel:.3e} > {ROLLOUT_RTOL}")
    worst = 0.0
    for s, (a, b) in enumerate(zip(runs["kernel"], runs["plain"])):
        for key in a:
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
            worst = max(worst, rel)
            if not rel <= ROLLOUT_RTOL:
                raise RuntimeError(f"step {s + 1} {key}: kernel {a[key]!r} vs plain "
                                   f"{b[key]!r} (rel {rel:.3e} > {ROLLOUT_RTOL})")
    print(f"[rollout] {features.shape[0]} cases x {STEPS} steps, kernel vs plain metrics: "
          f"max rel diff {worst:.3e} (bound {ROLLOUT_RTOL:.0e})")


def timing(device, card):
    """Phase 5: rollout frames/s at batch 128 and each kernel against its
    plain version at batch 128, by CUDA events, in turns."""
    from cfdbench_tpu_torch.ops import fno_kernels as fk
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn

    B, H, W = TIMING_BATCH, GRID, GRID
    gen = torch.Generator().manual_seed(SEED + 1)
    model = flagship_model(device).eval()
    frame0 = torch.randn((B, H, W, 2), generator=gen).to(device)
    cp = torch.randn((B, 5), generator=gen).to(device)
    mask = torch.ones((B, H, W, 1))
    mask[:, 20:30, 10:40] = 0
    mask = mask.to(device)
    kernel_roll = make_rollout_fn(model, STEPS)
    plain_roll = plain_rollout(model)
    plain_ms, kern_ms = interleaved_ms(lambda: plain_roll(frame0, cp, mask),
                                       lambda: kernel_roll(frame0, cp, mask), reps=3)
    frames = B * STEPS
    print(f"[time] [{card}] rollout b{B} x {STEPS} steps: kernel path {kern_ms:.3f} ms "
          f"= {frames / kern_ms * 1e3:.1f} frames/s; plain path {plain_ms:.3f} ms "
          f"= {frames / plain_ms * 1e3:.1f} frames/s")

    t = kernel_inputs(B, H, W, WIDTH, gen, device)
    block_args = (t["x"], t["weights"], t["w0"], t["b0"], MODES, MODES)
    head_args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["mask"])
    work = {"fno_block": block_work(B, H, W, WIDTH, WIDTH, MODES),
            "fno_head": head_work(B, H, W, WIDTH, t["w1"].shape[0], t["w2"].shape[0])}
    times = {}
    with torch.inference_mode():
        for name, kern, ref, args in (
            ("fno_block", fk.fno_block, fk.fno_block_reference, block_args),
            ("fno_head", fk.fno_head, fk.fno_head_reference, head_args),
        ):
            p, k = interleaved_ms(lambda: ref(*args), lambda: kern(*args), reps=20)
            bound_ms, bound_by = bound(*work[name])
            times[name] = dict(ms=k, plain_ms=p, bound_ms=bound_ms, bound_by=bound_by)
            nbytes, tensor_fma, core_fma = work[name]
            print(f"[time] [{card}] {name} B={B} {H}x{W} C={WIDTH}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms ({p / k:.2f}x); bound {bound_ms:.4f} ms by {bound_by} "
                  f"({nbytes / 1e6:.1f} MB; {tensor_fma / 1e9:.3f} G multiply-adds in split "
                  f"TF32, {core_fma / 1e9:.3f} G in float32 FMA), kernel at "
                  f"{bound_ms / k:.1%} of it; library call: none")
    return times


def train_inputs(B, gen, device):
    """A seeded batch for the flagship at 64x64 (mask with a hole)."""
    mask = torch.ones((B, GRID, GRID, 1))
    mask[:, 20:30, 10:40] = 0
    batch = dict(inputs=torch.randn((B, GRID, GRID, 2), generator=gen),
                 labels=torch.randn((B, GRID, GRID, 2), generator=gen),
                 case_params=torch.randn((B, 5), generator=gen), mask=mask,
                 weights=torch.ones(B))
    return {k: v.to(device) for k, v in batch.items()}


def plain_task(model):
    from cfdbench_tpu_torch.models.fno import PlainFno2d

    return nmse_task(PlainFno2d(model))


def nmse_task(model):
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.training.trainer_auto import AutoTask

    return AutoTask(model, loss_name_to_fn("nmse"))


def check_gradients(device):
    """Phase 6a: the loss and every parameter's gradient of the flagship
    at B=8 through FnoBlockFn/FnoHeadFn, against autograd through the
    plain versions on the same weights and batch."""
    model = flagship_model(device)
    batch = train_inputs(GRAD_BATCH, torch.Generator().manual_seed(SEED + 2), device)
    runs = {}
    for name, task in (("kernel", nmse_task(model)), ("plain", plain_task(model))):
        model.zero_grad(set_to_none=True)
        loss, _ = task.loss_scores(batch)
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = loss.item(), {k: p.grad for k, p in model.named_parameters()}
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[grad] flagship B={GRAD_BATCH} {GRID}x{GRID}: nmse kernel {loss_k:.9g}, plain "
          f"{loss_p:.9g}, rel diff {loss_rel:.3e} (bound {GRAD_LOSS_RTOL:.0e})")
    if not loss_rel <= GRAD_LOSS_RTOL:
        raise RuntimeError(f"train loss through the kernels disagrees: {loss_rel:.3e}")
    worst = 0.0
    for k, want in grads_p.items():
        got = grads_k[k]
        if got is None or not torch.isfinite(got).all():
            raise RuntimeError(f"{k}: no finite gradient through the kernels")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"[grad]   {k} {tuple(want.shape)}: max abs diff / max |grad| {rel:.3e}")
        if not rel <= GRAD_RTOL:
            raise RuntimeError(f"{k}: gradient disagrees, {rel:.3e} > {GRAD_RTOL:.0e}")
        worst = max(worst, rel)
    print(f"[grad] {len(grads_p)} gradients: worst {worst:.3e} (bound {GRAD_RTOL:.0e})")


def train_path(grid: int = GRID):
    """Phase 6b: ``main_auto --mode train_test`` at the flagship width on
    a synthetic cavity tree, 2 epochs of a few steps; then
    ``main_multistep`` rolls out the checkpoint it wrote. Returns
    main_auto's launches."""
    from cfdbench_tpu_torch.cli import main_auto, main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.data import get_auto_dataset
    from cfdbench_tpu_torch.data.pipeline import num_batches
    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.models.fno import FLAGSHIP
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    data_root, out_root = WORK / "train_data", WORK / "train_result"
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=6, grid=grid, seed=SEED)
    argv = [
        "--model", "fno", "--data_name", "cavity_prop_bc_geo",
        "--data_dir", str(data_root), "--output_dir", str(out_root),
        "--fno_depth", str(FLAGSHIP["num_layers"]),
        "--fno_hidden_dim", str(FLAGSHIP["hidden_dim"]),
        "--fno_modes_x", str(FLAGSHIP["modes1"]), "--fno_modes_y", str(FLAGSHIP["modes2"]),
    ]
    train_flags = ["--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS),
                   "--eval_interval", "1", "--batch_size", "16", "--eval_batch_size", "16",
                   "--log_interval", "1"]
    args = parse_args(argv + train_flags)
    train, dev, test = get_auto_dataset(data_root, args.data_name, args.delta_time,
                                        True, True, seed=args.seed)
    # Forwards: one per train step; per eval epoch one per dev batch and
    # one for example.png; one per test case (batch 1).
    steps = num_batches(len(train), args.batch_size)
    evals = num_batches(len(dev), args.eval_batch_size) + 1
    forwards = TRAIN_EPOCHS * (steps + evals) + len(test)
    reset_launch_counts()
    t0 = time.perf_counter()
    main_auto(argv + train_flags)
    counts = launch_counts()
    print(f"[train] main_auto: {time.perf_counter() - t0:.2f} s, {len(train)} train pairs, "
          f"{TRAIN_EPOCHS} epochs x {steps} steps, {evals} eval forwards an epoch, "
          f"{len(test)} test cases; launches {counts}")
    want = {"fno_block": FLAGSHIP["num_layers"] * forwards, "fno_head": forwards}
    if counts != want:
        raise RuntimeError(f"main_auto launches {counts}, expected {want}: "
                           f"{FLAGSHIP['num_layers']} blocks and 1 head per forward")
    run = run_dir(args)
    for ep in range(TRAIN_EPOCHS):
        scores = json.loads((run / f"ckpt-{ep}" / "scores.json").read_text())
        if not (math.isfinite(scores["train_loss"]) and math.isfinite(scores["dev_loss"])):
            raise RuntimeError(f"ckpt-{ep}/scores.json is not finite: {scores}")
        print(f"[train] ckpt-{ep}/scores.json: {scores}")
        # The checkpoint a card wrote loads on a machine without one.
        devices = {str(v.device) for v in torch.load(
            run / f"ckpt-{ep}" / "model.pt", weights_only=True).values()}
        if devices != {"cpu"}:
            raise RuntimeError(f"ckpt-{ep}/model.pt holds tensors on {devices}, not the host")
    test_scores = json.loads((run / "test" / "scores.json").read_text())["mean"]
    if not all(math.isfinite(v) for v in test_scores.values()):
        raise RuntimeError(f"test/scores.json is not finite: {test_scores}")
    print(f"[train] test/scores.json mean: {test_scores}")

    reset_launch_counts()
    main_multistep(argv)
    rollout = launch_counts()
    want = {"fno_block": FLAGSHIP["num_layers"] * STEPS, "fno_head": STEPS}
    metrics = json.loads((run / "multistep_metrics.json").read_text())
    if rollout != want or len(metrics) != STEPS or not all(
            math.isfinite(v) for m in metrics for v in m.values()):
        raise RuntimeError(f"main_multistep on the trained checkpoint: launches {rollout} "
                           f"(expected {want}), metrics {metrics}")
    print(f"[train] main_multistep on the trained checkpoint: launches {rollout}, "
          f"step-20 nmse {metrics[-1]['nmse']:.6g}")
    return counts


def step_split(loss_scores, opt, sched, device):
    """A train step (``trainer_auto.train_step`` or
    ``trainer_nonauto.train_step``, whose forward and loss are
    ``loss_scores()``) TRAIN_REPS times with an event between its parts:
    mean forward (with the loss), backward and update ms, and the peak
    memory of those steps."""
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(TRAIN_REPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for ev in marks:
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss, _ = loss_scores()
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        sched.step()
        ev[3].record()
    torch.cuda.synchronize()
    fwd, bwd, upd = (sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / TRAIN_REPS
                     for i in range(3))
    return dict(forward_ms=fwd, backward_ms=bwd, update_ms=upd,
                peak_mib=torch.cuda.max_memory_allocated(device) / 2**20)


def split_text(r) -> str:
    total = r["forward_ms"] + r["backward_ms"] + r["update_ms"]
    return (f"forward {r['forward_ms']:.3f} ms, backward {r['backward_ms']:.3f} ms, update "
            f"{r['update_ms']:.3f} ms; backward {r['backward_ms'] / total:.1%} of the step; "
            f"peak memory {r['peak_mib']:.1f} MiB")


def train_step_timing(device, card):
    """Phase 6c: the float32 train step at batch 128 (Adam, forward,
    backward, update; ``trainer_auto.train_step``) on the kernel path and
    on the all-plain autograd path, by CUDA events, in turns; then each
    path's split into forward, backward and update, and its peak memory."""
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import train_step

    batch = train_inputs(TIMING_BATCH, torch.Generator().manual_seed(SEED + 3), device)
    paths = {}
    for name in ("plain", "kernel"):
        model = flagship_model(device)
        task = nmse_task(model) if name == "kernel" else plain_task(model)
        paths[name] = (task, *make_adam(model.parameters(), 1e-4))
    step = {name: (lambda p=p: train_step(*p, batch)) for name, p in paths.items()}
    plain_ms, kern_ms = interleaved_ms(step["plain"], step["kernel"], reps=TRAIN_REPS)
    print(f"[time] [{card}] train step b{TIMING_BATCH} {GRID}x{GRID} f32: kernel path "
          f"{kern_ms:.3f} ms, plain path {plain_ms:.3f} ms (kernel/plain {kern_ms / plain_ms:.3f})")
    result = {}
    for name, (task, opt, sched) in paths.items():
        result[name] = step_split(lambda: task.loss_scores(batch), opt, sched, device)
        print(f"[time] [{card}] train step b{TIMING_BATCH}, {name} path: "
              + split_text(result[name]))
    result.update(kernel_ms=kern_ms, plain_ms=plain_ms)
    return result


def family_argv(name: str, data_root: Path):
    return ["--model", name, "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(WORK / "family_result")]


def finite_scores(run: Path, what: str) -> dict:
    scores = {f"ckpt-{ep}": json.loads((run / f"ckpt-{ep}" / "scores.json").read_text())
              for ep in range(TRAIN_EPOCHS)}
    scores["test"] = json.loads((run / "test" / "scores.json").read_text())["mean"]
    if not all(math.isfinite(v) for d in scores.values() for v in d.values()
               if isinstance(v, float)):
        raise RuntimeError(f"{what}: scores are not finite: {scores}")
    return scores


def family_paths():
    """Phase 7a: ``main_auto --mode train_test`` and ``main_multistep``
    for each model of the conv and point families at its default widths,
    on the phase-6 tree. Returns each model's step-20 nmse."""
    from cfdbench_tpu_torch.cli import main_auto, main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    data_root = WORK / "train_data"
    train_flags = ["--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS),
                   "--eval_interval", "1", "--batch_size", "16", "--eval_batch_size", "16",
                   "--log_interval", "100"]
    result = {}
    for name in FAMILIES:
        argv = family_argv(name, data_root)
        run = run_dir(parse_args(argv))
        reset_launch_counts()
        t0 = time.perf_counter()
        main_auto(argv + train_flags)
        scores = finite_scores(run, name)
        t1 = time.perf_counter()
        if name == "auto_deeponet_cnn":
            try:
                main_multistep(argv)
            except ValueError as e:
                if "has no rollout" not in str(e):
                    raise
                print(f"[family] {name}: main_multistep refuses, as it must: {e}")
            else:
                raise RuntimeError(f"main_multistep --model {name} did not refuse")
            result[name] = None
        else:
            frames = main_multistep(argv)
            channels = 1 if name.startswith("auto_") else 2
            metrics = json.loads((run / "multistep_metrics.json").read_text())
            if (frames.shape[0] != STEPS or frames.shape[-1] != channels
                    or not torch.isfinite(frames).all() or len(metrics) != STEPS
                    or not all(math.isfinite(v) for m in metrics for v in m.values())):
                raise RuntimeError(f"{name}: rollout frames {tuple(frames.shape)} (expected "
                                   f"{STEPS} steps of {channels} channels), metrics {metrics}")
            result[name] = metrics[-1]["nmse"]
        counts = launch_counts()
        if any(counts.values()):
            raise RuntimeError(f"{name} launched FNO kernels: {counts}")
        print(f"[family] {name}: main_auto {t1 - t0:.2f} s, dev loss "
              f"{[scores[f'ckpt-{ep}']['dev_loss'] for ep in range(TRAIN_EPOCHS)]}, test nmse "
              f"{scores['test']['nmse']:.6g}; main_multistep {time.perf_counter() - t1:.2f} s, "
              f"step-20 nmse {result[name]}; FNO kernel launches {counts}")
    return result


def family_model(name: str, device, seed: int = SEED):
    """``name`` at its default widths on 64x64 with 5 case parameters,
    from a seeded init; the U-Net's running statistics set off their
    init values, so that its eval forward uses them."""
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.models import init_auto_model

    model = init_auto_model(Args(model=name), n_case_params=5, field_shape=(GRID, GRID),
                            generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for key, buf in model.named_buffers():
            if key.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 2.0, generator=gen)
    return model.to(device)


def zero_in_exact_arithmetic(key: str) -> bool:
    """A U-Net bias that runs only into a train-mode BatchNorm: the conv
    biases of every DoubleConv, and the upsampling's, whose constant the
    next replicate-padded conv keeps constant (at even grids)."""
    return key.endswith((".conv1.0.bias", ".conv2.0.bias", ".up.bias"))


def family_card_vs_cpu(device):
    """Phase 7b: eval forwards on the card against the CPU, then the loss
    and gradients of one train-mode step of the U-Net and Auto-DeepONet."""
    batch_cpu = train_inputs(FAMILY_BATCH, torch.Generator().manual_seed(SEED + 4), "cpu")
    batch = {k: v.to(device) for k, v in batch_cpu.items()}
    args = ("inputs", "case_params", "mask")
    for name in FAMILIES:
        models = {"cpu": family_model(name, "cpu").eval(), "card": family_model(name, device).eval()}
        with torch.no_grad():
            want = models["cpu"](*(batch_cpu[k] for k in args))
            got = models["card"](*(batch[k] for k in args)).cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"[family] {name} eval forward B={FAMILY_BATCH} {GRID}x{GRID}, card vs CPU: max abs "
              f"diff / max |out| {rel:.3e} (bound {FAMILY_RTOL:.0e})")
        if not (got.shape == want.shape and rel <= FAMILY_RTOL):
            raise RuntimeError(f"{name}: card and CPU forwards disagree ({rel:.3e})")
    for name in ("unet", "auto_deeponet"):
        runs = {}
        for where, b in (("cpu", batch_cpu), ("card", batch)):
            model = family_model(name, "cpu" if where == "cpu" else device).train()
            loss, _ = nmse_task(model).loss_scores(b)
            loss.backward()
            runs[where] = loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}
        (loss_c, grads_c), (loss_g, grads_g) = runs["cpu"], runs["card"]
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        top = max(g.abs().max().item() for g in grads_c.values())
        worst, zeros = 0.0, 0
        for k, want in grads_c.items():
            got = grads_g[k]
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {k}: no finite gradient on the card")
            if name == "unet" and zero_in_exact_arithmetic(k):
                noise = max(got.abs().max().item(), want.abs().max().item()) / top
                if not noise <= ZERO_GRAD_RTOL:
                    raise RuntimeError(f"{name} {k}: gradient {noise:.3e} of the largest, "
                                       f"where exact arithmetic gives 0")
                zeros += 1
                continue
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not rel <= GRAD_RTOL:
                raise RuntimeError(f"{name} {k}: card gradient disagrees, {rel:.3e} > {GRAD_RTOL}")
            worst = max(worst, rel)
        print(f"[family] {name} train-mode step B={FAMILY_BATCH}, card vs CPU: nmse rel diff "
              f"{loss_rel:.3e} (bound {GRAD_LOSS_RTOL:.0e}); {len(grads_c) - zeros} gradients, "
              f"worst max abs diff / max |grad| {worst:.3e} (bound {GRAD_RTOL:.0e}); {zeros} "
              f"biases before a BatchNorm at rounding level (bound {ZERO_GRAD_RTOL:.0e})")
        if not loss_rel <= GRAD_LOSS_RTOL:
            raise RuntimeError(f"{name}: train loss on the card disagrees ({loss_rel:.3e})")


def auto_model_timing(name: str, batch, device, card) -> dict:
    """The float32 train step at batch 128 (Adam) with its split and peak
    memory, and the 20-step batch-128 rollout, of one autoregressive model
    at its default widths, by CUDA events."""
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn
    from cfdbench_tpu_torch.training.trainer_auto import step_generator, train_step

    model = family_model(name, device).train()
    task = nmse_task(model)
    opt, sched = make_adam(model.parameters(), 1e-4)
    # The ResNet's dropout draws from a generator on the card.
    gen = step_generator(SEED, 0, device) if name == "resnet" else None
    train_step(task, opt, sched, batch, gen)  # warm-up: cuDNN's choice of algorithms
    step_ms = time_ms(lambda: train_step(task, opt, sched, batch, gen), TRAIN_REPS)
    split = step_split(lambda: task.loss_scores(batch, gen), opt, sched, device)
    model.eval()
    include_initial = name == "resnet"
    roll = make_rollout_fn(task.predict_frame, STEPS, include_initial=include_initial)
    args = (batch["inputs"], batch["case_params"], batch["mask"])
    roll(*args)
    roll_ms = time_ms(lambda: roll(*args), 3)
    predicted = TIMING_BATCH * (STEPS - include_initial)
    fps = predicted / roll_ms * 1e3
    print(f"[time] [{card}] {name} train step b{TIMING_BATCH} {GRID}x{GRID} f32: "
          f"{step_ms:.3f} ms; " + split_text(split))
    print(f"[time] [{card}] {name} rollout b{TIMING_BATCH} x {STEPS} steps: {roll_ms:.3f} ms, "
          f"{predicted} predicted frames = {fps:.1f} frames/s")
    return dict(train_step_ms=step_ms, **split, rollout_ms=roll_ms, rollout_frames_per_s=fps)


def family_timing(device, card):
    """Phase 7c: the float32 train step at batch 128 (Adam) with its split
    and peak memory, and the 20-step batch-128 rollout, for the U-Net and
    the ResNet, by CUDA events."""
    batch = train_inputs(TIMING_BATCH, torch.Generator().manual_seed(SEED + 5), device)
    return {name: auto_model_timing(name, batch, device, card) for name in ("unet", "resnet")}


def phase8_paths():
    """Phase 8a: ``main_train --mode train_test`` then ``main_multistep``
    for the FFN and the DeepONet, ``main_auto --mode train_test`` then
    ``main_multistep`` for the FFNO, at their default widths on the
    phase-6 tree: finite checkpoint, dev and test scores, 20 finite
    per-step metrics, no FNO kernel launch. Returns each step-20 nmse."""
    from cfdbench_tpu_torch.cli import main_auto, main_multistep, main_train, parse_args, run_dir
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    train_flags = ["--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS),
                   "--eval_interval", "1", "--batch_size", "16", "--eval_batch_size", "16",
                   "--log_interval", "100"]
    result = {}
    for name in PHASE8:
        argv = family_argv(name, WORK / "train_data")
        run = run_dir(parse_args(argv))
        reset_launch_counts()
        t0 = time.perf_counter()
        (main_train if name in NONAUTO else main_auto)(argv + train_flags)
        scores = finite_scores(run, name)
        if name in NONAUTO:  # the non-auto trainer's dev scores file
            dev = [json.loads((run / f"ckpt-{ep}" / "dev_loss.json").read_text())["mean"]
                   for ep in range(TRAIN_EPOCHS)]
            if not all(math.isfinite(v) for d in dev for v in d.values()):
                raise RuntimeError(f"{name}: dev_loss.json is not finite: {dev}")
        t1 = time.perf_counter()
        frames = main_multistep(argv)
        channels = 1 if name in NONAUTO else 2
        metrics = json.loads((run / "multistep_metrics.json").read_text())
        if (frames.shape[0] != STEPS or frames.shape[-1] != channels
                or not torch.isfinite(frames).all() or len(metrics) != STEPS
                or not all(math.isfinite(v) for m in metrics for v in m.values())):
            raise RuntimeError(f"{name}: frames {tuple(frames.shape)} (expected {STEPS} steps "
                               f"of {channels} channels), metrics {metrics}")
        result[name] = metrics[-1]["nmse"]
        counts = launch_counts()
        if any(counts.values()):
            raise RuntimeError(f"{name} launched FNO kernels: {counts}")
        print(f"[phase8] {name}: {'main_train' if name in NONAUTO else 'main_auto'} "
              f"{t1 - t0:.2f} s, dev loss {[scores[f'ckpt-{ep}']['dev_loss'] for ep in range(TRAIN_EPOCHS)]}, "
              f"test nmse {scores['test']['nmse']:.6g}; main_multistep "
              f"{time.perf_counter() - t1:.2f} s, step-20 nmse {result[name]}; FNO kernel "
              f"launches {counts}")
    return result


def phase8_model(name: str, device, seed: int = SEED):
    """``name`` at its default widths (64x64, 5 case parameters) from a
    seeded init."""
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.models import init_nonauto_model

    if name not in NONAUTO:
        return family_model(name, device, seed)
    return init_nonauto_model(Args(model=name), n_case_params=5,
                              generator=torch.Generator().manual_seed(seed)).to(device)


def nonauto_inputs(B, gen, device):
    """A seeded frame batch: case parameters, frame indices, 64x64 labels."""
    batch = dict(case_params=torch.randn((B, 5), generator=gen),
                 t=torch.randint(0, STEPS, (B, 1), generator=gen).float(),
                 labels=torch.randn((B, GRID, GRID, 3), generator=gen), weights=torch.ones(B))
    return {k: v.to(device) for k, v in batch.items()}


def phase8_loss(name, model, batch, device):
    """``(loss, scores)`` of one train-mode forward: the DeepONet's and
    the FFN's at the trainer's 1000 points of step 0, the FFNO's on the
    whole field."""
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.training.trainer_nonauto import NonAutoTask, draw_query_idxs

    if name in NONAUTO:
        task = NonAutoTask(model, loss_name_to_fn("nmse"))
        q = draw_query_idxs(SEED, 0, task.num_label_samples, GRID, GRID, device)
        return task.loss_scores(batch, q)
    return nmse_task(model).loss_scores(batch)


def phase8_card_vs_cpu(device):
    """Phase 8b: each model's eval forward on the card against the CPU's
    (the FFN and DeepONet on the whole 64x64 lattice), then the loss and
    every gradient of one train step of the DeepONet (its scale-invariant
    act normalises over the queries) and the FFNO, at phase 6a's bounds."""
    from cfdbench_tpu_torch.training.trainer_nonauto import NonAutoTask

    gen = torch.Generator().manual_seed(SEED + 6)
    field = train_inputs(FAMILY_BATCH, gen, "cpu")
    frames = nonauto_inputs(FAMILY_BATCH, gen, "cpu")
    batches = {}
    for name in PHASE8:
        cpu = field if name not in NONAUTO else frames
        batches[name] = {"cpu": cpu, "card": {k: v.to(device) for k, v in cpu.items()}}
    for name in PHASE8:
        outs = {}
        for where in ("cpu", "card"):
            model = phase8_model(name, "cpu" if where == "cpu" else device).eval()
            b = batches[name][where]
            with torch.no_grad():
                if name in NONAUTO:
                    out = NonAutoTask(model).generate_one(b["case_params"], b["t"], GRID, GRID)
                else:
                    out = model(b["inputs"], b["case_params"], b["mask"])
            outs[where] = out.cpu()
        rel = ((outs["card"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
        print(f"[phase8] {name} eval forward B={FAMILY_BATCH} {GRID}x{GRID}, card vs CPU: max abs "
              f"diff / max |out| {rel:.3e} (bound {FAMILY_RTOL:.0e})")
        if not (outs["card"].shape == outs["cpu"].shape and rel <= FAMILY_RTOL):
            raise RuntimeError(f"{name}: card and CPU forwards disagree ({rel:.3e})")
    for name in ("deeponet", "ffno"):
        runs = {}
        for where in ("cpu", "card"):
            model = phase8_model(name, "cpu" if where == "cpu" else device).train()
            loss, _ = phase8_loss(name, model, batches[name][where],
                                  "cpu" if where == "cpu" else device)
            loss.backward()
            runs[where] = loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}
        (loss_c, grads_c), (loss_g, grads_g) = runs["cpu"], runs["card"]
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        worst = 0.0
        for k, want in grads_c.items():
            got = grads_g[k]
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {k}: no finite gradient on the card")
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not rel <= GRAD_RTOL:
                raise RuntimeError(f"{name} {k}: card gradient disagrees, {rel:.3e} > {GRAD_RTOL}")
            worst = max(worst, rel)
        print(f"[phase8] {name} train step B={FAMILY_BATCH}, card vs CPU: nmse rel diff "
              f"{loss_rel:.3e} (bound {GRAD_LOSS_RTOL:.0e}); {len(grads_c)} gradients, worst max "
              f"abs diff / max |grad| {worst:.3e} (bound {GRAD_RTOL:.0e})")
        if not loss_rel <= GRAD_LOSS_RTOL:
            raise RuntimeError(f"{name}: train loss on the card disagrees ({loss_rel:.3e})")


def nonauto_timing(name: str, device, card) -> dict:
    """The float32 train step at batch 128 (Adam; 1000 points a sample,
    drawn on the host each step as the trainer draws them) with its
    split and peak memory, and the 20-step whole-lattice generation over
    128 cases with its peak memory, by CUDA events."""
    from cfdbench_tpu_torch.cli import generate_steps
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_nonauto import (
        NonAutoTask,
        draw_query_idxs,
        train_step,
    )

    batch = nonauto_inputs(TIMING_BATCH, torch.Generator().manual_seed(SEED + 7), device)
    model = phase8_model(name, device).train()
    task = NonAutoTask(model, loss_name_to_fn("nmse"))
    opt, sched = make_adam(model.parameters(), 1e-4)
    k = task.num_label_samples
    steps = itertools.count()

    def step():
        q = draw_query_idxs(SEED, next(steps), k, GRID, GRID, device)
        return train_step(task, opt, sched, batch, q)

    step()  # warm-up
    step_ms = time_ms(step, TRAIN_REPS)
    q = draw_query_idxs(SEED, 0, k, GRID, GRID, device)
    split = step_split(lambda: task.loss_scores(batch, q), opt, sched, device)
    model.eval()
    cp = batch["case_params"]
    generate_steps(task, cp, (GRID, GRID), STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    gen_ms = time_ms(lambda: generate_steps(task, cp, (GRID, GRID), STEPS), 3)
    gen_peak = torch.cuda.max_memory_allocated(device) / 2**20
    fps = TIMING_BATCH * STEPS / gen_ms * 1e3
    print(f"[time] [{card}] {name} train step b{TIMING_BATCH} x {k} points f32: {step_ms:.3f} ms; "
          + split_text(split))
    print(f"[time] [{card}] {name} generation {TIMING_BATCH} cases x {STEPS} steps x {GRID}x{GRID}: "
          f"{gen_ms:.3f} ms = {fps:.1f} frames/s; peak memory {gen_peak:.1f} MiB")
    return dict(train_step_ms=step_ms, **split, generation_ms=gen_ms,
                generation_frames_per_s=fps, generation_peak_mib=gen_peak)


def phase8_timing(device, card):
    """Phase 8c: the FFNO's train step and rollout as phase 7c times the
    U-Net's, and the FFN's and DeepONet's train step and generation."""
    batch = train_inputs(TIMING_BATCH, torch.Generator().manual_seed(SEED + 5), device)
    result = {"ffno": auto_model_timing("ffno", batch, device, card)}
    for name in NONAUTO:
        result[name] = nonauto_timing(name, device, card)
    return result


def finite(tensors, what: str) -> None:
    if not all(torch.isfinite(v).all() for v in tensors):
        raise RuntimeError(f"{what}: not finite")


def host_checkpoint(path: Path, what: str) -> None:
    """A checkpoint the card wrote: finite, and its tensors on the host."""
    sd = torch.load(path, weights_only=True)
    if {str(v.device) for v in sd.values()} != {"cpu"}:
        raise RuntimeError(f"{what}: {path} holds tensors off the host")
    finite(sd.values(), f"{what}: {path}")


def check_frames(frames, metrics, what: str) -> float:
    """20 finite frames of 2 channels and 20 finite per-step metric dicts;
    returns the step-20 nmse."""
    if (frames.shape[0] != STEPS or frames.shape[-1] != 2 or not torch.isfinite(frames).all()
            or len(metrics) != STEPS
            or not all(math.isfinite(v) for m in metrics for v in m.values())):
        raise RuntimeError(f"{what}: frames {tuple(frames.shape)}, metrics {metrics}")
    return metrics[-1]["nmse"]


def phase9_paths():
    """Phase 9a: pixel diffusion through ``main_auto --mode train_test`` and
    ``main_multistep``, GenCast through ``main_gencast --mode train_test``
    (gradient accumulation and checkpointing on) and ``main_multistep``, at
    their default widths on the phase-6 tree. Returns each model's dev and
    test nmse of generated frames and step-20 nmse."""
    from cfdbench_tpu_torch.cli import main_auto, main_gencast, main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    train_flags = ["--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS),
                   "--eval_interval", "1", "--batch_size", "16", "--eval_batch_size", "16",
                   "--log_interval", "1"]
    extra = {"pixel_diffusion": [],
             "gencast": ["--gradient_accumulation_steps", "2", "--use_gradient_checkpointing", "1"]}
    result = {}
    for name in GENERATIVE:
        argv = family_argv(name, WORK / "train_data") + extra[name]
        run = run_dir(parse_args(argv))
        reset_launch_counts()
        t0 = time.perf_counter()
        (main_auto if name == "pixel_diffusion" else main_gencast)(argv + train_flags)
        t1 = time.perf_counter()
        dev = [json.loads((run / f"ckpt-{ep}" / "dev_scores.json").read_text())["mean"]
               for ep in range(TRAIN_EPOCHS)]
        # Pixel diffusion's dev scores are its generated frames' (beside the
        # persistence baseline); GenCast's add gen_frame_* to its noise scores.
        key = "nmse" if name == "pixel_diffusion" else "gen_frame_nmse"
        if not all(key in d and all(math.isfinite(v) for v in d.values()) for d in dev):
            raise RuntimeError(f"{name}: dev scores lack a finite {key}: {dev}")
        if name == "pixel_diffusion":
            finite_scores(run, name)
            weights = [run / f"ckpt-{ep}" / "model.pt" for ep in range(TRAIN_EPOCHS)]
        else:
            weights = [run / "best_model" / "model.pt"]
        for path in weights:
            host_checkpoint(path, name)
        test = json.loads((run / "test" / "scores.json").read_text())["mean"]
        if not all(math.isfinite(v) for v in test.values()):
            raise RuntimeError(f"{name}: test/scores.json is not finite: {test}")
        frames = main_multistep(argv)
        metrics = json.loads((run / "multistep_metrics.json").read_text())
        step20 = check_frames(frames, metrics, name)
        counts = launch_counts()
        if any(counts.values()):
            raise RuntimeError(f"{name} launched FNO kernels: {counts}")
        result[name] = dict(dev=[d[key] for d in dev], test_nmse=test["nmse"],
                            test_input_nmse=test["input_nmse"], step20_nmse=step20)
        print(f"[phase9] {name}: train_test {t1 - t0:.2f} s, dev {key} {result[name]['dev']}, "
              f"test nmse {test['nmse']:.6g} (persistence {test['input_nmse']:.6g}); "
              f"main_multistep {time.perf_counter() - t1:.2f} s, step-20 nmse {step20:.6g}; "
              f"FNO kernel launches {counts}")
    return result


def generative_task(name: str, device, dropout=None, seed: int = SEED):
    """``name``'s task at its default widths (64x64, 5 case parameters)
    from a seeded init; ``dropout`` replaces the default rate."""
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.models import init_gencast, init_pixel_diffusion

    kw = {} if dropout is None else dict(pixel_diffusion_dropout=dropout)
    args = Args(model=name, **kw)
    init = dict(generator=torch.Generator().manual_seed(seed), device=device)
    if name == "pixel_diffusion":
        return init_pixel_diffusion(args, 5, loss_name_to_fn("nmse"), **init)
    return init_gencast(args, GEN_STATS, 5, loss_name_to_fn("nmse"), **init)


def generative_batch(B, gen, device):
    batch = train_inputs(B, gen, "cpu")
    batch["inputs_prev"] = torch.randn((B, GRID, GRID, 2), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def phase9_card_vs_cpu(device):
    """Phase 9b: dropout 0 and the noise, timesteps and sampler noise drawn
    on the CPU for both devices: the PUNetG eval forward, each task's loss
    and every gradient, and each task's 50-step DDPM frame (pixel
    diffusion's ``predict_frame``, GenCast's ``generate``), card against
    CPU."""
    from cfdbench_tpu_torch.models import diffusion
    from cfdbench_tpu_torch.ops import diffusion as ops
    from cfdbench_tpu_torch.utils.rng import train_key

    draw_noise, draw_sampler = diffusion.train_noise_and_t, ops.ddpm_noise
    diffusion.train_noise_and_t = lambda key, shape, T, dev: tuple(
        v.to(dev) for v in draw_noise(key, shape, T, "cpu"))
    ops.ddpm_noise = lambda key, i, shape, dev: draw_sampler(key, i, shape, "cpu").to(dev)
    try:
        batch_cpu = generative_batch(FAMILY_BATCH, torch.Generator().manual_seed(SEED + 8), "cpu")
        batch = {k: v.to(device) for k, v in batch_cpu.items()}
        steps = torch.randint(0, 1000, (FAMILY_BATCH,), generator=torch.Generator().manual_seed(9))
        tasks = {name: {"cpu": generative_task(name, "cpu", 0.0),
                        "card": generative_task(name, device, 0.0)} for name in GENERATIVE}
        for name in GENERATIVE:
            x = batch_cpu["labels"] if name == "pixel_diffusion" else torch.cat(
                [batch_cpu["labels"], batch_cpu["inputs"], batch_cpu["inputs_prev"]], -1)
            with torch.no_grad():
                want = tasks[name]["cpu"].model(x, steps, batch_cpu["case_params"])
                got = tasks[name]["card"].model(x.to(device), steps.to(device),
                                                batch["case_params"]).cpu()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"[phase9] {name} PUNetG eval forward B={FAMILY_BATCH} {GRID}x{GRID}, card vs "
                  f"CPU: max abs diff / max |out| {rel:.3e} (bound {FAMILY_RTOL:.0e})")
            if not rel <= FAMILY_RTOL:
                raise RuntimeError(f"{name}: card and CPU forwards disagree ({rel:.3e})")
            runs = {}
            for where, b in (("cpu", batch_cpu), ("card", batch)):
                task = tasks[name][where]
                loss, _ = task.loss_scores(b, train_key(SEED, 0))
                loss.backward()
                runs[where] = loss.item(), {k: p.grad.cpu()
                                            for k, p in task.model.named_parameters()}
            (loss_c, grads_c), (loss_g, grads_g) = runs["cpu"], runs["card"]
            loss_rel = abs(loss_g - loss_c) / abs(loss_c)
            worst = 0.0
            for k, want in grads_c.items():
                got = grads_g[k]
                finite([got], f"{name} {k} gradient on the card")
                rel = ((got - want).abs().max() / want.abs().max()).item()
                if not rel <= GRAD_RTOL:
                    raise RuntimeError(f"{name} {k}: card gradient disagrees, {rel:.3e} > "
                                       f"{GRAD_RTOL}")
                worst = max(worst, rel)
            print(f"[phase9] {name} train step B={FAMILY_BATCH}, card vs CPU: nmse rel diff "
                  f"{loss_rel:.3e} (bound {GRAD_LOSS_RTOL:.0e}); {len(grads_c)} gradients, "
                  f"worst max abs diff / max |grad| {worst:.3e} (bound {GRAD_RTOL:.0e})")
            if not loss_rel <= GRAD_LOSS_RTOL:
                raise RuntimeError(f"{name}: train loss on the card disagrees ({loss_rel:.3e})")
        frame_calls = {"pixel_diffusion": ("predict_frame", ("inputs", "case_params", "mask")),
                       "gencast": ("generate", ("inputs", "inputs_prev", "case_params", "mask"))}
        for name, (method, keys) in frame_calls.items():
            want = getattr(tasks[name]["cpu"], method)(
                *(batch_cpu[k][:GEN_CHECK_BATCH] for k in keys))
            got = getattr(tasks[name]["card"], method)(
                *(batch[k][:GEN_CHECK_BATCH] for k in keys)).cpu()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"[phase9] {name} 50-step DDPM frame ({method}) B={GEN_CHECK_BATCH}, card vs "
                  f"CPU: max abs diff / max |frame| {rel:.3e} (bound {FAMILY_RTOL:.0e})")
            if not rel <= FAMILY_RTOL:
                raise RuntimeError(f"{name}: card and CPU frames disagree ({rel:.3e})")
    finally:
        diffusion.train_noise_and_t, ops.ddpm_noise = draw_noise, draw_sampler


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) one call of ``fn``
    launches, from the profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def generative_timing(name: str, device, card) -> dict:
    """At each of GEN_BATCHES: the float32 train step (dropout on; Adam and
    StepLR for pixel diffusion, GenCast's AdamW chain) with its split, peak
    memory and device operations, then one denoise call, one 50-step DDPM
    frame and the 20-step rollout, by CUDA events."""
    import types

    from cfdbench_tpu_torch.training.optim import make_adam, make_gencast_tx
    from cfdbench_tpu_torch.utils.rng import train_key
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn

    result = {}
    for B in GEN_BATCHES:
        batch = generative_batch(B, torch.Generator().manual_seed(SEED + 10), device)
        task = generative_task(name, device)
        params = task.model.parameters()
        if name == "pixel_diffusion":
            opt, sched = make_adam(params, 1e-4)
        else:
            opt, sched = make_gencast_tx(params, 1e-4, total_steps=1000), types.SimpleNamespace(
                step=lambda: None)
        steps = itertools.count()

        def step():
            opt.zero_grad(set_to_none=True)
            loss, _ = task.loss_scores(batch, train_key(SEED, next(steps)))
            loss.backward()
            opt.step()
            sched.step()

        step()  # warm-up: cuDNN's choice of algorithms
        step_ms = time_ms(step, TRAIN_REPS)
        split = step_split(lambda: task.loss_scores(batch, train_key(SEED, 0)), opt, sched, device)
        ops_per_step = device_ops(step)
        x = batch["labels"] if name == "pixel_diffusion" else torch.cat(
            [batch["labels"], batch["inputs"], batch["inputs_prev"]], -1)
        t = torch.full((B,), 500, device=device)
        cp, mask = batch["case_params"], batch["mask"]
        with torch.inference_mode():
            task.model(x, t, cp)
            denoise_ms = time_ms(lambda: task.model(x, t, cp), 10)
        if name == "pixel_diffusion":
            frame = lambda: task.predict_frame(batch["inputs"], cp, mask)  # noqa: E731
            roll = make_rollout_fn(task.predict_frame, STEPS, stochastic=True, seed=SEED)
            rollout = lambda: roll(batch["inputs"], cp, mask)  # noqa: E731
        else:
            frame = lambda: task.generate(batch["inputs"], batch["inputs_prev"], cp, mask)  # noqa: E731
            rollout = lambda: task.rollout(batch["inputs"], batch["inputs"], cp, mask, STEPS)  # noqa: E731
        frame_ms = time_ms(frame, 1)
        torch.cuda.reset_peak_memory_stats(device)
        roll_ms = time_ms(rollout, 1)
        roll_peak = torch.cuda.max_memory_allocated(device) / 2**20
        fps = B * STEPS / roll_ms * 1e3
        print(f"[time] [{card}] {name} train step b{B} {GRID}x{GRID} f32: {step_ms:.3f} ms, "
              f"{ops_per_step} device operations; " + split_text(split))
        print(f"[time] [{card}] {name} b{B}: denoise call {denoise_ms:.3f} ms, 50-step DDPM frame "
              f"{frame_ms:.3f} ms ({B / frame_ms * 1e3:.2f} frames/s), rollout {STEPS} steps "
              f"{roll_ms:.3f} ms = {fps:.2f} frames/s, peak memory {roll_peak:.1f} MiB")
        result[f"b{B}"] = dict(train_step_ms=step_ms, **split, device_ops_per_step=ops_per_step,
                               denoise_ms=denoise_ms, frame_ms=frame_ms, rollout_ms=roll_ms,
                               rollout_frames_per_s=fps, rollout_peak_mib=roll_peak)
        del task, opt, batch
        torch.cuda.empty_cache()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cfdbench_tpu_torch.utils.device import require_cuda, set_f32_numerics

    device = require_cuda()
    set_f32_numerics()
    card = host_facts()
    errors = check_kernels(device)
    counts, features, case_params = main_path()
    compare_rollouts(device, features, case_params)
    times = timing(device, card)
    check_gradients(device)
    train_counts = train_path()
    train_step_timing(device, card)
    family = family_paths()
    family_card_vs_cpu(device)
    family_times = family_timing(device, card)
    print(f"[family] [{card}] " + json.dumps({"step20_nmse": family, "timing": family_times}))
    phase8 = phase8_paths()
    phase8_card_vs_cpu(device)
    phase8_times = phase8_timing(device, card)
    print(f"[phase8] [{card}] " + json.dumps({"step20_nmse": phase8, "timing": phase8_times}))
    phase9 = phase9_paths()
    phase9_card_vs_cpu(device)
    phase9_times = {name: generative_timing(name, device, card) for name in GENERATIVE}
    print(f"[phase9] [{card}] " + json.dumps({"quality": phase9, "timing": phase9_times}))
    print(f"[main] launches on the main paths: main_multistep {counts}, "
          f"main_auto {train_counts}")
    replaces = {"fno_block": "cfdbench_tpu/ops/pallas_fno.py:179",
                "fno_head": "cfdbench_tpu/ops/pallas_fno.py:268"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"cfdbench_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": counts[name],
         "launches_by_path": {"main_multistep": counts[name], "main_auto": train_counts[name]},
         "max_abs_err": errors[name], **times[name], "library_ms": None}
        for name in ("fno_block", "fno_head")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
