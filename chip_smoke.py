#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cfdbench_tpu_torch``).

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

1. Prints the card (name, power limit), the PyTorch, CUDA and nvcc
   versions, whether Triton imports, and builds both kernels from
   ``cfdbench_tpu_torch/csrc`` (build time, ptxas report, and the Hopper
   routes' wgmma, TMA and bulk-copy instructions in the library's SASS, in
   all and in each kernel's functions).
2. Holds each kernel to its plain PyTorch version on the card, in float32
   with TF32 off (the block's output, and what it keeps for the backward:
   the pre-activation and x's retained modes), at the flagship widths
   (B=8, 64x64, 32 channels, 12 modes), at 66x65 (odd W), at the ragged
   18x17 with 10 channels (4 modes, 3 head outputs) and 16x16 with 8
   channels (modes clamped), and at the kernels' wider tilings: 64x136
   (the forward pass in three column chunks), 66x80 with 128 channels
   (channel tiles, one row per item of the inverse-columns pass, the
   Hopper head's widest resident w1) and 8x64 with 198 channels (4 modes,
   3 head outputs: a width not a multiple of 4, so the head's ``mma.sync``
   route with w1 streamed).
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
   Each kernel's route is printed (``route_name``, ``head_route_name``).
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
   --model pixel_diffusion --mode train_test`` then ``main_multistep``
   (CHECK_INFERENCE_STEPS denoising steps a frame);
   ``main_gencast --mode train_test --gradient_accumulation_steps 2
   --use_gradient_checkpointing 1`` then ``main_multistep --model
   gencast``, on the phase-6 tree: finite checkpoints on the host, dev
   scores of generated frames (pixel diffusion's ``nmse``, GenCast's
   ``gen_frame_nmse``), finite test scores, 20 finite frames, no FNO
   kernel launch. (b) With dropout 0 and the same draws (made on the CPU)
   on both devices: the PUNetG eval forward, each task's loss and every
   gradient, and one CHECK_INFERENCE_STEPS-step DDPM frame, card against
   CPU, at phase 7b's
   and 6a's bounds. (c) At batch 8 and 32: each model's float32 train
   step (split, peak memory, device operations a step), one denoise call,
   one 50-step DDPM frame and a GEN_ROLLOUT_STEPS-step rollout in frames/s.
10. The VAE, the latent diffusion models and the unconditional DDPM at
   their default widths (lite VAE 32-64-128-256, latent 4; latent UNet
   base 64, mults 1-2-4, 1 res block; 1000 train timesteps, 50 denoising
   steps). (a) On the phase-6 tree: ``main_vae --mode train_anneal`` for 2
   epochs, then ``--resume`` for a third (finite history, ``cur_lr`` in
   ``training_meta.json``, finite weights on the host); on those weights
   ``main_auto --mode train_test`` for ``latent_diffusion``,
   ``latent_diffusion2`` and ``latent_diffusion_lite`` (finite dev and
   test scores of generated frames) and ``main_multistep`` for
   ``latent_diffusion2`` (20 finite frames, CHECK_INFERENCE_STEPS denoising
   steps each); ``main_uncond`` for 2 epochs
   (``ema_model/``); no FNO kernel launch. (b) Every draw made on the CPU
   for both devices: the VAE's forward (its mode) against a float64 run
   on the CPU, within 1e-5 of max |out|; its train step's loss (rel 1e-5)
   and gradients (1e-4 of their max), card against CPU; each latent
   model's loss and gradients at the same bounds and its
   CHECK_INFERENCE_STEPS-step decoded
   frame at B=2 within 1e-4 of max |frame|. A gradient that a float64
   run on the CPU finds 0 in exact arithmetic is held below 1e-5 of the
   largest. (c) At batch 8 and 32: the VAE's train step, each latent
   model's train step, denoise call (ms, device operations) and 50-step
   frame with its decode (frames/s), and the unconditional DDPM's step.

11. Serving (``utils/export.py``, ``scripts/serve_bench_torch.py``,
   ``scripts/import_reference_checkpoint_torch.py``). (a) The phase-6 FNO
   checkpoint's weights in the reference's layout (complex corner weights,
   1x1-conv weights) through ``import_reference_checkpoint_torch.py`` into
   a fresh result tree, where ``main_multistep`` must give phase 6b's
   per-step metrics (rel 1e-6: a relayout). (b) Cut to keep the script in
   its time limit: ``scripts/export_model_torch.py`` on a trained FNO
   checkpoint runs in the CPU tests (``tests/test_torch_serving.py``). (c)
   ``serve_bench_torch.py --selftest`` for the flagship FNO and the U-Net
   at its default width, batch 128, 64x64, rollouts of 20 steps (the
   U-Net's of SERVE_UNET_ROLLOUT_STEPS): served and in-process
   ms a call (host wall time to a synchronize, and CUDA-event time),
   frames/s, the served overhead; the served outputs within 1e-6 (FNO) and
   1e-5 (U-Net: cuDNN may choose another algorithm for a traced
   convolution) of max |out| of the in-process ones; one served FNO
   predict call must launch 4 block and 1 head kernels, one served rollout
   80 and 20, the U-Net none. (d) ``serve_bench_torch.py
   --selftest`` for pixel diffusion and latent_diffusion2 at their default
   widths (SERVE_INFERENCE_STEPS denoising steps; the latent model on a
   seeded lite VAE),
   64x64: predict at b8 and b32, a rollout of SERVE_DIFFUSION_ROLLOUT_STEPS
   frames at b8. Each served
   call without noise (it draws what the in-process call draws) within
   1e-5 of max |frame| of the in-process one; the predict's graph holds
   the sampler as one loop operator, the rollout's one loop over the
   frames that holds it; no FNO kernel. Printed: export seconds, artifact
   and weights bytes, graph nodes, served and in-process ms a call (host
   wall time to a synchronize, and CUDA-event time) on noise drawn before
   the call, frames/s, and the noise draw's ms apart.

12. Mixed precision, Adafactor and the bfloat16 rollout. (a) On the
   phase-6 tree, ``main_auto --use_mixed_precision 1 --mode train_test``
   for the flagship FNO, the U-Net, the FFNO and pixel diffusion, and
   ``main_gencast --use_mixed_precision 1``: finite scores; the FNO's
   bfloat16 train forwards launch no kernel, its float32 evaluation and
   test forwards 4 blocks and 1 head each, the others none. (b)
   ``main_auto --opt_state_dtype factored`` for the FNO at width 128 (at 32
   no tensor factors), one epoch, then ``--resume`` for a second: finite
   losses and scores, Adafactor's row and column statistics in the saved
   state. (c) ``main_multistep --rollout_dtype bfloat16`` on the phase-6,
   7 and 8 checkpoints of the FNO, the U-Net and the FFNO: 20 finite
   per-step metrics within PHASE12_METRIC_RTOL of each metric's largest in
   the float32 rollout, no kernel launch; with ``--use_pallas_head 1`` it
   must refuse. (d) The bfloat16 train step of the FNO and the U-Net at
   B=8, card against CPU: the loss and the gradients at the bounds below.
   (e) By CUDA events: the FNO's 20-step b128 rollout, float32 on the
   kernels against bfloat16 on the plain ops; the float32 and the mixed
   precision train step (split, peak memory) of the FNO and the U-Net at
   b128 and of pixel diffusion's PUNetG at b32; Adam's and Adafactor's
   update of the FNO at width 128.
   12f. ``--matmul_precision high`` (TF32 in cuBLAS and cuDNN, both kernels
   in their one-product TF32 mode), at the gates TF32_*: (a) each kernel in
   TF32 at the flagship's shapes (B=128) against its TF32 plain version and
   the float32 one (the block's saved outputs too), timed against that plain
   version and beside its split mode, with its bound at one TF32 product;
   the head's ``mma.sync`` route (route 0) in TF32 at the same gates; the
   block's TF32 halves at 15a's first split. (b) Phase 6b's
   ``main_auto`` under ``high`` (every launch in TF32 mode) against phase
   6b's float32 run, and ``main_multistep`` under ``high`` on phase 6b's
   checkpoint (80 and 20 TF32 launches) against its float32 rollout. (c) The
   b128 train step of the flagship, the U-Net and the ResNet under ``high``
   beside float32, peak memory, and the flagship's b128 rollout in each
   mode, by CUDA events.

13. Data parallelism (``parallel/mesh.py``). (a) Phase 6b's
   ``main_auto`` and its ``main_multistep`` again through the real launcher,
   ``python -m torch.distributed.run --standalone --nproc_per_node 1
   train_auto_torch.py ... --mesh_shape 1`` (then
   ``test_multistep_torch.py``), in subprocesses started in a thread
   before (b), which runs meanwhile: an NCCL group of one rank,
   which runs no collective, whose checkpoints, test scores and per-step
   metrics must equal phase 6b's within DP_TORCHRUN_RTOL, and whose
   launches (each rank prints its own) phase 6b's and phase 3's. (b) Two
   ranks spawned on the one card in a gloo group that they initialise (a
   file rendezvous), against one process on the card (its runs made while
   the ranks run): the flagship FNO's
   ``main_auto`` at global batch 128 (64 a rank; a full and a padded batch
   an epoch), its test and its ``main_multistep`` on the one test case
   (padded to two), losses, scores, per-step metrics and parameters within
   DP_RTOL; the U-Net's ``main_auto`` for an epoch at DP_UNET_BATCH (its
   last batch 8 rows and 24 of padding, over which the global BatchNorm
   normalises), held against a control: one process with the rows of every
   batch (and the batch's draws) permuted, which parts from one process by
   rounding alone (CONTROLS: the U-Net, the VAE, GenCast and the DDPM);
   pixel diffusion's for two steps (the draws over the global batch), its
   losses within DP_RTOL and its first step's float32 gradients within
   DP_RTOL of the largest; one float64 train step of the U-Net and of pixel
   diffusion from the same weights on a padded global batch of
   DP_UNET_BATCH, the scores, the gradients, the parameters and the
   running statistics within DP_RTOL. Then the other trainers at their
   default widths: ``main_train`` (the FFN and the DeepONet at width 100,
   depth 8) one epoch at DP_BATCH with its dev evaluation and test,
   ``main_gencast`` (PUNetG base 64) one epoch at DP_UNET_BATCH with
   ``--gradient_accumulation_steps 2``, its dev and test frames at
   MP_INFERENCE_STEPS, ``main_vae`` (lite) at DP_UNET_BATCH until its
   early stop, its rate cut twice on the way (``--lr_scheduler_patience
   0``), and ``main_uncond`` (PUNetG base 64) one epoch at DP_UNET_BATCH,
   each last batch padded: every number of their loss and score files
   within DP_RTOL of one process's, the FFN's and DeepONet's weights too;
   GenCast's dev nmse and the VAE's dev losses, rate cuts and stopping
   epoch as each rank printed them, alike on both ranks and in one
   process; and one float64 step of each from the same weights on a padded
   global batch with real rows on both ranks, the scores, gradients and
   parameters within DP_RTOL. Parameters identical on both ranks, each
   rank's launches those of the one-process run (none for the other
   trainers). Two ranks on one card measure correctness, not scaling. (c) The flagship's b128 train step by
   CUDA events in one process, in an NCCL group of one rank, and in that
   group with the collectives of several ranks forced.

14. Tensor and pipeline parallelism over a model axis of two ranks
   (``parallel/sharding_rules.py``, ``tensor.py``, ``pipeline.py``). (a)
   Phase 2's check at the shapes a model rank gives each kernel at the
   flagship, B=128: the block at 16 and 8 of its 32 output channels (the
   column-parallel block), the head at 64 and 32 of its 128 hidden units
   (the row-parallel head; ``b2`` on the first rank, zeros on the others),
   each against its plain version at phase 2's bounds and timed against
   it as phase 5 times them, beside its bound. (b) Two ranks on the one
   card in a gloo group, ``--mesh_shape 1x2``, against phase 13b's runs in
   one process on its tree: the flagship's ``main_auto`` at DP_BATCH
   (tensor parallel: the spectral weights and fc1 split) and its
   ``main_multistep``; the same ``main_auto`` with ``--pp_microbatches
   PP_MICRO`` (two stages of two blocks); the U-Net's epoch at
   DP_UNET_BATCH (its split convolutions gathered at use), bounded by
   phase 13b's permuted-row control. Losses, per-step metrics and frames
   within DP_RTOL, the FNO's weights within DP_RTOL of their largest; each
   rank's launches: one process's under tp, and under pp the stage's
   blocks for each microbatch and the head on the last stage only, the
   evaluations' forwards on every rank. Then the other entry points on
   the model axis, each against one process: phase 13b's ``main_train``
   (FFN, DeepONet: a replicated model axis), ``main_gencast``,
   ``main_vae`` and ``main_uncond`` runs (their networks split and
   gathered at use), held as phase 13b holds them and, the PUNetG's and
   the VAE's, their files and parameters within DP_DRIFT_FACTOR times
   their permuted-row control's distance plus DP_RTOL, and their first
   float64 step (scores, gradients of the largest, parameters) within
   DP_RTOL; GenCast's ``main_multistep`` of phase 13b's checkpoint, frames
   and metrics within DP_RTOL (each frame sampled in
   TP_GENCAST_INFERENCE_STEPS denoising steps); the flagship's ``main_auto
   --use_mixed_precision`` under tp and under pp (losses and dev scores
   within TP_BF16_RTOL of one process's mixed-precision run) and its
   ``main_multistep --rollout_dtype bfloat16`` under tp (bfloat16 frames
   within TP_BF16_FRAME_RTOL of their max, metrics TP_BF16_RTOL): each
   rank's launches one process's, none on the other trainers' paths and
   the bfloat16 rollout's, and in the mixed-precision runs only those of
   the float32 evaluation (train steps in bfloat16 run the plain
   versions). These runs, phase 13b's and their one-process references
   take PyTorch's deterministic algorithms, so that a run parts from one
   process by what its layout changes alone. Then phase 13b's U-Net,
   GenCast and FFN runs again at ``1x2`` on the default algorithms, which
   users' runs take (DEFAULT_ALGORITHM_RUNS): each rank's weights equal to
   the others', bit for bit, which the model ranks' gradient averages keep
   when cuDNN sums each rank's weight gradients in another order; their
   distance from one process printed. (c) Each rank's
   parameter and optimizer-state bytes of the flagship under tp and under
   pp, and of GenCast's PUNetG, the VAE and the DDPM (and its EMA) under
   tp, against one process's.

15. Spatial sharding (``--shard_spatial 1``: ``parallel/spatial.py``). (a)
   The block kernel at the rows a model rank holds (SP_KERNEL_CASES,
   B=128, the flagship's width and modes): its first pass on each rank's
   rows, the partial spectra summed, its other passes on each rank's rows,
   against the plain whole block at phase 2's bounds; each half timed on
   one rank's rows beside its bound, and the bytes of spectrum the ranks
   sum; the head kernel at the same rows. (b) ``main_auto --mesh_shape
   1x2 --shard_spatial 1`` on two gloo ranks sharing the card, under
   deterministic algorithms: phase 13b's flagship run and U-Net epoch, an
   epoch each of the FFNO and the ResNet, against one process (the
   U-Net's within DP_DRIFT_FACTOR times phase 13b's permuted-row control
   plus DP_RTOL, the others' losses, dev scores and weights within
   DP_RTOL), each rank's launches one process's (the flagship again on
   ``2x2``, four ranks, runs in (d)'s spawn); each rank's peak memory of a
   DP_BATCH flagship step against one process's. (c) The rest of ``main_auto --shard_spatial
   1`` at ``1x2`` (:func:`spatial_rest`), each run against one process
   within (b)'s gates (its ranks start once (d)(i), 14a and 15a have timed
   their kernels, and run on through 14b-c and (b); its one-process runs
   are made while 14b's ranks run; its generative runs sample their dev
   batch in SP_INFERENCE_STEPS denoising steps): the flagship with ``--use_mixed_precision`` (losses
   and dev scores within TP_BF16_RTOL; both kernels on every rank in its
   float32 evaluation) and with ``--pp_microbatches`` (every stage on whole
   rows, as JAX's pipeline takes its batch: the step is pp's; its kernels
   on the stages), and on trees of SP_REST_FRAMES frames a case the U-Net
   on TUBE_GRID (33 rows a rank), the
   point models SP_POINT_MODELS, pixel diffusion and the three latent
   models (on phase 10's VAE; Lite on the TUBE_GRID tree too, padded to
   72 rows on the last rank) at SP_PIXEL_BATCH at default widths, their
   epochs against the largest of their permuted-row controls
   (SP_CONTROL_SEEDS) and the float64 steps of each of them within
   DP_RTOL, no kernel launch on any rank; each rank's peak memory of a
   b128 U-Net step on TUBE_GRID and a b8 pixel diffusion and
   latent_diffusion2 step, as a fraction of one process's, with what fills
   it (the rank's parameters, gradients and Adam state, and a second
   step's peak over them), and the phase's seconds, on its ``[phase15c]``
   line. (d) What spatial sharding refused until it ran: (i) the block
   kernel split at the rows of the flagship padded by PAD at ``1x2``
   (``Rows(0, 32, 73)``, W = 73, B=128; the field's pad zero) against the
   plain whole padded block at phase 2's bounds, each rank's halves timed
   beside their bounds; the head on each rank's cropped rows against its
   plain version, the last rank's timed; (ii) (b)'s flagship main_auto with
   ``padding=PAD`` (no flag sets it: :class:`padded_fno`) at ``1x2`` and
   ``2x2`` within (b)'s gates, each rank's launches one process's; (iii)
   on SP_EMPTY_MESH, four ranks, where a level leaves a rank without a
   row: (c)'s latent_diffusion2 epoch and float64 step at default widths
   on its 64x64 tree, against (c)'s one process and controls, and the
   U-Net's epoch and float64 step on a SP_EMPTY_GRID tree against its own
   one process and permuted-row controls, within (c)'s gates, no kernel
   launch on any rank; each rank's peak memory of a b8 latent_diffusion2
   step at ``1x4``. (ii) on ``2x2`` and (iii) share one spawn; the phase's
   seconds on its ``[phase15d]`` line.
16. The last modules of the JAX package. (a) ``Fno2d(padding=PAD)``, the
   flagship padded by 9 (the pad of the FNO authors' 2-D Darcy script): the
   block kernel at B=128 on the padded 73x73 grid (odd W above 64: pass
   1's streamed route; 73 rows against 8-row groups) against its plain
   version at phase 2's bounds, what it keeps for the backward, and timed
   against it as phase 5 times them, beside its bound; the head kernel on
   the cropped field and the crop's contiguous copy, timed; the padded
   flagship's forward (B=8) on the card against the CPU's plain forward
   (rel ROLLOUT_RTOL) and one float32 train step card against CPU (loss
   GRAD_LOSS_RTOL, every gradient GRAD_RTOL of its largest); a 20-step
   b128 rollout through the kernels (80 block and 20 head launches) and
   its frames/s beside the plain path's. (b) ``main_multistep
   --profile_dir`` on phase 3's checkpoint, twice in this process: each
   run phase 3's launches and a ``torch.profiler`` trace of its own that
   holds each of the block's CUDA kernels 80 times and the head's 20
   times by name (each kernel's route's: ``route_kernels``,
   ``head_route_kernels``). (c)
   ``scripts/vae_diagnostics_torch.py`` on phase 10's VAE and the phase-6
   tree: its summary and arrays written (``diagnostics.json``,
   ``diagnostics.npz``; the machine has no matplotlib for its plots), all
   finite.
17. The FNO past the kernels' old shared-memory limits (the inverse-columns
   pass tiled over columns and its K, the head's fc1 streamed over the
   channels). (a) Each kernel against its plain version at phase 2's
   bounds (the block's saved outputs too) and timed against it as phase 5
   times them, beside its bound, at WIDE_KERNEL_CASES: both at B=128, 64x64,
   width 256 (the JAX package's widest), and at B=8 on a 512x512 grid at
   width 32; the block at B=8, 256x256, 32 modes; the head with 9 outputs;
   and the block split at 256 of 512 rows (as 15a). (b) ``main_auto --mode
   train_test`` then ``main_multistep`` at ``--fno_hidden_dim 256`` on the
   phase-6 tree: launches 68 and 17, then 80 and 20, as the flagship's;
   the width-256 FNO's forward and one train step on the card against the
   CPU's plain path at phase 16a's bounds; its 20-step b128 rollout through
   the kernels (launches, frames/s beside the plain path's). (c) The same
   two entry points at width 32 on a synthetic 512x512 cavity tree. The
   phase's seconds on its ``[phase17]`` line.

Every phase's seconds are printed on a line of their own (``[seconds]``),
and the whole script's. They run in this order: 1-12f, 13a-b, 13c, 14a,
15a, 15d(i), 14b-c, 15b, 15c, 15d(ii-iii), 16, 17; a phase's seconds
include the work of another made meanwhile (13a beside 13b; 15c's ranks
beside 14b-c and 15b, its one-process runs beside 14b's ranks), and no
kernel is timed while any of it runs.

``launches`` in the kernels' record is phase 3's count (main_multistep),
``launches_by_path`` each main path's own: main_multistep's and
main_auto's, one served predict call's and one served rollout's
(phase 11c), each served diffusion path's (phase 11d:
``serve_<model>_<kind>_b<B>``, 0), main_auto's with ``--use_mixed_precision`` and
main_multistep's with ``--rollout_dtype bfloat16`` (phase 12), and each
rank's main_auto, main_multistep, main_train, main_gencast, main_vae and
main_uncond under data parallelism (phase 13: ``dp_torchrun_*``,
``dp2_rank{r}_*``), and each rank's main_auto, main_multistep, main_train,
main_gencast, main_vae, main_uncond, GenCast's main_multistep, main_auto
with --use_mixed_precision and main_multistep with --rollout_dtype
bfloat16 under tensor parallelism and main_auto in both precisions under
pipeline parallelism (phase 14: ``tp2_rank{r}_*``, ``pp2_rank{r}_*``),
and each rank's main_auto under spatial sharding (phase 15:
``sp1x2_rank{r}_main_auto_sp``, ``sp2x2_rank{r}_main_auto_sp``; phase 15c:
``sp1x2_rank{r}_main_auto_sp_<run>`` for each of its runs; phase 15d:
``sp{mesh}_rank{r}_main_auto_sp_padded``, ``sp1x4_rank{r}_main_auto_sp_<run>``), and the
padded flagship's 20-step rollout and main_multistep under --profile_dir
(phase 16: ``padded_rollout``, ``main_multistep_profiled``), and main_auto
and main_multistep at width 256 and on a 512x512 grid and the width-256
rollout (phase 17: ``main_auto_h256``, ``main_multistep_h256``,
``rollout_h256``, ``main_auto_512``, ``main_multistep_512``),
each read from counters set
to 0 just before the run and read just after it; ``at_rank_shapes`` the
kernel's phase 14a records, ``at_rank_rows`` its phase 15a and 15d(i) records,
``at_padded_grid`` its phase 16a record, ``at_wide_shapes`` its phase 17a
records; ``fno_block_tf32`` and ``fno_head_tf32``, the kernels' TF32 mode
(phase 12f): ``launches`` main_multistep's under ``--matmul_precision high``,
``launches_by_path`` that and main_auto's (TF32 launches alone), its
errors, times and bounds phase 12f(a)'s. The
line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
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
# The timed rollout of phase 9c: its frames/s is a frame's (each step one
# full DDPM sampling), so it runs 2 of the STEPS frames (20 took 83 s of
# the script's time on an H100, 5 about 20 s).
GEN_ROLLOUT_STEPS = 2
GEN_CHECK_BATCH = 2
# The sampling that phases 9 and 10 check rather than time (9a's and 10a's
# main_multistep, 9b's and 10b's frames card against CPU) runs
# CHECK_INFERENCE_STEPS denoising steps: the models' sampler at a fifth of
# its 50 steps.
CHECK_INFERENCE_STEPS = 10
# Residual statistics for the GenCast task outside main_gencast.
GEN_STATS = dict(residual_mean=[0.01, -0.02], residual_std=[0.1, 0.2])
# Phase 10: the lite VAE and the latent diffusion models at their default
# widths (UNet base 64, mults 1-2-4, 1 res block), and the unconditional DDPM.
LATENT = ("latent_diffusion", "latent_diffusion2", "latent_diffusion_lite")
# Phase 10b: the lite VAE's float32 forward, on the card and on the CPU,
# against a float64 run on the CPU, at these seeds of weights and input;
# and, as the fault the bound must catch, on the card with TF32 on. On an
# H100 the card's float32 reads 9.4e-6 to 1.4e-5 of max |out| at these
# seeds, the CPU's 5.0e-6 to 6.8e-6, TF32 3.9e-3 to 5.7e-3: the bound
# lies twice over the first and 78x under the last.
VAE_FORWARD_SEEDS = (0, 1, 2, 3)
VAE_FORWARD_RTOL = 5e-5  # max abs diff over max |out|
# A gradient below this share of the largest in float64 is 0 in exact
# arithmetic (a bias that a GroupNorm of one channel a group, or a softmax,
# cancels): on either device it is rounding.
EXACT_ZERO = 1e-9
# (B, H, W, channels, modes, head outputs) of phase 2.
CHECK_SHAPES = ((8, GRID, GRID, WIDTH, MODES, 2), (8, GRID + 2, GRID + 1, WIDTH, MODES, 2),
                (3, 18, 17, 10, 4, 3), (17, 16, 16, 8, MODES, 2),
                (4, GRID, 136, WIDTH, MODES, 2), (4, GRID + 2, 80, 128, MODES, 2),
                (2, 8, 64, 198, 4, 3))
# Phase 11: serving. The imported reference checkpoint's metrics against
# the original's (a relayout: equal up to rounding); the served FNO against
# the in-process forward (the same kernels on the same inputs); the served
# U-Net (cuDNN may choose another algorithm for the traced convolutions).
SERVE_IMPORT_RTOL = 1e-6
SERVE_FNO_RTOL = 1e-6  # max abs diff over max |out|
SERVE_UNET_RTOL = 1e-5
SERVE_ITERS = 12
# The served U-Net's rollout: its export unrolls every step (35 s of the
# script's time on an H100 at 20 steps), so it runs a quarter of them.
SERVE_UNET_ROLLOUT_STEPS = STEPS // 4
# Phase 11d: the served diffusion models at their default widths, predict at
# GEN_BATCHES (SERVE_DIFFUSION_ITERS timed calls after a warm-up) and the
# 20-step rollout at the first (one call each way, timed, no warm-up: the
# predict at that batch warmed its shapes); served against in process at
# SERVE_UNET_RTOL.
SERVE_DIFFUSION = ("pixel_diffusion", "latent_diffusion2")
SERVE_DIFFUSION_ITERS = 2
SERVE_DIFFUSION_ROLLOUT_STEPS = 2  # the served rollout's frames
# Each served frame samples with this many denoising steps, a fifth of the
# models' 50: a served call's time grows with them, its graph (one loop
# operator) does not.
SERVE_INFERENCE_STEPS = "10"
# Phase 12: mixed precision, Adafactor, the bfloat16 rollout.
MP_MODELS = ("fno", "unet", "ffno", "pixel_diffusion")
BF16_ROLLOUT = ("fno", "unet", "ffno")
FACTORED_WIDTH = 128  # the FNO's width at which its tensors factor
# Each per-step metric of the bfloat16 rollout against the float32
# rollout's, over that metric's largest value across the 20 steps. On an
# H100 the FNO's read 5.3e-5, the FFNO's 6.6e-5, the U-Net's 8.0e-3.
PHASE12_METRIC_RTOL = 3e-2
# The bfloat16 train step, card against CPU: the loss (relative) and the
# gradients (max abs diff over the largest gradient); for the U-Net those
# of its output conv, whose gradient no BatchNorm cancels, and all of them
# at a bound of their own (its BatchNorms leave rounding in the rest:
# tests/test_torch_mixed_precision.py). On an H100: the losses 1.2e-7
# (FNO) and 8.5e-5 (U-Net); the FNO's gradients 1.7e-6, the U-Net's
# output conv's 5.3e-3, all of the U-Net's 2.2e-2.
MP_CHECK_BATCH = 8
MP_LOSS_RTOL = 4e-4
MP_GRAD_RTOL = 2e-2
MP_UNET_ALL_GRAD_RTOL = 8e-2
# Phase 12's generative runs sample with fewer denoising steps.
MP_INFERENCE_STEPS = "10"
# Phase 12f: --matmul_precision high, which JAX runs as TF32 on an NVIDIA
# card (cuBLAS and cuDNN in TF32, both kernels in their one-product TF32
# mode). Gates, stated in PERF.md before the first run: each TF32 kernel
# against its TF32 plain version (operands rounded as the kernel rounds
# them, float32 products): the block's output and pre-activation within
# TF32_BLOCK_RTOL of the largest output, its retained modes of their largest
# (the two sum in other orders, so an intermediate both round to TF32 may
# land on neighbouring TF32 values), the head within HEAD_ATOL; against the
# float32 plain version within TF32_F32_RTOL of the largest output and
# further than TF32_RAN_RTOL (that it ran in TF32; split TF32 reads 3e-7).
# The flagship's main_auto under high against phase 6b's float32 run (train
# losses, dev and test scores, relative) and main_multistep under high on
# phase 6b's checkpoint (each per-step metric of its largest), within
# TF32_RUN_RTOL: a third of the bfloat16 rollout's PHASE12_METRIC_RTOL.
TF32_PRECISION = "high"
TF32_PRODUCTS = 1
TF32_BLOCK_RTOL = 1e-4
TF32_F32_RTOL = 1e-2
TF32_RAN_RTOL = 5e-5
TF32_RUN_RTOL = 1e-2
TF32_STEP_MODELS = ("fno", "unet", "resnet")  # 12f(c): b128 steps under high and float32
# Phase 13: data parallelism. (a) torchrun at world size 1 against the same
# run without it (the same arithmetic: one rank runs no collective); (b) two
# ranks on the one card against one process: the losses and per-step
# metrics (relative), the parameters (of their largest).
DP_TORCHRUN_RTOL = 1e-6
DP_RANKS = 2
DP_BATCH = 128  # the global batch of (b), and of the step timing
# The U-Net's main_auto at global b32: 200 train pairs give six full batches
# and a last one of 8 rows padded with 24 weight-0 rows, which the global
# BatchNorm normalises over. The one-step checks train such a padded batch
# (DP_STEP_VALID real rows) from the same weights.
DP_UNET_BATCH = 32
DP_STEP_VALID = 8
DP_RTOL = 1e-5
# Over several steps, the elements of rounding-level gradient that Adam
# moves by lr either way are read by the next batches: the U-Net's losses
# and parameters part from one process's. The same run in one process with
# the rows of every train batch permuted (an exact no-op: the loss and the
# BatchNorm statistics are sums over the rows) parts from it by rounding
# alone; two ranks may part by at most DP_DRIFT_FACTOR times as much, plus
# DP_RTOL.
DP_DRIFT_FACTOR = 4.0
# Phase 13b's other trainers, at their default widths on the same tree:
# main_train (FFN, DeepONet) one epoch at DP_BATCH (a full batch and one of
# 61 real rows); main_gencast, main_vae and main_uncond at DP_UNET_BATCH
# (their last batch padded). The VAE's huge --early_stopping_delta makes no
# epoch after the first a new best: at --lr_scheduler_patience 0 the rate is
# cut after epochs 1 and 2, and at --early_stopping_patience 1 the run stops
# after epoch 2, before DP_VAE_EPOCHS.
DP_TRAINERS = ("main_train", "main_gencast", "main_vae", "main_uncond")
DP_VAE_EPOCHS = 4
# The runs whose drift from one process is Adam amplifying rounding-level
# gradients (biases that a BatchNorm or a GroupNorm cancels), each run again
# in one process with the rows of every train batch permuted: the control.
CONTROLS = (("unet", "main_auto"), ("vae", "main_vae"), ("gencast", "main_gencast"),
            ("uncond", "main_uncond"))
# Their float64 steps take DP_UNET_BATCH rows of which these are real: rank
# 0's block is all real rows, rank 1's real rows and padding.
DP_TRAINER_STEP_VALID = 24
DP_TIMING_ROUNDS = 12
# Phase 14: a model axis of two ranks; the pipeline's microbatches; the
# shapes a model rank gives the kernels at the flagship (the block's output
# channels, the head's hidden units) under a model axis of 2 and of 4.
TP_MESH = "1x2"
TP_RANKS = 2
PP_MICRO = 2
RANK_BLOCK_COUT = (16, 8)
RANK_HEAD_HIDDEN = (64, 32)
# Phase 14b's GenCast rollout (20 frames) samples each frame with fewer
# denoising steps: each step gathers the split PUNetG over the ranks.
TP_GENCAST_INFERENCE_STEPS = "2"
# Phase 14b's other trainers, whose network tp splits and gathers at use.
SPLIT_TRAINERS = ("gencast", "vae", "uncond")
# Phase 14b's runs on the default algorithms, as users' runs take them: phase
# 13b's U-Net (main_auto), GenCast (main_gencast) and FFN (main_train) runs,
# trained only, at TP_MESH. There each model rank may sum a gradient in
# another order (cuDNN's weight gradients), so their replicas of the unsplit
# parameters stay equal only because each trainer averages those gradients
# over the model ranks (trainer_auto.reduce_gradients, GenCastAdamW,
# trainer_nonauto.train_step): they are held to that, bit for bit. Their
# distance from the deterministic one-process run is printed, not held: on
# these algorithms it differs from run to run.
DEFAULT_ALGORITHM_RUNS = ("unet", "gencast", "ffn")
# The bfloat16 runs over the model axis (the FNO's mixed-precision main_auto
# under tp and pp, its bfloat16 rollout under tp) against the same run in one
# process: the losses, dev scores and per-step metrics (relative), the frames
# (of their max). The row-parallel head sums partial outputs rounded to
# bfloat16, and a rank's products on half the channels may take another
# cuBLAS kernel: a bfloat16 ulp is 7.8e-3. On the CPU the step's loss parted
# 2.4e-6, the rollout's frames 7.4e-3 of their max and its metrics 5.3e-5
# (tests/test_torch_tp_vae_bf16.py).
TP_BF16_RTOL = 1e-3
TP_BF16_FRAME_RTOL = 3e-2
# Phase 15: spatial sharding. (a) The block kernel split around its
# spectrum's row sum at the rows a model rank holds, (H, W, ranks): 32 and 16
# of the flagship's 64 rows, 128 of 256 rows at W = 256. (b) main_auto
# --shard_spatial 1 on each mesh, SP_RANKS[mesh] gloo ranks on the one card.
SP_KERNEL_CASES = ((GRID, GRID, 2), (GRID, GRID, 4), (256, 256, 2))
SP_MESHES = ("1x2", "2x2")
SP_RANKS = {"1x2": 2, "2x2": 4}
# Phase 15c: the rest of main_auto under --shard_spatial 1 on SP_MESHES[0]:
# the flagship with --use_mixed_precision and with --pp_microbatches
# PP_MICRO, the U-Net on a TUBE_GRID tree (33 rows a rank, which its
# poolings reshard), two point models, pixel diffusion and the latent models
# (SP_PIXEL_BATCH; on phase 10's lite VAE, whose latents of a 64-row grid
# split 4 and 4 rows, and Lite on TUBE_GRID too: padded to 72 rows, the
# last rank holds 39 and the latents split 4 and 5), at default widths; and
# each rank's peak memory of one step of the U-Net, of pixel diffusion and
# of latent_diffusion2 (model flags, grid, global batch).
TUBE_GRID = (66, 65)  # the tube and dam problems' grid
# The frames of a case in the trees of phase 15c's runs other than the
# flagship's: a fifth of phase 13b's steps an epoch (40 train pairs; still a
# full and a padded batch of the U-Net's and the point models').
SP_REST_FRAMES = STEPS // 5 + 1
SP_POINT_MODELS = ("auto_ffn", "auto_deeponet_cnn")
SP_LATENT = {name: name for name in LATENT} | {"latent_diffusion_lite66": "latent_diffusion_lite"}
# Phase 15c's runs whose epoch is held against permuted-row controls, one a
# seed: gradients of rounding level (the biases that the U-Net's BatchNorms
# and the PUNetG's GroupNorms cancel; the point models' weights into units
# whose gradient sums cancel) turn into Adam steps of either sign. A control
# is one draw of the drift that rounding alone leaves, so the bound takes the
# largest of a few. On an H100 the U-Net's three controls read 6.1e-4 to
# 7.1e-3 in their losses.
SP_CONTROLLED = ("unet66",) + SP_POINT_MODELS + ("pixel_diffusion",) + tuple(SP_LATENT)
SP_CONTROL_SEEDS = (SEED, SEED + 1000, SEED + 2000)
# The latent runs' controls add the float64 run's drift (float64_run): a
# permuted-row control reorders only the batch's sums, and in a GroupNorm
# network (the PUNetG on 8x8 latents, the VAE, the CondEncoder) no
# per-sample sum, while sp reorders every spatial sum; so its draws fell
# short of sp's drift, which the float64 run's matches (PERF.md §6).
SP_LATENT_CONTROL = "float64"
SP_PIXEL_BATCH = 8
# Their dev batch samples with this many denoising steps: each step runs the
# network with its exchanges between the ranks, and the runs are held by
# their losses, weights and float64 steps, which sampling does not touch.
SP_INFERENCE_STEPS = "2"
SP_MEMORY = {"memory_unet66": (["--model", "unet"], TUBE_GRID, 128),
             "memory_pixel": (["--model", "pixel_diffusion"], (GRID, GRID), SP_PIXEL_BATCH),
             "memory_latent": (["--model", "latent_diffusion2", "--ldm_vae_weights_path",
                                str(WORK / "vae_weights")], (GRID, GRID), SP_PIXEL_BATCH)}
# Phase 15d: spatial sharding without its last refusals. (a) The block kernel
# split at the rows of the flagship padded by PAD over SP_MESHES[0] (the last
# rank holds the pad rows: Rows(0, 32, 73)), the head on each rank's crop;
# (b) phase 15b's flagship main_auto padded by PAD on both SP_MESHES; (c) on
# SP_EMPTY_MESH, where a level leaves a rank without a row, phase 15c's
# latent_diffusion2 at default widths on its 64x64 tree (8 latent rows,
# none on two ranks at the UNet's third level) and the U-Net on a
# SP_EMPTY_GRID tree (none on two ranks at its bottleneck), with
# SP_MESHES[1]'s runs in one spawn of four ranks.
SP_EMPTY_MESH = "1x4"
SP_EMPTY_GRID = (32, 32)
SP_EMPTY_CONTROLLED = ("unet_empty",)
# An H100 SXM's published peaks (NVIDIA's data sheet, dense rates): device
# memory bytes/s, TF32 FLOP/s on the tensor cores and float32 FLOP/s outside
# them. A split-TF32 product (csrc/tf32.cuh) is three TF32 products.
# Phase 16: the flagship's domain padding (the CUDA kernels a block or head
# call launches, one each, depend on its route: ops/fno_kernels.py::
# route_kernels, head_route_kernels).
PAD = 9
PROFILE_DIR = WORK / "profile"  # phase 16b's main_multistep traces
# Phase 17: the FNO past the kernels' old shared-memory limits. WIDE is the
# widest width of the JAX package's own sweep (bench.py) and the one
# --opt_state_dtype exists for; WIDE_GRID a grid 512 wide.
WIDE, WIDE_GRID = 256, 512
# (label, kernels, B, H, W, channels, modes, head outputs) of phase 17a.
WIDE_KERNEL_CASES = (
    ("width 256", ("fno_block", "fno_head"), TIMING_BATCH, GRID, GRID, WIDE, MODES, 2),
    ("512x512", ("fno_block", "fno_head"), 8, WIDE_GRID, WIDE_GRID, WIDTH, MODES, 2),
    ("32 modes", ("fno_block",), 8, 256, 256, WIDTH, 32, 2),
    ("9 outputs", ("fno_head",), TIMING_BATCH, GRID, GRID, WIDTH, MODES, 9),
)
WIDE_SPLIT = (8, WIDE_GRID, WIDE_GRID, 2)  # (B, H, W, ranks): 256 of 512 rows
# What vae_diagnostics_torch.py writes without matplotlib, which the card's
# machine lacks (its plots are written beside them where it is installed).
DIAGNOSTIC_FILES = ("diagnostics.json", "diagnostics.npz")
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12
SPLIT_TF32_PRODUCTS = 3


def sh(*cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


class PhaseClock:
    """Each phase's seconds, printed on a line of its own as it ends, and
    the whole script's, from the clock's start (``card`` names the card
    once it is known)."""

    def __init__(self):
        self.card = ""
        self.start = self.last = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[seconds] [{self.card}] phase {phase}: {now - self.last:.1f} s")
        self.last = now

    def total(self) -> None:
        print(f"[seconds] [{self.card}] all phases: {time.perf_counter() - self.start:.1f} s")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_ms(fn, reps: int) -> float:
    """:func:`time_ms` after one call (which builds a grid's DFT tables)."""
    fn()
    torch.cuda.synchronize()
    return time_ms(fn, reps)


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
    # The Hopper routes' instructions in the library: wgmma, TMA boxes, bulk
    # copies, in all and in each kernel's functions.
    sass = sh(str(Path(_build.find_nvcc()).with_name("cuobjdump")), "-sass", str(_build.LIBRARY))

    def counts(text: str) -> str:
        return ", ".join(f"{op} {len(re.findall(rf'\b{op}\b', text))}"
                         for op in ("HGMMA", "UTMALDG", "UBLKCP"))

    print(f"kernel library SASS: {counts(sass)}")
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    for kernel in ("fno_block", "fno_head"):
        mine = [f for f in functions if f"_{kernel}_cu_" in f.split("\n", 1)[0]]
        print(f"  {kernel}.cu, {len(mine)} functions: {counts(''.join(mine))}")
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


def bound(nbytes: int, tensor_fma: int, core_fma: int, products: int = SPLIT_TF32_PRODUCTS):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations at their units' rates, each tensor-core product as
    ``products`` TF32 products (three in split TF32, one in the TF32 mode)
    plus float32 FMA on the CUDA cores."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (products * 2 * tensor_fma / TF32_FLOP_PER_S
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


def flagship_model(device, **changes):
    """The seeded flagship FNO, with ``changes`` to its widths or padding."""
    from cfdbench_tpu_torch.models.fno import FLAGSHIP, Fno2d

    return Fno2d(n_case_params=5, **{**FLAGSHIP, **changes},
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
    data_root = WORK / "data"
    t0 = time.perf_counter()
    # 30 cases per subset: the seeded 80/10/10 split leaves 9 test cases.
    generate_all(data_root, cases_per_subset=30, num_frames=STEPS + 1, grid=GRID, seed=SEED)
    argv = fno_argv(data_root, WORK / "result")
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
    if counts != want or any(launch_counts(tf32=True).values()):
        raise RuntimeError(f"main path launches {counts}, expected {want}, "
                           f"{launch_counts(tf32=True)} in TF32 mode, expected none")
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
            if name == "fno_block":
                route = fk.block_route(fk.load_library(), H, W, WIDTH, WIDTH, MODES, MODES)
                passes = pass_ms(lambda: kern(*args))
                times[name].update(block_route=fk.route_name(route), passes_ms=passes)
                print(f"[time] [{card}] fno_block {fk.route_name(route)}; per pass (ms, "
                      f"torch.profiler over 10 calls): " + ", ".join(
                          f"{k_} {v:.4f}" for k_, v in passes.items()))
            else:
                route = fk.head_route(fk.load_library(), WIDTH, t["w1"].shape[0],
                                      t["w2"].shape[0])
                times[name].update(head_route=fk.head_route_name(route))
                print(f"[time] [{card}] fno_head {fk.head_route_name(route)}")
            nbytes, tensor_fma, core_fma = work[name]
            print(f"[time] [{card}] {name} B={B} {H}x{W} C={WIDTH}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms ({p / k:.2f}x); bound {bound_ms:.4f} ms by {bound_by} "
                  f"({nbytes / 1e6:.1f} MB; {tensor_fma / 1e9:.3f} G multiply-adds in split "
                  f"TF32, {core_fma / 1e9:.3f} G in float32 FMA), kernel at "
                  f"{bound_ms / k:.1%} of it; library call: none")
    return times


def pass_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of each CUDA kernel that ``fn`` launches, by
    torch.profiler over ``calls`` calls after one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {m.group(1): e.device_time_total / calls / 1e3 for e in prof.key_averages()
            if (m := re.search(r"(\w+_kernel)", e.key)) and e.device_time_total > 0}


def train_inputs(B, gen, device, grid=(GRID, GRID)):
    """A seeded batch for the flagship at 64x64, or on ``grid`` (mask with
    a hole)."""
    H, W = grid
    mask = torch.ones((B, H, W, 1))
    mask[:, 20:30, 10:40] = 0
    batch = dict(inputs=torch.randn((B, H, W, 2), generator=gen),
                 labels=torch.randn((B, H, W, 2), generator=gen),
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


# Phase 6b's main_auto flags, which phase 13a runs again under torchrun.
PHASE6_FLAGS = ("--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS), "--eval_interval",
                "1", "--batch_size", "16", "--eval_batch_size", "16", "--log_interval", "1")


def train_path(grid: int = GRID, tree: str = "train_data", result: str = "train_result",
               flags=()):
    """Phase 6b: ``main_auto --mode train_test`` at the flagship width on
    a synthetic cavity tree (``WORK / tree``, made unless it is there), 2
    epochs of a few steps; then ``main_multistep`` rolls out the checkpoint
    it wrote. ``flags`` follow the flagship's (phase 17: another width).
    Returns main_auto's launches, main_multistep's per-step metrics (phase
    12c rewrites the file with its bfloat16 rollout's) and its launches."""
    from cfdbench_tpu_torch.cli import main_auto, main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.data import get_auto_dataset
    from cfdbench_tpu_torch.data.pipeline import num_batches
    from cfdbench_tpu_torch.data.synthetic import generate_problem
    from cfdbench_tpu_torch.models.fno import FLAGSHIP
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    data_root = WORK / tree
    if not data_root.exists():
        generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=6, grid=grid,
                         seed=SEED)
    argv = fno_argv(data_root, WORK / result) + list(flags)
    train_flags = list(PHASE6_FLAGS)
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
    print(f"[train] {result} main_auto: {time.perf_counter() - t0:.2f} s, {len(train)} train "
          f"pairs, {TRAIN_EPOCHS} epochs x {steps} steps, {evals} eval forwards an epoch, "
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
    print(f"[train] {result} main_multistep on the trained checkpoint: launches {rollout}, "
          f"step-20 nmse {metrics[-1]['nmse']:.6g}")
    return counts, metrics, rollout


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
        frames = main_multistep(argv + ["--ldm_num_inference_steps", str(CHECK_INFERENCE_STEPS)])
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
    and every gradient, and each task's CHECK_INFERENCE_STEPS-step DDPM frame (pixel
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
        for pair in tasks.values():
            for task in pair.values():
                task.num_inference_steps = CHECK_INFERENCE_STEPS
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
            print(f"[phase9] {name} {CHECK_INFERENCE_STEPS}-step DDPM frame ({method}) "
                  f"B={GEN_CHECK_BATCH}, card vs "
                  f"CPU: max abs diff / max |frame| {rel:.3e} (bound {FAMILY_RTOL:.0e})")
            if not rel <= FAMILY_RTOL:
                raise RuntimeError(f"{name}: card and CPU frames disagree ({rel:.3e})")
    finally:
        diffusion.train_noise_and_t, ops.ddpm_noise = draw_noise, draw_sampler


def phase10_paths():
    """Phase 10a: ``main_vae --mode train_anneal`` (the lite VAE) for 2
    epochs, then ``--resume`` for a third; on its weights ``main_auto
    --mode train_test`` for each latent model and ``main_multistep`` for
    ``latent_diffusion2``; ``main_uncond`` for 2 epochs; all on the
    phase-6 tree at default widths. No FNO kernel launches. Returns the
    latent models' dev and test nmse of generated frames and the rollout's
    step-20 nmse."""
    from cfdbench_tpu_torch.cli import main_auto, main_multistep, main_uncond, main_vae, run_dir
    from cfdbench_tpu_torch.cli import parse_args
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    data_root, out = WORK / "train_data", WORK / "latent_result"
    common = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
              "--output_dir", str(out), "--ldm_vae_weights_path", str(WORK / "vae_weights"),
              "--batch_size", "16"]
    reset_launch_counts()
    t0 = time.perf_counter()
    main_vae(common + ["--mode", "train_anneal", "--num_epochs", "2"])
    main_vae(common + ["--mode", "train_anneal", "--num_epochs", "3", "--resume", "1"])
    vae_run = out / "vae" / "cavity_prop_bc_geo"
    history = json.loads((vae_run / "loss_history.json").read_text())
    meta = json.loads((vae_run / "training_meta.json").read_text())
    if (meta["epoch"] != 2 or "cur_lr" not in meta or len(history["val_total"]) != 3
            or not all(math.isfinite(v) for k in ("train_total", "val_total")
                       for v in history[k])):
        raise RuntimeError(f"main_vae: meta {meta}, history {history}")
    host_checkpoint(WORK / "vae_weights" / "model.pt", "main_vae")
    print(f"[phase10] main_vae --mode train_anneal, 2 epochs then --resume for a third: "
          f"{time.perf_counter() - t0:.2f} s, val_total {history['val_total']}, "
          f"cur_lr {meta['cur_lr']}")
    train_flags = ["--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS),
                   "--eval_interval", "1", "--eval_batch_size", "16", "--log_interval", "1"]
    result = {}
    for name in LATENT:
        argv = ["--model", name] + common
        run = run_dir(parse_args(argv))
        t0 = time.perf_counter()
        main_auto(argv + train_flags)
        dev = [json.loads((run / f"ckpt-{ep}" / "dev_scores.json").read_text())["mean"]
               for ep in range(TRAIN_EPOCHS)]
        if not all(math.isfinite(v) for d in dev for v in d.values()):
            raise RuntimeError(f"{name}: dev scores are not finite: {dev}")
        finite_scores(run, name)
        for ep in range(TRAIN_EPOCHS):
            host_checkpoint(run / f"ckpt-{ep}" / "model.pt", name)
        test = json.loads((run / "test" / "scores.json").read_text())["mean"]
        result[name] = dict(dev=[d["nmse"] for d in dev], test_nmse=test["nmse"],
                            test_input_nmse=test["input_nmse"])
        print(f"[phase10] {name}: train_test {time.perf_counter() - t0:.2f} s, dev nmse "
              f"{result[name]['dev']}, test nmse {test['nmse']:.6g} (persistence "
              f"{test['input_nmse']:.6g})")
        if name == "latent_diffusion2":
            t0 = time.perf_counter()
            frames = main_multistep(argv + ["--ldm_num_inference_steps",
                                            str(CHECK_INFERENCE_STEPS)])
            metrics = json.loads((run / "multistep_metrics.json").read_text())
            result[name]["step20_nmse"] = check_frames(frames, metrics, name)
            print(f"[phase10] {name}: main_multistep {time.perf_counter() - t0:.2f} s, step-20 "
                  f"nmse {result[name]['step20_nmse']:.6g}")
    t0 = time.perf_counter()
    _, _, losses = main_uncond(common + ["--num_epochs", str(TRAIN_EPOCHS)])
    uncond_run = out / "uncond_ddpm" / "cavity_prop_bc_geo"
    host_checkpoint(uncond_run / "ema_model" / "model.pt", "main_uncond")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"main_uncond: losses {losses}")
    print(f"[phase10] main_uncond: {TRAIN_EPOCHS} epochs, {len(losses)} steps, "
          f"{time.perf_counter() - t0:.2f} s, last loss {losses[-1]:.6g}; ema_model/ written")
    counts = launch_counts()
    print(f"[phase10] FNO kernel launches on these paths: {counts}")
    if any(counts.values()):
        raise RuntimeError(f"the latent and unconditional paths launched FNO kernels: {counts}")
    return result


def latent_task(name: str, device, vae_state, seed: int = SEED):
    """``name``'s task at its default widths (5 case parameters) on a lite
    VAE holding ``vae_state``, from a seeded init."""
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.models import init_latent_diffusion

    return init_latent_diffusion(Args(model=name), 5, vae_state, loss_name_to_fn("nmse"),
                                 generator=torch.Generator().manual_seed(seed), device=device)


def lite_vae(device, seed: int = SEED):
    from cfdbench_tpu_torch.models import make_cfd_vae

    return make_cfd_vae("lite", generator=torch.Generator().manual_seed(seed), device=device)


def exact_zero_keys(grads64) -> set:
    """The parameters whose float64 gradient is 0 in exact arithmetic."""
    top = max(g.abs().max().item() for g in grads64.values())
    return {k for k, g in grads64.items() if g.abs().max().item() <= EXACT_ZERO * top}


def compare_grads(what: str, loss_c: float, loss_g: float, grads_c, grads_g, zero: set) -> None:
    """The loss within GRAD_LOSS_RTOL, each gradient within GRAD_RTOL of its
    max, and those in ``zero`` below ZERO_GRAD_RTOL of the largest."""
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    top = max(g.abs().max().item() for g in grads_c.values())
    worst = 0.0
    for k, want in grads_c.items():
        got = grads_g[k]
        finite([got], f"{what} {k} gradient on the card")
        if k in zero:
            noise = max(got.abs().max().item(), want.abs().max().item()) / top
            if not noise <= ZERO_GRAD_RTOL:
                raise RuntimeError(f"{what} {k}: gradient {noise:.3e} of the largest, where "
                                   "exact arithmetic gives 0")
            continue
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not rel <= GRAD_RTOL:
            raise RuntimeError(f"{what} {k}: card gradient disagrees, {rel:.3e} > {GRAD_RTOL}")
        worst = max(worst, rel)
    print(f"[phase10] {what} train step B={FAMILY_BATCH}, card vs CPU: loss rel diff "
          f"{loss_rel:.3e} (bound {GRAD_LOSS_RTOL:.0e}); {len(grads_c) - len(zero)} gradients, "
          f"worst max abs diff / max |grad| {worst:.3e} (bound {GRAD_RTOL:.0e}); {len(zero)} "
          f"zero in exact arithmetic, at rounding level (bound {ZERO_GRAD_RTOL:.0e})")
    if not loss_rel <= GRAD_LOSS_RTOL:
        raise RuntimeError(f"{what}: train loss on the card disagrees ({loss_rel:.3e})")


def vae_forward_check(device) -> None:
    """The lite VAE's forward (its mode) at each of VAE_FORWARD_SEEDS:
    float32 on the card and on the CPU, each against float64 on the CPU,
    and the card with TF32 on. The card's float32 readings must lie within
    VAE_FORWARD_RTOL, and the TF32 reading outside it."""
    import copy

    from cfdbench_tpu_torch.utils.device import set_numerics

    worst = 0.0
    for seed in VAE_FORWARD_SEEDS:
        x = train_inputs(FAMILY_BATCH, torch.Generator().manual_seed(seed + 11), "cpu")["labels"]
        cpu_vae, card_vae = lite_vae("cpu", seed), lite_vae(device, seed)
        with torch.no_grad():
            exact = copy.deepcopy(cpu_vae).double()(x.double())[0]
            want = cpu_vae(x)[0]
            got = card_vae(x.to(device))[0].cpu()
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                tf32 = card_vae(x.to(device))[0].cpu()
            finally:
                set_numerics()
        top = exact.abs().max()
        rel, rel_cpu, rel_f32, rel_tf32 = (
            ((a - b).abs().max() / top).item()
            for a, b in ((got, exact), (want, exact), (got, want), (tf32, exact)))
        print(f"[phase10] lite VAE forward (mode) B={FAMILY_BATCH} {GRID}x{GRID}, seed {seed}, "
              f"max abs diff / max |out|: card float32 vs CPU float64 {rel:.3e} (bound "
              f"{VAE_FORWARD_RTOL:.0e}), CPU float32 vs float64 {rel_cpu:.3e}, card vs CPU "
              f"float32 {rel_f32:.3e}, card TF32 vs CPU float64 {rel_tf32:.3e}")
        if not rel_tf32 > VAE_FORWARD_RTOL:
            raise RuntimeError(f"lite VAE: the bound {VAE_FORWARD_RTOL:.0e} does not catch TF32 "
                               f"({rel_tf32:.3e})")
        worst = max(worst, rel)
    if not worst <= VAE_FORWARD_RTOL:
        raise RuntimeError(f"lite VAE: the card's forward strays from float64 ({worst:.3e})")


def phase10_card_vs_cpu(device):
    """Phase 10b: float32, TF32 off, every draw (the posterior's noise, the
    noise and timesteps, the sampler's noise) made on the CPU for both
    devices: the lite VAE's forward (``vae_forward_check``) and its train
    step's loss and gradients; each latent model's loss and gradients and
    its CHECK_INFERENCE_STEPS-step frame at B=2, card against CPU. Which gradients are 0 in
    exact arithmetic is read from a float64 run on the CPU."""
    import copy

    from cfdbench_tpu_torch.models import diffusion, vae as vae_mod
    from cfdbench_tpu_torch.ops import diffusion as ops
    from cfdbench_tpu_torch.training.trainer_vae import loss_parts
    from cfdbench_tpu_torch.utils.rng import train_key, vae_key

    draws = diffusion.train_noise_and_t, ops.ddpm_noise, vae_mod.posterior_noise
    diffusion.train_noise_and_t = lambda key, shape, T, dev: tuple(
        v.to(dev) for v in draws[0](key, shape, T, "cpu"))
    ops.ddpm_noise = lambda key, i, shape, dev: draws[1](key, i, shape, "cpu").to(dev)
    vae_mod.posterior_noise = lambda key, shape, dev: draws[2](key, shape, "cpu").to(dev)
    try:
        vae_forward_check(device)
        batch_cpu = train_inputs(FAMILY_BATCH, torch.Generator().manual_seed(SEED + 11), "cpu")
        batch = {k: v.to(device) for k, v in batch_cpu.items()}
        vaes = {"cpu": lite_vae("cpu"), "card": lite_vae(device)}
        x = batch_cpu["labels"]
        w = batch_cpu["weights"]

        def vae_grads(model, dtype, dev):
            parts = loss_parts(model, x.to(dev, dtype), w.to(dev, dtype), 1e-4, vae_key(SEED, 0))
            parts[0].backward()
            return parts[0].item(), {k: p.grad.cpu() for k, p in model.named_parameters()}

        zero = exact_zero_keys(vae_grads(copy.deepcopy(vaes["cpu"]).double(), torch.float64,
                                         "cpu")[1])
        (loss_c, grads_c), (loss_g, grads_g) = (vae_grads(vaes["cpu"], torch.float32, "cpu"),
                                                vae_grads(vaes["card"], torch.float32, device))
        compare_grads("lite VAE", loss_c, loss_g, grads_c, grads_g, zero)
        vae_state = vaes["cpu"].state_dict()
        for name in LATENT:
            tasks = {"cpu": latent_task(name, "cpu", vae_state),
                     "card": latent_task(name, device, vae_state)}
            for task in tasks.values():
                task.num_inference_steps = CHECK_INFERENCE_STEPS

            def task_grads(task, b):
                task.model.zero_grad(set_to_none=True)
                loss, _ = task.loss_scores(b, train_key(SEED, 0))
                loss.backward()
                return loss.item(), {k: p.grad.cpu() for k, p in task.model.named_parameters()}

            exact = copy.deepcopy(tasks["cpu"])
            exact.model.double()
            exact.vae.double()
            zero = exact_zero_keys(task_grads(exact, {k: v.double()
                                                      for k, v in batch_cpu.items()})[1])
            (loss_c, grads_c), (loss_g, grads_g) = (task_grads(tasks["cpu"], batch_cpu),
                                                    task_grads(tasks["card"], batch))
            compare_grads(name, loss_c, loss_g, grads_c, grads_g, zero)
            args = ("inputs", "case_params", "mask")
            want = tasks["cpu"].predict_frame(*(batch_cpu[k][:GEN_CHECK_BATCH] for k in args))
            got = tasks["card"].predict_frame(*(batch[k][:GEN_CHECK_BATCH] for k in args)).cpu()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"[phase10] {name} {CHECK_INFERENCE_STEPS}-step frame (decoded) "
                  f"B={GEN_CHECK_BATCH}, card vs CPU: "
                  f"max abs diff / max |frame| {rel:.3e} (bound {FAMILY_RTOL:.0e})")
            if not rel <= FAMILY_RTOL:
                raise RuntimeError(f"{name}: card and CPU frames disagree ({rel:.3e})")
    finally:
        diffusion.train_noise_and_t, ops.ddpm_noise, vae_mod.posterior_noise = draws


def phase10_timing(device, card) -> dict:
    """Phase 10c, at each of GEN_BATCHES by CUDA events: the lite VAE's
    train step (Adam; forward, backward, update), each latent model's train
    step (Adam and StepLR) with its split, peak memory and device
    operations, one denoise call (and its device operations), the 50-step
    frame with its decode in frames/s; the unconditional DDPM's step (AdamW
    and the EMA)."""
    from cfdbench_tpu_torch.ops.diffusion import make_ddpm_scheduler
    from cfdbench_tpu_torch.training import trainer_auto, trainer_uncond, trainer_vae
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.utils.rng import uncond_key, vae_key

    result = {}
    vae_state = lite_vae("cpu").state_dict()
    for B in GEN_BATCHES:
        batch = generative_batch(B, torch.Generator().manual_seed(SEED + 12), device)
        x, w = batch["labels"], batch["weights"]
        row = {}
        vae = lite_vae(device)
        opt = trainer_vae.make_optimizer(vae, 1e-4, 0.0)
        steps = itertools.count()

        def vae_step():
            trainer_vae.train_step(vae, opt, x, w, 1e-4, vae_key(SEED, next(steps)))

        def vae_loss():
            parts = trainer_vae.loss_parts(vae, x, w, 1e-4, vae_key(SEED, next(steps)))
            return parts[0], parts

        vae_step()
        split = step_split(vae_loss, opt, types.SimpleNamespace(step=lambda: None), device)
        row["vae"] = dict(train_step_ms=time_ms(vae_step, TRAIN_REPS), **split,
                          device_ops_per_step=device_ops(vae_step))
        print(f"[time] [{card}] lite VAE train step b{B} {GRID}x{GRID} f32: "
              f"{row['vae']['train_step_ms']:.3f} ms, {row['vae']['device_ops_per_step']} device "
              "operations; " + split_text(split))
        del vae, opt
        for name in LATENT:
            task = latent_task(name, device, vae_state)
            opt, sched = make_adam(task.model.parameters(), 1e-4)

            def step(task=task, opt=opt, sched=sched):
                trainer_auto.train_step(task, opt, sched, batch,
                                        task.step_draws(SEED, next(steps), device))

            step()
            step_ms = time_ms(step, TRAIN_REPS)
            split = step_split(lambda task=task: task.loss_scores(batch, task.step_draws(
                SEED, 0, device)), opt, sched, device)
            ops_step = device_ops(step)
            cp = batch["case_params"]
            with torch.inference_mode():
                cond = task.condition(batch["inputs"], cp)
                lat = torch.randn(task.vae.latent_shape(batch["inputs"].shape), device=device)
                t = torch.full((B,), 500, device=device)

                def denoise():
                    return task.denoise(lat, t, cp, cond)

                denoise()
                denoise_ms = time_ms(denoise, 10)
                ops_call = device_ops(denoise)
            torch.cuda.reset_peak_memory_stats(device)
            frame_ms = time_ms(lambda: task.predict_frame(batch["inputs"], cp, batch["mask"]), 1)
            frame_peak = torch.cuda.max_memory_allocated(device) / 2**20
            row[name] = dict(train_step_ms=step_ms, **split, device_ops_per_step=ops_step,
                             denoise_ms=denoise_ms, device_ops_per_call=ops_call,
                             frame_ms=frame_ms, frames_per_s=B / frame_ms * 1e3,
                             frame_peak_mib=frame_peak)
            print(f"[time] [{card}] {name} train step b{B} {GRID}x{GRID} f32: {step_ms:.3f} ms, "
                  f"{ops_step} device operations; " + split_text(split))
            print(f"[time] [{card}] {name} b{B}: denoise call {denoise_ms:.3f} ms ({ops_call} "
                  f"device operations), 50-step frame with its decode {frame_ms:.3f} ms = "
                  f"{B / frame_ms * 1e3:.2f} frames/s, peak memory {frame_peak:.1f} MiB")
            del task, opt
        scheduler = make_ddpm_scheduler(1000, device=device)
        unet = trainer_uncond.make_unet(2, 64, SEED, device)
        ema = trainer_uncond.make_unet(2, 64, SEED, device).requires_grad_(False)
        opt = torch.optim.AdamW(unet.parameters(), 1e-4, weight_decay=trainer_uncond.WEIGHT_DECAY)

        def uncond_step():
            trainer_uncond.train_step(unet, ema, opt, scheduler, x, w,
                                      uncond_key(SEED, next(steps)))

        uncond_step()
        torch.cuda.reset_peak_memory_stats(device)
        uncond_ms = time_ms(uncond_step, TRAIN_REPS)
        row["uncond"] = dict(train_step_ms=uncond_ms,
                             peak_mib=torch.cuda.max_memory_allocated(device) / 2**20,
                             device_ops_per_step=device_ops(uncond_step))
        print(f"[time] [{card}] unconditional DDPM train step b{B} {GRID}x{GRID} f32 (AdamW + "
              f"EMA): {uncond_ms:.3f} ms, {row['uncond']['device_ops_per_step']} device "
              f"operations, peak memory {row['uncond']['peak_mib']:.1f} MiB")
        result[f"b{B}"] = row
        del unet, ema, opt, batch, x, w
        torch.cuda.empty_cache()
    return result


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
    frame and the GEN_ROLLOUT_STEPS-step rollout, by CUDA events."""
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
            roll = make_rollout_fn(task.predict_frame, GEN_ROLLOUT_STEPS, stochastic=True,
                                   seed=SEED)
            rollout = lambda: roll(batch["inputs"], cp, mask)  # noqa: E731
        else:
            frame = lambda: task.generate(batch["inputs"], batch["inputs_prev"], cp, mask)  # noqa: E731
            rollout = lambda: task.rollout(batch["inputs"], batch["inputs"], cp, mask,  # noqa: E731
                                           GEN_ROLLOUT_STEPS)
        frame_ms = time_ms(frame, 1)
        torch.cuda.reset_peak_memory_stats(device)
        roll_ms = time_ms(rollout, 1)
        roll_peak = torch.cuda.max_memory_allocated(device) / 2**20
        fps = B * GEN_ROLLOUT_STEPS / roll_ms * 1e3
        print(f"[time] [{card}] {name} train step b{B} {GRID}x{GRID} f32: {step_ms:.3f} ms, "
              f"{ops_per_step} device operations; " + split_text(split))
        print(f"[time] [{card}] {name} b{B}: denoise call {denoise_ms:.3f} ms, 50-step DDPM frame "
              f"{frame_ms:.3f} ms ({B / frame_ms * 1e3:.2f} frames/s), rollout "
              f"{GEN_ROLLOUT_STEPS} steps "
              f"{roll_ms:.3f} ms = {fps:.2f} frames/s, peak memory {roll_peak:.1f} MiB")
        result[f"b{B}"] = dict(train_step_ms=step_ms, **split, device_ops_per_step=ops_per_step,
                               denoise_ms=denoise_ms, frame_ms=frame_ms, rollout_ms=roll_ms,
                               rollout_frames_per_s=fps, rollout_peak_mib=roll_peak)
        del task, opt, batch
        torch.cuda.empty_cache()
    return result


def load_script(name: str):
    """``scripts/<name>.py`` as a module (its ``main`` takes argv)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fno_argv(data_root: Path, output_dir: Path):
    """The flagship FNO's flags on a synthetic cavity tree."""
    from cfdbench_tpu_torch.models.fno import FLAGSHIP

    return ["--model", "fno", "--data_name", "cavity_prop_bc_geo",
            "--data_dir", str(data_root), "--output_dir", str(output_dir),
            "--fno_depth", str(FLAGSHIP["num_layers"]),
            "--fno_hidden_dim", str(FLAGSHIP["hidden_dim"]),
            "--fno_modes_x", str(FLAGSHIP["modes1"]), "--fno_modes_y", str(FLAGSHIP["modes2"])]


def max_rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def same_metrics(got, want, rtol: float, what: str) -> float:
    """Every per-step metric of ``got`` within ``rtol`` of ``want``'s;
    returns the largest relative difference."""
    if len(got) != STEPS or len(want) != STEPS:
        raise RuntimeError(f"{what}: {len(got)} and {len(want)} steps, not {STEPS}")
    worst = 0.0
    for s, (a, b) in enumerate(zip(got, want)):
        for key in b:
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
            if not rel <= rtol:
                raise RuntimeError(f"{what}: step {s + 1} {key} {a[key]!r} vs {b[key]!r} "
                                   f"(rel {rel:.3e} > {rtol:.0e})")
            worst = max(worst, rel)
    return worst


def reference_import(run: Path) -> None:
    """Phase 11a: the run's best weights in the reference's layout, through
    the import script into a fresh tree; ``main_multistep`` there must give
    the run's own per-step metrics (``multistep_metrics.json``)."""
    from cfdbench_tpu_torch.cli import main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.training.checkpoints import load_best_params
    from cfdbench_tpu_torch.utils.torch_import import to_reference

    src = WORK / "reference" / "ckpt-0"
    src.mkdir(parents=True, exist_ok=True)
    reference = to_reference("fno", load_best_params(run))
    torch.save(reference, src / "model.pt")
    argv = fno_argv(WORK / "train_data", WORK / "imported_result")
    t0 = time.perf_counter()
    load_script("import_reference_checkpoint_torch").main(["--torch_ckpt", str(src / "model.pt")]
                                                          + argv)
    main_multistep(argv)
    metrics = json.loads((run_dir(parse_args(argv)) / "multistep_metrics.json").read_text())
    original = json.loads((run / "multistep_metrics.json").read_text())
    worst = same_metrics(metrics, original, SERVE_IMPORT_RTOL, "imported reference checkpoint")
    print(f"[serve] reference checkpoint ({', '.join(sorted(reference)[:3])}, ... "
          f"{len(reference)} tensors) imported and rolled out in {time.perf_counter() - t0:.2f} "
          f"s: per-step metrics against the original's max rel diff {worst:.3e} (bound "
          f"{SERVE_IMPORT_RTOL:.0e})")


def serving(device, card):
    """Phase 11: the reference import (a), ``serve_bench_torch.py
    --selftest`` for the FNO and the U-Net (c). Returns the launches of one
    served predict call and one served rollout of the FNO."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.models.fno import FLAGSHIP

    argv = fno_argv(WORK / "train_data", WORK / "train_result")
    reference_import(run_dir(parse_args(argv)))
    depth = FLAGSHIP["num_layers"]
    bench = load_script("serve_bench_torch")
    timing = {}
    for model, width, steps in (("fno", FLAGSHIP["hidden_dim"], STEPS),
                                ("unet", Args().unet_dim, SERVE_UNET_ROLLOUT_STEPS)):
        out = bench.main(["--selftest", "--model", model, "--batch", str(TIMING_BATCH),
                          "--grid", str(GRID), "--hidden", str(width), "--depth", str(depth),
                          "--modes", str(FLAGSHIP["modes1"]), "--steps", str(steps),
                          "--iters", str(SERVE_ITERS)])["selftest"]
        timing[model] = out
        for kind in ("predict", "rollout"):
            r = out[kind]
            calls = 1 if kind == "predict" else steps
            counts = ({"fno_block": depth * calls, "fno_head": calls} if model == "fno"
                      else {"fno_block": 0, "fno_head": 0})
            rtol = SERVE_FNO_RTOL if model == "fno" else SERVE_UNET_RTOL
            if (r["launches_per_call"] != counts
                    or not r["max_abs_diff_vs_in_process"] <= rtol * r["max_abs_out"]):
                raise RuntimeError(f"serve_bench_torch.py --selftest --model {model} {kind}: "
                                   f"launches {r['launches_per_call']} (expected {counts}), "
                                   f"served vs in process {r['max_abs_diff_vs_in_process']:.3e}")
            print(f"[time] [{card}] served {model} {kind} b{TIMING_BATCH} {GRID}x{GRID}"
                  f"{f' x {steps} steps' if kind == 'rollout' else ''}: served "
                  f"{r['latency_ms_per_call']:.3f} ms a call (device {r['device_ms_per_call']:.3f}"
                  f" ms), in process {r['in_process_ms_per_call']:.3f} ms (device "
                  f"{r['in_process_device_ms_per_call']:.3f} ms); {r['frames_per_sec']:.1f} "
                  f"frames/s served; overhead {r['served_overhead_pct']:+.2f} %; artifact "
                  f"{r['bytes']} bytes, export {r['export_s']:.2f} s; launches a served call "
                  f"{r['launches_per_call']}; served vs in process max abs diff "
                  f"{r['max_abs_diff_vs_in_process']:.3e} (max |out| {r['max_abs_out']:.3e})")
    print(f"[serve] [{card}] " + json.dumps(timing))
    return (timing["fno"]["predict"]["launches_per_call"],
            timing["fno"]["rollout"]["launches_per_call"])


def serving_diffusion(card):
    """Phase 11d: ``serve_bench_torch.py --selftest`` for each of
    SERVE_DIFFUSION at its default widths: each served call within
    SERVE_UNET_RTOL of max |frame| of the in-process one, the sampler one
    loop operator in the predict's graph and one inside the rollout's
    loop over the frames, no FNO kernel launched. Returns each path's
    launches a served call (0) and the timings."""
    bench = load_script("serve_bench_torch")
    launches, timing = {}, {}
    runs = [(B, "predict", SERVE_DIFFUSION_ITERS, 1) for B in GEN_BATCHES]
    runs.append((GEN_BATCHES[0], "rollout", 1, 0))
    for model in SERVE_DIFFUSION:
        for B, kind, iters, warmup in runs:
            r = bench.main(["--selftest", "--model", model, "--batch", str(B), "--grid", str(GRID),
                            "--steps", str(SERVE_DIFFUSION_ROLLOUT_STEPS), "--only", kind,
                            "--inference_steps", SERVE_INFERENCE_STEPS,
                            "--iters", str(iters), "--warmup", str(warmup)])["selftest"][kind]
            path = f"serve_{model}_{kind}_b{B}"
            launches[path], timing[path] = r["launches_per_call"], r
            loops = [1] if kind == "predict" else [1, 1]
            frames = (B,) if kind == "predict" else (SERVE_DIFFUSION_ROLLOUT_STEPS, B)
            if (any(r["launches_per_call"].values()) or r["loops"] != loops
                    or tuple(r["out_shape"][:-3]) != frames
                    or not r["max_abs_diff_vs_in_process"] <= SERVE_UNET_RTOL * r["max_abs_out"]):
                raise RuntimeError(f"served {model} {kind} b{B}: launches "
                                   f"{r['launches_per_call']}, loops {r['loops']} (expected "
                                   f"{loops}), out {r['out_shape']}, served vs in process "
                                   f"{r['max_abs_diff_vs_in_process']:.3e} (max |out| "
                                   f"{r['max_abs_out']:.3e}, bound {SERVE_UNET_RTOL:.0e})")
            print(f"[time] [{card}] served {model} {kind} b{B} {GRID}x{GRID}"
                  f"{f' x {SERVE_DIFFUSION_ROLLOUT_STEPS} steps' if kind == 'rollout' else ''}, "
                  f"{SERVE_INFERENCE_STEPS} denoising steps: "
                  f"export {r['export_s']:.2f} s, artifact {r['bytes']} bytes (weights "
                  f"{r['weights_bytes']} bytes), graph {r['nodes']} nodes, loops by depth "
                  f"{r['loops']}; served {r['latency_ms_per_call']:.3f} ms a call (device "
                  f"{r['device_ms_per_call']:.3f} ms), in process {r['in_process_ms_per_call']:.3f}"
                  f" ms (device {r['in_process_device_ms_per_call']:.3f} ms); "
                  f"{r['frames_per_sec']:.2f} frames/s served; noise draw "
                  f"{r['noise_draw_ms']:.3f} ms (device {r['noise_draw_device_ms']:.3f} ms); "
                  f"served vs in process max abs diff {r['max_abs_diff_vs_in_process']:.3e} "
                  f"(max |out| {r['max_abs_out']:.3e}, bound {SERVE_UNET_RTOL:.0e}); FNO "
                  f"launches a served call {r['launches_per_call']}")
    print(f"[serve] [{card}] diffusion " + json.dumps(timing))
    return launches


def phase12_argv(name: str, output_dir: Path, width: int = WIDTH):
    """``name``'s flags on the phase-6 tree: the flagship FNO's widths (or
    ``width``), the others' defaults; the generative models sample with
    MP_INFERENCE_STEPS denoising steps."""
    data_root = WORK / "train_data"
    if name == "fno":  # the last --fno_hidden_dim wins
        return fno_argv(data_root, output_dir) + ["--fno_hidden_dim", str(width)]
    argv = ["--model", name, "--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(output_dir)]
    if name in GENERATIVE:
        argv += ["--ldm_num_inference_steps", MP_INFERENCE_STEPS]
    return argv


def fno_eval_forwards(argv, train_flags) -> int:
    """The forwards of a ``main_auto --mode train_test`` run of the FNO that
    are not train steps: per eval epoch one per dev batch and one for
    example.png, and one per test case."""
    from cfdbench_tpu_torch.cli import parse_args
    from cfdbench_tpu_torch.data import get_auto_dataset
    from cfdbench_tpu_torch.data.pipeline import num_batches

    args = parse_args(argv + train_flags)
    _, dev, test = get_auto_dataset(WORK / "train_data", args.data_name, args.delta_time,
                                    True, True, seed=args.seed)
    return TRAIN_EPOCHS * (num_batches(len(dev), args.eval_batch_size) + 1) + len(test)


def phase12_paths():
    """Phase 12a-c. Returns main_auto's launches under
    ``--use_mixed_precision`` (the FNO) and main_multistep's under
    ``--rollout_dtype bfloat16`` (the FNO)."""
    from cfdbench_tpu_torch.cli import main_auto, main_gencast, main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.models.fno import FLAGSHIP
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    train_flags = ["--mode", "train_test", "--num_epochs", str(TRAIN_EPOCHS),
                   "--eval_interval", "1", "--batch_size", "16", "--eval_batch_size", "16",
                   "--log_interval", "100"]
    mp = ["--use_mixed_precision", "1"]
    mp_counts = None
    for name in MP_MODELS:
        argv = phase12_argv(name, WORK / "mp_result")
        reset_launch_counts()
        t0 = time.perf_counter()
        main_auto(argv + train_flags + mp)
        counts = launch_counts()
        scores = finite_scores(run_dir(parse_args(argv)), f"{name} --use_mixed_precision")
        if name == "fno":
            forwards = fno_eval_forwards(argv, train_flags)
            want = {"fno_block": FLAGSHIP["num_layers"] * forwards, "fno_head": forwards}
            mp_counts = counts
        else:
            want = {"fno_block": 0, "fno_head": 0}
        if counts != want:
            raise RuntimeError(f"{name} --use_mixed_precision launched {counts}, expected {want}"
                               ": none in the bfloat16 train forwards, 4 blocks and 1 head a "
                               "float32 eval or test forward of the FNO")
        print(f"[phase12] {name} main_auto --use_mixed_precision: "
              f"{time.perf_counter() - t0:.2f} s, dev loss "
              f"{[scores[f'ckpt-{ep}']['dev_loss'] for ep in range(TRAIN_EPOCHS)]}, test nmse "
              f"{scores['test']['nmse']:.6g}; launches {counts} (expected {want})")
    argv = phase12_argv("gencast", WORK / "mp_result")
    reset_launch_counts()
    t0 = time.perf_counter()
    main_gencast(argv + train_flags + mp)
    run = run_dir(parse_args(argv))
    test = json.loads((run / "test" / "scores.json").read_text())["mean"]
    if not all(math.isfinite(v) for v in test.values()) or any(launch_counts().values()):
        raise RuntimeError(f"gencast --use_mixed_precision: test scores {test}, "
                           f"launches {launch_counts()}")
    print(f"[phase12] main_gencast --use_mixed_precision: {time.perf_counter() - t0:.2f} s, "
          f"test gen nmse {test['nmse']:.6g}")

    # (b) Adafactor at width 128, one epoch, then --resume for a second.
    argv = phase12_argv("fno", WORK / "factored_result", FACTORED_WIDTH)
    flags = ["--mode", "train", "--eval_interval", "1", "--batch_size", "16",
             "--eval_batch_size", "16", "--log_interval", "100", "--opt_state_dtype", "factored",
             "--plot_train_examples", "0"]
    t0 = time.perf_counter()
    main_auto(argv + flags + ["--num_epochs", "1"])
    main_auto(argv + flags + ["--num_epochs", str(TRAIN_EPOCHS), "--resume", "1"])
    run = run_dir(parse_args(argv))
    losses = json.loads((run / "train_losses.json").read_text())
    meta = json.loads((run / "training_meta.json").read_text())
    state = torch.load(run / "training_state" / "model.pt", weights_only=True)["optimizer"]
    factored = [s for s in state["state"].values() if "v_row" in s]
    dev = [json.loads((run / f"ckpt-{ep}" / "scores.json").read_text())["dev_loss"]
           for ep in range(TRAIN_EPOCHS)]
    if (meta["epoch"] != TRAIN_EPOCHS - 1 or not losses or not factored
            or not all(math.isfinite(v) for v in losses + dev)):
        raise RuntimeError(f"--opt_state_dtype factored: meta {meta}, {len(factored)} factored "
                           f"tensors, losses {losses}, dev {dev}")
    print(f"[phase12] fno width {FACTORED_WIDTH} --opt_state_dtype factored, 1 epoch then "
          f"--resume: {time.perf_counter() - t0:.2f} s, {len(losses)} finite step losses, dev "
          f"loss {dev}; {len(factored)} of {len(state['state'])} tensors factored")

    # (c) The bfloat16 rollout of the phase-6, 7 and 8 checkpoints.
    bf16_counts = None
    for name in BF16_ROLLOUT:
        argv = (fno_argv(WORK / "train_data", WORK / "train_result") if name == "fno"
                else family_argv(name, WORK / "train_data"))
        run = run_dir(parse_args(argv))
        main_multistep(argv)
        want = json.loads((run / "multistep_metrics.json").read_text())
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = main_multistep(argv + ["--rollout_dtype", "bfloat16"])
        counts = launch_counts()
        got = json.loads((run / "multistep_metrics.json").read_text())
        worst = 0.0
        for key in want[0]:
            top = max(abs(w[key]) for w in want)
            worst = max(worst, max(abs(g[key] - w[key]) for g, w in zip(got, want)) / top)
        if (frames.dtype != torch.bfloat16 or len(got) != STEPS or any(counts.values())
                or not all(math.isfinite(v) for m in got for v in m.values())
                or not worst <= PHASE12_METRIC_RTOL):
            raise RuntimeError(f"{name} --rollout_dtype bfloat16: frames {frames.dtype}, "
                               f"launches {counts}, metrics {got} against float32 {want} "
                               f"({worst:.3e})")
        if name == "fno":
            bf16_counts = counts
        print(f"[phase12] {name} main_multistep --rollout_dtype bfloat16: "
              f"{time.perf_counter() - t0:.2f} s, launches {counts}, step-20 nmse "
              f"{got[-1]['nmse']:.6g} (float32 {want[-1]['nmse']:.6g}); per-step metrics against "
              f"float32: {worst:.3e} of each one's largest (bound {PHASE12_METRIC_RTOL:.0e})")
    argv = fno_argv(WORK / "train_data", WORK / "train_result")
    try:
        main_multistep(argv + ["--rollout_dtype", "bfloat16", "--use_pallas_head", "1"])
    except NotImplementedError as e:
        print(f"[phase12] --rollout_dtype bfloat16 --use_pallas_head 1 refuses, as it must: {e}")
    else:
        raise RuntimeError("--rollout_dtype bfloat16 --use_pallas_head 1 did not refuse")
    return mp_counts, bf16_counts


def mp_step(model, batch):
    """The bfloat16 train step's loss and gradients (on the host) of
    ``model`` on ``batch``."""
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.training.trainer_auto import AutoTask

    task = AutoTask(model.train(), loss_name_to_fn("nmse"), compute_dtype=torch.bfloat16)
    loss, _ = task.loss_scores(batch)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}


def phase12_card_vs_cpu(device):
    """Phase 12d: the bfloat16 train step of the flagship FNO and of the
    U-Net at its default width, B=MP_CHECK_BATCH, card against CPU."""
    batch_cpu = train_inputs(MP_CHECK_BATCH, torch.Generator().manual_seed(SEED + 12), "cpu")
    batch = {k: v.to(device) for k, v in batch_cpu.items()}
    for name in ("fno", "unet"):
        runs = {}
        for where, b in (("cpu", batch_cpu), ("card", batch)):
            dev = "cpu" if where == "cpu" else device
            model = flagship_model(dev) if name == "fno" else family_model(name, dev)
            runs[where] = mp_step(model, b)
        (loss_c, grads_c), (loss_g, grads_g) = runs["cpu"], runs["card"]
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        keys = list(grads_c) if name == "fno" else ["out_conv.conv.weight", "out_conv.conv.bias"]
        top = max(grads_c[k].abs().max().item() for k in keys)
        worst = max((grads_g[k] - grads_c[k]).abs().max().item() for k in keys) / top
        every = max((grads_g[k] - grads_c[k]).abs().max().item() for k in grads_c) / max(
            g.abs().max().item() for g in grads_c.values())
        every_bound = MP_GRAD_RTOL if name == "fno" else MP_UNET_ALL_GRAD_RTOL
        print(f"[phase12] {name} bfloat16 train step B={MP_CHECK_BATCH} {GRID}x{GRID}, card vs "
              f"CPU: nmse rel diff {loss_rel:.3e} (bound {MP_LOSS_RTOL:.0e}); {len(keys)} "
              f"gradients held, max abs diff / largest {worst:.3e} (bound {MP_GRAD_RTOL:.0e}); "
              f"all {len(grads_c)} gradients: {every:.3e} (bound {every_bound:.0e})")
        if not (loss_rel <= MP_LOSS_RTOL and worst <= MP_GRAD_RTOL and every <= every_bound
                and all(torch.isfinite(g).all() for g in grads_g.values())):
            raise RuntimeError(f"{name}: the bfloat16 train step on the card disagrees with the "
                               f"CPU's (loss {loss_rel:.3e}, gradients {worst:.3e})")


def phase12_timing(device, card) -> dict:
    """Phase 12e, by CUDA events."""
    import copy

    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn
    from cfdbench_tpu_torch.training.trainer_auto import train_step
    from cfdbench_tpu_torch.utils.rng import train_key

    result = {}
    bf16 = torch.bfloat16
    # The FNO's rollout: float32 on the kernels against bfloat16 plain.
    B = TIMING_BATCH
    batch = train_inputs(B, torch.Generator().manual_seed(SEED + 13), device)
    args = (batch["inputs"], batch["case_params"], batch["mask"])
    model = flagship_model(device).eval()
    roll32 = make_rollout_fn(model, STEPS)
    roll16 = make_rollout_fn(copy.deepcopy(model).to(bf16), STEPS)
    args16 = tuple(a.to(bf16) for a in args)
    f32_ms, bf16_ms = interleaved_ms(lambda: roll32(*args), lambda: roll16(*args16), reps=3)
    result["fno_rollout"] = dict(f32_kernels_ms=f32_ms, bf16_plain_ms=bf16_ms,
                                 f32_frames_per_s=B * STEPS / f32_ms * 1e3,
                                 bf16_frames_per_s=B * STEPS / bf16_ms * 1e3)
    print(f"[time] [{card}] fno rollout b{B} x {STEPS} steps: float32 on the kernels "
          f"{f32_ms:.3f} ms = {B * STEPS / f32_ms * 1e3:.1f} frames/s; bfloat16 plain "
          f"{bf16_ms:.3f} ms = {B * STEPS / bf16_ms * 1e3:.1f} frames/s")

    # The train step, float32 against mixed precision.
    for name, B in (("fno", TIMING_BATCH), ("unet", TIMING_BATCH), ("pixel_diffusion", 32)):
        if name == "pixel_diffusion":
            batch = generative_batch(B, torch.Generator().manual_seed(SEED + 14), device)
            tasks = {"f32": generative_task(name, device), "mixed": generative_task(name, device)}
            draws = train_key(SEED, 0)
        else:
            batch = train_inputs(B, torch.Generator().manual_seed(SEED + 14), device)
            make = flagship_model if name == "fno" else (lambda d: family_model("unet", d))
            tasks = {"f32": nmse_task(make(device)), "mixed": nmse_task(make(device))}
            draws = None
        tasks["mixed"].compute_dtype = bf16
        paths = {k: (t, *make_adam(t.model.parameters(), 1e-4)) for k, t in tasks.items()}
        step = {k: (lambda p=p: train_step(*p, batch, draws)) for k, p in paths.items()}
        f32_ms, mixed_ms = interleaved_ms(step["f32"], step["mixed"], reps=TRAIN_REPS)
        entry = dict(f32_ms=f32_ms, mixed_ms=mixed_ms)
        for k, (task, opt, sched) in paths.items():
            entry[k] = step_split(lambda t=task: t.loss_scores(batch, draws), opt, sched, device)
            print(f"[time] [{card}] {name} train step b{B} {GRID}x{GRID}, "
                  f"{'float32' if k == 'f32' else 'mixed precision'}: "
                  + split_text(entry[k]))
        print(f"[time] [{card}] {name} train step b{B}: float32 {f32_ms:.3f} ms, mixed "
              f"precision {mixed_ms:.3f} ms (mixed/float32 {mixed_ms / f32_ms:.3f})")
        result[f"{name}_train_b{B}"] = entry
        del tasks, paths, step, batch
        torch.cuda.empty_cache()

    # Adam's and Adafactor's update of the FNO at width 128.
    from cfdbench_tpu_torch.models.fno import FLAGSHIP, Fno2d

    updates, opts = {}, []
    for opt_state in ("f32", "factored"):
        model = Fno2d(n_case_params=5, **dict(FLAGSHIP, hidden_dim=FACTORED_WIDTH),
                      generator=torch.Generator().manual_seed(SEED), device=device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen, device=device) * 1e-3
        opt, sched = make_adam(model.parameters(), 1e-4, opt_state=opt_state)
        opts.append((opt, sched))  # the scheduler's step wrapper holds its optimizer weakly
        updates[opt_state] = opt.step
        n = sum(p.numel() for p in model.parameters())
    adam_ms, ada_ms = interleaved_ms(updates["f32"], updates["factored"], reps=20)
    result["update_width128"] = dict(adam_ms=adam_ms, adafactor_ms=ada_ms, params=n)
    print(f"[time] [{card}] fno width {FACTORED_WIDTH} ({n} parameters) update: Adam "
          f"{adam_ms:.3f} ms, Adafactor {ada_ms:.3f} ms")
    return result


def tf32_kernels(device, card) -> dict:
    """Phase 12f(a): each kernel in its TF32 mode at the flagship's shapes
    (B=128) against its TF32 plain version and the float32 one, at the
    gates above (the block's saved pre-activation and retained modes too),
    timed in turns with its TF32 plain version and its split mode, beside
    its bound at one TF32 product; the block's halves in TF32 at 15a's
    first split. Returns a record per kernel."""
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk

    lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    B, H, W = TIMING_BATCH, GRID, GRID
    t = kernel_inputs(B, H, W, WIDTH, torch.Generator().manual_seed(SEED + 21), device)
    block = (t["x"], t["weights"], t["w0"], t["b0"], MODES, MODES)
    head = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["mask"])
    work = {"fno_block": block_work(B, H, W, WIDTH, WIDTH, MODES),
            "fno_head": head_work(B, H, W, WIDTH, t["w1"].shape[0], t["w2"].shape[0])}
    out = {}
    with torch.inference_mode():
        for name, kern, ref, args in (("fno_block", fk.fno_block, fk.fno_block_reference, block),
                                      ("fno_head", fk.fno_head, fk.fno_head_reference, head)):
            got = kern(*args, tf32=True)
            want, want32 = ref(*args, tf32=True), ref(*args)
            torch.cuda.synchronize()
            top = want.abs().max().item()
            err = (got - want).abs().max().item()
            f32_err = (got - want32).abs().max().item()
            atol = TF32_BLOCK_RTOL * top if name == "fno_block" else HEAD_ATOL
            print(f"[tf32] fno {name} B={B} {H}x{W} C={WIDTH} in TF32: max abs err {err:.3e} "
                  f"against its TF32 plain version (bound {atol:.1e}), {f32_err:.3e} against "
                  f"the float32 one ({f32_err / top:.3e} of the largest |out| {top:.3f}; "
                  f"bounds {TF32_RAN_RTOL:.0e} to {TF32_F32_RTOL:.0e})")
            if not (torch.isfinite(got).all() and err <= atol
                    and TF32_RAN_RTOL * top < f32_err <= TF32_F32_RTOL * top):
                raise RuntimeError(f"{name} in TF32: {err:.3e} from its TF32 plain version, "
                                   f"{f32_err:.3e} from the float32 one")
            if name == "fno_block":
                _, xm, pre = fk._block_call(lib, *block, stream, keep=True, tf32=True)
                want_xm, want_pre = fk.fno_block_saved_reference(*block, tf32=True)
                pre_err = (pre - want_pre).abs().max().item()
                xm_rel = ((xm - want_xm).abs().max() / want_xm.abs().max()).item()
                print(f"[tf32] fno_block saved for the backward: pre-activation {pre_err:.3e} "
                      f"(bound {atol:.1e}), retained modes {xm_rel:.3e} of their largest "
                      f"(bound {TF32_BLOCK_RTOL:.0e})")
                if not (pre_err <= atol and xm_rel <= TF32_BLOCK_RTOL):
                    raise RuntimeError("fno_block's saved outputs in TF32 disagree")
            else:  # the mma.sync route, which widths not a multiple of 4 take
                old = fk._head_call(lib, *head, stream, True, route=0)
                old_err = (old - want).abs().max().item()
                old_f32 = (old - want32).abs().max().item()
                print(f"[tf32] fno_head on route 0 (mma.sync) in TF32: max abs err {old_err:.3e} "
                      f"against its TF32 plain version (bound {atol:.1e}), {old_f32:.3e} against "
                      f"the float32 one")
                if not (torch.isfinite(old).all() and old_err <= atol
                        and TF32_RAN_RTOL * top < old_f32 <= TF32_F32_RTOL * top):
                    raise RuntimeError(f"fno_head's route 0 in TF32: {old_err:.3e} from its TF32 "
                                       f"plain version, {old_f32:.3e} from the float32 one")
            plain_ms, ms = interleaved_ms(lambda: ref(*args, tf32=True),
                                          lambda: kern(*args, tf32=True), reps=20)
            split_ms, ms2 = interleaved_ms(lambda: kern(*args), lambda: kern(*args, tf32=True),
                                           reps=20)
            bound_ms, bound_by = bound(*work[name], TF32_PRODUCTS)
            out[name] = dict(max_abs_err=err, max_abs_err_f32=f32_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, split_ms=split_ms,
                             tf32_ms_beside_split=ms2)
            if name == "fno_head":
                out[name].update(route0_max_abs_err=old_err, route0_max_abs_err_f32=old_f32)
            print(f"[time] [{card}] {name} B={B} {H}x{W} C={WIDTH} TF32: kernel {ms:.4f} ms, "
                  f"its plain version {plain_ms:.4f} ms; beside split TF32 {split_ms:.4f} ms, "
                  f"TF32 {ms2:.4f} ms ({ms2 / split_ms:.3f}); bound {bound_ms:.4f} ms by "
                  f"{bound_by} at one TF32 product, kernel at {bound_ms / ms:.1%} of it")
    record, _, _ = split_block(lib, stream, device, card, B, *SP_KERNEL_CASES[0], tf32=True)
    out["fno_block"]["at_rank_rows"] = [record]
    out["fno_block"]["max_abs_err"] = max(out["fno_block"]["max_abs_err"], record["max_abs_err"])
    return out


def tf32_paths(train_counts: dict, train_metrics) -> dict:
    """Phase 12f(b): phase 6b's main_auto under ``--matmul_precision high``
    (every launch in TF32 mode, phase 6b's counts), its losses and scores
    against phase 6b's float32 run; then main_multistep under high on a
    copy of phase 6b's result tree (80 and 20 TF32 launches), its per-step
    metrics against phase 6b's float32 rollout of that checkpoint. Returns
    each path's launches."""
    from cfdbench_tpu_torch.cli import main_auto, main_multistep, parse_args, run_dir
    from cfdbench_tpu_torch.models.fno import FLAGSHIP
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts
    from cfdbench_tpu_torch.utils.device import set_numerics

    high = ["--matmul_precision", TF32_PRECISION]
    f32_argv = fno_argv(WORK / "train_data", WORK / "train_result")
    argv = fno_argv(WORK / "train_data", WORK / "train_result_high") + high
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        main_auto(argv + list(PHASE6_FLAGS))
    finally:
        set_numerics()  # the entry point set TF32 for the process
    counts, tf32_counts = launch_counts(), launch_counts(tf32=True)
    run, f32_run = run_dir(parse_args(argv)), run_dir(parse_args(f32_argv))
    test, test32 = (json.loads((r / "test" / "scores.json").read_text())["mean"]
                    for r in (run, f32_run))
    rels = dict(train_losses=losses_rel(run, f32_run), dev_scores=dev_rel(run, f32_run),
                test_scores=max(abs(test[k] - v) / abs(v) for k, v in test32.items() if v))
    print(f"[tf32] main_auto --matmul_precision {TF32_PRECISION}: {time.perf_counter() - t0:.2f} "
          f"s, launches {counts}, in TF32 mode {tf32_counts} (phase 6b {train_counts}); against "
          f"phase 6b's float32 run, max rel diff: " + ", ".join(
              f"{k} {v:.3e}" for k, v in rels.items()) + f" (bound {TF32_RUN_RTOL:.0e})")
    if counts != train_counts or tf32_counts != train_counts or not all(
            v <= TF32_RUN_RTOL for v in rels.values()):
        raise RuntimeError(f"main_auto under {TF32_PRECISION}: launches {counts}, TF32 "
                           f"{tf32_counts}, against float32 {rels}")

    rollout_root = WORK / "train_result_high_rollout"
    shutil.rmtree(rollout_root, ignore_errors=True)
    shutil.copytree(WORK / "train_result", rollout_root)
    roll_argv = fno_argv(WORK / "train_data", rollout_root) + high
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        main_multistep(roll_argv)
    finally:
        set_numerics()
    roll_counts, roll_tf32 = launch_counts(), launch_counts(tf32=True)
    got = json.loads((run_dir(parse_args(roll_argv)) / "multistep_metrics.json").read_text())
    worst = 0.0
    for key in train_metrics[0]:
        top = max(abs(w[key]) for w in train_metrics)
        worst = max(worst, max(abs(g[key] - w[key]) for g, w in zip(got, train_metrics)) / top)
    want = {"fno_block": FLAGSHIP["num_layers"] * STEPS, "fno_head": STEPS}
    print(f"[tf32] main_multistep --matmul_precision {TF32_PRECISION} on phase 6b's checkpoint: "
          f"{time.perf_counter() - t0:.2f} s, launches {roll_counts}, in TF32 mode {roll_tf32}; "
          f"step-20 nmse {got[-1]['nmse']:.6g} (float32 {train_metrics[-1]['nmse']:.6g}); "
          f"per-step metrics {worst:.3e} of each one's largest (bound {TF32_RUN_RTOL:.0e})")
    if (roll_counts != want or roll_tf32 != want or len(got) != STEPS
            or not all(math.isfinite(v) for m in got for v in m.values())
            or not worst <= TF32_RUN_RTOL):
        raise RuntimeError(f"main_multistep under {TF32_PRECISION}: launches {roll_counts}, "
                           f"TF32 {roll_tf32}, metrics {worst:.3e} from float32")
    return {"main_auto_high": tf32_counts, "main_multistep_high": roll_tf32}


def tf32_step_timing(device, card) -> dict:
    """Phase 12f(c): the b128 train step (Adam) of TF32_STEP_MODELS at their
    default widths with cuBLAS and cuDNN (and the FNO's kernels) in TF32
    against float32, by CUDA events in turns on one model each, with each
    setting's peak memory; and the flagship's 20-step b128 rollout through
    the kernels in each mode."""
    from cfdbench_tpu_torch.models.fno import use_tf32
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn
    from cfdbench_tpu_torch.training.trainer_auto import step_generator, train_step
    from cfdbench_tpu_torch.utils.device import set_numerics

    result = {}
    batch = train_inputs(TIMING_BATCH, torch.Generator().manual_seed(SEED + 22), device)
    try:
        for name in TF32_STEP_MODELS:
            model = (flagship_model(device) if name == "fno" else family_model(name, device))
            task = nmse_task(model.train())
            opt, sched = make_adam(model.parameters(), 1e-4)
            gen = step_generator(SEED, 0, device) if name == "resnet" else None

            def step(precision):
                set_numerics(precision)
                if name == "fno":
                    use_tf32(model, precision == TF32_PRECISION)
                train_step(task, opt, sched, batch, gen)

            peaks = {}
            for precision in ("highest", TF32_PRECISION):  # warm-up: cuDNN's choices
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                step(precision)
                step(precision)
                torch.cuda.synchronize()
                peaks[precision] = torch.cuda.max_memory_allocated(device) / 2**20
            f32_ms, tf32_ms = interleaved_ms(lambda: step("highest"),
                                             lambda: step(TF32_PRECISION), reps=TRAIN_REPS)
            result[f"{name}_train_b{TIMING_BATCH}"] = dict(
                f32_ms=f32_ms, tf32_ms=tf32_ms, f32_peak_mib=peaks["highest"],
                tf32_peak_mib=peaks[TF32_PRECISION])
            print(f"[time] [{card}] {name} train step b{TIMING_BATCH} {GRID}x{GRID}: float32 "
                  f"{f32_ms:.3f} ms, --matmul_precision {TF32_PRECISION} {tf32_ms:.3f} ms "
                  f"(TF32/float32 {tf32_ms / f32_ms:.3f}); peak memory {peaks['highest']:.1f} "
                  f"and {peaks[TF32_PRECISION]:.1f} MiB")
            del model, task, opt, sched
            torch.cuda.empty_cache()
        model = flagship_model(device).eval()
        tf32_model = flagship_model(device, tf32=True).eval()
        args = (batch["inputs"], batch["case_params"], batch["mask"])
        roll, roll_tf32 = make_rollout_fn(model, STEPS), make_rollout_fn(tf32_model, STEPS)
        f32_ms, tf32_ms = interleaved_ms(lambda: (set_numerics(), roll(*args)),
                                         lambda: (set_numerics(TF32_PRECISION),
                                                  roll_tf32(*args)), reps=3)
    finally:
        set_numerics()
    frames = TIMING_BATCH * STEPS
    result["fno_rollout"] = dict(f32_ms=f32_ms, tf32_ms=tf32_ms,
                                 f32_frames_per_s=frames / f32_ms * 1e3,
                                 tf32_frames_per_s=frames / tf32_ms * 1e3)
    print(f"[time] [{card}] fno rollout b{TIMING_BATCH} x {STEPS} steps: split TF32 "
          f"{f32_ms:.3f} ms = {frames / f32_ms * 1e3:.1f} frames/s; TF32 {tf32_ms:.3f} ms = "
          f"{frames / tf32_ms * 1e3:.1f} frames/s")
    return result


def launches_in(output: str, tags) -> dict:
    """The kernel launches that the entry points printed under ``tags``
    (``cli.print_launches``: ``[train] kernel launches: fno_block=68,
    fno_head=17``), summed."""
    total = {"fno_block": 0, "fno_head": 0}
    for line in output.splitlines():
        for tag in tags:
            if line.startswith(f"[{tag}] kernel launches: "):
                for item in line.split(": ", 1)[1].split(", "):
                    name, n = item.split("=")
                    total[name] += int(n)
    return total


def torchrun(script: str, argv) -> str:
    """``script`` under ``python -m torch.distributed.run --standalone
    --nproc_per_node 1``; its standard output. A failure prints the end of
    both streams and raises."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", script, *argv]
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    if run.returncode:
        print(run.stdout[-4000:], run.stderr[-4000:], sep="\n", file=sys.stderr)
        raise RuntimeError(f"{' '.join(cmd[:7])} {script} exited {run.returncode}")
    return run.stdout


def state_rel(got: dict, want: dict, what: str) -> float:
    """The largest of each float tensor's max |got - want| over its max |want|."""
    if got.keys() != want.keys():
        raise RuntimeError(f"{what}: keys differ")
    worst = 0.0
    for k, w in want.items():
        if w.is_floating_point() and w.abs().max() > 0:
            worst = max(worst, max_rel(got[k], w))
    return worst


def metrics_rel(got, want, what: str, rtol: float) -> float:
    """The largest relative difference of two per-step metric lists (or
    score dicts); raises above ``rtol``."""
    pairs = [(g[k], w[k]) for g, w in zip(got, want) for k in w]
    if len(got) != len(want) or not pairs:
        raise RuntimeError(f"{what}: {len(got)} entries against {len(want)}")
    worst = max(abs(g - w) / abs(w) if w else abs(g) for g, w in pairs)
    print(f"[dp] {what}: max rel diff {worst:.3e} (bound {rtol:.0e})")
    if not worst <= rtol:
        raise RuntimeError(f"{what} disagree: {worst:.3e} > {rtol:.0e}")
    return worst


def torchrun_argv() -> list:
    return fno_argv(WORK / "train_data", WORK / "dp_torchrun") + ["--mesh_shape", "1"]


def start_torchruns():
    """Phase 13a's two subprocesses, started in a thread of their own while
    phase 13b runs: phase 6b's main_auto, then its main_multistep on the
    checkpoint that run writes, each under ``torch.distributed.run
    --nproc_per_node 1`` (:func:`torchrun`). The thread prints nothing
    (phase 13b captures the entry points' standard output): the future's
    result is each run's standard output and seconds, which
    :func:`dp_torchrun` checks; a failed run raises there."""
    from concurrent.futures import ThreadPoolExecutor

    def runs():
        timed = []
        for script, flags in (("train_auto_torch.py", list(PHASE6_FLAGS)),
                              ("test_multistep_torch.py", [])):
            t0 = time.perf_counter()
            timed.append((torchrun(script, torchrun_argv() + flags), time.perf_counter() - t0))
        return timed

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(runs)
    pool.shutdown(wait=False)
    return future


def dp_torchrun(train_counts: dict, train_metrics, runs) -> dict:
    """Phase 13a: phase 6b's main_auto and its main_multistep again under
    ``torch.distributed.run --nproc_per_node 1`` with ``--mesh_shape 1``
    (``runs``, :func:`start_torchruns`'s future): an NCCL group of one rank,
    the loss's reductions and the gradient all-reduce run. The checkpoints,
    test scores and per-step metrics must equal phase 6b's within
    DP_TORCHRUN_RTOL, the launches phase 6b's and phase 3's. Returns each
    entry point's launches."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir
    from cfdbench_tpu_torch.models.fno import FLAGSHIP

    argv = torchrun_argv()
    (out, seconds), (multistep_out, multistep_seconds) = runs.result()
    if "backend=nccl" not in out:
        raise RuntimeError("main_auto under torchrun did not run in an NCCL group")
    counts = launches_in(out, ("train", "test"))
    print(f"[dp] torchrun main_auto --mesh_shape 1 (NCCL, one rank): "
          f"{seconds:.2f} s, launches {counts}")
    if counts != train_counts:
        raise RuntimeError(f"main_auto under torchrun launches {counts}, phase 6b {train_counts}")
    got, want = run_dir(parse_args(argv)), WORK / "train_result" / run_dir(
        parse_args(argv)).relative_to(WORK / "dp_torchrun")
    for name in [f"ckpt-{ep}/model.pt" for ep in range(TRAIN_EPOCHS)]:
        rel = state_rel(torch.load(got / name, weights_only=True),
                        torch.load(want / name, weights_only=True), name)
        print(f"[dp] torchrun {name} against phase 6b's: max rel diff {rel:.3e}")
        if not rel <= DP_TORCHRUN_RTOL:
            raise RuntimeError(f"{name} under torchrun disagrees: {rel:.3e}")
    metrics_rel([json.loads((got / "test/scores.json").read_text())["mean"]],
                [json.loads((want / "test/scores.json").read_text())["mean"]],
                "torchrun test scores against phase 6b's", DP_TORCHRUN_RTOL)
    rollout = launches_in(multistep_out, ("multistep",))
    print(f"[dp] torchrun main_multistep --mesh_shape 1: {multistep_seconds:.2f} s, "
          f"launches {rollout}")
    if rollout != {"fno_block": FLAGSHIP["num_layers"] * STEPS, "fno_head": STEPS}:
        raise RuntimeError(f"main_multistep under torchrun launches {rollout}")
    metrics_rel(json.loads((got / "multistep_metrics.json").read_text()), train_metrics,
                "torchrun per-step metrics against phase 6b's", DP_TORCHRUN_RTOL)
    return {"main_auto": counts, "main_multistep": rollout}


def dp_jobs(data_root: Path, out: Path, mesh: str):
    """Phase 13b's runs, ``(name, entry, argv)``: the flagship FNO trains at
    DP_BATCH (a full and a padded batch an epoch), is tested and rolls its
    one test case out (padded to DP_RANKS); the U-Net trains an epoch at
    DP_UNET_BATCH (its last batch padded), pixel diffusion two steps at
    DP_BATCH; then one train step each of the U-Net and of pixel diffusion
    (entry ``step``, :func:`dp_step`); then the other trainers'
    (:func:`dp_trainer_jobs`)."""
    data = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out), "--mesh_shape", mesh, "--log_interval", "100"]
    fno = fno_argv(data_root, out) + ["--mesh_shape", mesh]
    fno_train = fno + ["--num_epochs", str(TRAIN_EPOCHS), "--eval_interval", "1",
                       "--batch_size", str(DP_BATCH), "--eval_batch_size", str(DP_BATCH),
                       "--log_interval", "100"]
    return [
        ("fno", "main_auto", fno_train + ["--mode", "train"]),
        ("fno_test", "main_auto", fno_train + ["--mode", "test"]),
        ("fno_multistep", "main_multistep", fno),
        ("unet", "main_auto", ["--model", "unet", "--mode", "train", "--num_epochs", "1",
                               "--eval_interval", "1", "--batch_size", str(DP_UNET_BATCH),
                               "--eval_batch_size", str(DP_UNET_BATCH)] + data),
        ("pixel_diffusion", "main_auto", [
            "--model", "pixel_diffusion", "--mode", "train", "--num_epochs", "1",
            "--eval_interval", "1", "--batch_size", str(DP_BATCH), "--max_eval_batches", "1",
            "--ldm_num_inference_steps", MP_INFERENCE_STEPS] + data),
        ("unet_step", "step", ["--model", "unet"]),
        ("pixel_diffusion_step", "step", ["--model", "pixel_diffusion"]),
        ("pixel_diffusion_step32", "step32", ["--model", "pixel_diffusion"]),
    ] + dp_trainer_jobs(data_root, out, mesh)


def dp_trainer_jobs(data_root: Path, out: Path, mesh: str):
    """The runs of main_train (FFN and DeepONet, --mode train_test),
    main_gencast (--mode train_test, --gradient_accumulation_steps 2, the
    frames at MP_INFERENCE_STEPS), main_vae and main_uncond, one epoch each
    (the VAE until it stops), at their default widths; then one float64
    train step of each (entry ``step``)."""
    data = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(data_root),
            "--output_dir", str(out), "--mesh_shape", mesh, "--num_epochs", "1"]
    train = data + ["--mode", "train_test", "--eval_interval", "1", "--log_interval", "100"]
    return [
        ("ffn", "main_train", ["--model", "ffn", "--batch_size", str(DP_BATCH)] + train),
        ("deeponet", "main_train", ["--model", "deeponet", "--batch_size", str(DP_BATCH)] + train),
        ("gencast", "main_gencast", [
            "--model", "gencast", "--batch_size", str(DP_UNET_BATCH), "--eval_batch_size",
            str(DP_UNET_BATCH), "--gradient_accumulation_steps", "2", "--max_eval_batches", "1",
            "--ldm_num_inference_steps", MP_INFERENCE_STEPS] + train),
        ("vae", "main_vae", data + [
            "--batch_size", str(DP_UNET_BATCH), "--num_epochs", str(DP_VAE_EPOCHS),
            "--lr_scheduler_patience", "0", "--early_stopping_patience", "1",
            "--early_stopping_delta", "1e9", "--ldm_vae_weights_path", str(out / "vae_weights")]),
        ("uncond", "main_uncond", data + ["--batch_size", str(DP_UNET_BATCH)]),
    ] + [(f"{name}_step", "step", ["--model", name])
         for name in ("ffn", "deeponet", "gencast", "vae", "uncond")]


def dp_step(argv, device, dtype=torch.float64, grid=(GRID, GRID)) -> dict:
    """One ``trainer_auto.train_step`` of ``main_auto``'s task for ``argv``
    (its init from ``--seed``, Adam at its ``--lr``) on this rank's block of
    a seeded global batch of DP_UNET_BATCH rows, the last of them weight-0
    padding past DP_STEP_VALID; the step's scores, gradients, parameters and
    buffers, on the host. In float64 unless ``dtype`` says otherwise: what
    data parallelism computes (the global BatchNorm statistics over the
    padding rows, the draws over the global batch, the averaged gradient)
    stands clear of float32's rounding, which a train-mode BatchNorm turns,
    in a first convolution's weight gradient, into a sum over 131,072 rows
    of terms that cancel. A float32 step (``step32``) is the first step of
    the run itself, whose gradients pixel diffusion's run is held by. The
    batch is on ``grid`` (``step_tube``: TUBE_GRID)."""
    import torch.distributed as dist

    from cfdbench_tpu_torch.cli import make_auto_task, parse_args
    from cfdbench_tpu_torch.data.pipeline import field_rows
    from cfdbench_tpu_torch.parallel.mesh import make_mesh
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import (
        join_model, split_model, train_step, use_mesh)

    args = parse_args(argv + ["--data_name", "cavity_prop_bc_geo"])
    mesh = make_mesh(args.mesh_shape, dist.group.WORLD if dist.is_initialized() else None)
    if args.model in ("ffn", "deeponet", "gencast", "vae", "uncond"):
        return dp_trainer_step(args, mesh, device)
    task = make_auto_task(args, 5, grid, device)
    task.model.to(dtype)
    if hasattr(task, "vae"):  # a latent model's frozen VAE
        task.vae.to(dtype)
    use_mesh(task, mesh)
    if args.shard_spatial:  # phase 15
        split_model(task, 0, True)
    split = getattr(task, "split", None)
    opt, sched = make_adam(task.model.parameters(), args.lr)
    batch = train_inputs(DP_UNET_BATCH, torch.Generator().manual_seed(SEED + 13), "cpu", grid)
    for v in batch.values():
        v[DP_STEP_VALID:] = 0
    block = {k: v.to(device, dtype).contiguous()
             for k, v in field_rows(mesh.block(batch), getattr(task, "rows", None)).items()}
    scores = train_step(task, opt, sched, block, task.step_draws(args.seed, 0, device))
    model = task.model
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads = grads if split is None else split.layout.to_std(grads)
    join_model(task)
    return dict(scores={k: v.item() for k, v in scores.items()}, lr=args.lr,
                grads={k: g.cpu() for k, g in grads.items()},
                state={k: v.detach().cpu() for k, v in model.state_dict().items()},
                names=[k for k, _ in model.named_parameters()])


def dp_step_batch():
    """A seeded global batch of DP_UNET_BATCH rows on the host, the rows
    past DP_TRAINER_STEP_VALID weight-0 padding."""
    batch = train_inputs(DP_UNET_BATCH, torch.Generator().manual_seed(SEED + 13), "cpu")
    batch["inputs_prev"] = torch.randn((DP_UNET_BATCH, GRID, GRID, 2),
                                       generator=torch.Generator().manual_seed(SEED + 14))
    batch["t"] = torch.arange(DP_UNET_BATCH, dtype=torch.float32)[:, None] % STEPS
    for v in batch.values():
        v[DP_TRAINER_STEP_VALID:] = 0
    return batch


def dp_trainer_step(args, mesh, device, dtype=torch.float64) -> dict:
    """:func:`dp_step` for the other trainers, in float64, each its own
    step from ``--seed``'s init on this rank's block of
    :func:`dp_step_batch`: main_train's (the step's query points, alike on
    every rank), GenCast's two steps through its optimizer (which averages
    the gradients: the gradients returned are the first step's, averaged
    here as it averages them; the first update runs at the warmup's rate of
    0, the second at ``--lr``), the VAE's (its
    posterior noise over the global batch) and the unconditional DDPM's
    (its noise, timesteps and dropout masks over the global batch). With a
    model axis the PUNetG, the VAE and the EMA are split as their trainers
    split them; the gradients and parameters come back in the one-process
    layout, beside this rank's parameter and optimizer-state bytes (and
    the EMA's). ``dtype``: the step's (float64 unless asked).""" 
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.models import init_gencast, init_nonauto_model, make_cfd_vae
    from cfdbench_tpu_torch.training import trainer_nonauto, trainer_uncond, trainer_vae
    from cfdbench_tpu_torch.training.optim import make_adam, make_gencast_tx
    from cfdbench_tpu_torch.training.trainer_auto import split_module, use_mesh
    from cfdbench_tpu_torch.utils.rng import train_key, uncond_key, vae_key

    host = dp_step_batch()
    block = {k: v.to(device, dtype) for k, v in mesh.block(host).items()}
    gen = torch.Generator().manual_seed(args.seed)
    loss_fn = loss_name_to_fn("nmse")
    split = None
    if args.model in ("ffn", "deeponet"):
        net = init_nonauto_model(args, 5, generator=gen, device=device).to(dtype)
        task = trainer_nonauto.NonAutoTask(net, loss_fn)
        use_mesh(task, mesh)
        opt, sched = make_adam(net.parameters(), args.lr)
        block["labels"] = block["labels"][..., :1]
        q = trainer_nonauto.draw_query_idxs(args.seed, 0, task.num_label_samples, GRID, GRID,
                                            device)
        scores = trainer_nonauto.train_step(task, opt, sched, block, q)
        grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    elif args.model == "gencast":
        task = init_gencast(args, GEN_STATS, 5, loss_fn, generator=gen, device=device)
        net = task.model.to(dtype)
        use_mesh(task, mesh)
        split = split_module(net, mesh)
        # The first update runs at the warmup's rate of 0, the second at lr.
        opt = make_gencast_tx(net.parameters(), args.lr, total_steps=2, warmup_steps=1,
                              mesh=mesh, split=split)
        for i in range(2):
            opt.zero_grad(set_to_none=True)
            loss, s = task.loss_scores(block, train_key(args.seed, i))
            loss.backward()
            if i == 0:
                scores = s
                grads = {k: mesh.sum(p.grad) / mesh.size for k, p in net.named_parameters()}
            opt.step()
    elif args.model == "vae":
        latent = args.z_channels if args.vae_variant == "custom" else args.ldm_latent_dim
        net = make_cfd_vae(args.vae_variant, 2, 2, latent, ch=args.ch,
                           ch_mult=tuple(args.ch_mult), num_res_blocks=args.num_res_blocks,
                           generator=gen, device=device).to(dtype)
        split = split_module(net, mesh)
        opt = trainer_vae.make_optimizer(net, args.lr, 0.0)
        parts = trainer_vae.train_step(net, opt, block["labels"], block["weights"], 1e-4,
                                       vae_key(args.seed, 0), mesh, split)
        scores = dict(zip(trainer_vae.PARTS, parts))
        grads = {k: p.grad for k, p in net.named_parameters()}
    else:
        net = trainer_uncond.make_unet(2, args.pixel_diffusion_base_channels, args.seed,
                                       device).to(dtype)
        ema = trainer_uncond.make_unet(2, args.pixel_diffusion_base_channels, args.seed,
                                       device).to(dtype)
        split = split_module(net, mesh)
        split_module(ema, mesh)
        opt = torch.optim.AdamW(net.parameters(), args.lr, weight_decay=trainer_uncond.WEIGHT_DECAY)
        sched = trainer_uncond.make_ddpm_scheduler(args.ldm_noise_scheduler_timesteps, device)
        loss = trainer_uncond.train_step(net, ema, opt, sched, block["labels"], block["weights"],
                                         uncond_key(args.seed, 0), mesh, split)
        scores = dict(loss=loss)
        grads = {k: p.grad for k, p in net.named_parameters()}
    sizes = dict(param_bytes=sum(p.numel() * p.element_size() for p in net.parameters()),
                 opt_bytes=sum(t.numel() * t.element_size() for st in opt.state.values()
                               for t in st.values() if torch.is_tensor(t) and t.dim() > 0))
    if args.model == "uncond":
        sizes["ema_bytes"] = sum(p.numel() * p.element_size() for p in ema.parameters())
    state = {k: v.detach() for k, v in net.state_dict().items()}
    if split is not None:  # the one-process layout
        grads, state = split.layout.to_std(grads), split.layout.to_std(state)
    return dict(scores={k: v.item() for k, v in scores.items()}, lr=args.lr, **sizes,
                grads={k: g.cpu() for k, g in grads.items()},
                state={k: v.cpu() for k, v in state.items()},
                names=[k for k, _ in net.named_parameters()])


class Tee:
    """Standard output kept as well as printed."""

    def __init__(self):
        self.parts, self.out = [], sys.stdout

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def dp_run(jobs, device, rank: int = 0, deterministic: bool = True) -> dict:
    """Each job through its entry point on ``device``: the launches it
    made, and main_auto's trained weights (and their order as parameters),
    main_multistep's frames, or a step's results, on the host. With
    ``deterministic``, for the runs held against one process, PyTorch runs
    its deterministic algorithms meanwhile (warning where an op has none):
    the others sum in no fixed order, which Adam amplifies over an epoch
    into a drift that differs from run to run (on an H100 two one-process
    U-Net epochs parted by 4.7e-3 in their losses with only cuDNN's
    algorithms deterministic, by 0 with every algorithm), so that a run and
    its one-process reference would part by as much as two one-process runs
    do; there they part by what the run's layout changes alone. Without
    it the jobs run on the default algorithms, as users' runs do."""
    from cfdbench_tpu_torch import cli
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    import contextlib

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    torch.backends.cudnn.deterministic = deterministic
    result = {}
    try:
        for name, entry, argv in jobs:
            t0 = time.perf_counter()
            reset_launch_counts()
            if entry in ("step", "step32", "step_tube", "step_empty"):
                grid = {"step_tube": TUBE_GRID, "step_empty": SP_EMPTY_GRID}.get(entry,
                                                                                  (GRID, GRID))
                r = dp_step(argv, device, torch.float32 if entry == "step32" else torch.float64,
                            grid)
            elif entry == "bytes":
                r = split_bytes(argv, device)
            elif entry == "memory":
                r = sp_memory(argv, device)
            elif entry in SP_MEMORY:
                flags, grid, batch = SP_MEMORY[entry]
                r = sp_memory(flags + argv, device, grid, batch)
            else:
                tee = Tee()
                padded = entry == "main_auto_padded"
                with contextlib.redirect_stdout(tee), (
                        padded_fno() if padded else contextlib.nullcontext()):
                    out = getattr(cli, "main_auto" if padded else entry)(argv, device=device)
                r = {"printed": tee.text()}
                if entry == "main_multistep":
                    r["frames"] = out.cpu()
                else:
                    # The trained weights: the task's model's, the DDPM's network's,
                    # or the VAE's best (main_vae returns a state dict).
                    model = (None if entry == "main_vae" else out[0] if entry == "main_uncond"
                             else out.model)
                    state = out if model is None else model.state_dict()
                    r["state"] = {k: v.detach().cpu() for k, v in state.items()}
                    r["names"] = (list(state) if model is None
                                  else [k for k, _ in model.named_parameters()])
            r["launches"] = launch_counts()
            result[name] = r
            print(f"[dp] rank {rank} {name}: launches {r['launches']}, "
                  f"{time.perf_counter() - t0:.2f} s")
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
    return result


def dp_rank(rank: int, world: int, root: str, jobs, device: str, default_jobs=()) -> None:
    """Phase 13b's or 14b's rank ``rank`` of ``world``, spawned: a gloo
    group that meets through a file under ``root``, every rank on
    ``device`` (the one card); ``jobs`` on the deterministic algorithms,
    then ``default_jobs`` on the default ones; its results to
    ``root/rank{rank}.pt``."""
    import os

    import torch.distributed as dist

    # The ranks share the host's cores: each takes its share of them.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=world)
    try:
        result = dp_run(jobs, device, rank)
        result.update(dp_run(default_jobs, device, rank, deterministic=False))
        torch.save(result, f"{root}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class Ranks:
    """:func:`dp_rank` on ``world`` gloo ranks sharing the one card, their
    group meeting under ``WORK/tag``: ``jobs`` on the deterministic
    algorithms, then ``default_jobs`` on the default ones. The ranks start
    at once and run while the caller works on (one process's references,
    other phases that time nothing); :meth:`results` waits for them, prints
    ``what`` with the seconds since the start, and loads each rank's
    results. :func:`stop_ranks` ends those still running when the script
    fails."""

    running: list = []

    def __init__(self, tag: str, world: int, jobs, device, what: str, default_jobs=()):
        import torch.multiprocessing as mp

        self.root, self.world, self.what = WORK / tag, world, what
        shutil.rmtree(self.root, ignore_errors=True)
        self.root.mkdir(parents=True)
        self.t0 = time.perf_counter()
        self.context = mp.spawn(dp_rank, args=(world, str(self.root), jobs, str(device),
                                                default_jobs), nprocs=world, join=False)
        Ranks.running.append(self)

    def results(self) -> list:
        while not self.context.join():
            pass
        Ranks.running.remove(self)
        print(f"{self.what}: {time.perf_counter() - self.t0:.2f} s, spawn included")
        return [torch.load(self.root / f"rank{r}.pt", weights_only=True)
                for r in range(self.world)]


def stop_ranks() -> None:
    for ranks in Ranks.running:
        for process in ranks.context.processes:
            if process.is_alive():
                process.terminate()


class permuted_train_rows:
    """Within it, the trainers train on every shuffled batch with its rows
    permuted (a seeded permutation a batch), and the draws of that batch
    with them (the VAE's posterior noise; the diffusion models' noise,
    timesteps and dropout masks): the same sums in another order, the
    control of the runs whose drift is Adam amplifying rounding. ``seed``
    picks the permutations."""

    def __init__(self, seed: int = SEED):
        self.seed = seed

    def __enter__(self):
        import numpy as np

        from cfdbench_tpu_torch.models import diffusion, vae
        from cfdbench_tpu_torch.training import (
            trainer_auto, trainer_gencast, trainer_uncond, trainer_vae)

        rows = {}
        real = trainer_auto.batches

        def batches(arrays, batch_size, shuffle, rng=None, pad_multiple=1):
            for i, b in enumerate(real(arrays, batch_size, shuffle, rng=rng,
                                       pad_multiple=pad_multiple)):
                rows.pop("perm", None)
                if shuffle:
                    p = rows["perm"] = np.random.default_rng(self.seed + i).permutation(
                        len(b["weights"]))
                    b = {k: v[p] for k, v in b.items()}
                yield b

        def permuted(t):  # row i of the batch was row p[i]
            p = rows.get("perm")
            return t if p is None else t[torch.as_tensor(p, device=t.device)]

        def posterior_noise(key, shape, device, real=vae.posterior_noise):
            return permuted(real(key, shape, device))

        def noise_and_t(key, shape, T, device, real=diffusion.train_noise_and_t):
            return tuple(permuted(x) for x in real(key, shape, T, device))

        def masks(key, shapes, rate, device, real=diffusion.dropout_keep_masks):
            return [permuted(m) for m in real(key, shapes, rate, device)]

        self.sites = [(m, "batches", batches)
                      for m in (trainer_auto, trainer_vae, trainer_gencast, trainer_uncond)]
        self.sites += [(vae, "posterior_noise", posterior_noise)]
        self.sites += [(m, name, f) for m in (diffusion, trainer_uncond)
                       for name, f in (("train_noise_and_t", noise_and_t),
                                       ("dropout_keep_masks", masks))]
        self.saved = [(m, name, getattr(m, name)) for m, name, _ in self.sites]
        for m, name, f in self.sites:
            setattr(m, name, f)

    def __exit__(self, *exc):
        for m, name, f in self.saved:
            setattr(m, name, f)


class float64_run:
    """Within it, ``main_auto`` builds its task in float64 (the network and
    a latent model's frozen VAE) and trains and evaluates on float64
    batches: the same run, its draws, batches and steps alike, with
    float32's rounding all but gone. Against the float32 run it is the
    drift that float32's rounding alone leaves: a control of the latent
    runs (SP_LATENT_CONTROL), whose GroupNorm networks a permuted-row
    control leaves every per-sample sum of, so that it reorders only the
    weight gradients' sums over the batch."""

    def __enter__(self):
        from cfdbench_tpu_torch import cli
        from cfdbench_tpu_torch.training import trainer_auto

        real_task, real_to_device = cli.make_auto_task, trainer_auto.to_device

        def make_auto_task(*args, **kwargs):
            task = real_task(*args, **kwargs)
            task.model.double()
            if hasattr(task, "vae"):
                task.vae.double()
            return task

        def to_device(batch, device):
            return {k: v.double() if v.is_floating_point() else v
                    for k, v in real_to_device(batch, device).items()}

        self.saved = [(cli, "make_auto_task", real_task),
                      (trainer_auto, "to_device", real_to_device)]
        cli.make_auto_task, trainer_auto.to_device = make_auto_task, to_device

    def __exit__(self, *exc):
        for m, name, f in self.saved:
            setattr(m, name, f)


class padded_fno:
    """Within it, ``main_auto`` builds its FNO with ``padding=PAD`` (no flag
    of either package sets it): phase 15d's padded flagship, trained as the
    flagship is."""

    def __enter__(self):
        from cfdbench_tpu_torch import cli

        real = self.real = cli.make_auto_task

        def make_auto_task(*args, **kwargs):
            task = real(*args, **kwargs)
            task.model.padding = PAD
            return task

        cli.make_auto_task = make_auto_task

    def __exit__(self, *exc):
        from cfdbench_tpu_torch import cli

        cli.make_auto_task = self.real


def dp_params(got: dict, want: dict, names, what: str) -> float:
    """The parameters' max |got - want| over the largest |want|, printed
    with the count of elements past DP_RTOL of it."""
    largest = max(want[k].abs().max().item() for k in names)
    worst, past = 0.0, 0
    for k in names:
        d = (got[k] - want[k]).abs()
        worst = max(worst, d.max().item() / largest)
        past += int((d > DP_RTOL * largest).sum())
    n = sum(want[k].numel() for k in names)
    print(f"[dp] {what}: parameters max diff / largest {worst:.3e}, {past} of {n} elements "
          f"past {DP_RTOL:.0e}")
    return worst


def dp_step_check(name: str, got: dict, want: dict, what: str) -> None:
    """One float64 step from the same weights, two ranks against one
    process, each within DP_RTOL: the scores (relative), every gradient
    (of the largest), every parameter (of lr, Adam's step), the running
    statistics (of their largest)."""
    metrics_rel([got["scores"]], [want["scores"]], f"{what} scores", DP_RTOL)
    top = max(g.abs().max().item() for g in want["grads"].values())
    worst = {
        "gradients, of the largest": max((got["grads"][k] - g).abs().max().item() / top
                                         for k, g in want["grads"].items()),
        "parameters, of lr": max((got["state"][k] - want["state"][k]).abs().max().item()
                                 for k in want["names"]) / want["lr"]}
    stats = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    if name.startswith("unet") != bool(stats):
        raise RuntimeError(f"{what}: running statistics {stats[:2]}")
    if stats:
        worst["running statistics, of their largest"] = max(
            max_rel(got["state"][k], want["state"][k]) for k in stats)
    for k, v in worst.items():
        print(f"[dp] {what}: {k} max diff {v:.3e} (bound {DP_RTOL:.0e})")
        if not v <= DP_RTOL:
            raise RuntimeError(f"{what}: {k} disagree, {v:.3e}")


def dp_grad_check(got: dict, want: dict, what: str) -> None:
    """A float32 step from the same weights, two ranks against one process:
    the scores (relative) and every gradient (of the largest) within
    DP_RTOL. Its parameters are not held: Adam's first step moves an
    element of rounding-level gradient by lr either way."""
    metrics_rel([got["scores"]], [want["scores"]], f"{what} scores", DP_RTOL)
    top = max(g.abs().max().item() for g in want["grads"].values())
    worst = max((got["grads"][k] - g).abs().max().item() / top for k, g in want["grads"].items())
    print(f"[dp] {what}: float32 gradients, of the largest, max diff {worst:.3e} "
          f"(bound {DP_RTOL:.0e})")
    if not worst <= DP_RTOL:
        raise RuntimeError(f"{what}: float32 gradients disagree, {worst:.3e}")


def losses_rel(got_run: Path, want_run: Path) -> float:
    """The largest relative difference of two runs' per-step train losses."""
    got, want = (json.loads((r / "train_losses.json").read_text()) for r in (got_run, want_run))
    if len(got) != len(want):
        raise RuntimeError(f"{got_run}: {len(got)} train losses against {len(want)}")
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def trainer_run(entry: str, argv) -> Path:
    """The result directory of an entry point's run with ``argv``."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir

    args = parse_args(argv)
    if entry == "main_vae":
        return Path(args.output_dir) / "vae" / args.data_name
    if entry == "main_uncond":
        return Path(args.output_dir) / "uncond_ddpm" / args.data_name
    return run_dir(args)


def json_numbers(obj) -> list:
    """The numbers of a JSON value, in key order."""
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in json_numbers(obj[k])]
    if isinstance(obj, list):
        return [x for v in obj for x in json_numbers(v)]
    return [obj]


def vae_epochs(printed: str):
    """What a rank printed of each VAE epoch: its number and the dev loss it
    read, each rate it cut to, and whether it stopped early."""
    return (re.findall(r"ep (\d+): val_total=(\S+) ", printed),
            re.findall(r"plateau: lr reduced to (\S+)", printed), "Early stopping." in printed)


def dp_trainer_check(name: str, entry: str, argv, ranks, want, control=None,
                     mesh_root: Path = None, what: str = None, hold_params: bool = False
                     ) -> None:
    """Phase 13b's and 14b's checks of main_train's, main_gencast's,
    main_vae's and main_uncond's runs on two ranks (under ``mesh_root``,
    phase 13b's ``dp_mesh`` by default) against one process's (the
    launches and the equal weights of the ranks are checked with the
    others): every number of the files that hold the losses and scores
    within DP_RTOL (relative), or, given the ``control`` run (one process,
    rows permuted: a network whose GroupNorms leave biases whose gradient is
    rounding, which Adam amplifies over its steps), within DP_DRIFT_FACTOR
    times the control's distance plus DP_RTOL, and so the parameters
    with ``hold_params``; GenCast's dev nmse, as each rank printed it, alike; the VAE's dev
    losses, its rate cuts (at least one) and its early stop, as each rank
    printed them, alike, and the cuts and the stop those of one process."""
    files = {"main_train": ["train_losses.json", "ckpt-0/dev_loss.json", "test/scores.json"],
             "main_gencast": ["ckpt-0/dev_scores.json", "training_meta.json",
                              "test/scores.json"],
             "main_vae": ["loss_history.json", "training_meta.json"],
             "main_uncond": ["train_losses.json"]}[entry]
    mesh_root = WORK / "dp_mesh" if mesh_root is None else mesh_root
    mesh_run = trainer_run(entry, argv)
    single_run = WORK / "dp_single" / mesh_run.relative_to(mesh_root)
    what = what or f"{name}, {DP_RANKS} ranks against one process"

    def rel(run, f):
        got, ref = (json_numbers(json.loads((r / f).read_text())) for r in (run, single_run))
        if len(got) != len(ref):
            raise RuntimeError(f"{what}: {f} holds {len(got)} numbers against {len(ref)}")
        return len(got), max(abs(g - w) / abs(w) if w else abs(g) for g, w in zip(got, ref))

    for f in files:
        n, worst = rel(mesh_run, f)
        bound, against = DP_RTOL, ""
        if control is not None:
            ctl = rel(WORK / "dp_control" / mesh_run.relative_to(mesh_root), f)[1]
            bound = DP_DRIFT_FACTOR * ctl + DP_RTOL
            against = f"; the permuted-row control {ctl:.3e}"
        print(f"[dp] {what}: {f}, {n} numbers, max rel diff {worst:.3e}{against} "
              f"(bound {bound:.3e})")
        if not worst <= bound:
            raise RuntimeError(f"{what}: {f} disagrees, {worst:.3e}")
    params_rel = dp_params(ranks[0]["state"], want["state"], want["names"], what)
    # The FFN's and the DeepONet's gradients stay clear of rounding level:
    # their weights are held, as the FNO's are. The PUNetG's and the VAE's
    # GroupNorms cancel biases whose gradient is rounding, which Adam turns
    # into steps of +-lr; their steps are held in float64 (entry "step").
    if entry == "main_train" and not params_rel <= DP_RTOL:
        raise RuntimeError(f"{what}: parameters disagree, {params_rel:.3e}")
    if hold_params:
        ctl = dp_params(control["state"], want["state"], want["names"],
                        f"{name}, one process with permuted rows against one process")
        if not params_rel <= DP_DRIFT_FACTOR * ctl + DP_RTOL:
            raise RuntimeError(f"{what}: parameters parted further than the permuted-row "
                               f"control, {params_rel:.3e} against {ctl:.3e}")
    if entry == "main_gencast":
        lines = [re.findall(r"ep \d+: dev nmse = \S+", r["printed"]) for r in ranks + [want]]
        if not lines[0] or any(x != lines[0] for x in lines):
            raise RuntimeError(f"{what}: the ranks printed dev nmse {lines}")
    if entry == "main_vae":
        seen = [vae_epochs(r["printed"]) for r in ranks]
        one = vae_epochs(want["printed"])
        epochs, cuts, stopped = seen[0]
        print(f"[dp] {what}: each rank read the dev losses {[v for _, v in epochs]}, cut its "
              f"rate to {cuts} and stopped after epoch {epochs[-1][0] if epochs else None}; one "
              f"process {[v for _, v in one[0]]}, {one[1]}")
        if not (cuts and stopped and all(x == seen[0] for x in seen)):
            raise RuntimeError(f"{what}: the ranks' epochs differ or never cut and stopped: "
                               f"{seen}")
        if [e for e, _ in epochs] != [e for e, _ in one[0]] or cuts != one[1]:
            raise RuntimeError(f"{what}: the ranks stopped or cut otherwise than one process: "
                               f"{seen[0]} against {one}")


def dp_two_ranks(device) -> dict:
    """Phase 13b: DP_RANKS ranks on the one card in a gloo group, against
    one process (its runs made while the ranks run); returns each rank's
    launches per path."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir
    from cfdbench_tpu_torch.data.synthetic import generate_problem

    data_root = WORK / "dp_data"
    # 12 cases of 21 frames: 200 train pairs (a full and a padded batch of
    # DP_BATCH; six full batches and a padded one of DP_UNET_BATCH), and one
    # test case, which DP_RANKS ranks pad.
    generate_problem(data_root, "cavity", cases_per_subset=4, num_frames=STEPS + 1, grid=GRID,
                     seed=SEED)
    spawned = Ranks("dp_ranks", DP_RANKS, dp_jobs(data_root, WORK / "dp_mesh", "2"), device,
                    f"[dp] {DP_RANKS} ranks on one card (gloo; they share it, so this measures "
                    "correctness, not scaling)")
    single_jobs = dp_jobs(data_root, WORK / "dp_single", "1")
    single = dp_run(single_jobs, device)
    argvs = {n: [a.replace(str(WORK / "dp_single"), str(WORK / "dp_control")) for a in argv]
             for n, _, argv in single_jobs}
    with permuted_train_rows():
        ran = dp_run([(f"{name}_control", entry, argvs[name]) for name, entry in CONTROLS],
                     device)
    controls = {name: ran[f"{name}_control"] for name, _ in CONTROLS}
    control = controls["unet"]
    ranks = spawned.results()
    for name, entry, argv in dp_jobs(data_root, WORK / "dp_mesh", "2"):
        want = single[name]
        what = f"{name}, {DP_RANKS} ranks against one process"
        for r, result in enumerate(ranks):
            got = result[name]
            if got["launches"] != want["launches"]:
                raise RuntimeError(f"{name} rank {r}: launches {got['launches']}, one process "
                                   f"{want['launches']}")
            if name.startswith("fno") and device.type == "cuda" and not all(
                    got["launches"].values()):
                raise RuntimeError(f"{name} rank {r}: a kernel never launched")
            if entry in DP_TRAINERS and any(got["launches"].values()):
                raise RuntimeError(f"{name} rank {r}: launched {got['launches']}; these "
                                   "trainers run no FNO")
        if entry == "main_multistep":
            for r, result in enumerate(ranks):
                err = max_rel(result[name]["frames"], want["frames"])
                print(f"[dp] {name} rank {r}: frames max diff / max {err:.3e}")
                if not err <= DP_RTOL:
                    raise RuntimeError(f"{name} rank {r}: frames disagree, {err:.3e}")
            continue
        for k, v in ranks[0][name]["state"].items():
            if not torch.equal(v, ranks[1][name]["state"][k]):
                raise RuntimeError(f"{name}: rank 1's {k} differs from rank 0's")
        if entry == "step":
            dp_step_check(name, ranks[0][name], want, what)
            continue
        if entry == "step32":
            dp_grad_check(ranks[0][name], want, what)
            continue
        if name == "fno_test":  # the best checkpoint, loaded: scores below
            continue
        if entry in DP_TRAINERS:
            dp_trainer_check(name, entry, argv, [r[name] for r in ranks], want,
                             controls["vae"] if name == "vae" else None)
            continue
        mesh_run = run_dir(parse_args(argv))
        single_run = WORK / "dp_single" / mesh_run.relative_to(WORK / "dp_mesh")
        loss_rel = losses_rel(mesh_run, single_run)
        params_rel = dp_params(ranks[0][name]["state"], want["state"], want["names"], what)
        if name == "unet":
            control_run = WORK / "dp_control" / mesh_run.relative_to(WORK / "dp_mesh")
            ctl_loss = losses_rel(control_run, single_run)
            ctl_params = dp_params(control["state"], want["state"], want["names"],
                                   "unet, one process with permuted rows against one process")
            print(f"[dp] {what}: losses max rel diff {loss_rel:.3e}, parameters {params_rel:.3e}"
                  f" of the largest; the permuted-row control {ctl_loss:.3e}, {ctl_params:.3e} "
                  f"(bound {DP_DRIFT_FACTOR:g} x the control + {DP_RTOL:.0e})")
            if not (loss_rel <= DP_DRIFT_FACTOR * ctl_loss + DP_RTOL
                    and params_rel <= DP_DRIFT_FACTOR * ctl_params + DP_RTOL):
                raise RuntimeError(f"{what}: parted further than the permuted-row control")
            continue
        print(f"[dp] {what}: train losses max rel diff {loss_rel:.3e} (bound {DP_RTOL:.0e})")
        if not loss_rel <= DP_RTOL:
            raise RuntimeError(f"{what}: train losses disagree, {loss_rel:.3e}")
        # The FNO's gradients stay clear of rounding level: its parameters
        # are held too. Pixel diffusion's PUNetG has biases that a
        # GroupNorm cancels, whose rounding Adam amplifies: its run is held
        # by its first step's gradients (pixel_diffusion_step32, float32)
        # and its step in float64 (pixel_diffusion_step).
        if name == "fno" and not params_rel <= DP_RTOL:
            raise RuntimeError(f"{what}: parameters disagree, {params_rel:.3e}")
    mesh_run = run_dir(parse_args(dp_jobs(data_root, WORK / "dp_mesh", "2")[0][2]))
    single_run = WORK / "dp_single" / mesh_run.relative_to(WORK / "dp_mesh")
    got, want = (json.loads((r / "test/scores.json").read_text()) for r in (mesh_run, single_run))
    metrics_rel([got["mean"]], [want["mean"]], "fno test scores", DP_RTOL)
    metrics_rel(*(json.loads((r / "multistep_metrics.json").read_text())
                  for r in (mesh_run, single_run)), "fno per-step metrics", DP_RTOL)
    counts = {f"dp{DP_RANKS}_rank{r}_{path}": {
        k: sum(ranks[r][n]["launches"][k] for n in names) for k in ("fno_block", "fno_head")}
        for r in range(DP_RANKS)
        for path, names in (("main_auto", ("fno", "fno_test")),
                            ("main_multistep", ("fno_multistep",)),
                            ("main_train", ("ffn", "deeponet")), ("main_gencast", ("gencast",)),
                            ("main_vae", ("vae",)), ("main_uncond", ("uncond",)))}
    return counts, data_root, single, controls


def dp_step_timing(device, card) -> dict:
    """Phase 13c: the flagship's float32 train step at DP_BATCH, by CUDA
    events, in one process, in an NCCL group of one rank (which runs no
    collective: the same step), and in that group with the collectives of
    N > 1 ranks forced (the loss's SUM and MAX, the gradient all-reduce):
    their cost on one card, not N cards' scaling."""
    import torch.distributed as dist

    from cfdbench_tpu_torch.parallel.mesh import make_mesh
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import train_step, use_mesh

    # The profiler's mesh of one rank that runs the collectives; it opens
    # the NCCL group of one.
    collectives = load_script("profile_torch_rollout").collectives_mesh()
    try:
        meshes = {"one_process": None, "nccl_group": make_mesh("1", dist.group.WORLD),
                  "collectives": collectives}
        batch = train_inputs(DP_BATCH, torch.Generator().manual_seed(SEED + 3), device)
        steps = {}
        for name, mesh in meshes.items():
            model = flagship_model(device)
            task = nmse_task(model)
            if mesh is not None:
                use_mesh(task, mesh)
            p = (task, *make_adam(model.parameters(), 1e-4))
            steps[name] = lambda p=p: train_step(*p, batch)
        for f in steps.values():
            f()
        torch.cuda.synchronize()
        # The step is host-bound, and the host's speed wanders between turns:
        # DP_TIMING_ROUNDS rounds of each variant in a rotating order, and
        # the median of its rounds.
        names = list(steps)
        turns = {name: [] for name in names}
        for r in range(DP_TIMING_ROUNDS):
            for name in names[r % 3:] + names[:r % 3]:
                turns[name].append(time_ms(steps[name], TRAIN_REPS))
    finally:
        dist.destroy_process_group()
    ms = {f"{name}_ms": statistics.median(t) for name, t in turns.items()}
    print(f"[time] [{card}] train step b{DP_BATCH} {GRID}x{GRID} f32, median of "
          f"{DP_TIMING_ROUNDS} rounds of {TRAIN_REPS} steps: " + ", ".join(
              f"{name} {ms[name + '_ms']:.3f} ms ({min(t):.3f}-{max(t):.3f})"
              for name, t in turns.items()))
    return ms


def rank_kernels(device, card) -> dict:
    """Phase 14a: each kernel at the shapes a model rank gives it at the
    flagship, B=128: the column-parallel block at RANK_BLOCK_COUT of 32
    output channels, the row-parallel head at RANK_HEAD_HIDDEN of 128
    hidden units (``b2`` on the first rank only). Each against its plain
    version at phase 2's bounds (the block's saved tensors too), timed
    against it as phase 5 times them; returns per kernel a record a shape."""
    from cfdbench_tpu_torch.ops import fno_kernels as fk
    from cfdbench_tpu_torch.ops.spectral import init_spectral_weights

    B, H, W, C = TIMING_BATCH, GRID, GRID, WIDTH
    gen = torch.Generator().manual_seed(SEED + 14)
    x = torch.randn((B, H, W, C), generator=gen).to(device)
    mask = torch.ones((B, H, W, 1))
    mask[:, 20:30, 10:40] = 0
    mask = mask.to(device)
    cases = []
    for co in RANK_BLOCK_COUT:
        args = (x, (init_spectral_weights(gen, C, co, MODES, MODES) * C).to(device),
                (torch.randn((co, C), generator=gen) * C ** -0.5).to(device),
                (torch.randn((co,), generator=gen) * 0.1).to(device), MODES, MODES)
        cases.append(("fno_block", f"Cout={co}", args, BLOCK_ATOL,
                      block_work(B, H, W, C, co, MODES)))
    for i, hidden in enumerate(RANK_HEAD_HIDDEN):
        b2 = torch.full((2,), 0.1) if i == 0 else torch.zeros(2)
        args = (x, (torch.randn((hidden, C), generator=gen) * C ** -0.5).to(device),
                (torch.randn((hidden,), generator=gen) * 0.1).to(device),
                (torch.randn((2, hidden), generator=gen) * 128 ** -0.5).to(device),
                b2.to(device), mask)
        cases.append(("fno_head", f"hidden={hidden}, b2 {'set' if i == 0 else 'zeros'}", args,
                      HEAD_ATOL, head_work(B, H, W, C, hidden, 2)))
    out = {"fno_block": [], "fno_head": []}
    plain = {"fno_block": fk.fno_block_reference, "fno_head": fk.fno_head_reference}
    kernel = {"fno_block": fk.fno_block, "fno_head": fk.fno_head}
    with torch.inference_mode():
        for name, shape, args, atol, work in cases:
            got, want = kernel[name](*args), plain[name](*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if got.shape != want.shape or not torch.isfinite(got).all() or not err <= atol:
                raise RuntimeError(f"{name} at a rank's shape {shape}: max abs err {err:.3e} "
                                   f"(bound {atol:.0e}), shape {tuple(got.shape)}")
            if name == "fno_block":
                check_saved(args)
            p, k = interleaved_ms(lambda: plain[name](*args), lambda: kernel[name](*args),
                                  reps=20)
            bound_ms, bound_by = bound(*work)
            out[name].append(dict(shape=shape, max_abs_err=err, ms=k, plain_ms=p,
                                  bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / k))
            print(f"[tp] [{card}] {name} B={B} {H}x{W} C={C} {shape}: max abs err {err:.3e} "
                  f"(bound {atol:.0e}); kernel {k:.4f} ms, plain {p:.4f} ms ({p / k:.2f}x); "
                  f"bound {bound_ms:.4f} ms by {bound_by}, kernel at {bound_ms / k:.1%} of it")
    return out


def tp_jobs(data_root: Path, out: Path):
    """Phase 14b's runs on TP_MESH: phase 13b's flagship main_auto (tp) and
    main_multistep, the same main_auto with --pp_microbatches PP_MICRO into
    ``out``'s sibling ``_pp`` directory, the U-Net's epoch, phase 13b's
    main_train (FFN, DeepONet), main_gencast, main_vae and main_uncond runs
    and the float64 steps of the last three; GenCast's main_multistep of
    phase 13b's one-process checkpoint; the flagship's main_auto with
    --use_mixed_precision under tp (``_mp``) and pp (``_mp_pp``) and its
    bfloat16 main_multistep (in ``tp_bf16``, a copy of phase 13b's
    one-process run); and the bytes of each layout (entry ``bytes``)."""
    jobs = {n: (n, e, a) for n, e, a in dp_jobs(data_root, out, TP_MESH)}
    fno = jobs["fno"][2]
    pp = ["--pp_microbatches", str(PP_MICRO)]
    mp = ["--use_mixed_precision", "1"]
    gencast = {n: a for n, _, a in dp_trainer_jobs(data_root, WORK / "dp_single", TP_MESH)}["gencast"]
    bf16 = [a.replace(str(out), str(WORK / "tp_bf16")) for a in jobs["fno_multistep"][2]]
    return [jobs[n] for n in ("fno", "fno_multistep")] + [
        ("fno_pp", "main_auto", [a.replace(str(out), f"{out}_pp") for a in fno] + pp),
        jobs["unet"], jobs["ffn"], jobs["deeponet"],
        *(jobs[n] for n in SPLIT_TRAINERS),
        ("gencast_multistep", "main_multistep",
         gencast + ["--ldm_num_inference_steps", TP_GENCAST_INFERENCE_STEPS]),
        ("fno_mp", "main_auto", [a.replace(str(out), f"{out}_mp") for a in fno] + mp),
        ("fno_mp_pp", "main_auto", [a.replace(str(out), f"{out}_mp_pp") for a in fno] + mp + pp),
        ("fno_bf16_multistep", "main_multistep", bf16 + ["--rollout_dtype", "bfloat16"]),
    ] + [(f"{n}_step", "step", ["--model", n, "--mesh_shape", TP_MESH]) for n in SPLIT_TRAINERS
         ] + [("bytes_tp", "bytes", ["--mesh_shape", TP_MESH]),
              ("bytes_pp", "bytes", ["--mesh_shape", TP_MESH] + pp)
              ] + [(f"bytes_{n}", "bytes", ["--model", n, "--mesh_shape", TP_MESH])
                   for n in SPLIT_TRAINERS]


def tp_default_jobs(data_root: Path):
    """Phase 14b's runs on the default algorithms, ``(name, entry, argv)``
    with ``name`` ``<run>_default`` for each of DEFAULT_ALGORITHM_RUNS:
    phase 13b's run at TP_MESH into ``tp_default``, ``--mode train``."""
    jobs = {n: (e, a) for n, e, a in dp_jobs(data_root, WORK / "tp_default", TP_MESH)}
    return [(f"{n}_default", jobs[n][0], ["train" if x == "train_test" else x
                                          for x in jobs[n][1]])
            for n in DEFAULT_ALGORITHM_RUNS]


def replicas_check(ranks, jobs, single=None) -> None:
    """Phase 14b's runs on the default algorithms (:func:`tp_default_jobs`):
    every rank's weights and buffers equal to rank 0's, bit for bit, and
    finite, and no launch of the FNO's kernels; with ``single`` (phase
    13b's deterministic one-process results) the distance of the losses
    and parameters from them, printed."""
    for name, entry, argv in jobs:
        what = f"{name}, {TP_MESH}"
        state = ranks[0][name]["state"]
        for r, result in enumerate(ranks):
            got = result[name]
            if any(got["launches"].values()):
                raise RuntimeError(f"{what}: rank {r} launched {got['launches']}")
            for k, v in state.items():
                if not torch.equal(got["state"][k], v):
                    d = (got["state"][k] - v).abs().max().item()
                    raise RuntimeError(f"{what}: rank {r}'s {k} parted from rank 0's by {d:.3e}: "
                                       "a replica parted")
                if v.is_floating_point() and not torch.isfinite(v).all():
                    raise RuntimeError(f"{what}: {k} is not finite")
        print(f"[tp] {what}: {len(ranks)} ranks' {len(state)} tensors equal, bit for bit")
        if single is None:
            continue
        want = single[name[:-len("_default")]]
        mesh_run = trainer_run(entry, argv)
        one_run = WORK / "dp_single" / mesh_run.relative_to(WORK / "tp_default")
        losses = (f"losses max rel diff {losses_rel(mesh_run, one_run):.3e}, "
                  if (one_run / "train_losses.json").exists() else "")
        params = dp_params(state, want["state"], want["names"], what)
        print(f"[tp] {what}: against the deterministic one process (not held): {losses}"
              f"parameters {params:.3e} of the largest")


def split_bytes(argv, device) -> dict:
    """The flagship's parameter and Adam-state bytes on this rank after one
    train step at GRAD_BATCH, its model laid over ``--mesh_shape``'s model
    axis as main_auto lays it (``--pp_microbatches``: staged); or, for
    ``--model gencast``, ``vae`` or ``uncond``, those of one float32 step of
    :func:`dp_trainer_step`, the network split as its trainer splits it."""
    import torch.distributed as dist

    from cfdbench_tpu_torch.cli import make_auto_task, parse_args
    from cfdbench_tpu_torch.parallel.mesh import make_mesh
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import (
        split_model, train_step, trained_module, use_mesh)

    args = parse_args(fno_argv(WORK / "dp_data", WORK / "bytes") + argv)
    mesh = make_mesh(args.mesh_shape, dist.group.WORLD if dist.is_initialized() else None)
    if args.model in SPLIT_TRAINERS:
        step = dp_trainer_step(args, mesh, device, torch.float32)
        return {k: v for k, v in step.items() if k.endswith("_bytes")}
    task = make_auto_task(args, 5, (GRID, GRID), device)
    use_mesh(task, mesh)
    split_model(task, args.pp_microbatches)
    trained = trained_module(task)
    opt, sched = make_adam(trained.parameters(), args.lr)
    batch = train_inputs(GRAD_BATCH * max(1, args.pp_microbatches),
                         torch.Generator().manual_seed(SEED + 15), device)
    train_step(task, opt, sched, mesh.block(batch))
    return dict(param_bytes=sum(p.numel() * p.element_size() for p in trained.parameters()),
                opt_bytes=sum(t.numel() * t.element_size() for st in opt.state.values()
                               for t in st.values() if torch.is_tensor(t) and t.dim() > 0))


def tp_references(device, jobs, out: Path):
    """The one-process runs that phase 13b has not made, made before the
    ranks write over any file they read: GenCast's main_multistep of phase
    13b's checkpoint, the flagship's main_auto with --use_mixed_precision
    (into ``tp_mp_single``), and its bfloat16 main_multistep (of a copy of
    phase 13b's run, in ``tp_bf16``). Returns dp_run's results, each
    rollout's per-step metrics beside its frames."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir

    argv = {n: a for n, _, a in jobs}
    one = {n: ["1" if x == TP_MESH else x for x in argv[n]]
           for n in ("gencast_multistep", "fno_mp", "fno_bf16_multistep")}
    one["fno_mp"] = [x.replace(f"{out}_mp", str(WORK / "tp_mp_single")) for x in one["fno_mp"]]
    src = run_dir(parse_args(argv["fno_multistep"]))
    copy = run_dir(parse_args(argv["fno_bf16_multistep"]))
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(WORK / "dp_single" / src.relative_to(out), copy)
    ran = dp_run([(n, "main_auto" if n == "fno_mp" else "main_multistep", a)
                  for n, a in one.items()], device)
    for n in ("gencast_multistep", "fno_bf16_multistep"):
        path = run_dir(parse_args(one[n])) / "multistep_metrics.json"
        ran[n]["metrics"] = json.loads(path.read_text())
    return ran


def tp_bf16_check(name: str, mesh_run: Path, one_run: Path, what: str) -> None:
    """A mixed-precision main_auto on the model axis against one process's:
    the per-step losses and each epoch's dev scores within TP_BF16_RTOL."""
    worst = losses_rel(mesh_run, one_run)
    for ckpt_dir in sorted(one_run.glob("ckpt-*")):
        got, want = (json.loads((r / ckpt_dir.name / "dev_scores.json").read_text())["mean"]
                     for r in (mesh_run, one_run))
        worst = max(worst, max(abs(got[k] - w) / abs(w) for k, w in want.items() if w))
    print(f"[tp] {what}: losses and dev scores max rel diff {worst:.3e} "
          f"(bound {TP_BF16_RTOL:.0e})")
    if not worst <= TP_BF16_RTOL:
        raise RuntimeError(f"{what}: losses or dev scores disagree, {worst:.3e}")


def start_model_axis(device, data_root: Path) -> dict:
    """Phase 14b's one-process references (:func:`tp_references`, made
    before the ranks write over any file they read), then its TP_RANKS
    ranks, started to run while phase 15c's one-process runs go on."""
    out = WORK / "tp_mesh"
    jobs, default_jobs = tp_jobs(data_root, out), tp_default_jobs(data_root)
    refs = tp_references(device, jobs, out)
    ranks = Ranks("tp_ranks", TP_RANKS, jobs, device,
                  f"[tp] {TP_RANKS} ranks on one card (gloo), --mesh_shape {TP_MESH}",
                  default_jobs)
    return dict(out=out, jobs=jobs, default_jobs=default_jobs, refs=refs, ranks=ranks)


def model_axis_ranks(device, single: dict, controls: dict, started: dict):
    """Phase 14b-c: TP_RANKS ranks on the one card in a gloo group
    (``started``: :func:`start_model_axis`), the jobs of :func:`tp_jobs`,
    against phase 13b's runs in one process (and its permuted-row controls)
    and :func:`tp_references`; returns each rank's launches per path and the
    bytes of each layout against one process's."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir
    from cfdbench_tpu_torch.models.fno import FLAGSHIP

    out, jobs, default_jobs, refs = (started[k] for k in ("out", "jobs", "default_jobs", "refs"))
    ranks = started["ranks"].results()
    argv = {n: a for n, _, a in jobs}
    entries = {n: e for n, e, _ in jobs}

    def single_run(name):
        mesh_run = run_dir(parse_args(argv[name]))
        base = f"{out}_pp" if name == "fno_pp" else str(out)
        return mesh_run, WORK / "dp_single" / mesh_run.relative_to(base)

    # The one-process launches of phase 13b's train run: its train steps
    # and its evaluations' forwards (each one head launch).
    printed = single["fno"]["printed"]
    steps = int(re.search(r"# step: (\d+)", printed).group(1)) * TRAIN_EPOCHS
    evals = single["fno"]["launches"]["fno_head"] - steps
    L, S = FLAGSHIP["num_layers"], TP_RANKS
    kernels = ("fno_block", "fno_head")
    for name, entry in entries.items():
        if entry == "bytes":
            continue
        what = f"{name}, {TP_MESH} against one process"
        ref = {"fno_pp": "fno", "fno_mp_pp": "fno_mp"}.get(name, name)
        want = single[ref] if ref in single else refs[ref]
        for r, result in enumerate(ranks):
            got = result[name]["launches"]
            # One process's launches, which are 0 on the paths of the other
            # trainers and of the bfloat16 forwards; a mixed-precision run's
            # float32 evaluation launches the kernels (under pp on every
            # rank, the model filled whole), its train steps none.
            expect = want["launches"]
            if name == "fno_pp" and device.type == "cuda":
                expect = {"fno_block": steps * (L // S) * PP_MICRO + evals * L,
                          "fno_head": (steps * PP_MICRO if r == S - 1 else 0) + evals}
            if got != expect:
                raise RuntimeError(f"{what}: rank {r} launched {got}, expected {expect}")
            if name in ("fno", "fno_multistep", "fno_pp") and device.type == "cuda" and not all(
                    got.values()):
                raise RuntimeError(f"{what}: rank {r}: a kernel never launched")
        if entry == "main_multistep":
            bf16 = name == "fno_bf16_multistep"
            frame_tol, metric_tol = (TP_BF16_FRAME_RTOL, TP_BF16_RTOL) if bf16 else (DP_RTOL,
                                                                                     DP_RTOL)
            for r, result in enumerate(ranks):
                got = result[name]["frames"]
                if bf16 and got.dtype != torch.bfloat16:
                    raise RuntimeError(f"{what}: rank {r}'s frames are {got.dtype}")
                err = max_rel(got.float(), want["frames"].float())
                print(f"[tp] {what}: rank {r} frames max diff / max {err:.3e} "
                      f"(bound {frame_tol:.0e})")
                if not err <= frame_tol:
                    raise RuntimeError(f"{what}: rank {r}'s frames disagree, {err:.3e}")
            mesh_metrics = json.loads((run_dir(parse_args(argv[name])) /
                                       "multistep_metrics.json").read_text())
            if name == "fno_multistep":
                mesh_run, one_run = single_run("fno")
                want_metrics = json.loads((one_run / "multistep_metrics.json").read_text())
            else:
                want_metrics = want["metrics"]
            metrics_rel(mesh_metrics, want_metrics, f"{what}: per-step metrics", metric_tol)
            continue
        for k, v in ranks[0][name]["state"].items():
            if not torch.equal(v, ranks[1][name]["state"][k]):
                raise RuntimeError(f"{what}: rank 1's {k} differs from rank 0's")
        if entry == "step":
            dp_step_check(name, ranks[0][name], want, what)
            continue
        if entry in DP_TRAINERS:
            dp_trainer_check(name, entry, argv[name], [r[name] for r in ranks], want,
                             controls.get(name), mesh_root=out, what=what,
                             hold_params=name in controls)
            continue
        if name.startswith("fno_mp"):
            mesh_run = run_dir(parse_args(argv[name]))
            tp_bf16_check(name, mesh_run, WORK / "tp_mp_single" / mesh_run.relative_to(
                f"{out}_{name[4:]}"), what)
            print(f"[tp] {what}: parameters "
                  f"{dp_params(ranks[0][name]['state'], want['state'], want['names'], what):.3e}"
                  " of the largest (not held: bfloat16)")
            continue
        mesh_run, one_run = single_run(name)
        loss_rel = losses_rel(mesh_run, one_run)
        params_rel = dp_params(ranks[0][name]["state"], want["state"], want["names"], what)
        if name == "unet":
            control_run = WORK / "dp_control" / mesh_run.relative_to(out)
            ctl_loss = losses_rel(control_run, one_run)
            ctl_params = dp_params(controls["unet"]["state"], want["state"], want["names"],
                                   "unet, one process with permuted rows against one process")
            print(f"[tp] {what}: losses max rel diff {loss_rel:.3e}, parameters {params_rel:.3e}"
                  f" of the largest; the permuted-row control {ctl_loss:.3e}, {ctl_params:.3e} "
                  f"(bound {DP_DRIFT_FACTOR:g} x the control + {DP_RTOL:.0e})")
            if not (loss_rel <= DP_DRIFT_FACTOR * ctl_loss + DP_RTOL
                    and params_rel <= DP_DRIFT_FACTOR * ctl_params + DP_RTOL):
                raise RuntimeError(f"{what}: parted further than the permuted-row control")
            continue
        print(f"[tp] {what}: train losses max rel diff {loss_rel:.3e}, parameters "
              f"{params_rel:.3e} of the largest (bound {DP_RTOL:.0e} each)")
        if not (loss_rel <= DP_RTOL and params_rel <= DP_RTOL):
            raise RuntimeError(f"{what}: losses or parameters disagree")
    replicas_check(ranks, default_jobs, single)
    sizes = {"one_process": split_bytes(["--mesh_shape", "1"], device)}
    for n in SPLIT_TRAINERS:
        sizes[f"{n}_one_process"] = split_bytes(["--model", n, "--mesh_shape", "1"], device)
    for layout in ("tp", "pp") + SPLIT_TRAINERS:
        one = sizes["one_process" if layout in ("tp", "pp") else f"{layout}_one_process"]
        for r, result in enumerate(ranks):
            got = result[f"bytes_{layout}"]
            sizes[f"{layout}_rank{r}"] = got
            print(f"[tp] {layout} rank {r}: " + ", ".join(
                f"{k} {got[k]} B (one process {one[k]} B)" for k in one))
            if not (got["param_bytes"] < one["param_bytes"]
                    and got["opt_bytes"] == 2 * got["param_bytes"]
                    and got.get("ema_bytes", got["param_bytes"]) == got["param_bytes"]):
                raise RuntimeError(f"{layout} rank {r} holds {got}, one process {one}")
    counts = {}
    paths = (("tp", "main_auto", ("fno",)), ("tp", "main_multistep", ("fno_multistep",)),
             ("pp", "main_auto", ("fno_pp",)), ("tp", "main_train", ("ffn", "deeponet")),
             ("tp", "main_gencast", ("gencast",)), ("tp", "main_vae", ("vae",)),
             ("tp", "main_uncond", ("uncond",)),
             ("tp", "main_multistep_gencast", ("gencast_multistep",)),
             ("tp", "main_auto_mixed_precision", ("fno_mp",)),
             ("pp", "main_auto_mixed_precision", ("fno_mp_pp",)),
             ("tp", "main_multistep_bf16", ("fno_bf16_multistep",)))
    for r in range(TP_RANKS):
        for kind, path, names in paths:
            counts[f"{kind}{TP_RANKS}_rank{r}_{path}"] = {
                k: sum(ranks[r][n]["launches"][k] for n in names) for k in kernels}
    return counts, sizes

def split_block_work(B, h, W, Ci, Co, m1, m2):
    """(bytes, multiply-adds on the tensor cores, on the CUDA cores) of each
    half of the block kernel on a rank's ``h`` rows: pass 1 (the rows'
    partial spectrum: x's rows read, the spectrum written) and passes 2-4
    (the summed spectrum, the weights and x's rows read, the output
    written), at the global grid's clamped modes ``m1``, ``m2``."""
    K = 2 * m1
    spectrum = B * K * m2 * 2 * Ci
    first = (4 * (B * h * W * Ci + spectrum),
             B * h * Ci * 2 * m2 * W + B * m2 * Ci * 2 * K * 2 * h, 0)
    rest = (4 * (spectrum + B * h * W * Ci + 4 * Ci * Co * m1 * m2 + Co * Ci + Co
                 + B * h * W * Co),
            B * m2 * Co * 2 * h * 2 * K + B * h * W * Co * 2 * m2 + B * h * W * Ci * Co,
            B * K * m2 * 2 * Ci * 2 * Co)
    return first, rest


def split_block(lib, stream, device, card, B, H, W, M, bounds=None, pad=0, tf32=False):
    """The block kernel split around its spectrum's row sum at M ranks'
    rows of an H x W grid (B images, the flagship's width and modes; the
    even split, or the rows ``bounds``; with ``pad`` the field's last
    ``pad`` rows and columns zero, as a padded FNO's): pass 1 on each
    rank's rows, the partial spectra summed, passes 2-4 on each rank's
    rows, against the plain whole block at phase 2's bounds (the summed
    spectrum and the pre-activation too); each half timed on the first
    rank's rows (with ``bounds``, on each rank's) beside its bound, the
    plain whole block timed, and the bytes of the spectrum that the ranks
    sum. With ``tf32`` the halves run in the kernel's TF32 mode, held to
    the plain TF32 block at phase 12f's gates. Returns the record, each
    rank's rows of the output and the generator that drew the inputs."""
    from cfdbench_tpu_torch.ops import fno_kernels as fk
    from cfdbench_tpu_torch.ops.spectral import clamp_modes, init_spectral_weights

    C = WIDTH
    gen = torch.Generator().manual_seed(SEED + 15)
    even = bounds is None
    bounds = [j * H // M for j in range(M + 1)] if even else list(bounds)
    x = torch.randn((B, H, W, C), generator=gen)
    if pad:
        x[:, H - pad:], x[:, :, W - pad:] = 0, 0
    x = x.to(device)
    weights = (init_spectral_weights(gen, C, C, MODES, MODES) * C).to(device)
    w0 = (torch.randn((C, C), generator=gen) * C ** -0.5).to(device)
    b0 = (torch.randn((C,), generator=gen) * 0.1).to(device)
    block = (x, weights, w0, b0, MODES, MODES)
    spans = list(zip(bounds, bounds[1:]))
    rows = [x[:, a:b].contiguous() for a, b in spans]
    with torch.inference_mode():
        xm = sum(fk._block_spectrum(lib, r, MODES, MODES, stream, (a, H), tf32)
                 for r, (a, _) in zip(rows, spans))
        halves = [fk._block_finish(lib, r, xm, weights, w0, b0, MODES, MODES, stream, True,
                                   (a, H), tf32) for r, (a, _) in zip(rows, spans)]
        got = torch.cat([o for o, _ in halves], 1)
        pre = torch.cat([p for _, p in halves], 1)
        want = fk.fno_block_reference(*block, tf32=tf32)
        want_xm, want_pre = fk.fno_block_saved_reference(*block, tf32=tf32)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        pre_err = (pre - want_pre).abs().max().item()
        xm_rel = ((xm - want_xm).abs().max() / want_xm.abs().max()).item()
        atol = TF32_BLOCK_RTOL * want.abs().max().item() if tf32 else BLOCK_ATOL
        xm_rtol = TF32_BLOCK_RTOL if tf32 else XM_RTOL
        shape = (f"{bounds[1]} of {H} rows ({M} ranks), W={W}" if even
                 else f"the rows {tuple(bounds)} ({M} ranks), W={W}")
        if not (torch.isfinite(got).all() and err <= atol and pre_err <= atol
                and xm_rel <= xm_rtol):
            raise RuntimeError(f"fno_block split at {shape}{' in TF32' * tf32}: max abs err "
                               f"{err:.3e}, pre-activation {pre_err:.3e}, spectrum "
                               f"{xm_rel:.3e}")
        plain_ms = warm_ms(lambda: fk.fno_block_reference(*block, tf32=tf32), 10)
        timed = []
        for r, (a, b) in list(zip(rows, spans))[:1 if even else M]:
            first_ms = warm_ms(lambda: fk._block_spectrum(lib, r, MODES, MODES, stream, (a, H),
                                                          tf32), 20)
            rest_ms = warm_ms(lambda: fk._block_finish(lib, r, xm, weights, w0, b0, MODES,
                                                       MODES, stream, False, (a, H), tf32), 20)
            timed.append((b - a, first_ms, rest_ms))
        whole_ms = warm_ms(lambda: fk.fno_block(*block, tf32=tf32), 20)
    m1, m2 = clamp_modes(H, W, MODES, MODES)
    products = TF32_PRODUCTS if tf32 else SPLIT_TF32_PRODUCTS
    ranks = []
    for h, first_ms, rest_ms in timed:
        first, rest = split_block_work(B, h, W, C, C, m1, m2)
        (b1, by1), (b2, by2) = bound(*first, products), bound(*rest, products)
        ranks.append(dict(rows=h, ms=first_ms + rest_ms, pass1_ms=first_ms,
                          passes2_4_ms=rest_ms, bound_ms=b1 + b2, pass1_bound_ms=b1,
                          pass1_bound_by=by1, passes2_4_bound_ms=b2, passes2_4_bound_by=by2))
    sum_bytes = 4 * B * 2 * 2 * m1 * m2 * C
    print(f"[sp] [{card}] fno_block{' TF32' * tf32} B={B} {shape}: max abs err {err:.3e}, "
          f"pre-activation {pre_err:.3e} (bound {atol:.1e}), summed spectrum {xm_rel:.3e} of its "
          f"max (bound {xm_rtol:.0e}); " + "; ".join(
              f"a rank's {t['rows']} rows: pass 1 {t['pass1_ms']:.4f} ms (bound "
              f"{t['pass1_bound_ms']:.4f} ms by {t['pass1_bound_by']}), passes 2-4 "
              f"{t['passes2_4_ms']:.4f} ms (bound {t['passes2_4_bound_ms']:.4f} ms by "
              f"{t['passes2_4_bound_by']})" for t in ranks)
          + f"; the whole block {whole_ms:.4f} ms, its plain version {plain_ms:.4f} ms; the "
          f"ranks sum {sum_bytes} bytes of spectrum")
    first = {k: v for k, v in ranks[0].items() if k != "rows"}
    record = dict(shape=shape, max_abs_err=err, pre_err=pre_err, spectrum_rel_err=xm_rel,
                  **first, plain_whole_ms=plain_ms, whole_ms=whole_ms, row_sum_bytes=sum_bytes)
    if not even:
        record["ranks"] = ranks
    return record, [o for o, _ in halves], gen


def sp_kernels(device, card) -> dict:
    """Phase 15a: :func:`split_block` at the rows a model rank holds under
    spatial sharding (SP_KERNEL_CASES, B=TIMING_BATCH); the head kernel at
    the same rows against its plain version. Returns per kernel a record a
    shape."""
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk

    lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    out = {"fno_block": [], "fno_head": []}
    B, C = TIMING_BATCH, WIDTH
    for H, W, M in SP_KERNEL_CASES:
        record, outs, gen = split_block(lib, stream, device, card, B, H, W, M)
        out["fno_block"].append(record)
        shape, h = record["shape"], H // M
        mask = torch.ones((B, h, W, 1))
        mask[:, : h // 3] = 0
        head = (outs[0], (torch.randn((128, C), generator=gen) * C ** -0.5).to(device),
                (torch.randn((128,), generator=gen) * 0.1).to(device),
                (torch.randn((2, 128), generator=gen) * 128 ** -0.5).to(device),
                (torch.randn((2,), generator=gen) * 0.1).to(device), mask.to(device))
        with torch.inference_mode():
            herr = (fk.fno_head(*head) - fk.fno_head_reference(*head)).abs().max().item()
            if not herr <= HEAD_ATOL:
                raise RuntimeError(f"fno_head at a rank's {shape}: max abs err {herr:.3e}")
            p, k = interleaved_ms(lambda: fk.fno_head_reference(*head),
                                  lambda: fk.fno_head(*head), reps=20)
        hb, hby = bound(*head_work(B, h, W, C, 128, 2))
        out["fno_head"].append(dict(shape=shape, max_abs_err=herr, ms=k, plain_ms=p,
                                    bound_ms=hb, bound_by=hby))
        print(f"[sp] [{card}] fno_head B={B} {shape}: max abs err {herr:.3e} (bound "
              f"{HEAD_ATOL:.0e}); kernel {k:.4f} ms, plain {p:.4f} ms; bound {hb:.4f} ms by {hby}")
    return out


def sp_jobs(data_root: Path, out: Path, mesh: str):
    """Phase 15b's runs under ``--shard_spatial 1`` on ``mesh`` (with
    ``mesh`` "1" the one-process references): phase 13b's flagship
    main_auto (DP_BATCH, TRAIN_EPOCHS) and U-Net epoch, an epoch each of
    the FFNO and the ResNet at their default widths at DP_UNET_BATCH, and
    the U-Net's float64 step of phase 13b (entry ``step``), each rank's
    peak device memory of one flagship step at DP_BATCH (entry
    ``memory``), and phase 15d's flagship padded by PAD, main_auto's run as
    the flagship's (entry ``main_auto_padded``, into ``out/padded``)."""
    jobs = {n: (n, e, a) for n, e, a in dp_jobs(data_root, out, mesh)}
    sp = ["--shard_spatial", "1"] if mesh != "1" else []
    unet = jobs["unet"][2]
    family = [("ffno", "main_auto", [x if x != "unet" else "ffno" for x in unet]),
              ("resnet", "main_auto", [x if x != "unet" else "resnet" for x in unet])]
    padded = [str(out / "padded") if x == str(out) else x for x in jobs["fno"][2]]
    return [(n, e, a + sp) for n, e, a in [jobs["fno"], jobs["unet"]] + family] + [
        ("unet_step", "step", ["--model", "unet", "--mesh_shape", mesh] + sp),
        ("memory", "memory", ["--mesh_shape", mesh] + sp),
        ("fno_padded", "main_auto_padded", padded + sp)]


def sp_memory(argv, device, grid=(GRID, GRID), global_batch: int = DP_BATCH) -> dict:
    """This rank's peak device memory over one train step of the flagship
    (or of the model ``argv`` names) at DP_BATCH (or ``global_batch``) on
    ``grid`` and ``--mesh_shape`` (``--shard_spatial 1``: its rows of its
    block), and what the step added to what was allocated before it (the
    activations, the gradients and Adam's state). Then what fills it: the
    bytes of this rank's parameters, of their gradients and of Adam's
    state after the step, and the peak that a second step adds to what was
    allocated before it, Adam's state in place (``step2_bytes``)."""
    import torch.distributed as dist

    from cfdbench_tpu_torch.cli import make_auto_task, parse_args
    from cfdbench_tpu_torch.data.pipeline import field_rows
    from cfdbench_tpu_torch.parallel.mesh import make_mesh
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import (
        join_model, split_model, train_step, trained_module, use_mesh)

    args = parse_args(fno_argv(WORK / "dp_data", WORK / "memory") + argv)
    mesh = make_mesh(args.mesh_shape, dist.group.WORLD if dist.is_initialized() else None)
    task = make_auto_task(args, 5, grid, device)
    use_mesh(task, mesh)
    split_model(task, 0, bool(args.shard_spatial))
    opt, sched = make_adam(trained_module(task).parameters(), args.lr)
    gen = torch.Generator().manual_seed(SEED + 16)
    batch = field_rows(mesh.block(train_inputs(global_batch, gen, device, grid)),
                       getattr(task, "rows", None))
    batch = {k: v.contiguous() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    train_step(task, opt, sched, batch, task.step_draws(SEED, 0, device))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    params = list(trained_module(task).parameters())
    parts = {"param_bytes": params,
             "grad_bytes": [p.grad for p in params if p.grad is not None],
             "adam_bytes": [v for st in opt.state.values() for v in st.values()
                            if torch.is_tensor(v)]}
    parts = {k: sum(t.numel() * t.element_size() for t in ts) for k, ts in parts.items()}
    torch.cuda.reset_peak_memory_stats(device)
    before2 = torch.cuda.memory_allocated(device)
    train_step(task, opt, sched, batch, task.step_draws(SEED, 1, device))
    torch.cuda.synchronize()
    step2 = torch.cuda.max_memory_allocated(device) - before2
    join_model(task)
    return dict(peak_bytes=peak, step_bytes=peak - before, step2_bytes=step2, **parts)


def sp_spawn(tag: str, world: int, jobs, device, what: str) -> Ranks:
    """``jobs`` started on ``world`` gloo ranks sharing the one card
    (:class:`Ranks`, deterministic algorithms on), their group meeting under
    ``WORK/tag``."""
    return Ranks(tag, world, jobs, device, f"[sp] {world} ranks on one card (gloo), {what}")


def spatial_ranks(device, card, data_root: Path, single: dict, controls: dict):
    """Phase 15b: ``main_auto --shard_spatial 1`` on SP_MESHES[0]
    (:func:`check_sp_ranks`; SP_MESHES[1] runs in phase 15d's spawn). Returns
    each rank's launches on the FNO's paths, the memory records and the
    one-process references (made while the ranks run)."""
    mesh = SP_MESHES[0]
    jobs = sp_jobs(data_root, WORK / f"sp_{mesh}", mesh)
    spawned = sp_spawn(f"sp_ranks_{mesh}", SP_RANKS[mesh], jobs, device,
                       f"--mesh_shape {mesh} --shard_spatial 1")
    refs = dp_run([j for j in sp_jobs(data_root, WORK / "sp_single", "1")
                   if j[0] in ("ffno", "resnet", "memory", "fno_padded")], device)
    want = {n: single[n] for n in ("fno", "unet", "unet_step")} | refs
    ranks = spawned.results()
    counts, memory = check_sp_ranks(mesh, jobs, ranks, want, controls, card, device)
    return counts, {"one_process": refs["memory"]} | memory, want


def check_sp_ranks(mesh: str, jobs, ranks, want: dict, controls: dict, card, device):
    """Phase 15b's checks of :func:`sp_jobs` on ``mesh``, SP_RANKS[mesh] gloo
    ranks sharing the one card: the flagship FNO at DP_BATCH (phase 13b's
    run) and the flagship padded by PAD, the U-Net (phase 13b's epoch and
    float64 step), the FFNO and the ResNet, against one process (``want``):
    the FNO's, the padded FNO's, the FFNO's and the ResNet's losses, dev
    scores and weights within DP_RTOL (the ResNet's dropout masks drawn over
    the global grid), the U-Net's step within DP_RTOL (``dp_step_check``)
    and its epoch within DP_DRIFT_FACTOR times phase 13b's permuted-row
    control plus DP_RTOL; each rank's launches of both kernels one
    process's (none on the other models); each rank's peak memory of one
    flagship step against one process's. Returns each rank's launches on
    the FNO's paths and the memory records."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir

    counts, memory = {}, {}
    out = WORK / f"sp_{mesh}"
    for name, entry, argv in jobs:
        what = f"{name}, {mesh} --shard_spatial 1 against one process"
        if entry == "memory":
            for r, result in enumerate(ranks):
                got = result[name]
                memory[f"{mesh}_rank{r}"] = {k: got[k] for k in ("peak_bytes", "step_bytes")}
                print(f"[sp] [{card}] {what}: rank {r} peak {got['peak_bytes']} B, the step "
                      f"{got['step_bytes']} B (one process {want[name]['peak_bytes']} B, "
                      f"{want[name]['step_bytes']} B: "
                      f"{got['step_bytes'] / want[name]['step_bytes']:.3f} of it)")
            continue
        if entry == "step":
            dp_step_check(name, ranks[0][name], want[name], what)
            continue
        for r, result in enumerate(ranks):
            got = result[name]["launches"]
            if got != want[name]["launches"]:
                raise RuntimeError(f"{what}: rank {r} launched {got}, one process "
                                   f"{want[name]['launches']}")
            if name.startswith("fno") and device.type == "cuda" and not all(got.values()):
                raise RuntimeError(f"{what}: rank {r}: a kernel never launched")
            for k, v in ranks[0][name]["state"].items():
                if not torch.equal(v, result[name]["state"][k]):
                    raise RuntimeError(f"{what}: rank {r}'s {k} differs from rank 0's")
        mesh_run = run_dir(parse_args(argv))
        base = WORK / ("dp_single" if name in ("fno", "unet") else "sp_single")
        one_run = base / mesh_run.relative_to(out)
        loss_rel = losses_rel(mesh_run, one_run)
        params_rel = dp_params(ranks[0][name]["state"], want[name]["state"],
                               want[name]["names"], what)
        dev = dev_rel(mesh_run, one_run)
        if name == "unet":
            control_run = WORK / "dp_control" / mesh_run.relative_to(out)
            ctl_loss = losses_rel(control_run, one_run)
            ctl_params = dp_params(controls["unet"]["state"], want[name]["state"],
                                   want[name]["names"], "unet control")
            print(f"[sp] {what}: losses max rel diff {loss_rel:.3e}, parameters "
                  f"{params_rel:.3e} of the largest, dev scores {dev:.3e}; the permuted-row "
                  f"control {ctl_loss:.3e}, {ctl_params:.3e} (bound {DP_DRIFT_FACTOR:g} x the "
                  f"control + {DP_RTOL:.0e})")
            if not (loss_rel <= DP_DRIFT_FACTOR * ctl_loss + DP_RTOL
                    and params_rel <= DP_DRIFT_FACTOR * ctl_params + DP_RTOL):
                raise RuntimeError(f"{what}: parted further than the permuted-row control")
            continue
        print(f"[sp] {what}: losses max rel diff {loss_rel:.3e}, dev scores {dev:.3e}, "
              f"parameters {params_rel:.3e} of the largest (bound {DP_RTOL:.0e} each)")
        if not (loss_rel <= DP_RTOL and dev <= DP_RTOL and params_rel <= DP_RTOL):
            raise RuntimeError(f"{what}: losses, dev scores or parameters disagree")
    for r in range(len(ranks)):
        for name, path in (("fno", "main_auto_sp"), ("fno_padded", "main_auto_sp_padded")):
            counts[f"sp{mesh}_rank{r}_{path}"] = ranks[r][name]["launches"]
    return counts, memory


def sp_rest_trees(root: Path):
    """Phase 15c's 12-case cavity trees of SP_REST_FRAMES frames: on the
    flagship's grid, on TUBE_GRID (the generator's square tree of 66 rows,
    each frame cropped to 65 columns), and phase 15d's on SP_EMPTY_GRID."""
    import numpy as np

    from cfdbench_tpu_torch.data.synthetic import generate_problem

    square, tube, empty = root / "data", root / "tube_data", root / "empty_data"
    H, W = TUBE_GRID
    for tree, grid in ((square, GRID), (tube, H), (empty, SP_EMPTY_GRID[0])):
        generate_problem(tree, "cavity", cases_per_subset=4, num_frames=SP_REST_FRAMES,
                         grid=grid, seed=SEED)
    for f in tube.rglob("*.npy"):
        np.save(f, np.load(f)[..., :W])
    return square, tube, empty


def sp_rest_jobs(data_root: Path, rest_root: Path, tube_root: Path, out: Path, mesh: str):
    """Phase 15c's runs on ``mesh`` (``--shard_spatial 1`` unless ``mesh`` is
    "1", the one-process references): phase 13b's flagship main_auto with
    --use_mixed_precision (``fno_mp``, into ``out``'s sibling ``_mp``) and
    with --pp_microbatches PP_MICRO (``fno_pp``; its reference is phase
    13b's run), on phase 13b's tree ``data_root``; on :func:`sp_rest_trees`
    (``rest_root``, ``tube_root``) an epoch of the U-Net on the TUBE_GRID
    tree at DP_UNET_BATCH, of each of SP_POINT_MODELS at DP_UNET_BATCH and
    of pixel diffusion and
    each of SP_LATENT (on phase 10's VAE; ``latent_diffusion_lite66`` on the
    TUBE_GRID tree) at SP_PIXEL_BATCH, at default widths; a float64 step of
    the U-Net on TUBE_GRID, of each of SP_POINT_MODELS, of pixel diffusion
    and of each of SP_LATENT (:func:`dp_step`); then the memory records of
    SP_MEMORY."""
    sp = ["--shard_spatial", "1"] if mesh != "1" else []
    fno = {n: a for n, _, a in dp_jobs(data_root, out, mesh)}["fno"]
    data = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(rest_root),
            "--output_dir", str(out), "--mesh_shape", mesh, "--log_interval", "100",
            "--mode", "train", "--num_epochs", "1", "--eval_interval", "1"]
    batch = ["--batch_size", str(DP_UNET_BATCH), "--eval_batch_size", str(DP_UNET_BATCH)]
    tube = [str(tube_root) if a == str(rest_root) else a for a in data]
    jobs = [("fno_mp", "main_auto",
             [a.replace(str(out), f"{out}_mp") for a in fno] + ["--use_mixed_precision", "1"]),
            ("fno_pp", "main_auto", fno + ["--pp_microbatches", str(PP_MICRO)]),
            ("unet66", "main_auto", ["--model", "unet"] + batch + tube)]
    jobs += [(name, "main_auto", ["--model", name] + batch + data) for name in SP_POINT_MODELS]
    generative = ["--batch_size", str(SP_PIXEL_BATCH), "--max_eval_batches", "1",
                  "--ldm_num_inference_steps", SP_INFERENCE_STEPS]
    vae = ["--ldm_vae_weights_path", str(WORK / "vae_weights")]
    jobs.append(("pixel_diffusion", "main_auto", ["--model", "pixel_diffusion"] + generative
                 + data))
    # Lite on TUBE_GRID writes under out/66: its run directory is Lite's.
    tube66 = [str(out / "66") if a == str(out) else a for a in tube]
    jobs += [(run, "main_auto", ["--model", name] + vae + generative
              + (tube66 if run.endswith("66") else data)) for run, name in SP_LATENT.items()]
    jobs += [("unet66_step", "step_tube", ["--model", "unet", "--mesh_shape", mesh])]
    jobs += [(f"{name}_step", "step", ["--model", name, "--mesh_shape", mesh])
             for name in SP_POINT_MODELS + ("pixel_diffusion",)]
    jobs += [(f"{run}_step", "step_tube" if run.endswith("66") else "step",
              ["--model", name, "--mesh_shape", mesh] + vae) for run, name in SP_LATENT.items()]
    jobs += [(name, name, ["--mesh_shape", mesh]) for name in SP_MEMORY]
    jobs = [(n, e, a + sp) for n, e, a in jobs]
    if mesh == "1":  # phase 13b ran the one-process fno_pp: main_auto alone
        jobs = [j for j in jobs if j[0] != "fno_pp"]
    return jobs


def start_spatial_rest(device, data_root: Path) -> dict:
    """Phase 15c's trees (:func:`sp_rest_trees`) and its ranks: the jobs of
    :func:`sp_rest_jobs` on SP_MESHES[0], started to run on while phases
    14b-c and 15b and 15c's one-process runs go on, which share no file with
    them and time nothing (the kernels of 14a, 15a and 15d(a) are timed
    before they start)."""
    mesh = SP_MESHES[0]
    trees = sp_rest_trees(WORK / "sp_rest_trees")
    jobs = sp_rest_jobs(data_root, trees[0], trees[1], WORK / "sp_rest", mesh)
    ranks = sp_spawn("sp_rest_ranks", SP_RANKS[mesh], jobs, device,
                     f"--mesh_shape {mesh} --shard_spatial 1, the rest of main_auto")
    return dict(trees=trees, jobs=jobs, ranks=ranks)


def spatial_rest_references(device, data_root: Path, single: dict, started: dict) -> dict:
    """Phase 15c's one-process runs of :func:`sp_rest_jobs` and their
    controls (:func:`rest_controls`), made while :func:`start_spatial_rest`'s
    ranks (``started``) run."""
    rest_root, tube_root, _ = started["trees"]
    one_jobs = sp_rest_jobs(data_root, rest_root, tube_root, WORK / "sp_rest_single", "1")
    want = dp_run(one_jobs, device) | {"fno_pp": single["fno"]}
    return dict(want=want, controls=rest_controls(one_jobs, SP_CONTROLLED, device))


def spatial_rest(device, card, started: dict, refs: dict):
    """Phase 15c: :func:`start_spatial_rest`'s ranks (``started``), sharing
    the one card in a gloo group, deterministic algorithms on, against one
    process (:func:`check_rest_ranks`; ``refs``:
    :func:`spatial_rest_references`). Returns each rank's launches by path,
    the memory records, and what phase 15d compares with: the trees, the
    one-process results and the controls."""
    mesh, trees, jobs = SP_MESHES[0], started["trees"], started["jobs"]
    want, controls = refs["want"], refs["controls"]
    ranks = started["ranks"].results()
    counts, memory = check_rest_ranks(mesh, jobs, ranks, want, controls, WORK / "sp_rest", card,
                                      device)
    return counts, memory, dict(trees=trees, want=want, controls=controls)


def rest_controls(one_jobs, names, device) -> dict:
    """The controls of the one-process runs ``one_jobs`` (written under
    ``WORK/sp_rest_single``) of ``names``: each run again with the rows of
    its train batches permuted, one run a seed of SP_CONTROL_SEEDS, and a
    latent model's in float64 too (SP_LATENT_CONTROL). Returns (name, seed)
    -> the control's result directory root and its result."""
    controls = {}
    for seed in SP_CONTROL_SEEDS + (SP_LATENT_CONTROL,):
        chosen = [n for n in names if seed != SP_LATENT_CONTROL or n in SP_LATENT]
        with permuted_train_rows(seed) if seed != SP_LATENT_CONTROL else float64_run():
            for name in chosen:
                argv = next(a for n, _, a in one_jobs if n == name)
                root = WORK / f"sp_rest_control{seed}"
                controls[name, seed] = root, dp_run([(name, "main_auto", [
                    a.replace(str(WORK / "sp_rest_single"), str(root)) for a in argv])],
                    device)[name]
    return controls


def check_rest_ranks(mesh: str, jobs, ranks, want: dict, controls: dict, out: Path, card,
                     device):
    """Phase 15c's checks of ``jobs`` (written under ``out``) on ``mesh``'s
    ranks against one process (``want``, written under
    ``WORK/sp_rest_single``): the mixed-precision flagship's losses and dev
    scores within TP_BF16_RTOL; the pipelined flagship's losses, dev scores
    and weights within DP_RTOL; the other runs (SP_CONTROLLED, whose
    rounding-level gradients Adam amplifies) by their losses and weights
    within DP_DRIFT_FACTOR times the largest of their permuted-row controls
    plus DP_RTOL, and each of them by its float64 step within DP_RTOL too
    (``dp_step_check``), as phase 15b holds the U-Net. Both kernels launch on
    every rank in the flagship's float32 evaluation and on the pipeline's
    stages, none on the other models; each rank's peak memory of a step,
    against one process's. Returns each rank's launches by path and the
    memory records."""
    from cfdbench_tpu_torch.cli import parse_args, run_dir

    counts, memory, failures = {}, {}, []
    for name, entry, argv in jobs:
        what = f"{name}, {mesh} --shard_spatial 1 against one process"
        if entry in SP_MEMORY:
            one = want[name]
            memory[name] = {"one_process_peak_bytes": one["peak_bytes"], **{
                f"rank{r}_peak_fraction": res[name]["peak_bytes"] / one["peak_bytes"]
                for r, res in enumerate(ranks)}}
            for r, res in enumerate(ranks):
                got = res[name]
                print(f"[sp] [{card}] {what}: rank {r} peak {got['peak_bytes']} B "
                      f"({got['peak_bytes'] / one['peak_bytes']:.3f} of one process's "
                      f"{one['peak_bytes']} B), the step {got['step_bytes']} B "
                      f"({got['step_bytes'] / one['step_bytes']:.3f} of {one['step_bytes']} B); "
                      + ", ".join(f"{k} {got[k]} B ({got[k] / one[k]:.3f})" for k in (
                          "param_bytes", "grad_bytes", "adam_bytes", "step2_bytes")))
            continue
        if entry in ("step", "step_tube", "step_empty"):
            try:
                dp_step_check(name, ranks[0][name], want[name], what)
            except RuntimeError as e:
                failures.append(str(e))
            continue
        launches = [res[name]["launches"] for res in ranks]
        fno = name.startswith("fno")
        for r, got in enumerate(launches):
            if not fno and any(got.values()):
                raise RuntimeError(f"{what}: rank {r} launched {got}; this model runs no FNO")
            if fno and device.type == "cuda" and not got["fno_block"]:
                raise RuntimeError(f"{what}: rank {r} never launched the block kernel")
            if name == "fno_mp" and device.type == "cuda" and not got["fno_head"]:
                raise RuntimeError(f"{what}: rank {r} never launched the head kernel")
            for k, v in ranks[0][name]["state"].items():
                if not torch.equal(v, ranks[r][name]["state"][k]):
                    raise RuntimeError(f"{what}: rank {r}'s {k} differs from rank 0's")
        if fno and device.type == "cuda" and not any(g["fno_head"] for g in launches):
            raise RuntimeError(f"{what}: no rank launched the head kernel")
        mesh_run = run_dir(parse_args(argv))
        if name == "fno_mp":
            try:
                tp_bf16_check(name, mesh_run,
                              WORK / "sp_rest_single_mp" / mesh_run.relative_to(f"{out}_mp"),
                              what)
            except RuntimeError as e:
                failures.append(str(e))
        else:
            base = WORK / ("dp_single" if name == "fno_pp" else "sp_rest_single")
            one_run = base / mesh_run.relative_to(out)
            loss_rel, dev = losses_rel(mesh_run, one_run), dev_rel(mesh_run, one_run)
            params_rel = dp_params(ranks[0][name]["state"], want[name]["state"],
                                   want[name]["names"], what)
            if name in SP_CONTROLLED + SP_EMPTY_CONTROLLED:  # dev scores printed, as 15b's U-Net's
                ctl_loss = ctl_params = 0.0
                for seed in SP_CONTROL_SEEDS + ((SP_LATENT_CONTROL,) if name in SP_LATENT
                                                else ()):
                    root, ctl = controls[name, seed]
                    control_run = root / one_run.relative_to(WORK / "sp_rest_single")
                    loss_c = losses_rel(control_run, one_run)
                    params_c = dp_params(ctl["state"], want[name]["state"], want[name]["names"],
                                         f"{name} control, seed {seed}")
                    kind = ("the float64 run" if seed == SP_LATENT_CONTROL
                            else f"the permuted-row control of seed {seed}")
                    print(f"[sp] {name}: {kind} against one process: losses {loss_c:.3e}, "
                          f"parameters {params_c:.3e}, dev scores "
                          f"{dev_rel(control_run, one_run):.3e}")
                    ctl_loss, ctl_params = max(ctl_loss, loss_c), max(ctl_params, params_c)
                print(f"[sp] {what}: losses max rel diff {loss_rel:.3e}, parameters "
                      f"{params_rel:.3e} of the largest, dev scores {dev:.3e}; the controls' "
                      f"largest {ctl_loss:.3e}, {ctl_params:.3e} (bound {DP_DRIFT_FACTOR:g} x "
                      f"that + {DP_RTOL:.0e})")
                if not (loss_rel <= DP_DRIFT_FACTOR * ctl_loss + DP_RTOL
                        and params_rel <= DP_DRIFT_FACTOR * ctl_params + DP_RTOL):
                    failures.append(f"{what}: parted further than the permuted-row controls")
            else:
                print(f"[sp] {what}: losses max rel diff {loss_rel:.3e}, dev scores {dev:.3e}, "
                      f"parameters {params_rel:.3e} of the largest (bound {DP_RTOL:.0e} each)")
                if not (loss_rel <= DP_RTOL and dev <= DP_RTOL and params_rel <= DP_RTOL):
                    failures.append(f"{what}: losses, dev scores or parameters disagree")
        for r, got in enumerate(launches):
            counts[f"sp{mesh}_rank{r}_main_auto_sp_{name}"] = got
        print(f"[sp] {what}: launches by rank {launches}")
    if failures:  # every comparison printed first
        raise RuntimeError("; ".join(failures))
    return counts, memory


def empty_jobs(rest_root: Path, empty_root: Path, out: Path, mesh: str):
    """Phase 15d's runs where a level leaves a rank without a row, on
    ``mesh`` (``--shard_spatial 1`` unless ``mesh`` is "1"): phase 15c's
    latent_diffusion2 epoch and float64 step on its 64x64 tree
    (``rest_root``) and its memory record at SP_PIXEL_BATCH; an epoch of the
    U-Net on the SP_EMPTY_GRID tree ``empty_root`` at DP_UNET_BATCH and its
    float64 step there (entry ``step_empty``)."""
    sp = ["--shard_spatial", "1"] if mesh != "1" else []
    latent = [(n, e, a) for n, e, a in sp_rest_jobs(WORK / "unused", rest_root, rest_root, out,
                                                    mesh)
              if n in ("latent_diffusion2", "latent_diffusion2_step", "memory_latent")]
    data = ["--data_name", "cavity_prop_bc_geo", "--data_dir", str(empty_root),
            "--output_dir", str(out / "empty"), "--mesh_shape", mesh, "--log_interval", "100",
            "--mode", "train", "--num_epochs", "1", "--eval_interval", "1",
            "--batch_size", str(DP_UNET_BATCH), "--eval_batch_size", str(DP_UNET_BATCH)]
    return latent + [(n, e, a + sp) for n, e, a in (
        ("unet_empty", "main_auto", ["--model", "unet"] + data),
        ("unet_empty_step", "step_empty", ["--model", "unet", "--mesh_shape", mesh]))]


def spatial_empty(device, card, data_root: Path, sp_want: dict, dp_controls: dict, rest: dict):
    """Phase 15d(b-c), on one spawn of four gloo ranks sharing the one card:
    phase 15b's runs on SP_MESHES[1] (the flagship, the flagship padded by
    PAD, the memory record; :func:`check_sp_ranks`) and, on SP_EMPTY_MESH,
    :func:`empty_jobs` (:func:`check_rest_ranks`, against phase 15c's
    one-process latent_diffusion2 and its controls, and the U-Net's on the
    SP_EMPTY_GRID tree, run here with its permuted-row controls while the
    ranks run). Returns each rank's launches by path and the memory
    records."""
    empty_root = rest["trees"][2]
    mesh2 = SP_MESHES[1]
    jobs2 = [j for j in sp_jobs(data_root, WORK / f"sp_{mesh2}", mesh2)
             if j[0] in ("fno", "fno_padded", "memory")]
    out = WORK / f"sp_{SP_EMPTY_MESH}"
    jobs = empty_jobs(rest["trees"][0], empty_root, out, SP_EMPTY_MESH)
    spawned = sp_spawn("sp_empty_ranks", SP_RANKS[mesh2], jobs2 + jobs, device,
                       f"--mesh_shape {mesh2} and {SP_EMPTY_MESH} --shard_spatial 1")
    one_jobs = empty_jobs(rest["trees"][0], empty_root, WORK / "sp_rest_single", "1")
    unet = [j for j in one_jobs if j[0].startswith("unet")]
    want = rest["want"] | dp_run(unet, device)
    controls = rest["controls"] | rest_controls(one_jobs, ("unet_empty",), device)
    ranks = spawned.results()
    counts, memory = check_sp_ranks(mesh2, jobs2, ranks, sp_want, dp_controls, card, device)
    empty_counts, empty_memory = check_rest_ranks(SP_EMPTY_MESH, jobs, ranks, want, controls,
                                                  out, card, device)
    return counts | empty_counts, memory | {f"{SP_EMPTY_MESH}_{k}": v
                                            for k, v in empty_memory.items()}


def padded_split_kernels(device, card) -> dict:
    """Phase 15d(a): :func:`split_block` on the rows of the flagship padded
    by PAD at SP_MESHES[0] (the last rank holds the pad rows, ``Rows(0, 32,
    73)``), B=TIMING_BATCH, W = GRID + PAD, each rank's halves timed beside
    their bounds; the head on each rank's cropped rows (a contiguous copy,
    as the model's crop) against its plain version, the last rank's timed.
    Returns per kernel a record."""
    from cfdbench_tpu_torch.models.fno import crop, padded_rows
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk
    from cfdbench_tpu_torch.parallel.mesh import ModelAxis

    lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    B, C, M = TIMING_BATCH, WIDTH, SP_RANKS[SP_MESHES[0]]
    h = GRID // M
    bounds = padded_rows(h, PAD, ModelAxis(M)).bounds
    record, outs, gen = split_block(lib, stream, device, card, B, GRID + PAD, GRID + PAD, M,
                                    bounds, PAD)
    w1 = (torch.randn((128, C), generator=gen) * C ** -0.5).to(device)
    b1 = (torch.randn((128,), generator=gen) * 0.1).to(device)
    w2 = (torch.randn((2, 128), generator=gen) * 128 ** -0.5).to(device)
    b2 = (torch.randn((2,), generator=gen) * 0.1).to(device)
    mask = torch.ones((B, h, GRID, 1))
    mask[:, : h // 3] = 0
    errs = []
    with torch.inference_mode():
        for out in outs:
            head = (crop(out, PAD, h), w1, b1, w2, b2, mask.to(device))
            errs.append((fk.fno_head(*head) - fk.fno_head_reference(*head)).abs().max().item())
        if not max(errs) <= HEAD_ATOL:
            raise RuntimeError(f"fno_head on the ranks' cropped padded rows: max abs err {errs}")
        p, k = interleaved_ms(lambda: fk.fno_head_reference(*head), lambda: fk.fno_head(*head),
                              reps=20)
    hb, hby = bound(*head_work(B, h, GRID, C, 128, 2))
    shape = f"{h} of {GRID} rows, the last rank's crop of the rows {bounds}"
    print(f"[sp] [{card}] fno_head B={B} {shape}: max abs err by rank "
          + ", ".join(f"{e:.3e}" for e in errs)
          + f" (bound {HEAD_ATOL:.0e}); kernel {k:.4f} ms, plain {p:.4f} ms; bound {hb:.4f} ms "
          f"by {hby}")
    return {"fno_block": record, "fno_head": dict(shape=shape, max_abs_err=max(errs), ms=k,
                                                  plain_ms=p, bound_ms=hb, bound_by=hby)}


def padded_kernels(device, card):
    """Phase 16a, the kernels: the block at B=128 on the padded grid against
    its plain version and timed beside its bound; the head on the cropped
    field, and the crop's contiguous copy, timed. Returns the block's
    record and the head's error."""
    from cfdbench_tpu_torch.models.fno import crop
    from cfdbench_tpu_torch.ops import fno_kernels as fk

    B, H, W = TIMING_BATCH, GRID + PAD, GRID + PAD
    t = kernel_inputs(B, H, W, WIDTH, torch.Generator().manual_seed(SEED + 16), device)
    block_args = (t["x"], t["weights"], t["w0"], t["b0"], MODES, MODES)
    with torch.inference_mode():
        got, want = fk.fno_block(*block_args), fk.fno_block_reference(*block_args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"[padded] fno_block B={B} {H}x{W} C={WIDTH} modes={MODES}: max abs err "
              f"{err:.3e} (bound {BLOCK_ATOL:.0e}), max rel err "
              f"{err / want.abs().max().item():.3e}")
        if not (torch.isfinite(got).all() and err <= BLOCK_ATOL):
            raise RuntimeError(f"fno_block at {H}x{W} disagrees with its plain version: {err:.3e}")
        check_saved(block_args)
        p, k = interleaved_ms(lambda: fk.fno_block_reference(*block_args),
                              lambda: fk.fno_block(*block_args), reps=20)
        bound_ms, bound_by = bound(*block_work(B, H, W, WIDTH, WIDTH, MODES))
        print(f"[time] [{card}] fno_block B={B} {H}x{W} C={WIDTH} (the flagship padded by "
              f"{PAD}): kernel {k:.4f} ms, plain {p:.4f} ms ({p / k:.2f}x); bound "
              f"{bound_ms:.4f} ms by {bound_by}, kernel at {bound_ms / k:.1%} of it")
        cropped = crop(got, PAD, GRID)
        mask = t["mask"][:, :GRID, :GRID].contiguous()
        head_args = (cropped, t["w1"], t["b1"], t["w2"], t["b2"], mask)
        head_err = (fk.fno_head(*head_args) - fk.fno_head_reference(*head_args)).abs().max().item()
        print(f"[padded] fno_head on the cropped {GRID}x{GRID} field: max abs err "
              f"{head_err:.3e} (bound {HEAD_ATOL:.0e})")
        if not head_err <= HEAD_ATOL:
            raise RuntimeError(f"fno_head on the cropped field disagrees: {head_err:.3e}")
        crop_ms = warm_ms(lambda: crop(got, PAD, GRID), reps=20)
        crop_bytes = 2 * 4 * B * GRID * GRID * WIDTH
        print(f"[time] [{card}] the crop's contiguous copy B={B} {H}x{W} -> {GRID}x{GRID} "
              f"C={WIDTH}: {crop_ms:.4f} ms, bound {crop_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"by bytes ({crop_bytes / 1e6:.1f} MB)")
    return dict(grid=[H, W], max_abs_err=err, ms=k, plain_ms=p, bound_ms=bound_ms,
                bound_by=bound_by, crop_ms=crop_ms), head_err


def card_against_cpu(model, cpu_model, what: str, seed: int) -> None:
    """``model``'s forward (B=GRAD_BATCH) on the card against ``cpu_model``'s
    (the same weights; the CPU's plain path), rel ROLLOUT_RTOL, and one
    float32 train step card against CPU: loss GRAD_LOSS_RTOL, every
    gradient GRAD_RTOL of its largest."""
    device = next(model.parameters()).device
    batch = train_inputs(GRAD_BATCH, torch.Generator().manual_seed(seed), "cpu")
    args = [batch[k] for k in ("inputs", "case_params", "mask")]
    with torch.inference_mode():
        got = model(*(a.to(device) for a in args)).cpu()
        want = cpu_model(*args)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[card-cpu] {what}, forward B={GRAD_BATCH}: card against CPU max abs diff / max "
          f"|out| {rel:.3e} (bound {ROLLOUT_RTOL:.0e})")
    if not rel <= ROLLOUT_RTOL:
        raise RuntimeError(f"{what}: the forward disagrees card against CPU: {rel:.3e}")
    runs = {}
    for name, m, dev in (("card", model, device), ("cpu", cpu_model, torch.device("cpu"))):
        m.zero_grad(set_to_none=True)
        loss, _ = nmse_task(m).loss_scores({k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        runs[name] = loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()}
    (loss_k, grads_k), (loss_c, grads_c) = runs["card"], runs["cpu"]
    loss_rel = abs(loss_k - loss_c) / abs(loss_c)
    worst = max(((grads_k[k] - g).abs().max() / g.abs().max()).item()
                for k, g in grads_c.items())
    print(f"[card-cpu] {what}, train step B={GRAD_BATCH}: nmse card {loss_k:.9g}, CPU "
          f"{loss_c:.9g}, rel {loss_rel:.3e} (bound {GRAD_LOSS_RTOL:.0e}); gradients worst "
          f"{worst:.3e} of their largest (bound {GRAD_RTOL:.0e})")
    if not (loss_rel <= GRAD_LOSS_RTOL and worst <= GRAD_RTOL):
        raise RuntimeError(f"{what}: the train step disagrees card against CPU")


def rollout_timing(model, what: str, card, seed: int):
    """A 20-step b128 rollout of ``model`` on GRID through the kernels, its
    launches (counters set to 0 just before it) and its frames/s beside the
    plain path's, by CUDA events in turns. Returns the launches and times."""
    from cfdbench_tpu_torch.models.fno import PlainFno2d
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts
    from cfdbench_tpu_torch.training.rollout import make_rollout_fn

    device = next(model.parameters()).device
    B = TIMING_BATCH
    gen = torch.Generator().manual_seed(seed)
    frame0 = torch.randn((B, GRID, GRID, 2), generator=gen).to(device)
    cp = torch.randn((B, 5), generator=gen).to(device)
    mask = torch.ones((B, GRID, GRID, 1), device=device)
    model.eval()
    kernel_roll = make_rollout_fn(model, STEPS)
    plain_roll = make_rollout_fn(PlainFno2d(model), STEPS)
    with torch.inference_mode():
        reset_launch_counts()
        frames = kernel_roll(frame0, cp, mask)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {"fno_block": len(model.blocks) * STEPS, "fno_head": STEPS}
        if counts != want or not torch.isfinite(frames).all():
            raise RuntimeError(f"{what} rollout: launches {counts} (expected {want}), or "
                               "non-finite frames")
        plain_ms, kern_ms = interleaved_ms(lambda: plain_roll(frame0, cp, mask),
                                           lambda: kernel_roll(frame0, cp, mask), reps=3)
    fps = B * STEPS / kern_ms * 1e3
    print(f"[time] [{card}] {what} rollout b{B} x {STEPS} steps: launches {counts}; "
          f"kernel path {kern_ms:.3f} ms = {fps:.1f} frames/s; plain path {plain_ms:.3f} ms = "
          f"{B * STEPS / plain_ms * 1e3:.1f} frames/s")
    return counts, dict(frames_per_s=fps, kernel_ms=kern_ms, plain_ms=plain_ms)


def padded_paths(device, card):
    """Phase 16a, the padded flagship: its forward and a train step on the
    card against the CPU's plain path; a 20-step b128 rollout through the
    kernels, its launches, and its frames/s beside the plain path's.
    Returns the rollout's launches and frames/s."""
    model = flagship_model(device, padding=PAD)
    card_against_cpu(model, flagship_model("cpu", padding=PAD), f"flagship padded by {PAD}",
                     SEED + 17)
    return rollout_timing(model, "padded flagship", card, SEED + 18)


def flagship_block_kernels() -> tuple:
    """The CUDA kernels a flagship block call launches (its route's)."""
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk

    return fk.route_kernels(fk.block_route(_build.load_library(), GRID, GRID, WIDTH, WIDTH,
                                           MODES, MODES))


def flagship_head_kernels() -> tuple:
    """The CUDA kernels a flagship head call launches (its route's)."""
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk

    return fk.head_route_kernels(fk.head_route(_build.load_library(), WIDTH, 128, 2))


def trace_kernel_counts(path: Path) -> dict:
    """Each of the FNO's CUDA kernels: how many launches a Chrome trace holds."""
    names = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names)
            for k in flagship_block_kernels() + flagship_head_kernels()}


def profiled_multistep(want_counts: dict) -> dict:
    """Phase 16b: ``main_multistep --profile_dir`` on phase 3's checkpoint,
    twice in this process. Each run launches phase 3's ``want_counts`` and
    writes a trace of its own, which holds each of the block's CUDA kernels
    (its route's) and the head's as often as they launched. Returns the
    first run's launches."""
    from cfdbench_tpu_torch.cli import main_multistep
    from cfdbench_tpu_torch.ops.fno_kernels import launch_counts, reset_launch_counts

    want = {**{k: want_counts["fno_block"] for k in flagship_block_kernels()},
            **{k: want_counts["fno_head"] for k in flagship_head_kernels()}}
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    counts = []
    for _ in range(2):
        reset_launch_counts()
        main_multistep(fno_argv(WORK / "data", WORK / "result") + ["--profile_dir",
                                                                   str(PROFILE_DIR)])
        counts.append(launch_counts())
    files = sorted(PROFILE_DIR.iterdir())
    in_trace = [trace_kernel_counts(f) for f in files]
    print(f"[profile] main_multistep --profile_dir, twice in this process: launches {counts}, "
          f"traces {[f.name for f in files]} "
          f"({sum(f.stat().st_size for f in files) / 1e6:.1f} MB), CUDA kernels in them "
          f"{in_trace}")
    if counts != [want_counts] * 2 or in_trace != [want] * 2:
        raise RuntimeError(f"main_multistep --profile_dir: launches {counts}, traces "
                           f"{in_trace}; expected {want_counts} and {want} in each of two")
    return counts[0]


def vae_diagnostics(device):
    """Phase 16c: ``scripts/vae_diagnostics_torch.py`` on phase 10's VAE."""
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "vae_diagnostics_torch", ROOT / "scripts" / "vae_diagnostics_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = WORK / "vae_diagnostics"
    t0 = time.perf_counter()
    summary = script.main(["--data_name", "cavity_prop_bc_geo", "--data_dir",
                           str(WORK / "train_data"), "--ldm_vae_weights_path",
                           str(WORK / "vae_weights"), "--output_dir", str(out),
                           "--device", str(device)])
    stats = summary["per_dim_kl"] + [summary["latent_mean"], summary["latent_std"]]
    missing = [n for n in DIAGNOSTIC_FILES if not (out / n).exists()]
    with np.load(out / "diagnostics.npz") as arrays:
        stats += [float(np.abs(a).max()) for a in arrays.values()]
    print(f"[vae_diag] scripts/vae_diagnostics_torch.py on phase 10's VAE: "
          f"{time.perf_counter() - t0:.2f} s, per-dimension KL {summary['per_dim_kl']}, latent "
          f"mean {summary['latent_mean']:.6g}, std {summary['latent_std']:.6g}, embedding "
          f"{summary['embedding_method']}")
    if missing or not all(math.isfinite(v) for v in stats):
        raise RuntimeError(f"vae_diagnostics_torch.py: files missing {missing} or statistics "
                           f"not finite {summary}")


def wide_kernels(device, card) -> list:
    """Phase 17a: each kernel at WIDE_KERNEL_CASES against its plain
    version at phase 2's bounds (the block's saved outputs too), timed
    against it in turns beside its bound; the block split at WIDE_SPLIT
    (:func:`split_block`). Returns a record a kernel and shape."""
    from cfdbench_tpu_torch.ops import _build, fno_kernels as fk

    out = []
    for what, names, B, H, W, C, modes, n_out in WIDE_KERNEL_CASES:
        t = kernel_inputs(B, H, W, C, torch.Generator().manual_seed(SEED + 19), device, modes,
                          n_out)
        runs = {"fno_block": (fk.fno_block, fk.fno_block_reference, BLOCK_ATOL,
                              (t["x"], t["weights"], t["w0"], t["b0"], modes, modes),
                              block_work(B, H, W, C, C, modes)),
                "fno_head": (fk.fno_head, fk.fno_head_reference, HEAD_ATOL,
                             (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["mask"]),
                             head_work(B, H, W, C, t["w1"].shape[0], n_out))}
        for name in names:
            kern, ref, atol, args, work = runs[name]
            shape = f"{what}: B={B} {H}x{W} C={C} modes={modes} outputs={n_out}"
            with torch.inference_mode():
                got, want = kern(*args), ref(*args)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                print(f"[wide] {name} {shape}: max abs err {err:.3e} (bound {atol:.0e}), max "
                      f"rel err {err / want.abs().max().item():.3e}")
                if not (got.shape == want.shape and torch.isfinite(got).all() and err <= atol):
                    raise RuntimeError(f"{name} at {shape} disagrees with its plain version: "
                                       f"{err:.3e}")
                del got, want
                if name == "fno_block":
                    check_saved(args)
                p, k = interleaved_ms(lambda: ref(*args), lambda: kern(*args), reps=10)
            bound_ms, bound_by = bound(*work)
            print(f"[time] [{card}] {name} {shape}: kernel {k:.4f} ms, plain {p:.4f} ms "
                  f"({p / k:.2f}x); bound {bound_ms:.4f} ms by {bound_by}, kernel at "
                  f"{bound_ms / k:.1%} of it")
            out.append(dict(name=name, shape=shape, max_abs_err=err, ms=k, plain_ms=p,
                            bound_ms=bound_ms, bound_by=bound_by))
        del t
    record, _, _ = split_block(_build.load_library(), torch.cuda.current_stream().cuda_stream,
                               device, card, *WIDE_SPLIT)
    out.append(dict(name="fno_block", **record))
    return out


def wide_paths(device, card):
    """Phase 17b-c: ``main_auto --mode train_test`` then ``main_multistep``
    (:func:`train_path`) at ``--fno_hidden_dim WIDE`` on phase 6's tree and
    at the flagship's width on a synthetic WIDE_GRID x WIDE_GRID tree, each
    with the launches of the flagship's depth on its forwards; at WIDE a
    forward and a train step card against the CPU's plain path and a
    20-step b128 rollout's frames/s. Returns each path's launches and the
    rollout's times."""
    counts = {}
    flags = ["--fno_hidden_dim", str(WIDE)]
    counts["main_auto_h256"], _, counts["main_multistep_h256"] = train_path(
        result="wide_result", flags=flags)
    model = flagship_model(device, hidden_dim=WIDE)
    card_against_cpu(model, flagship_model("cpu", hidden_dim=WIDE), f"flagship at width {WIDE}",
                     SEED + 20)
    counts["rollout_h256"], times = rollout_timing(model, f"width {WIDE}", card, SEED + 21)
    del model
    counts["main_auto_512"], _, counts["main_multistep_512"] = train_path(
        WIDE_GRID, tree="wide_grid_data", result="wide_grid_result")
    return counts, times


def dev_rel(got_run: Path, want_run: Path) -> float:
    """The largest relative difference of two runs' dev scores."""
    worst = 0.0
    for ckpt_dir in sorted(want_run.glob("ckpt-*")):
        g, w = (json.loads((r / ckpt_dir.name / "dev_scores.json").read_text())["mean"]
                for r in (got_run, want_run))
        worst = max([worst] + [abs(g[k] - v) / abs(v) for k, v in w.items() if v])
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        return phases()
    finally:
        stop_ranks()


def phases() -> int:
    from cfdbench_tpu_torch.utils.device import require_cuda, set_numerics

    phase = PhaseClock()
    device = require_cuda()
    set_numerics()
    card = phase.card = host_facts()
    errors = check_kernels(device)
    phase.done("1-2 (card, kernels built and checked)")
    counts, features, case_params = main_path()
    compare_rollouts(device, features, case_params)
    times = timing(device, card)
    phase.done("3-5 (main_multistep, rollouts, timing)")
    check_gradients(device)
    train_counts, train_metrics, _ = train_path()
    train_step_timing(device, card)
    phase.done("6 (main_auto)")
    family = family_paths()
    family_card_vs_cpu(device)
    family_times = family_timing(device, card)
    print(f"[family] [{card}] " + json.dumps({"step20_nmse": family, "timing": family_times}))
    phase.done("7 (conv and point families)")
    phase8 = phase8_paths()
    phase8_card_vs_cpu(device)
    phase8_times = phase8_timing(device, card)
    print(f"[phase8] [{card}] " + json.dumps({"step20_nmse": phase8, "timing": phase8_times}))
    phase.done("8 (FFN, DeepONet, FFNO)")
    phase9 = phase9_paths()
    phase9_card_vs_cpu(device)
    phase9_times = {name: generative_timing(name, device, card) for name in GENERATIVE}
    print(f"[phase9] [{card}] " + json.dumps({"quality": phase9, "timing": phase9_times}))
    phase.done("9 (pixel diffusion, GenCast)")
    phase10 = phase10_paths()
    phase10_card_vs_cpu(device)
    phase10_times = phase10_timing(device, card)
    print(f"[phase10] [{card}] " + json.dumps({"quality": phase10, "timing": phase10_times}))
    phase.done("10 (VAE, latent models, DDPM)")
    serve_predict, serve_rollout = serving(device, card)
    phase.done("11a-c (serving)")
    serve_diffusion = serving_diffusion(card)
    phase.done("11d (serving the diffusion models)")
    mp_counts, bf16_counts = phase12_paths()
    phase12_card_vs_cpu(device)
    phase12_times = phase12_timing(device, card)
    print(f"[phase12] [{card}] " + json.dumps({"timing": phase12_times}))
    phase.done("12 (bfloat16, Adafactor)")
    tf32_times = tf32_kernels(device, card)
    tf32_counts = tf32_paths(train_counts, train_metrics)
    tf32_steps = tf32_step_timing(device, card)
    print(f"[phase12f] [{card}] " + json.dumps({"kernels": tf32_times, "launches": tf32_counts,
                                                "timing": tf32_steps}))
    phase.done(f"12f (--matmul_precision {TF32_PRECISION})")
    # Phase 13a's torchruns and 13b's ranks run beside 13b's one-process
    # runs; the kernels of 14a, 15a and 15d(a) are timed before 15c's ranks
    # start, which run on through 14b-c and 15b; 15c's one-process runs are
    # made while 14b's ranks run.
    t13 = time.perf_counter()
    torchruns = start_torchruns()
    two_ranks, dp_data, dp_single, controls = dp_two_ranks(device)
    dp_counts = {f"dp_torchrun_{k}": v
                 for k, v in dp_torchrun(train_counts, train_metrics, torchruns).items()}
    dp_counts.update(two_ranks)
    phase.done("13a-b (torchrun; two ranks, meanwhile)")
    dp_times = dp_step_timing(device, card)
    print(f"[phase13] [{card}] " + json.dumps({"timing": dp_times, "launches": dp_counts,
                                               "seconds": time.perf_counter() - t13}))
    phase.done("13c (collectives timed)")
    rank_times = rank_kernels(device, card)
    phase.done("14a (kernels at a rank's shapes)")
    sp_times = sp_kernels(device, card)
    phase.done("15a (kernels at a rank's rows)")
    padded_split = padded_split_kernels(device, card)
    for name, record in padded_split.items():
        sp_times[name].append(record)
    phase.done("15d(a) (kernels at the padded flagship's rows)")
    t15c = time.perf_counter()
    rest_started = start_spatial_rest(device, dp_data)
    t14 = time.perf_counter()
    tp_started = start_model_axis(device, dp_data)
    rest_refs = spatial_rest_references(device, dp_data, dp_single, rest_started)
    mp_counts_14, mp_bytes = model_axis_ranks(device, dp_single, controls, tp_started)
    dp_counts.update(mp_counts_14)
    print(f"[phase14] [{card}] " + json.dumps({"kernels_at_rank_shapes": rank_times,
                                               "bytes": mp_bytes, "launches": mp_counts_14,
                                               "seconds": time.perf_counter() - t14}))
    phase.done("14b-c (model axis; 15c's ranks and one-process runs meanwhile)")
    t15 = time.perf_counter()
    sp_counts, sp_mem, sp_want = spatial_ranks(device, card, dp_data, dp_single, controls)
    dp_counts.update(sp_counts)
    print(f"[phase15] [{card}] " + json.dumps({"kernels_at_rank_rows": sp_times,
                                               "memory": sp_mem, "launches": sp_counts,
                                               "seconds": time.perf_counter() - t15}))
    phase.done("15b (spatial sharding; 15c's ranks meanwhile)")
    rest_counts, rest_memory, rest = spatial_rest(device, card, rest_started, rest_refs)
    dp_counts.update(rest_counts)
    print(f"[phase15c] [{card}] " + json.dumps({"launches": rest_counts, "memory": rest_memory,
                                                "seconds": time.perf_counter() - t15c}))
    phase.done("15c (the rest of spatial sharding, after its ranks' start)")
    t15d = time.perf_counter()
    empty_counts, empty_memory = spatial_empty(device, card, dp_data, sp_want, controls, rest)
    dp_counts.update(empty_counts)
    print(f"[phase15d] [{card}] " + json.dumps({"kernels_at_padded_rows": padded_split,
                                                "launches": empty_counts,
                                                "memory": empty_memory,
                                                "seconds": time.perf_counter() - t15d}))
    phase.done(f"15d(b-c) ({SP_MESHES[1]}, the padded flagship, {SP_EMPTY_MESH} with empty "
               "ranks)")
    t16 = time.perf_counter()
    padded, padded_head_err = padded_kernels(device, card)
    padded_counts, padded_times = padded_paths(device, card)
    profiled_counts = profiled_multistep(counts)
    vae_diagnostics(device)
    print(f"[phase16] [{card}] " + json.dumps({"block_at_padded_grid": padded,
                                               "padded_rollout": padded_times,
                                               "seconds": time.perf_counter() - t16}))
    phase.done("16 (padded FNO, --profile_dir, VAE diagnostics)")
    t17 = time.perf_counter()
    wide = wide_kernels(device, card)
    wide_counts, wide_times = wide_paths(device, card)
    print(f"[phase17] [{card}] " + json.dumps({"kernels": wide, "launches": wide_counts,
                                               "rollout_h256": wide_times,
                                               "seconds": time.perf_counter() - t17}))
    phase.done("17 (width 256, a 512x512 grid, 32 modes, 9 outputs)")
    phase.total()
    print(f"[main] launches on the main paths: main_multistep {counts}, "
          f"main_auto {train_counts}, one served predict call {serve_predict}, one served "
          f"rollout {serve_rollout}, served diffusion {serve_diffusion}, "
          f"main_auto --use_mixed_precision {mp_counts}, "
          f"main_multistep --rollout_dtype bfloat16 {bf16_counts}, per rank under data, "
          f"tensor, pipeline and spatial parallelism {dp_counts}, the padded flagship's "
          f"rollout {padded_counts}, main_multistep --profile_dir {profiled_counts}, at width "
          f"{WIDE} and on a {WIDE_GRID}x{WIDE_GRID} grid {wide_counts}")
    replaces = {"fno_block": "cfdbench_tpu/ops/pallas_fno.py:179",
                "fno_head": "cfdbench_tpu/ops/pallas_fno.py:268"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"cfdbench_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": counts[name],
         "launches_by_path": {"main_multistep": counts[name], "main_auto": train_counts[name],
                              "serve_predict": serve_predict[name],
                              "serve_rollout": serve_rollout[name],
                              **{path: c[name] for path, c in serve_diffusion.items()},
                              "main_auto_mixed_precision": mp_counts[name],
                              "main_multistep_bf16": bf16_counts[name],
                              **{path: c[name] for path, c in dp_counts.items()},
                              "padded_rollout": padded_counts[name],
                              "main_multistep_profiled": profiled_counts[name],
                              **{path: c[name] for path, c in wide_counts.items()}},
         "max_abs_err": max([errors[name], padded["max_abs_err"] if name == "fno_block"
                             else padded_head_err]
                            + [t["max_abs_err"] for t in rank_times[name] + sp_times[name]]
                            + [t["max_abs_err"] for t in wide if t["name"] == name]),
         **times[name], "library_ms": None, "at_rank_shapes": rank_times[name],
         "at_rank_rows": sp_times[name],
         "at_wide_shapes": [t for t in wide if t["name"] == name],
         **({"at_padded_grid": padded} if name == "fno_block" else {})}
        for name in ("fno_block", "fno_head")
    ] + [
        {"name": f"{name}_tf32", "route": "cuda", "source": f"cfdbench_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": tf32_counts["main_multistep_high"][name],
         "launches_by_path": {path: c[name] for path, c in tf32_counts.items()},
         **tf32_times[name], "library_ms": None}
        for name in ("fno_block", "fno_head")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
