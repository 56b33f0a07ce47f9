"""One rank of a data-, tensor- or pipeline-parallel run of the port,
spawned by ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_trainers.py``, ``tests/test_torch_tp.py``,
``tests/test_torch_pp.py``, ``tests/test_torch_tp_trainers.py``,
``tests/test_torch_tp_trainers_cli.py``, ``tests/test_torch_sp.py``,
``tests/test_torch_sp_models.py`` and ``tests/test_torch_sp_latent.py``
(and importable without JAX, so that the spawned processes stay light).

:func:`run` joins a gloo group through a file under the test's temporary
directory (never a TCP port: several test workers run at once), runs the
job that the test saved beside it on the job's ``--mesh_shape`` (all
ranks on the data axis by default), and saves this rank's results.
"""

from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def host_step(case: dict, mesh):
    """One ``trainer_auto.train_step`` of ``case`` on ``mesh``'s block of its
    global batch; returns what the test compares: the loss dict, the
    parameters and gradients after the step, the buffers (BatchNorm's
    running statistics), and the train forward's output gathered over the
    ranks."""
    from cfdbench_tpu_torch.models import diffusion
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import train_step, use_mesh

    task = build_task(case)
    use_mesh(task, mesh)
    draws = case.get("draws")

    def fixed(key, shape, T, device):  # the global draws the test made
        assert tuple(shape) == tuple(draws["noise"].shape), (shape, draws["noise"].shape)
        return torch.from_numpy(draws["noise"]), torch.from_numpy(draws["t"])

    def masks(key, shapes, rate, device):
        assert [tuple(s) for s in shapes] == [m.shape for m in draws["masks"]]
        return [torch.from_numpy(m) for m in draws["masks"]]

    originals = diffusion.train_noise_and_t, diffusion.dropout_keep_masks
    if draws is not None:
        diffusion.train_noise_and_t, diffusion.dropout_keep_masks = fixed, masks
    outputs = []
    net = getattr(task.model, "unet", task.model)  # a latent model's noise predictor
    hook = net.register_forward_hook(lambda m, i, o: outputs.append(o.detach()))
    opt, sched = make_adam(task.model.parameters(), case["lr"], steps_per_epoch=10)
    dtype = case.get("dtype", torch.float32)
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in mesh.block(case["batch"]).items()}
    step_draws = case["key"] if "key" in case else task.step_draws(0, 0, "cpu")
    try:
        scores = train_step(task, opt, sched, batch, step_draws)
    finally:
        hook.remove()
        diffusion.train_noise_and_t, diffusion.dropout_keep_masks = originals
    return dict(scores={k: float(v) for k, v in scores.items()},
                params={k: p.detach().clone() for k, p in task.model.named_parameters()},
                grads={k: p.grad.clone() for k, p in task.model.named_parameters()},
                buffers={k: b.clone() for k, b in task.model.named_buffers()},
                output=mesh.gather(outputs[0].float()))


def split_step(case: dict, mesh):
    """``case["steps"]`` ``trainer_auto.train_step``s of ``case`` with its
    model split over ``mesh``'s model axis (``split_model``: tp, pp with
    ``case["pp"]`` microbatches, or with ``case["spatial"]`` spatial
    sharding, each model rank on its grid rows) on ``mesh``'s block of its
    global batch. Returns each step's scores, the first step's predictions
    (gathered over the data ranks and the rows) and gradients (in the
    one-process layout), the parameters and buffers after the last step
    (the model joined whole again), and this rank's parameter and
    optimizer-state bytes against the whole model's. ``case["dropout"]``
    sets the ResNet's dropout rate; ``case["draws"]`` are a diffusion task's
    global draws (:func:`fixed_draws`), whose train forward's noise
    prediction is the step's "predictions" (a latent model's on its
    latents' split, gathered)."""
    from cfdbench_tpu_torch.data.pipeline import field_rows
    from cfdbench_tpu_torch.models import resnet
    from cfdbench_tpu_torch.parallel.spatial import all_rows, gather_rows
    from cfdbench_tpu_torch.training.optim import make_adam
    from cfdbench_tpu_torch.training.trainer_auto import (
        join_model, split_model, train_step, trained_module, use_mesh)

    task = build_task(case)
    use_mesh(task, mesh)
    whole = sum(p.numel() for p in task.model.parameters())
    with rules_at(case):
        split_model(task, case.get("pp", 0), case.get("spatial", False))
    rows = task.rows
    trained = trained_module(task)
    split = getattr(task, "split", None)
    shards = {}
    if split is not None and split.pipeline is None:
        params = dict(task.model.named_parameters())
        shards = {params[n]: d for n, d in split.layout.axes.items() if d is not None}
    opt, sched = make_adam(trained.parameters(), case["lr"], steps_per_epoch=10,
                           opt_state=case.get("opt_state", "f32"), shards=shards,
                           axis=mesh.model)
    preds, scores, grads = [], [], None
    hook = None
    if getattr(task, "generative", False):  # a diffusion task's noise prediction
        net = getattr(task.model, "unet", task.model)
        hook = net.register_forward_hook(lambda m, i, o: preds.append(o.detach().clone()))
    else:
        real_scores = task.scores

        def scores_of(out, batch):
            preds.append(out.detach().clone())
            return real_scores(out, batch)

        task.scores = scores_of
    if case.get("perturb"):
        # Each model rank's gradient of each whole parameter off by its own
        # rank-dependent rounding, as a kernel whose sums run in no fixed
        # order leaves it on the card.
        whole = [p for n, p in task.model.named_parameters()
                 if split.layout.axes.get(n) is None]
        for p in whole:
            p.register_hook(lambda g: g + 1e-9 * (1 + mesh.model.rank))
    batch = {k: torch.from_numpy(v)
             for k, v in field_rows(mesh.block(case["batch"]), rows).items()}
    draws = injected(case["draws"]) if "draws" in case else contextlib.nullcontext()
    with patched([(resnet, "DROPOUT", case.get("dropout", resnet.DROPOUT))]), draws:
        for step in range(case.get("steps", 1)):
            draws = task.step_draws(0, step, "cpu")
            scores.append({k: float(v)
                           for k, v in train_step(task, opt, sched, batch, draws).items()})
            if grads is None:
                named = {n: p.grad for n, p in trained.named_parameters()}
                grads = named if split is None else split.layout.to_std(named)
    if hook is not None:
        hook.remove()
    local = sum(p.numel() for p in trained.parameters())
    opt_bytes = sum(t.numel() * t.element_size() for st in opt.state.values()
                    for t in st.values() if torch.is_tensor(t) and t.dim() > 0)
    latent = getattr(task, "latent_rows", lambda h: None)(batch["labels"].shape[1])
    with torch.no_grad():
        preds = mesh.gather(gather_rows(preds[0], rows) if latent is None
                            else all_rows(preds[0], latent))
    join_model(task)
    return dict(scores=scores, preds=preds, grads=grads,
                params={k: p.detach().clone() for k, p in task.model.named_parameters()},
                buffers={k: b.clone() for k, b in task.model.named_buffers()},
                local_params=local, whole_params=whole, opt_bytes=opt_bytes)


def spatial_ops(job: dict, mesh):
    """``parallel/spatial.py``'s exchanges on this model rank's rows of the
    job's global tensors, each forward and backward: :func:`halo` for each
    of ``job["halos"]`` ((k, replicate), upstream gradient
    ``job["halo_grads"][i][model rank]``), the real and the complex
    :func:`row_sum` of the rows' partial sums (upstream gradients
    ``job["sum_grads"][model rank]``) and :func:`gather_rows`; the block
    kernel's backward (``fno_block_vjp``) on the rank's rows of
    ``job["vjp"]``; then a ``split_step`` of each of ``job["cases"]``."""
    from cfdbench_tpu_torch.parallel import spatial

    axis = mesh.model
    x_whole = torch.from_numpy(job["x"])
    out = {"halos": [], "steps": {}}

    def rows():
        return spatial.take_rows(x_whole, axis).clone().requires_grad_(True)

    for i, (k, replicate) in enumerate(job["halos"]):
        x = rows()
        y = spatial.halo(x, k, axis, replicate)
        y.backward(torch.from_numpy(job["halo_grads"][i][axis.rank]))
        out["halos"].append((y.detach(), x.grad))
    x = rows()
    c = spatial.take_rows(torch.from_numpy(job["c"]), axis)
    real = spatial.row_sum((x * c).sum(1), axis)
    cplx = spatial.row_sum(torch.complex((x * c).sum(1), (x * x).sum(1)), axis)
    g = [torch.from_numpy(a) for a in job["sum_grads"][axis.rank]]
    ((real * g[0]).sum() + (cplx.real * g[1] + cplx.imag * g[2]).sum()).backward()
    out["sums"] = (real.detach(), cplx.detach(), x.grad)
    out["gathered"] = spatial.gather_rows(spatial.take_rows(x_whole, axis), axis)
    if "vjp" in job:
        from cfdbench_tpu_torch.ops import fno_kernels as fk

        v = {k: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for k, a in job["vjp"].items()}
        xm, pre = fk.fno_block_saved_reference(v["x"], v["weights"], v["w0"], v["b0"],
                                               v["modes"], v["modes"])
        out["vjp"] = fk.fno_block_vjp(
            spatial.take_rows(v["grad"], axis).contiguous(),
            spatial.take_rows(v["x"], axis).contiguous(), xm,
            spatial.take_rows(pre, axis).contiguous(), v["weights"], v["w0"], v["modes"],
            v["modes"], rows=axis)
    for name, case in job.get("cases", {}).items():
        out["steps"][name] = split_step(case, mesh)
    return out


def latent_rows_job(job: dict, mesh):
    """A latent model's pieces on this model rank's rows, each gathered:
    the frozen VAE's ``encode`` (mean, log-variance) of each of
    ``job["vae"]``'s fields and its ``decode`` of the case's global latents
    (``vae_rows``); a ``split_step`` of each of ``job["cases"]``; the frame
    that ``predict_frame`` generates for each of ``job["samples"]``."""
    return dict(vae={name: vae_rows(case, mesh) for name, case in job.get("vae", {}).items()},
                steps={name: split_step(case, mesh) for name, case in job.get("cases", {}).items()},
                frames={name: spatial_sample(case, mesh)
                        for name, case in job.get("samples", {}).items()})


def vae_rows(case: dict, mesh):
    """``(mean, logvar, decoded)``: the lite VAE (``make_task``'s) on this
    model rank's rows of ``case["x"]`` (padded as a latent model pads it)
    and of the latents ``case["z"]``, gathered over the rows and the data
    ranks."""
    from cfdbench_tpu_torch.models import diffusion, make_cfd_vae
    from cfdbench_tpu_torch.parallel.spatial import Rows, active, all_rows, take_rows

    vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(5))
    axis = mesh.model
    for m in vae.modules():
        if hasattr(m, "sp"):
            m.sp = axis
    x, z = (mesh.block(torch.from_numpy(case[k])) for k in ("x", "z"))
    rows = Rows.even(x.shape[1], axis) if active(axis) else None
    padded = diffusion.padded_rows(rows)
    latent = vae.latent_rows(padded)
    with torch.no_grad():
        post = vae.encode(diffusion.pad_field(take_rows(x, rows), rows), padded)
        out = vae.decode(take_rows(z, latent), latent)
        return tuple(mesh.gather(all_rows(a, r)) for a, r in (
            (post.mean, latent), (post.logvar, latent), (out, vae.decoded_rows(latent))))


def spatial_sample(case: dict, mesh):
    """A diffusion task's frame from the evaluation key on this rank's rows
    of its block of the global batch, the model split as ``main_auto``
    splits it (``split_model(spatial=True)``; whole without a model axis),
    the case's draws injected; gathered over the rows and the ranks."""
    from cfdbench_tpu_torch.data.pipeline import field_rows
    from cfdbench_tpu_torch.parallel.spatial import gather_rows
    from cfdbench_tpu_torch.training.trainer_auto import join_model, split_model, use_mesh

    task = build_task(case)
    use_mesh(task, mesh)
    with rules_at(case):
        split_model(task, 0, spatial=True)
    task.model.eval()
    task.num_inference_steps = case["inference_steps"]
    b = {k: torch.from_numpy(v) for k, v in field_rows(mesh.block(case["batch"]), task.rows).items()}
    with injected(case.get("draws")), torch.no_grad():
        frame = task.predict_frame(b["inputs"], b["case_params"], b["mask"])
        frame = mesh.gather(gather_rows(frame, task.rows))
    join_model(task)
    return frame


def host_sample(case: dict, mesh):
    """A diffusion task's frames on ``mesh``'s block of its global batch, as
    ``main_multistep`` generates them (the sampler's draws over the global
    batch), gathered over the ranks."""
    from cfdbench_tpu_torch.training.trainer_auto import use_mesh

    task = build_task(case)
    use_mesh(task, mesh)
    task.model.eval()
    task.num_inference_steps = case["inference_steps"]
    b = {k: torch.from_numpy(v) for k, v in mesh.block(case["batch"]).items()}
    if case["model"] == "gencast":
        out = task.generate(b["inputs"], b["inputs_prev"], b["case_params"], b["mask"])
    else:
        out = task.predict_frame(b["inputs"], b["case_params"], b["mask"])
    return mesh.gather(out.float())


def build_task(case: dict):
    """The case's task, its weights from ``case["state"]``; with
    ``case["four_groups"]`` its PUNetG's GroupNorms at four groups."""
    from cfdbench_tpu_torch.metrics import loss_name_to_fn

    groups = four_groups(vae=False) if case.get("four_groups") else contextlib.nullcontext()
    with groups:
        task = make_task(case["model"], case["widths"], loss_name_to_fn("nmse"),
                         case.get("compute_dtype"))
    task.model.load_state_dict(case["state"])
    if "dtype" in case:
        task.model.to(case["dtype"])
        if hasattr(task, "vae"):
            task.vae.to(case["dtype"])
    return task


def make_task(model: str, widths: dict, loss_fn=None, compute_dtype=None):
    """A task of ``model`` at ``widths``, initialised from fixed seeds."""
    from cfdbench_tpu_torch.models import diffusion, make_cfd_vae, point
    from cfdbench_tpu_torch.models.ffno import Ffno2d
    from cfdbench_tpu_torch.models.fno import Fno2d
    from cfdbench_tpu_torch.models.resnet import ResNet
    from cfdbench_tpu_torch.models.unet import UNet
    from cfdbench_tpu_torch.training.trainer_auto import AutoTask

    gen = torch.Generator().manual_seed(0)
    if model == "pixel":
        task = diffusion.PixelDiffusionCfdModel(loss_fn, 2, 5, generator=gen, **widths)
        task.compute_dtype = compute_dtype
        return task
    if model == "gencast":
        return diffusion.GenCastCfdModel(loss_fn, np.array(GENCAST_STATS[0], np.float32),
                                         np.array(GENCAST_STATS[1], np.float32),
                                         generator=gen, **widths)
    if model in LATENT_MODELS:
        vae = make_cfd_vae("lite", generator=torch.Generator().manual_seed(5))
        task = getattr(diffusion, LATENT_MODELS[model])(loss_fn, vae, generator=gen, **widths)
        task.compute_dtype = compute_dtype
        return task
    if model in POINT_MODELS:  # widths: the model's own arguments
        net = getattr(point, POINT_MODELS[model])(generator=gen, **widths)
        return AutoTask(net, loss_fn, compute_dtype=compute_dtype)
    cls = {"fno": Fno2d, "ffno": Ffno2d, "unet": UNet, "resnet": ResNet}[model]
    return AutoTask(cls(in_chan=2, out_chan=2, n_case_params=5, generator=gen, **widths),
                    loss_fn, compute_dtype=compute_dtype)


# "latent" is v2, the model of the data-parallel tests.
LATENT_MODELS = {"latent": "LatentDiffusionCfdModel2", "latent_v1": "LatentDiffusionCfdModel",
                 "latent_lite": "LatentDiffusionCfdModelLite"}
POINT_MODELS = {"auto_ffn": "AutoFfn", "auto_deeponet": "AutoDeepONet",
                "auto_edeeponet": "AutoEDeepONet", "auto_deeponet_cnn": "AutoDeepONetCnn"}


# GenCast's residual mean and standard deviation, per channel.
GENCAST_STATS = ((0.1, -0.2), (0.5, 2.0))


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def fixed_draws(draws: dict):
    """Replacements for the port's draw functions that return the global
    draws the test made, by key: ``noise_and_t[key] = (noise, t)``,
    ``masks[key]``, ``posterior[key]``, ``sampler[(key, index)]``."""
    def noise_and_t(key, shape, T, device):
        noise, t = draws["noise_and_t"][key]
        assert tuple(shape) == noise.shape, (shape, noise.shape)
        return torch.from_numpy(noise), torch.from_numpy(t)

    def masks(key, shapes, rate, device):
        got = draws["masks"][key]
        assert [tuple(s) for s in shapes] == [m.shape for m in got]
        return [torch.from_numpy(m) for m in got]

    def posterior(key, shape, device):
        noise = draws["posterior"][key]
        assert tuple(shape) == noise.shape, (shape, noise.shape)
        return torch.from_numpy(noise)

    def sampler(key, index, shape, device):
        noise = draws["sampler"][(key, index)]
        assert tuple(shape) == noise.shape, (shape, noise.shape)
        return torch.from_numpy(noise)

    return noise_and_t, masks, posterior, sampler


@contextlib.contextmanager
def patched(sites):
    """Each ``(module, name, value)`` of ``sites`` set within."""
    originals = [(m, name, getattr(m, name)) for m, name, _ in sites]
    for m, name, value in sites:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in originals:
            setattr(m, name, value)


def rules_at(case: dict):
    """The sharding rules' threshold (``sharding_rules.MIN_SIZE``) at the
    case's ``min_size`` within, so that narrow test models split; the
    rules' own without one."""
    from cfdbench_tpu_torch.parallel import sharding_rules

    return patched([(sharding_rules, "MIN_SIZE",
                     case.get("min_size", sharding_rules.MIN_SIZE))])


def injected(draws):
    """The port's draw functions replaced by :func:`fixed_draws` within."""
    from cfdbench_tpu_torch.models import diffusion, vae
    from cfdbench_tpu_torch.ops import diffusion as ops_diffusion
    from cfdbench_tpu_torch.training import trainer_uncond

    draws = draws or {}
    noise_and_t, masks, posterior, sampler = fixed_draws(draws)
    return patched([(ops_diffusion, "ddpm_noise", sampler if "sampler" in draws
                     else ops_diffusion.ddpm_noise),
                    (diffusion, "train_noise_and_t", noise_and_t),
                    (diffusion, "dropout_keep_masks", masks),
                    (trainer_uncond, "train_noise_and_t", noise_and_t),
                    (trainer_uncond, "dropout_keep_masks", masks),
                    (vae, "posterior_noise", posterior)])


def four_groups_for(groups: int, channels: int) -> int:
    """``num_groups_for`` at four groups, whatever ``groups`` asks."""
    from cfdbench_tpu_torch.models.common import num_groups_for

    return num_groups_for(4, channels)


def four_groups(vae: bool = True):
    """The PUNetG's and (``vae``) the VAE's GroupNorms at four groups while
    built, as the tests build both packages'
    (``test_torch_diffusion.four_groups``)."""
    from cfdbench_tpu_torch.models import punetg, vae as vae_module

    return patched([(punetg, "num_groups_for", four_groups_for)]
                   + ([(vae_module, "num_groups_for", four_groups_for)] if vae else []))


def trainer_net(case: dict):
    """``(network, what a step takes)`` of a trainer case, its weights from
    ``case["state"]``: a ``NonAutoTask``, a GenCast task, a VAE, or the
    unconditional PUNetG."""
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.metrics import loss_name_to_fn
    from cfdbench_tpu_torch.models import init_nonauto_model, make_cfd_vae
    from cfdbench_tpu_torch.training.trainer_nonauto import NonAutoTask

    model = case["model"]
    with four_groups():
        if model in ("ffn", "deeponet"):
            net = init_nonauto_model(Args.parse_args(case["flags"]), n_case_params=5)
            task = NonAutoTask(net, loss_name_to_fn("nmse"))
        elif model == "gencast":
            task = make_task("gencast", case["widths"], loss_name_to_fn("nmse"))
            net = task.model
        elif model == "vae":
            task = net = make_cfd_vae(**case["widths"], generator=torch.Generator())
        else:
            task = net = make_uncond_unet(case)
    net.load_state_dict(case["state"])
    return net, task


def make_uncond_unet(case: dict):
    from cfdbench_tpu_torch.training import trainer_uncond

    with four_groups():
        return trainer_uncond.make_unet(2, case["widths"]["base_channels"], 0, "cpu")


def trainer_step(case: dict, mesh):
    """A trainer's step of ``case`` on ``mesh``'s block of each of its
    global batches, the draws the test made injected: ``main_train``'s
    (``trainer_nonauto.train_step`` at the case's query points), GenCast's
    (micro-steps through ``GenCastAdamW``), the VAE's
    (``trainer_vae.train_step``) or the unconditional DDPM's
    (``trainer_uncond.train_step``, its EMA). With a model axis the
    PUNetG, the VAE and the EMA are split as their trainers split them
    (``trainer_auto.split_module`` at the case's ``min_size``; the FFN and
    the DeepONet stay whole, replicated). Returns the first step's scores,
    network output (gathered) and gradients (averaged over the ranks), the
    parameters after the last step, all in the one-process layout; each
    micro-step's GenCast norm; this rank's parameter and optimizer-state
    elements against the whole model's. With ``case["perturb"]`` each model
    rank's gradients of the whole parameters are off by its own rounding,
    and the optimizer's state comes back too (``moments``, one-process
    layout)."""
    from cfdbench_tpu_torch.training import (
        checkpoints, trainer_nonauto, trainer_uncond, trainer_vae)
    from cfdbench_tpu_torch.training.optim import make_adam, make_gencast_tx
    from cfdbench_tpu_torch.training.trainer_auto import split_module, use_mesh

    net, task = trainer_net(case)
    model = case["model"]
    whole = sum(p.numel() for p in net.parameters())
    split = ema = ema_split = None
    if model not in ("ffn", "deeponet"):
        with rules_at(case):
            split = split_module(net, mesh)
    params = dict(net.named_parameters())
    if case.get("perturb"):
        # Each model rank's gradient of each whole parameter off by its own
        # rank-dependent rounding (a few float32 ulps), as a kernel whose
        # sums run in no fixed order leaves it on the card.
        for n, p in params.items():
            if split is None or split.layout.axes.get(n) is None:
                p.register_hook(lambda g: g * (1 + 2.0 ** -20 * (1 + mesh.model.rank)))
    outputs, grads, scores, norms = [], [], [], []
    hooked = net.decoder if model == "vae" else net  # the VAE's reconstruction
    hook = hooked.register_forward_hook(lambda m, i, o: outputs.append(o.detach()))

    def std(named):
        return named if split is None else split.layout.to_std(named)

    def averaged_grads():
        # GenCast's optimizer averages a flat copy; the test reads the average.
        return std({k: mesh.sum(p.grad.clone()) / mesh.size for k, p in params.items()})

    if model in ("ffn", "deeponet", "gencast"):
        use_mesh(task, mesh)
    if model in ("ffn", "deeponet"):
        opt, sched = make_adam(net.parameters(), case["lr"], steps_per_epoch=10)
    elif model == "gencast":
        opt = make_gencast_tx(net.parameters(), case["lr"], total_steps=len(case["batches"]),
                              warmup_steps=1, weight_decay=case["weight_decay"],
                              grad_accum_steps=case["accum"], mesh=mesh, split=split)
    elif model == "vae":
        opt = trainer_vae.make_optimizer(net, case["lr"], 0.0)
    else:
        opt = torch.optim.AdamW(net.parameters(), case["lr"],
                                weight_decay=trainer_uncond.WEIGHT_DECAY)
        ema = make_uncond_unet(case)
        ema.load_state_dict(case["state"])
        with rules_at(case):
            ema_split = split_module(ema, mesh)
        sched = trainer_uncond.make_ddpm_scheduler(case["widths"]["timesteps"])
    try:
        with injected(case.get("draws")):
            for host, key in zip(case["batches"], case["keys"]):
                b = {k: torch.from_numpy(v) for k, v in mesh.block(host).items()}
                if model in ("ffn", "deeponet"):
                    s = trainer_nonauto.train_step(task, opt, sched, b, torch.from_numpy(key))
                    s = {k: float(v) for k, v in s.items()}
                    grads.append({k: p.grad.clone() for k, p in params.items()})
                elif model == "gencast":
                    opt.zero_grad(set_to_none=True)
                    loss, s = task.loss_scores(b, key)
                    loss.backward()
                    grads.append(averaged_grads())
                    opt.step()
                    norms.append(float(opt.grad_norm))
                    s = {k: v.item() for k, v in s.items()}
                elif model == "vae":
                    parts = trainer_vae.train_step(net, opt, b["frames"], b["weights"],
                                                   case["kl_weight"], key, mesh, split)
                    s = dict(zip(trainer_vae.PARTS, parts.tolist()))
                    grads.append(std({k: p.grad.clone() for k, p in params.items()}))
                else:
                    loss = trainer_uncond.train_step(net, ema, opt, sched, b["x"], b["weights"],
                                                     key, mesh, split)
                    s = dict(loss=float(loss))
                    grads.append(std({k: p.grad.clone() for k, p in params.items()}))
                scores.append(s)
    finally:
        hook.remove()
    opt_elems = sum(t.numel() for st in opt.state.values() for k, t in st.items()
                    if torch.is_tensor(t) and t.dim() > 0 and k != "acc")
    result = dict(scores=scores[0], grads=grads[0], output=mesh.gather(outputs[0].float()),
                  params=std({k: p.detach().clone() for k, p in params.items()}), norms=norms,
                  local_params=sum(p.numel() for p in net.parameters()), whole_params=whole,
                  opt_elems=opt_elems)
    if case.get("perturb"):
        result["moments"] = checkpoints.optimizer_to_std(
            opt, None if split is None else split.layout)["state"]
    if model == "uncond":
        named = {k: p.detach().clone() for k, p in ema.named_parameters()}
        result["ema"] = named if ema_split is None else ema_split.layout.to_std(named)
    return result


def gate(case: dict, mesh):
    """``GenCastAdamW`` on parameters whose gradients each rank sets to its
    own (``case["grads"][step][rank]``); the parameters after each step."""
    from cfdbench_tpu_torch.training.optim import make_gencast_tx

    params = [torch.nn.Parameter(torch.from_numpy(a)) for a in case["start"]]
    opt = make_gencast_tx(params, case["lr"], mesh=mesh, **case["kw"])
    history = []
    for per_rank in case["grads"]:
        for p, g in zip(params, per_rank[mesh.rank]):
            p.grad = torch.from_numpy(g)
        opt.step()
        history.append([p.detach().clone() for p in params])
    return history


def tp_gate(case: dict, mesh):
    """``GenCastAdamW`` on a stack of ``Dense`` layers split over
    ``mesh``'s model axis (``split_module`` at the case's ``min_size``):
    each step every rank sets, of the step's whole gradients
    (``case["grads"][step]``, alike on every data rank), its slice of each
    split parameter and the whole of the others. Returns the whole
    parameters after each step, each step's global norm and the
    optimizer's state in the one-process layout."""
    from cfdbench_tpu_torch.models.common import Dense
    from cfdbench_tpu_torch.training import checkpoints
    from cfdbench_tpu_torch.training.optim import make_gencast_tx
    from cfdbench_tpu_torch.training.trainer_auto import split_module

    net = torch.nn.Sequential(*(Dense(i, o, generator=torch.Generator().manual_seed(0))
                                for i, o in case["dims"]))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in case["start"].items()})
    with rules_at(case):
        split = split_module(net, mesh)
    opt = make_gencast_tx(net.parameters(), case["lr"], mesh=mesh, split=split, **case["kw"])
    history, norms = [], []
    for step_grads in case["grads"]:
        whole = {k: torch.from_numpy(v) for k, v in step_grads.items()}
        local = whole if split is None else split.layout.from_std(whole)
        for k, p in net.named_parameters():
            p.grad = local[k].clone()
        opt.step()
        norms.append(opt.grad_norm.item())
        named = {k: p.detach().clone() for k, p in net.named_parameters()}
        history.append(named if split is None else split.layout.to_std(named))
    std = checkpoints.optimizer_to_std(opt, None if split is None else split.layout)
    return dict(history=history, norms=norms, opt_state=std["state"][0])


def returned_state(out):
    """The trained weights an entry point returned: a task's model's, the
    VAE's best (a state dict), the unconditional DDPM's network's."""
    if isinstance(out, dict):
        return out
    model = out[0] if isinstance(out, tuple) else out.model
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_cli(calls, init_state, query_draws=None):
    """``(entry, argv)`` calls of the port's CLI on the CPU, in order; the
    autoregressive model starts from ``init_state`` when given (the JAX
    trainer's initial weights), and ``main_train`` takes global step s's
    query points from ``query_draws[s]`` when given (the JAX trainer's).
    Returns main_multistep's frames, and each other call's trained weights
    and printed output."""
    from cfdbench_tpu_torch import cli
    from cfdbench_tpu_torch.models import init_auto_model
    from cfdbench_tpu_torch.training import trainer_nonauto

    if query_draws is not None:
        def sample_query_idxs(seed, step, k, height, width):
            assert query_draws[step].shape == (k, 2)
            return torch.from_numpy(query_draws[step])

        trainer_nonauto.sample_query_idxs = sample_query_idxs

    if init_state is not None:
        def init_from(*args, **kwargs):
            model = init_auto_model(*args, **kwargs)
            model.load_state_dict(init_state)
            return model

        cli.init_auto_model = init_from
    frames, states, printed = [], [], []
    for entry, argv in calls:
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            out = getattr(cli, entry)(argv, device="cpu")
        printed.append(tee.getvalue())
        if entry == "main_multistep":
            frames.append(out)
        else:
            states.append(returned_state(out))
    return dict(frames=frames, states=states, printed=printed)


def run(rank: int, world: int, root: str) -> None:
    """Rank ``rank`` of ``world``: the job in ``root/job.pt``, its results
    to ``root/rank{rank}.pt``."""
    from cfdbench_tpu_torch.parallel.mesh import make_mesh

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / 'rendezvous'}",
                            rank=rank, world_size=world)
    try:
        job = torch.load(root / "job.pt", weights_only=False)
        mesh = make_mesh(job.get("mesh", str(world)), dist.group.WORLD)
        if job["kind"] == "split_steps":
            result = {name: split_step(case, mesh) for name, case in job["cases"].items()}
        elif job["kind"] == "spatial_ops":
            result = spatial_ops(job, mesh)
        elif job["kind"] == "latent_rows":
            result = latent_rows_job(job, mesh)
        elif job["kind"] == "steps":
            result = {name: host_step(case, mesh) for name, case in job["cases"].items()}
            result["samples"] = {name: host_sample(case, mesh)
                                 for name, case in job["samples"].items()}
        elif job["kind"] == "trainer_steps":
            result = {name: trainer_step(case, mesh) for name, case in job["cases"].items()}
            if "gate" in job:
                result["gate"] = gate(job["gate"], mesh)
            if "tp_gate" in job:
                result["tp_gate"] = tp_gate(job["tp_gate"], mesh)
        else:
            # Module constants the test sets, each (module, name, value): the
            # sharding rules' threshold for narrow test models, the DDPM's
            # sampling interval, the PUNetG's group count (four_groups_for).
            import importlib

            for module, name, value in job.get("constants", ()):
                setattr(importlib.import_module(module), name, value)
            result = run_cli(job["calls"], job.get("init_state"), job.get("query_draws"))
        torch.save(result, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(job: dict, root: Path, world: int = 2):
    """Run ``job`` on ``world`` spawned ranks; returns each rank's results."""
    return start(job, root, world)()


def start(job: dict, root: Path, world: int = 2):
    """Start ``job`` on ``world`` spawned ranks; returns a function that
    waits for them and returns each rank's results."""
    import torch.multiprocessing as mp

    root.mkdir(parents=True, exist_ok=True)
    torch.save(job, root / "job.pt")
    ranks = mp.spawn(run, args=(world, str(root)), nprocs=world, join=False)

    def results():
        while not ranks.join():
            pass
        return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]

    return results


def global_batch(rng: np.random.Generator, B: int, H: int = 16, W: int = 16,
                 valid: int = None) -> dict:
    """A seeded global batch of ``B`` rows, the last ``B - valid`` of them
    zero padding with weight 0, as ``data/pipeline.py`` pads."""
    valid = B if valid is None else valid
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.2).astype(np.float32)
    batch = dict(inputs=rng.standard_normal((B, H, W, 2)),
                 labels=rng.standard_normal((B, H, W, 2)),
                 mask=mask, case_params=rng.standard_normal((B, 5)))
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    for v in batch.values():
        v[valid:] = 0
    batch["weights"] = (np.arange(B) < valid).astype(np.float32)
    return batch
