"""Pipeline parallelism (pp) of the FNO: GPipe microbatches over a mesh's
model axis (port of ``cfdbench_tpu/parallel/pipeline.py``).

The JAX package runs one SPMD program: ``shard_map`` over the mesh, one
``lax.scan`` of ``n_micro + S - 1`` ticks in which every device applies its
stage and ``ppermute``s the activation on, the lift on stage 0 and the head
on stage S-1, and ``jax.grad`` through the scan for the backward. Here each
model rank is one stage and the schedule is explicit:

- the forward runs the same ``n_micro + S - 1`` ticks: at tick t stage s
  takes microbatch ``t - s`` (stage 0 lifts it from the batch, the others
  take what the previous stage sent at tick t-1), runs its ``L/S`` blocks
  (the model's ``FnoBlock``s: the block kernel on the card) and, on the
  last stage, the head (the head kernel); each stage keeps its
  microbatches' autograd graphs;
- the last stage's predictions are summed over the model ranks (zeros on
  the others), so every rank computes the same loss on them;
- the backward runs the ticks in reverse: stage s backpropagates
  microbatch ``u - s`` at reverse tick u from the gradient of its output
  (the loss's, on the last stage; the next stage's input gradient, sent at
  reverse tick u+1, on the others), accumulating its parameters' gradients.

With a compute dtype (``--use_mixed_precision``) a step runs its stage on
bfloat16 copies of the stage's float32 parameters, cast once a step
(``models/common.py::cast_call``'s cast), the blocks and the head on their
plain versions; the gradients come back through the casts to the float32
parameters.

Parameters: each stage holds its own blocks (and the optimizer their
moments); the lift and the head are replicated, computed on one stage
only, and their gradients must be summed over the model ranks
(:attr:`PipelineStage.summed`) before the data average. On disk the state
is the one-process layout: :meth:`PipelineStage.to_std` and
:meth:`~PipelineStage.from_std`, the stacked ``(S, L/S, ...)`` stage layout
of :func:`pp_pack_params` in between, are the JAX package's
``pp_state_to_std`` and ``pp_state_from_std``, which
``training/checkpoints.py`` applies to the parameters and to each of
their optimizer moments.

Transport: a stage-to-stage send is an all-reduce, over the model ranks,
of a buffer with a slot per stage, each rank writing the slot of its
receiver: gloo has no send or all-gather of CUDA tensors (it all-reduces
them through host memory), NCCL all-reduces on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

BLOCK_KEYS = ("weights", "w0.weight", "w0.bias")  # an FnoBlock's parameters
PARTS = (("lift", "fc0"), ("fc1", "fc1"), ("fc2", "fc2"))  # packed part, module name


def _check(num_layers: int, n_stages: int) -> int:
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} blocks cannot split into {n_stages} equal stages")
    return num_layers // n_stages


def stack_stage_params(state: Dict[str, torch.Tensor], n_stages: int, num_layers: int):
    """An FNO state dict → ``(stages, lift, fc1, fc2)``: ``stages`` maps each
    block parameter to its ``(n_stages, L/S, ...)`` stack over the blocks,
    the others map ``weight``/``bias`` to the lift's and the head's."""
    per = _check(num_layers, n_stages)
    stages = {k: torch.stack([torch.stack([state[f"blocks.{s * per + j}.{k}"]
                                           for j in range(per)]) for s in range(n_stages)])
              for k in BLOCK_KEYS}
    return (stages, *({k: state[f"{name}.{k}"] for k in ("weight", "bias")}
                      for _, name in PARTS))


def pp_pack_params(state: Dict[str, torch.Tensor], n_stages: int, num_layers: int) -> dict:
    """The one-process FNO state dict → the pp layout ``dict(stages, lift,
    fc1, fc2)`` of the JAX package's ``pp_pack_params``."""
    stages, lift, fc1, fc2 = stack_stage_params(state, n_stages, num_layers)
    return dict(stages=stages, lift=lift, fc1=fc1, fc2=fc2)


def pp_unpack_params(packed: dict, num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pp_pack_params`: the one-process state dict."""
    stages = packed["stages"]
    S = stages["weights"].shape[0]
    per = num_layers // S
    out = {f"fc0.{k}": v for k, v in packed["lift"].items()}
    for i in range(num_layers):
        for k in BLOCK_KEYS:
            out[f"blocks.{i}.{k}"] = stages[k][i // per, i % per]
    for part in ("fc1", "fc2"):
        out.update({f"{part}.{k}": v for k, v in packed[part].items()})
    return out


def _exchange(x: Optional[torch.Tensor], slot: int, like: torch.Tensor, axis) -> torch.Tensor:
    """A buffer of a slot shaped as ``like`` for each stage, this stage's
    ``x`` (None: nothing) in ``slot`` (out of range: nowhere), summed over
    the model ranks."""
    buf = like.new_zeros((axis.size,) + tuple(like.shape))
    if x is not None and 0 <= slot < axis.size:
        buf[slot].copy_(x)
    dist.all_reduce(buf, group=axis.group)
    return buf


def _shift(x: Optional[torch.Tensor], like: torch.Tensor, step: int, axis) -> torch.Tensor:
    """Each stage's ``x`` sent to stage ``rank + step``; returns what this
    stage received (zeros where no one sent)."""
    return _exchange(x, axis.rank + step, like, axis)[axis.rank]


class PipelineStage(nn.Module):
    """Stage ``axis.rank`` of ``axis.size`` of an FNO ``model``: its lift
    (``fc0``), its ``L/S`` blocks and its head (``fc1``, ``fc2``), the
    model's own modules. ``lift(fc0, inputs, case_params, mask)`` and
    ``head(fc1, fc2, x, mask, tf32)`` are the FNO's (``models/fno.py``);
    the head runs in the model's TF32 mode, the blocks in their own.

    The model's other blocks give up their storage (:meth:`release`) and
    get it back from their stages for an evaluation or a checkpoint
    (:meth:`fill`)."""

    def __init__(self, model: nn.Module, axis, n_micro: int, lift: Callable, head: Callable):
        super().__init__()
        if getattr(model, "padding", None) is not None:
            raise NotImplementedError(
                f"pipeline parallelism of an Fno2d with padding {model.padding}: the stages "
                "run the unpadded grid, as the JAX pipeline asserts "
                "(cfdbench_tpu/parallel/pipeline.py:192; ROADMAP.md C)")
        self.S, self.s, self.axis, self.n_micro = axis.size, axis.rank, axis, n_micro
        L = len(model.blocks)
        self.per = _check(L, self.S)
        self.fc0 = model.fc0
        self.blocks = nn.ModuleList(model.blocks[self.s * self.per:(self.s + 1) * self.per])
        self.fc1, self.fc2 = model.fc1, model.fc2
        self.num_layers, self.width = L, model.fc1.weight.shape[1]
        self._lift, self._head, self.tf32 = lift, head, model.tf32
        self.local_names: List[str] = [n for n, _ in self.named_parameters()]
        self.std_names: List[str] = [n for n, _ in model.named_parameters()]
        # Replicated, computed on one stage: their gradients are summed over the model ranks.
        self.summed = [p for n, p in self.named_parameters() if not n.startswith("blocks.")]

    def std_name(self, name: str) -> str:
        if name.startswith("blocks."):
            _, j, rest = name.split(".", 2)
            return f"blocks.{self.s * self.per + int(j)}.{rest}"
        return name

    # --- the one-process layout -------------------------------------------

    def to_std(self, local: Dict[str, torch.Tensor], axes=None) -> Dict[str, torch.Tensor]:
        """This stage's tensors of each of its parameters (its state dict,
        or an optimizer moment of each) → those of the one-process model,
        on every stage: each stage's blocks placed in the ``(S, L/S, ...)``
        stacks, which are summed over the model ranks, then unpacked."""
        stages = {}
        for k in BLOCK_KEYS:
            mine = torch.stack([local[f"blocks.{j}.{k}"] for j in range(self.per)])
            stages[k] = _exchange(mine, self.s, mine, self.axis)
        packed = dict(stages=stages, **{part: {k: local[f"{name}.{k}"] for k in ("weight", "bias")}
                                        for part, name in PARTS})
        return pp_unpack_params(packed, self.num_layers)

    def shard_axis(self, name: str) -> None:
        """No tensor of a stage is a slice along an axis (its blocks are
        whole, the others replicated)."""
        return None

    def from_std(self, std: Dict[str, torch.Tensor], axes=None) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`to_std`, without a collective: this stage's
        slice of the packed layout."""
        packed = pp_pack_params(std, self.S, self.num_layers)
        out = {f"{name}.{k}": packed[part][k] for part, name in PARTS for k in ("weight", "bias")}
        for j in range(self.per):
            out.update({f"blocks.{j}.{k}": packed["stages"][k][self.s, j] for k in BLOCK_KEYS})
        return out

    def fill(self, model: nn.Module) -> None:
        """Give ``model``'s blocks of the other stages their current values
        from their stages (a collective over the model ranks)."""
        std = self.to_std(dict(self.named_parameters()))
        mine = {self.std_name(n) for n in self.local_names}
        for n, p in model.named_parameters():
            if n not in mine:
                p.data = std[n].detach().clone()

    def release(self, model: nn.Module) -> None:
        """Free the storage of ``model``'s blocks of the other stages."""
        mine = {self.std_name(n) for n in self.local_names}
        for n, p in model.named_parameters():
            if n not in mine:
                p.data = p.data.new_empty(0)

    # --- the GPipe schedule ------------------------------------------------

    def forward(self, x, inputs, case_params, mask, i: int, mb: int):
        """Microbatch ``i`` through this stage: the lift on stage 0 (``x``
        None), the blocks, the head on the last stage."""
        rows = slice(i * mb, (i + 1) * mb)
        if x is None:
            x = self._lift(self.fc0, inputs[rows], case_params[rows], mask[rows])
        for block in self.blocks:
            x = block(x)
        if self.s == self.S - 1:
            x = self._head(self.fc1, self.fc2, x, mask[rows], self.tf32)
        return x

    def forward_backward(self, inputs, case_params, mask,
                         loss_of: Callable[[torch.Tensor], tuple],
                         dtype: Optional[torch.dtype] = None):
        """One GPipe step on this rank's rows: ``(loss, scores)`` of
        ``loss_of(preds)`` on the predictions (the same on every stage),
        and every parameter's gradient accumulated (lift and head on their
        stage only, zero elsewhere). With ``dtype`` the stage runs on copies
        of its parameters cast to it, the inputs cast too. The rows must
        split into ``n_micro`` microbatches."""
        B, H, W = inputs.shape[:3]
        K, S, s = self.n_micro, self.S, self.s
        if B % K:
            raise ValueError(f"{B} rows do not split into {K} microbatches")
        mb = B // K
        run = self
        if dtype is not None:
            inputs, case_params, mask = (a.to(dtype) for a in (inputs, case_params, mask))
            with torch.enable_grad():
                cast = {n: p.to(dtype) for n, p in self.named_parameters()}

            def run(*args):
                return torch.func.functional_call(self, cast, args)
        act = inputs.new_zeros((mb, H, W, self.width))
        saved = {}
        recv = None
        outs = []
        for t in range(K + S - 1):
            i = t - s
            out = None
            if 0 <= i < K:
                with torch.enable_grad():
                    leaf = None if s == 0 else recv.detach().requires_grad_()
                    out = run(leaf, inputs, case_params, mask, i, mb)
                saved[i] = (leaf, out)
                if s == S - 1:
                    outs.append(out.detach())
            if t < K + S - 2:  # the last stage sends nowhere
                recv = _shift(None if out is None else out.detach(), act, 1, self.axis)
        n_out = self.fc2.weight.shape[0]
        preds = torch.cat(outs) if s == S - 1 else inputs.new_zeros((B, H, W, n_out))
        dist.all_reduce(preds, group=self.axis.group)
        preds.requires_grad_()
        with torch.enable_grad():
            loss, scores = loss_of(preds)
            loss.backward()
        dpreds = preds.grad
        grad_recv = None
        for u in reversed(range(K + S - 1)):
            i = u - s
            send = None
            if 0 <= i < K:
                leaf, out = saved.pop(i)
                g = dpreds[i * mb:(i + 1) * mb] if s == S - 1 else grad_recv
                torch.autograd.backward(out, g)
                send = None if leaf is None else leaf.grad
            if u > 0:
                grad_recv = _shift(send, act, -1, self.axis)
        return loss.detach(), scores
