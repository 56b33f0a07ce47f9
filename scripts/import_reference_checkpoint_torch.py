#!/usr/bin/env python
"""Convert a reference CFDBench checkpoint (``model.pt``) into the port's
checkpoint layout (port of ``scripts/import_reference_checkpoint.py``).

The reference saves ``model.state_dict()`` per eval into
``result/.../ckpt-{ep}/model.pt`` (``src/train_auto.py:294-301``). This
tool relays those weights out for the port
(``cfdbench_tpu_torch/utils/torch_import.py``), checks every key and
shape against a freshly built port model, and writes a ``ckpt-{ep}/``
directory (``model.pt`` and ``scores.json``) into the port's result tree,
so ``main_multistep`` and ``scripts/export_model_torch.py`` pick it up as
a checkpoint the port trained:

    python scripts/import_reference_checkpoint_torch.py \\
        --torch_ckpt /ref/result/auto/cavity_prop_bc_geo/dt0.1/fno/.../ckpt-40/model.pt \\
        --model fno --data_name cavity_prop_bc_geo --output_dir result
    python test_multistep_torch.py --model fno --data_name cavity_prop_bc_geo ...

The model flags must match the reference run; a mismatch fails and names
each key. A ``scores.json`` beside the ``model.pt`` is copied (the
reference's dev loss ranks the checkpoint); without one, a stub with
``dev_loss=0.0`` is written so the imported checkpoint is the best,
unless the result directory already holds scored checkpoints (then
``--force``). The point models' sizes follow ``--num_rows``/``--num_cols``.
Runs on the host; no card is needed.
"""

from __future__ import annotations

import argparse
import re
import shutil
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import torch  # noqa: E402


def template_state_dict(args):
    """A freshly built port model's ``state_dict``, which the imported
    weights must match key for key and shape for shape."""
    from cfdbench_tpu_torch.models import NONAUTO_MODELS, init_auto_model, init_nonauto_model

    if args.model in NONAUTO_MODELS:
        return init_nonauto_model(args).state_dict()
    return init_auto_model(args).state_dict()


def main(argv=None) -> Path:
    """Import the checkpoint; returns the ``ckpt-{ep}`` directory written."""
    from cfdbench_tpu_torch.cli import run_dir
    from cfdbench_tpu_torch.config import Args
    from cfdbench_tpu_torch.training import checkpoints
    from cfdbench_tpu_torch.utils.torch_import import import_state_dict, verify_state_dict

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--torch_ckpt", required=True, help="path to a reference-written model.pt")
    pre.add_argument("--as_epoch", type=int, default=None,
                     help="epoch number of the ckpt dir (default: parsed from the source "
                          "ckpt-N dir, else 0)")
    pre.add_argument("--force", action="store_true",
                     help="write the dev_loss=0.0 stub scores.json even where the result "
                          "dir already holds scored checkpoints (the stub would beat them "
                          "all in best-checkpoint selection)")
    ns, rest = pre.parse_known_args(argv)
    args = Args.parse_args(rest)

    src = Path(ns.torch_ckpt)
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise SystemExit(f"{src} is not a flat state dict (got {type(sd).__name__}); "
                         "pass the reference's ckpt-*/model.pt")
    imported = import_state_dict(args.model, sd)
    verify_state_dict(imported, template_state_dict(args))

    ep = ns.as_epoch
    if ep is None:
        m = re.match(r"ckpt-(\d+)$", src.parent.name)
        ep = int(m.group(1)) if m else 0
    out_root = run_dir(args)
    ckpt_dir = out_root / f"ckpt-{ep}"
    # The guard runs before any write: a refused import leaves the
    # target untouched.
    src_scores = src.parent / "scores.json"
    if not src_scores.exists():
        others = [p for p in out_root.glob("ckpt-*/scores.json") if p.parent != ckpt_dir]
        if others and not ns.force:
            raise SystemExit(
                f"{out_root} already holds {len(others)} checkpoint(s) with a scores.json; a "
                "dev_loss=0.0 stub for the imported checkpoint would beat all of them in "
                "best-checkpoint selection. Re-run with --force to write the stub anyway, "
                "or import into a fresh --output_dir.")
    if src_scores.exists():
        checkpoints.save_params(imported, ckpt_dir)
        shutil.copy(src_scores, ckpt_dir / "scores.json")
        print("copied the reference's scores.json (its dev loss ranks the checkpoint)")
    else:
        checkpoints.save_checkpoint(imported, ckpt_dir, ep=ep, dev_loss=0.0)
        print("no scores.json beside the source; wrote a dev_loss=0.0 stub, so this "
              "checkpoint is the best")
    n = sum(v.numel() for k, v in imported.items() if not k.endswith("num_batches_tracked"))
    print(f"imported {src} -> {ckpt_dir} ({n:,} weights, verified)")
    return ckpt_dir


if __name__ == "__main__":
    main()
