"""KITTI eval-parity harness of the port (the root ``eval_parity.py``):

    python -m depthestimation_tpu_torch.eval_parity --config C
        [--ckpt DIR] [--limit N] [--synthetic] [--device cuda|cpu]

Evaluates ``{exp}_model_best`` (from ``--ckpt``, default
``outputs/checkpoints/{exp}``) over the validation split at batch 1: one
eval forward a frame with the quarter-resolution ``prev_output`` carry,
reset at each trajectory's first frame (``DefaultTrainer._eval_frame``,
the validation's own frame, with one pass and no LC). Prints the JSON table of the JAX
harness: all nine KITTI devkit metrics of the low-res and the refined
depth (``{name: [mean, min, max]}``) and the UF error, over ``frames``
frames. The per-frame metrics stay on the card until the table is built.

It runs on the card unless ``--device cpu`` (or ``main(argv,
device="cpu")``) asks for the CPU. Unlike the JAX harness, a checkpoint
that exists but does not load raises (JAX evaluates random weights with a
warning); with no checkpoint it warns and evaluates the seeded weights,
as JAX does. A JAX (orbax) checkpoint is converted first by
``tools/jax_checkpoint_to_torch.py``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (defaults to the experiment's)")
    ap.add_argument("--limit", type=int, default=0,
                    help="evaluate at most N frames (0 = all)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Print and return the metric table."""
    args = parse_args(argv)
    device = args.device or device

    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.ops import metrics as metrics_ops
    from depthestimation_tpu_torch.train import build_loaders
    from depthestimation_tpu_torch.trainer import checkpoint as ckpt
    from depthestimation_tpu_torch.trainer.default import DefaultTrainer
    from depthestimation_tpu_torch.utils.logger import init_logger

    cfg = load_config(args.config)
    cfg["eval"] = True
    cfg.train.batch_size = 1

    model = get_model(cfg, device, seed=int(cfg.get("seed", 0)))
    _, val_loader = build_loaders(cfg, args.synthetic)
    logger = init_logger("eval_parity")
    exp = cfg.data.exp_name
    save_root = args.ckpt or f"outputs/checkpoints/{exp}"
    trainer = DefaultTrainer(0, model, get_loss(cfg), logger, save_root,
                             cfg, val_loader=val_loader)
    trainer.ensure_state()
    if ckpt.checkpoint_exists(save_root, exp, best=True):
        trainer.resume(best=True)
        logger.info(0, "Loaded best checkpoint")
    else:
        logger.info(0, "WARNING: no checkpoint found — evaluating random "
                       "init")

    errors = ([], [], [])
    n = 0
    for batch in val_loader.enumerate():
        if not batch.get("is_valid", True):
            continue
        trainer._eval_frame(batch, errors, recurse=1, lc=False)
        n += 1
        if args.limit and n >= args.limit:
            val_loader.stop()
            break

    def rows(xs):
        return torch.cat(xs) if xs else torch.zeros(0, 9)

    unc = rows(errors[2]).detach().cpu().double().numpy()
    table = {
        "frames": n,
        "low_res": metrics_ops.eval_errors(rows(errors[0])),
        "refined": metrics_ops.eval_errors(rows(errors[1])),
        "rmse_unc": float(np.nanmean(unc)) if unc.size else float("nan"),
    }
    print(json.dumps(table, indent=2))
    return table


if __name__ == "__main__":
    main()
