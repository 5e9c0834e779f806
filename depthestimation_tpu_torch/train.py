"""Training / eval entry point of the port, the root ``train.py``'s flags:

    python -m depthestimation_tpu_torch.train --config configs/test_tiny.json
        [-b N] [--eval] [--viz] [--lc] [--lc_debug] [--resume]
        [--init_model PATH] [--write_video PATH] [--synthetic]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU
(there is no device flag and no fallback). Checkpoints and the
``{exp}.json`` results go under ``outputs/checkpoints/{exp}`` in the
working directory. With ``--synthetic``, or when ``data.dataset_path`` is
not a directory, it trains on ``SyntheticStereoVideoDataset``; the real
KITTI / ILIM loaders are not ported yet (ROADMAP.md, queue 1: "Real-data
loaders"). Single process: DDP waits for queue 1's "Multi-GPU".
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--viz", action="store_true")
    p.add_argument("--lc", action="store_true")
    p.add_argument("--lc_debug", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_model", type=str, default=None)
    p.add_argument("--write_video", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no KITTI on disk)")
    return p.parse_args(argv)


def build_loaders(cfg, use_synthetic: bool):
    """(train, val) ``BatchScheduler``s of synthetic video (train: max(2B,
    4) trajectories of 4 frames, seed 1; val: B of 2 frames, seed 2), as
    the JAX CLI builds them."""
    from depthestimation_tpu_torch.data.scheduler import BatchScheduler
    bs = int(cfg.train.batch_size)
    if not (use_synthetic or not os.path.isdir(cfg.data.dataset_path)):
        raise NotImplementedError(
            f"the real-data loaders ({cfg.data.dataset_path}) are not ported "
            "yet (ROADMAP.md, queue 1: \"Real-data loaders\"); pass "
            "--synthetic")
    from depthestimation_tpu_torch.data.video_synthetic import (
        SyntheticStereoVideoDataset)
    w, h = cfg.var.crop_w, cfg.var.img_size[1]
    common = dict(h=h, w=w, t_win=cfg.var.t_win, d_min=cfg.var.d_min,
                  d_max=cfg.var.d_max, ndepth=cfg.var.ndepth,
                  qpower=cfg.var.qpower)
    train_ds = SyntheticStereoVideoDataset(n_traj=max(bs * 2, 4),
                                           traj_len=4, seed=1, **common)
    val_ds = SyntheticStereoVideoDataset(n_traj=bs, traj_len=2, seed=2,
                                         **common)
    qmax = int(cfg.train.get("qmax", 4))
    # cfg.var.mload: a spawned loader process; synthetic data asked for by
    # --synthetic is cheap enough to stay in-process
    mload = bool(cfg.var.get("mload", False)) and not use_synthetic
    return (BatchScheduler(train_ds, bs, shuffle=True, qmax=qmax,
                           mload=mload),
            BatchScheduler(val_ds, bs, shuffle=False, qmax=qmax,
                           mload=mload))


def main(argv=None, device="cuda"):
    """Train (or with ``--eval`` validate ``_model_best`` at batch 1) and
    return the trainer."""
    args = parse_args(argv)
    from depthestimation_tpu_torch.config import load_config
    cfg = load_config(args.config)

    # flag overrides (the reference's train.py)
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
    cfg.lc.enabled = bool(args.lc)
    cfg["eval"] = bool(args.eval)
    cfg.var.viz = bool(args.viz)
    if args.eval:
        cfg.train.batch_size = 1

    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

    save_root = os.path.join("outputs", "checkpoints", cfg.data.exp_name)
    os.makedirs(save_root, exist_ok=True)

    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.trainer import checkpoint as ckpt
    from depthestimation_tpu_torch.trainer.factory import get_trainer
    from depthestimation_tpu_torch.utils.logger import init_logger

    logger = init_logger(cfg.data.exp_name, save_root)
    model = get_model(cfg, device, seed=int(cfg.seed))
    train_loader, val_loader = build_loaders(cfg, args.synthetic)
    trainer = get_trainer(cfg)(0, model, get_loss(cfg), logger, save_root,
                               cfg, train_loader, val_loader)

    # the torch model holds its weights already: JAX's CLI builds its state
    # from the first validation batch, the port needs none
    trainer.ensure_state()

    if args.resume and ckpt.checkpoint_exists(save_root, cfg.data.exp_name):
        trainer.resume()
    if args.eval and ckpt.checkpoint_exists(save_root, cfg.data.exp_name,
                                            best=True):
        trainer.resume(best=True)
    if args.init_model:
        trainer.load_init_model(args.init_model)
    if args.write_video:
        trainer.video_path = args.write_video

    if args.eval:
        trainer.eval()
    else:
        trainer.train()
    return trainer


if __name__ == "__main__":
    main()
