"""Training / eval entry point of the port, the root ``train.py``'s flags:

    python -m depthestimation_tpu_torch.train --config configs/test_tiny.json
        [-b N] [--eval] [--viz] [--lc] [--lc_debug] [--resume]
        [--init_model PATH] [--write_video PATH] [--synthetic]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU
(there is no device flag and no fallback). Checkpoints and the
``{exp}.json`` results go under ``outputs/checkpoints/{exp}`` in the
working directory. With ``--synthetic``, or when ``data.dataset_path`` is
not a directory, it trains on ``SyntheticStereoVideoDataset``; otherwise
on ``IlimVideoDataset`` when ``data.dataset_split`` names "ilim" or
"sweep", else on ``KittiVideoDataset`` (both read PNGs without Pillow and
project the velodyne with ``native/kittiops.cpp``, built by ``g++`` at
first use).

Data parallel, one rank per card:

    torchrun --nproc_per_node N -m depthestimation_tpu_torch.train \
        --config ... [-b B]

Each rank is one JAX host with one device (``parallel/mesh.py``): it
loads the trajectories ``i % N == rank``, ``-b`` is its own batch (the
global batch is ``B x N``), BatchNorm takes the global batch's
statistics, the gradients are averaged over the ranks, and rank 0 logs,
writes tensorboard, the checkpoints and the results file. (JAX's
single-host mesh splits ``-b`` over the host's chips instead.) ``--eval``
validates at batch 1 per rank, with the metrics over every rank's frames.
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
    """(train, val) ``BatchScheduler``s, chosen as the JAX CLI chooses:
    synthetic video under ``--synthetic`` or without a dataset directory
    (train: max(2B, 4) trajectories of 4 frames per rank, seed 1; val: B
    of 2 frames per rank, seed 2), the ILIM / sweep drives when
    ``data.dataset_split`` names "ilim" or "sweep", else the KITTI raw
    drives (split "train" / "test"). Each rank takes the trajectories
    ``i % world == rank`` (``host_id``, ``n_hosts``)."""
    from depthestimation_tpu_torch.data.scheduler import BatchScheduler
    from depthestimation_tpu_torch.parallel import mesh
    bs = int(cfg.train.batch_size)
    ranks = dict(host_id=mesh.rank(), n_hosts=mesh.world())
    split = cfg.data.dataset_split
    if use_synthetic or not os.path.isdir(cfg.data.dataset_path):
        from depthestimation_tpu_torch.data.video_synthetic import (
            SyntheticStereoVideoDataset)
        w, h = cfg.var.crop_w, cfg.var.img_size[1]
        common = dict(h=h, w=w, t_win=cfg.var.t_win, d_min=cfg.var.d_min,
                      d_max=cfg.var.d_max, ndepth=cfg.var.ndepth,
                      qpower=cfg.var.qpower)
        n = ranks["n_hosts"]
        train_ds = SyntheticStereoVideoDataset(n_traj=max(bs * 2, 4) * n,
                                               traj_len=4, seed=1, **common)
        val_ds = SyntheticStereoVideoDataset(n_traj=bs * n, traj_len=2,
                                             seed=2, **common)
    elif "ilim" in split or "sweep" in split:
        from depthestimation_tpu_torch.data.ilim import IlimVideoDataset
        train_ds = IlimVideoDataset(cfg, split="train")
        val_ds = IlimVideoDataset(cfg, split="test")
    else:
        from depthestimation_tpu_torch.data.kitti import KittiVideoDataset
        train_ds = KittiVideoDataset(cfg, split="train")
        val_ds = KittiVideoDataset(cfg, split="test")
    qmax = int(cfg.train.get("qmax", 4))
    # cfg.var.mload: a spawned loader process; synthetic data asked for by
    # --synthetic is cheap enough to stay in-process
    mload = bool(cfg.var.get("mload", False)) and not use_synthetic
    return (BatchScheduler(train_ds, bs, shuffle=True, qmax=qmax,
                           mload=mload, **ranks),
            BatchScheduler(val_ds, bs, shuffle=False, qmax=qmax,
                           mload=mload, **ranks))


def main(argv=None, device="cuda"):
    """Train (or with ``--eval`` validate ``_model_best`` at batch 1) and
    return the trainer. Under ``torchrun`` it joins the process group
    first (``mesh.init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo
    for ``device="cpu"``); a group the caller made is used as it is."""
    from depthestimation_tpu_torch.parallel import mesh
    device = mesh.init_distributed(device)
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

    lead = mesh.rank() == 0
    logger = init_logger(cfg.data.exp_name, save_root if lead else None,
                         quiet=not lead)
    model = get_model(cfg, device, seed=int(cfg.seed))
    train_loader, val_loader = build_loaders(cfg, args.synthetic)
    trainer = get_trainer(cfg)(mesh.rank(), model, get_loss(cfg), logger,
                               save_root, cfg, train_loader, val_loader)

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
