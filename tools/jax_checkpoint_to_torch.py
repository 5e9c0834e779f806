#!/usr/bin/env python3
"""Convert the JAX package's checkpoints into the PyTorch port's.

The JAX trainer writes ``{exp}_ckpt`` and ``{exp}_model_best`` as orbax
directories under its save root (``outputs/checkpoints/{exp}``); the port
reads one ``torch.save`` file under the same names. This tool restores
each orbax directory that exists (no target tree is needed: orbax returns
plain dicts), builds the port's model and optimizer from the config on
the CPU, converts the parameters, ``batch_stats``, Adam's moments, the
step and the learning rate (``weights.from_jax_train_state``), and writes
them with the port's ``trainer/checkpoint.save_checkpoint`` under the same
names in ``--dst``, with the epoch. The ``{exp}.json`` history that
``resume`` reads is copied beside them.

Run where JAX and orbax are installed (a TPU host, or any CPU host with
the JAX package's requirements):

    python tools/jax_checkpoint_to_torch.py --config configs/default_exp7.json \\
        --src outputs/checkpoints/<exp> --dst converted/<exp>

Then, on the card's host: ``python -m depthestimation_tpu_torch.train
--config ... --resume`` with ``--dst`` as ``outputs/checkpoints/<exp>`` of
its working directory, ``python -m depthestimation_tpu_torch.eval_parity
--config ... --ckpt <dst>``, or ``NetRuntime(cfg, ..., save_root=<dst>)``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a data-conversion tool: JAX on the CPU unless the caller picks a platform
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def restore_jax(src: str, exp: str, best: bool):
    """(state dict of numpy leaves, epoch) of ``{exp}_model_best`` (or
    ``_ckpt``) under ``src``, or None when it does not exist."""
    import numpy as np
    import orbax.checkpoint as ocp

    name = f"{exp}_model_best" if best else f"{exp}_ckpt"
    path = os.path.abspath(os.path.join(src, name))
    if not os.path.isdir(path):
        return None
    payload = ocp.StandardCheckpointer().restore(path)
    return payload["state"], int(np.asarray(payload["epoch"]))


def convert(config: str, src: str, dst: str, exp: str | None = None) -> dict:
    """Convert ``{exp}_model_best`` and ``{exp}_ckpt`` from ``src`` into
    ``dst``; returns {name: (epoch, step)} of what was written. Raises
    ``FileNotFoundError`` when ``src`` holds neither, ``ValueError`` when
    a tree does not match the config's model (nothing is written then)."""
    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import make_optimizer
    from depthestimation_tpu_torch.trainer import checkpoint as ckpt
    from depthestimation_tpu_torch.weights import from_jax_train_state

    if os.path.abspath(src) == os.path.abspath(dst):
        raise ValueError("--src and --dst must differ: the port's "
                         "checkpoints take the orbax directories' names")
    cfg = load_config(config)
    exp = exp or cfg.data.exp_name
    model = get_model(cfg, "cpu", seed=int(cfg.get("seed", 0)))
    optimizer = make_optimizer(cfg, model)
    converted = {}
    for best in (True, False):
        restored = restore_jax(src, exp, best)
        if restored is None:
            continue
        state, epoch = restored
        model_sd, opt_sd, step = from_jax_train_state(state, model,
                                                      optimizer)
        converted[best] = ({"model": model_sd, "optimizer": opt_sd},
                           epoch, step)
    if not converted:
        raise FileNotFoundError(f"no {exp}_ckpt or {exp}_model_best "
                                f"under {src}")
    os.makedirs(dst, exist_ok=True)
    # save_checkpoint writes _ckpt and copies it to _model_best: the best
    # goes first, then _ckpt replaces the copy (or the copy goes)
    if True in converted:
        state, epoch, _ = converted[True]
        ckpt.save_checkpoint(dst, exp, state, epoch, is_best=True)
    if False in converted:
        state, epoch, _ = converted[False]
        ckpt.save_checkpoint(dst, exp, state, epoch)
    else:
        shutil.rmtree(os.path.join(dst, f"{exp}_ckpt"))
    history = os.path.join(src, exp + ".json")
    if os.path.isfile(history):
        shutil.copy(history, os.path.join(dst, exp + ".json"))
    return {(f"{exp}_model_best" if best else f"{exp}_ckpt"): (e, s)
            for best, (_, e, s) in converted.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True,
                    help="the config the JAX run trained with")
    ap.add_argument("--src", required=True,
                    help="the JAX save root (holds {exp}_ckpt / "
                         "{exp}_model_best orbax directories)")
    ap.add_argument("--dst", required=True,
                    help="where the port's checkpoints are written")
    ap.add_argument("--exp", default=None,
                    help="experiment name (default: the config's)")
    args = ap.parse_args(argv)
    done = convert(args.config, args.src, args.dst, args.exp)
    for name, (epoch, step) in done.items():
        print(f"{name}: epoch {epoch}, step {step} -> "
              f"{os.path.join(args.dst, name)}")
    return done


if __name__ == "__main__":
    main()
