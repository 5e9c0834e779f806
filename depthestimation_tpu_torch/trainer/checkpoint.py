"""Checkpoints with the JAX package's names and directory layout (port of
``depthestimation_tpu/trainer/checkpoint.py``).

``{exp}_ckpt`` at every save and ``{exp}_model_best`` beside it when the
save is the best so far, each a directory under ``save_root``. JAX writes
orbax directories; here the directory holds one ``torch.save`` file with
the state (for a trainer: the model's and the optimizer's ``state_dict``)
and the epoch. Warm start (``restore_params_partial``) copies every entry
whose key and shape match and keeps the rest. A JAX (orbax) checkpoint
directory is not read here: ``tools/jax_checkpoint_to_torch.py`` converts
it, on a host with JAX, into this layout.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch

_FILE = "checkpoint.pt"
#: files that mark a directory orbax wrote (its metadata, its OCDBT index)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def _path(save_root: str, name: str) -> str:
    return os.path.abspath(os.path.join(save_root, name))


def save_checkpoint(save_root: str, exp_name: str, state: Any, epoch: int,
                    is_best: bool = False):
    """Write ``state`` and ``epoch`` to ``{exp_name}_ckpt`` (replacing it)
    and, with ``is_best``, copy it to ``{exp_name}_model_best``."""
    path = _path(save_root, f"{exp_name}_ckpt")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"state": state, "epoch": int(epoch)},
               os.path.join(path, _FILE))
    if is_best:
        best = _path(save_root, f"{exp_name}_model_best")
        if os.path.exists(best):
            shutil.rmtree(best)
        shutil.copytree(path, best)


def load_checkpoint(save_root: str, exp_name: str, target_state: Any = None,
                    best: bool = False, map_location="cpu") -> tuple:
    """Returns (state, epoch). With ``target_state`` (a dict of the same
    kind as the saved one) the loaded state must have its keys."""
    name = f"{exp_name}_model_best" if best else f"{exp_name}_ckpt"
    path = _path(save_root, name)
    if not os.path.exists(os.path.join(path, _FILE)) and any(
            os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is a JAX (orbax) checkpoint, not the port's: convert "
            f"it with tools/jax_checkpoint_to_torch.py (on a host with JAX)")
    payload = torch.load(os.path.join(path, _FILE),
                         map_location=map_location, weights_only=True)
    state = payload["state"]
    if target_state is not None and set(state) != set(target_state):
        raise ValueError(f"checkpoint {name} holds {sorted(state)}, "
                         f"expected {sorted(target_state)}")
    return state, int(payload["epoch"])


def restore_params_partial(params: dict, loaded_params: dict) -> dict:
    """Warm start: each entry of ``params`` (a ``state_dict``) takes the
    loaded tensor of the same key where the shapes agree, else keeps its
    own (the functional form of ``strict=False``)."""
    out = {}
    for k, v in params.items():
        y = loaded_params.get(k)
        out[k] = (y if y is not None and tuple(y.shape) == tuple(v.shape)
                  else v)
    return out


def checkpoint_exists(save_root: str, exp_name: str,
                      best: bool = False) -> bool:
    name = f"{exp_name}_model_best" if best else f"{exp_name}_ckpt"
    return os.path.isdir(_path(save_root, name))
