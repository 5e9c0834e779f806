"""Weight bridge: the JAX ``{"params", "batch_stats"}`` tree -> ``state_dict``.

The port's modules carry flax's auto-names (``Conv_0``, ``ConvBN3d_3``,
``BatchNorm_0``, ...) as attribute names, so a leaf's ``state_dict`` key is
its tree path joined with dots, with the leaf renamed; no hand-kept list
of layers. Layout conversions, decided by the leaf and its rank:

- ``Conv`` kernel, HWIO ``[kh, kw, C, F]`` -> OIHW ``[F, C, kh, kw]``;
- ``Conv3d`` kernel ``[kd, kh, kw, C, F]`` -> ``[F, C, kd, kh, kw]``;
- ``ConvTranspose`` kernel ``[kh, kw, C, F]`` -> ``ConvTranspose2d``'s
  ``[C, F, kh, kw]``. JAX applies the kernel FLIPPED to the dilated input
  (``layers.py:347-356``) and ``conv_transpose2d`` flips its weight
  itself, so the two flips cancel and only the I/O swap remains;
- BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``; the running
  ``mean`` / ``var`` (``batch_stats``) -> ``running_mean`` /
  ``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert(path, leaf: np.ndarray):
    """(state_dict key, tensor) of one params leaf."""
    *mods, name = path
    a = np.asarray(leaf, np.float32)
    if name == "kernel":
        if a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)
        elif mods and mods[-1].startswith("ConvTranspose"):
            a = a.transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    elif name != "bias":
        raise ValueError(f"unexpected parameter {'/'.join(path)}")
    return ".".join(mods + [name]), torch.from_numpy(np.array(a, order="C"))


def from_jax_params(variables_np: dict) -> dict:
    """JAX variables (numpy leaves) -> the port's ``state_dict``.

    Every leaf maps to exactly one key; a duplicate key raises.
    """
    out = {}

    def put(key, t, path):
        if key in out:
            raise ValueError(f"two JAX leaves map to {key} ({path})")
        out[key] = t

    for path, leaf in _walk(variables_np.get("params", {})):
        key, t = _convert(path, leaf)
        put(key, t, path)
    for path, leaf in _walk(variables_np.get("batch_stats", {})):
        *mods, name = path
        key = ".".join(mods + [_STAT_NAMES[name]])
        put(key, torch.from_numpy(np.asarray(leaf, np.float32).copy()), path)
    return out


def load_jax_params(model: torch.nn.Module, variables_np: dict) -> None:
    """Load JAX variables into ``model``, requiring a one-to-one match:
    every JAX leaf fills exactly one parameter or buffer and none is left
    unfilled."""
    sd = from_jax_params(variables_np)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(f"JAX tree does not match the model: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    for k, t in sd.items():
        if own[k].shape != t.shape:
            raise ValueError(f"{k}: JAX shape {tuple(t.shape)} vs model "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
