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

``from_jax_train_state`` converts a whole JAX ``TrainState`` (the
parameters, ``batch_stats``, optax's Adam moments, the step and the
injected learning rate) into the port's model and optimizer
``state_dict``: a TPU-trained checkpoint resumes on the card.
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


def _check_match(sd: dict, own: dict, what: str) -> None:
    """Raise ``ValueError`` naming the first key (in sorted order) that
    ``sd`` lacks, has too many, or holds at another shape than ``own``."""
    for k in sorted(set(own) | set(sd)):
        if k not in sd:
            raise ValueError(f"{what} does not match the model: it has no "
                             f"{k}")
        if k not in own:
            raise ValueError(f"{what} does not match the model: the model "
                             f"has no {k}")
        if tuple(own[k].shape) != tuple(sd[k].shape):
            raise ValueError(f"{what} does not match the model: {k} is "
                             f"{tuple(sd[k].shape)} there, "
                             f"{tuple(own[k].shape)} in the model")


def load_jax_params(model: torch.nn.Module, variables_np: dict) -> None:
    """Load JAX variables into ``model``, requiring a one-to-one match:
    every JAX leaf fills exactly one parameter or buffer and none is left
    unfilled."""
    sd = from_jax_params(variables_np)
    _check_match(sd, model.state_dict(), "JAX tree")
    model.load_state_dict(sd, strict=True)


def _adam_state(tree):
    """The one ``{count, mu, nu}`` node of an optax state (Adam's or
    AdamW's ``ScaleByAdamState``, wherever the chain nests it; the
    ``add_decayed_weights`` and learning-rate stages hold none)."""
    found = []

    def visit(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            if {"count", "mu", "nu"} <= set(node):
                found.append(node)
                return
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the "
                         f"optimizer state, found {len(found)}")
    return found[0]


def from_jax_train_state(state_np: dict, model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> tuple:
    """A JAX ``TrainState`` as plain dicts of numpy leaves (what orbax's
    ``StandardCheckpointer().restore`` returns without a target: ``step``,
    ``params``, ``batch_stats``, ``opt_state``) -> (the model's
    ``state_dict``, the optimizer's ``state_dict``, the step).

    ``optimizer`` is the port's (``parallel/train_step.make_optimizer`` of
    ``model``): its groups give each parameter's index. optax's ``mu`` and
    ``nu`` mirror the params tree; each leaf takes its parameter's layout
    conversion (a conv's moments are transposed as its kernel) and lands
    at that parameter's index as ``exp_avg`` / ``exp_avg_sq``, with Adam's
    ``count`` as every parameter's ``step``. The injected
    ``hyperparams.learning_rate`` (halved after ``halflr``) becomes every
    group's ``lr``. A tree that does not match the model raises
    ``ValueError`` naming the first mismatching key; nothing is imported
    in part."""
    sd = from_jax_params({"params": state_np["params"],
                          "batch_stats": state_np.get("batch_stats", {})})
    _check_match(sd, model.state_dict(), "JAX params tree")
    opt_state = state_np["opt_state"]
    adam = _adam_state(opt_state)
    names = {id(p): k for k, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    params = dict(model.named_parameters())
    moments = {}
    for slot in ("mu", "nu"):
        conv = dict(_convert(path, leaf) for path, leaf in _walk(adam[slot]))
        _check_match(conv, params, f"JAX Adam {slot} tree")
        moments[slot] = conv
    step = float(np.asarray(adam["count"]))
    opt_sd = optimizer.state_dict()
    opt_sd["state"] = {
        i: {"step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": moments["mu"][k], "exp_avg_sq": moments["nu"][k]}
        for i, k in enumerate(order)}
    lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
    for group in opt_sd["param_groups"]:
        group["lr"] = lr
    return sd, opt_sd, int(np.asarray(state_np["step"]))
