"""The train and eval steps.

Port of ``depthestimation_tpu/parallel/train_step.py``: one train step is
the forward of both camera sides, the loss, one backward and one optimizer
update, with the 1/4-resolution ``prev_output`` feedback in ``aux``. The
parameters stay f32 and the optimizer state f32; a bf16 model computes in
bf16 (its kernels) and casts at use. PyTorch updates the parameters and the
optimizer state in place, where JAX returns new ones. With ``lc_fn`` the
light-curtain loop runs inside the step on the detached refined DPVs and
its ``prev_lc`` feedback lands in ``aux``. In a data-parallel group
(``parallel/mesh.py``) the step is JAX's on the global batch: BatchNorm
takes the global statistics inside the model, and the gradients are
averaged over the ranks between the backward and the optimizer step, so
every rank applies the same update. JAX's ``make_train_rollout``
(the step under ``lax.scan``) has no counterpart: on the card a chunk of
frames is the trainer's frame loop over this step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn

from depthestimation_tpu_torch.parallel import mesh
from depthestimation_tpu_torch.utils import precision


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def _decay_mask(model: nn.Module) -> dict:
    """name -> True for the parameters that take the weight decay: a
    non-bias leaf with more than one dimension (a BatchNorm scale, being
    1-D, is in the bias group), as ``train_step.py:_decay_mask``."""
    return {name: "bias" not in name.rsplit(".", 1)[-1] and p.dim() > 1
            for name, p in model.named_parameters()}


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """Adam with coupled L2 decay in two groups (``weight_decay`` for the
    weights, ``bias_decay`` for the rest), or AdamW with decoupled decay on
    the weights only; eps 1e-8 and betas (``momentum``, ``beta``), as the
    JAX package's optax chain."""
    t = cfg.train
    mask = _decay_mask(model)
    params = dict(model.named_parameters())
    weights = [params[k] for k, m in mask.items() if m]
    rest = [params[k] for k, m in mask.items() if not m]
    betas = (float(t.get("momentum", 0.9)), float(t.get("beta", 0.999)))
    wd = float(t.get("weight_decay", 0.0))
    if t.optim == "adam":
        bd = float(t.get("bias_decay", 0.0))
        return torch.optim.Adam(
            [{"params": weights, "weight_decay": wd},
             {"params": rest, "weight_decay": bd}],
            lr=float(t.lr), betas=betas, eps=1e-8)
    if t.optim == "adamw":
        return torch.optim.AdamW(
            [{"params": weights, "weight_decay": wd},
             {"params": rest, "weight_decay": 0.0}],
            lr=float(t.lr), betas=betas, eps=1e-8)
    raise ValueError(f"unknown optimizer {t.optim!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate (the trainer halves it at
    ``cfg.train.halflr`` epochs)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def init_state(model: nn.Module, cfg) -> TrainState:
    """The model (in train mode) with a fresh optimizer, step 0."""
    return TrainState(step=0, model=model.train(),
                      optimizer=make_optimizer(cfg, model))


def _quarter(dpv: torch.Tensor) -> torch.Tensor:
    """1/4-res nearest downsample of a [B, D, H, W] DPV, detached: the
    ``prev_output`` feedback (every 4th pixel starting at 0)."""
    return dpv[:, :, ::4, ::4].detach()


def make_train_step(loss_fn: Callable,
                    lc_fn: Optional[Callable] = None) -> Callable:
    """``step(state, mi_l, mi_r, gt_l, gt_r, generator) -> (state, loss,
    aux)``: both camera sides forward (left, then right, so the right side
    sees the running statistics the left one updated), the loss on
    ``[out_l, out_r]``, one backward, one optimizer step. ``generator``
    feeds the train-mode ``prev_lc`` drops, left first. ``aux`` holds the
    detached 1/4-res ``prev_output`` feedback and refined DPVs.

    ``lc_fn``: the fused light-curtain loop, ``(refined_l, refined_r, mi_l,
    mi_r, generator) -> (prev_lc_l, prev_lc_r)`` (both 1/4-res log DPVs;
    ``trainer.default.fused_lc_fn``), run after the update on the detached
    refined DPVs; its results land in ``aux["prev_lc_left"]`` and
    ``aux["prev_lc_right"]``. It draws from ``generator`` after the two
    drops. Without it the step and its draws are unchanged. The forward,
    loss and backward run with TF32 off (``utils/precision.no_tf32``).

    With more than one rank, one flat all-reduce averages the gradients
    after the backward (``mesh.all_reduce_grads``: the gradient of the
    mean of the ranks' losses, JAX's global loss), and the loss returned
    is that mean. ``DistributedDataParallel`` is not used: its reducer
    hooks fire per backward pass and expect each parameter once, where a
    step runs two forwards and a nmode may leave modules unused."""

    def step(state: TrainState, mi_l: dict, mi_r: dict, gt_l: dict,
             gt_r: dict, generator: torch.Generator | None = None):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        with precision.no_tf32():
            out_l = model(mi_l, generator=generator)
            out_r = model(mi_r, generator=generator)
            loss = loss_fn([out_l, out_r], [gt_l, gt_r])
            loss.backward()
        loss = loss.detach()
        if mesh.world() > 1:
            mesh.all_reduce_grads(model.parameters())
            loss = mesh.all_reduce_(loss.clone()) / mesh.world()
        opt.step()
        state.step += 1
        ref_l = out_l["output_refined"][-1]
        ref_r = out_r["output_refined"][-1]
        aux = {"prev_output_left": _quarter(ref_l),
               "prev_output_right": _quarter(ref_r),
               "refined_left": ref_l.detach(),
               "refined_right": ref_r.detach()}
        if lc_fn is not None:
            aux["prev_lc_left"], aux["prev_lc_right"] = lc_fn(
                aux["refined_left"], aux["refined_right"], mi_l, mi_r,
                generator)
        return state, loss, aux

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """``step(model_input) -> output dict``: the eval-mode forward without
    a graph."""

    def step(model_input: dict) -> dict:
        model.eval()
        with torch.inference_mode():
            return model(model_input)

    return step
