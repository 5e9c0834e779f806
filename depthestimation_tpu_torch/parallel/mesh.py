"""Data parallelism over a ``torch.distributed`` process group.

Port of ``depthestimation_tpu/parallel/mesh.py``. Each rank is one JAX
host with one device: it loads its own trajectories (``BatchScheduler``'s
``host_id`` / ``n_hosts``), runs the model on its share of the global
batch, and the collectives below make the result the function JAX's
batch-sharded mesh computes:

- BatchNorm normalizes with the statistics of the global batch
  (``all_reduce_sum`` of the per-rank sums, ``models/layers.py``): the
  ``psum`` of ``convcomb_pallas.py:318``, whose backward is the ``psum``
  of ``:337``;
- the gradient is that of the mean of the ranks' losses
  (``all_reduce_grads`` after the backward), which is JAX's global loss
  when every rank holds an equal share;
- the step-count vote ``global_min_steps``, the skip vote ``global_any``
  and ``barrier`` keep the ranks in lockstep, with JAX's contracts;
- a draw that JAX makes once for the global batch (the ``prev_lc`` drop)
  is rank 0's on every rank (``broadcast_``); draws per item come from
  each rank's own stream.

JAX's ``make_mesh``, ``shard_batch``, ``shard_frames`` and ``replicate``
have no counterpart: each rank loads its own items, so nothing is sharded
after loading, and ``broadcast_state`` replicates the model.

Without a group, or with a group of one, every function returns its input
unchanged and calls no collective.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if _group_active() else 0


def world() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if _group_active() else 1


def init_distributed(device="cuda") -> torch.device:
    """Join the default process group when ``torchrun`` started this
    process, and return the device this rank runs on.

    - A group that already exists is used as it is, with ``device``: a
      caller (a test, ``chip_smoke.py``) may bring its own, e.g. gloo with
      two ranks on one card.
    - ``RANK`` and ``WORLD_SIZE`` set (``torchrun``): a CUDA ``device``
      becomes ``cuda:LOCAL_RANK``, made current, and the group is NCCL
      bound to it; a CPU device joins a gloo group. A failed
      initialization raises.
    - Otherwise: a single process, no group (JAX's ``init_distributed``
      without a coordinator).
    """
    device = torch.device(device)
    if _group_active():
        return device
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device


def _collective_device() -> torch.device:
    """Where the host-side votes put their tensors: NCCL takes CUDA
    tensors only, gloo CPU ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no autograd) and return it. A
    CUDA tensor in a gloo group is reduced through a host copy."""
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        host = t.cpu()
        dist.all_reduce(host)
        return t.copy_(host)
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """psum: the forward sums over the ranks, and so does the backward
    (the transpose of a sum that every rank receives)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the gradient that
    reaches ``x`` on each rank is the sum of the ranks' gradients of the
    result. ``x`` itself without a group of more than one."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x)


def global_min_steps(local_steps: int) -> int:
    """Minimum of ``local_steps`` across ranks.

    With per-rank trajectory sharding, ranks see different numbers of
    batches per epoch; every rank must run the same number of steps or
    the gradient all-reduce deadlocks. One collective per epoch."""
    if world() == 1:
        return int(local_steps)
    t = torch.tensor([int(local_steps)], dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def global_any(flag: bool) -> bool:
    """True if ``flag`` is set on ANY rank.

    The per-iteration skip vote: when one rank draws a corrupted batch,
    every rank skips in lockstep (a lone ``continue`` would leave that
    rank one gradient all-reduce behind its peers). The vote is itself a
    collective, so every rank calls it every iteration, valid or not."""
    if world() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier(tag: str = "") -> None:
    """Wait until every rank got here (``sync_global_devices(tag)``; the
    tag only names the meeting point). A one-element all-reduce read back
    on the host, so it holds for any backend and device binding."""
    del tag
    if world() == 1:
        return
    t = torch.zeros(1, device=_collective_device())
    dist.all_reduce(t)
    t.item()


def rank0_first(fn: Callable):
    """Run ``fn`` on rank 0 while the other ranks wait, then on them: a
    build that rank 0 leaves on a shared disk is found there, not redone.
    Rank 0 reaches the barrier also when ``fn`` raises, so the others go
    on to their own call (and its error) instead of hanging."""
    if world() == 1:
        return fn()
    if rank() == 0:
        try:
            return fn()
        finally:
            barrier("rank0_first")
    barrier("rank0_first")
    return fn()


def all_gather_rows(rows: np.ndarray) -> np.ndarray:
    """Concatenate every rank's ``rows`` (any length along axis 0) in rank
    order; every rank gets the same array."""
    if world() == 1:
        return rows
    parts = [None] * world()
    dist.all_gather_object(parts, np.asarray(rows))
    return np.concatenate(parts, axis=0)


def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """Overwrite ``t`` with rank 0's (in place, no autograd) and return
    it. A CUDA tensor in a gloo group goes through a host copy."""
    if world() == 1:
        return t
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        host = t.cpu()
        dist.broadcast(host, 0)
        return t.copy_(host)
    dist.broadcast(t, 0)
    return t


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank."""
    for t in list(module.parameters()) + list(module.buffers()):
        broadcast_(t.data)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks: one flat
    all-reduce per dtype, divided by ``world``.

    A parameter without a gradient on this rank counts as zeros; it keeps
    ``grad = None`` only where no rank has one (a module the model builds
    but does not run), so the optimizer skips it on every rank alike."""
    n = world()
    if n == 1:
        return
    buckets: dict = {}
    for p in params:
        buckets.setdefault(p.dtype, []).append(p)
    for dtype, ps in buckets.items():
        dev = ps[0].device
        flat = torch.cat(
            [(p.grad if p.grad is not None
              else torch.zeros_like(p)).reshape(-1) for p in ps]
            + [torch.tensor([float(p.grad is not None) for p in ps],
                            dtype=dtype, device=dev)])
        all_reduce_(flat)
        flat.div_(n)
        absent = [i for i, p in enumerate(ps) if p.grad is None]
        off = 0
        for p in ps:
            view = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            if p.grad is not None:
                p.grad.copy_(view)
            else:
                p.grad = view.clone()
        if absent:                       # read back only when it matters
            seen = flat[off:][absent].tolist()
            for i, s in zip(absent, seen):
                if s == 0:
                    ps[i].grad = None
