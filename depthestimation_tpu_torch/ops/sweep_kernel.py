"""Plane-sweep stage 2 on a hand-written Hopper kernel, and its plain version.

Counterpart of ``depthestimation_tpu/ops/sweep_pallas.py`` (forward only;
the backward belongs to the training slice). For each source view n and
depth d:

    warped_d = Ry_d . F_c . Rx_d^T     (every feature channel c)
    cost_d   = sum_c (warped_d - ref)^2
    diag_d   = Ry_d . Fr[n, d] . Rx_d^T

``sweep_stage2`` launches ``csrc/sweep_stage2.cu`` for a CUDA tensor and
runs ``sweep_stage2_plain`` for a CPU tensor. The kernel takes bf16 only,
like the TPU kernel: an f32 model calls the plain version directly, which
keeps the f32 path's exactness at identity rotation.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops import cuda_lib


def sweep_stage2_plain(fa, ref, fr, rxt, ry, v: int):
    """The einsum form of stage 2, with the kernel's rounding points.

    fa [N, C1, H, W], ref [B, C1, H, W] (N = B*v), fr [N, D, H, W],
    rxt [N, D, W, X], ry [N, D, Y, H], all of one dtype ``cdt``. Products
    accumulate in f32; the intermediate ``s = F . Rx^T`` is rounded to
    ``cdt`` before the second product, and ``ref`` is upcast before the
    difference (``sweep_pallas.py:65-93``). For f32 inputs this is the
    plain f32 sweep of ``plane_sweep_and_warp_decomposed``.

    Returns (cost [N, D, Y, X] f32, diag [N, D, Y, X] f32).
    """
    cdt = fa.dtype
    f32 = torch.float32
    rxt32, ry32 = rxt.to(f32), ry.to(f32)
    s1 = torch.einsum("nchw,ndwx->ndchx", fa.to(f32), rxt32).to(cdt).to(f32)
    warped = torch.einsum("ndyh,ndchx->ndcyx", ry32, s1)
    refn = ref.to(f32).repeat_interleave(v, dim=0)
    diff = warped - refn[:, None]
    cost = (diff * diff).sum(dim=2)
    s2 = torch.einsum("ndhw,ndwx->ndhx", fr.to(f32), rxt32).to(cdt).to(f32)
    diag = torch.einsum("ndyh,ndhx->ndyx", ry32, s2)
    return cost, diag


def _check(fa, ref, fr, rxt, ry, v):
    ts = {"fa": fa, "ref": ref, "fr": fr, "rxt": rxt, "ry": ry}
    for name, t in ts.items():
        if t.device != fa.device:
            raise ValueError(f"sweep_stage2: {name} on {t.device}, fa on "
                             f"{fa.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"sweep_stage2: the kernel takes bf16, {name} "
                            f"is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sweep_stage2: {name} is not contiguous")
    n, c1, h, w = fa.shape
    d = fr.shape[1]
    if n % v or ref.shape != (n // v, c1, h, w):
        raise ValueError(f"sweep_stage2: ref {tuple(ref.shape)} does not "
                         f"match fa {tuple(fa.shape)} with v={v}")
    if (fr.shape != (n, d, h, w) or rxt.shape != (n, d, w, w)
            or ry.shape != (n, d, h, h)):
        raise ValueError(
            f"sweep_stage2: shapes fr {tuple(fr.shape)}, rxt "
            f"{tuple(rxt.shape)}, ry {tuple(ry.shape)} do not match fa "
            f"{tuple(fa.shape)}")


class _Stage2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fa, ref, fr, rxt, ry, v):
        n, c1, h, w = fa.shape
        d = fr.shape[1]
        cost = torch.empty((n, d, h, w), dtype=torch.float32,
                           device=fa.device)
        diag = torch.empty_like(cost)
        cuda_lib.library().call(
            "sweep_stage2_fwd", fa.data_ptr(), ref.data_ptr(), fr.data_ptr(),
            rxt.data_ptr(), ry.data_ptr(), cost.data_ptr(), diag.data_ptr(),
            n, v, c1, d, h, w, cuda_lib.stream_ptr(fa.device))
        sweep_stage2.launches += 1
        return cost, diag

    @staticmethod
    def backward(ctx, gcost, gdiag):
        raise NotImplementedError(
            "sweep_stage2 backward belongs to the training slice "
            "(ROADMAP.md, queue 2)")


def sweep_stage2(fa, ref, fr, rxt, ry, v: int):
    """Fused stage-2 sweep; see ``sweep_stage2_plain`` for the contract.

    A CPU tensor runs the plain version. A CUDA tensor launches the
    kernel (bf16, contiguous, shapes as documented) or raises.
    """
    if fa.device.type == "cpu":
        return sweep_stage2_plain(fa, ref, fr, rxt, ry, v)
    _check(fa, ref, fr, rxt, ry, v)
    return _Stage2.apply(fa, ref, fr, rxt, ry, v)


#: kernel launches since the last reset (plain-version calls not counted)
sweep_stage2.launches = 0
