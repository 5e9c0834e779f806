"""Plane-sweep stage 2 on hand-written Hopper kernels, and its plain
versions.

Counterpart of ``depthestimation_tpu/ops/sweep_pallas.py`` and its custom
VJP. For each source view n and depth d:

    warped_d = Ry_d . F_c . Rx_d^T     (every feature channel c)
    cost_d   = sum_c (warped_d - ref)^2
    diag_d   = Ry_d . Fr[n, d] . Rx_d^T

``sweep_stage2`` is one autograd Function on both devices: for a CUDA
tensor its forward and backward launch ``csrc/sweep_stage2.cu``, for a CPU
tensor they run ``sweep_stage2_plain`` and ``sweep_stage2_bwd_plain``. The
backward recomputes the forward from the saved inputs instead of keeping
the ``[C, D, H, W]`` warped volume; the band matrices come from poses and
take no gradient (``sweep_pallas.py:34-36``). The kernels take bf16 only,
like the TPU kernel: an f32 model calls the plain forward directly under
autograd, which keeps the f32 path's exactness at identity rotation.

The kernels compute on the band matrices' nonzero extents, not on the
dense squares: each call first scans Rx^T and Ry for the extent of every
row and column (the taps, in a scratch tensor the wrapper allocates), then
the forward streams feature rows to blocks of (view, depth group, row
strip) and the backward gives each block a row strip of one item's dfa and
dref for a group of channels (``ops/sweep_band.py`` models both on the
CPU). A dense matrix takes a slower separable path and stays correct.
"""

from __future__ import annotations

import ctypes

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


def sweep_stage2_bwd_plain(fa, ref, fr, rxt, ry, gcost, gdiag, v: int):
    """The backward of ``sweep_stage2_plain`` with the TPU kernel's
    rounding points (``sweep_pallas.py:110-148``): it recomputes the
    forward; ``dwarped = 2 diff g`` in f32 is rounded to ``cdt`` before
    ``Ry^T .``, and ``ds1`` (``ds2``) is rounded before ``. Rx``; ``dref``
    is minus the f32 sum of ``dwarped`` over depths and the item's views.

    gcost, gdiag [N, D, Y, X] f32. Returns (dfa [N, C1, H, W],
    dref [B, C1, H, W], dfr [N, D, H, W]), all f32.
    """
    cdt = fa.dtype
    f32 = torch.float32

    def rnd(t):
        return t.to(cdt).to(f32)

    rxt32, ry32 = rxt.to(f32), ry.to(f32)
    s1 = rnd(torch.einsum("nchw,ndwx->ndchx", fa.to(f32), rxt32))
    warped = torch.einsum("ndyh,ndchx->ndcyx", ry32, s1)
    refn = ref.to(f32).repeat_interleave(v, dim=0)
    dwarped = 2.0 * (warped - refn[:, None]) * gcost.to(f32)[:, :, None]
    ds1 = rnd(torch.einsum("ndyh,ndcyx->ndchx", ry32, rnd(dwarped)))
    dfa = torch.einsum("ndchx,ndwx->nchw", ds1, rxt32)
    n, d, c1, h, w = dwarped.shape
    dref = -dwarped.sum(dim=1).reshape(n // v, v, c1, h, w).sum(dim=1)
    ds2 = rnd(torch.einsum("ndyh,ndyx->ndhx", ry32, rnd(gdiag.to(f32))))
    dfr = torch.einsum("ndhx,ndwx->ndhw", ds2, rxt32)
    return dfa, dref, dfr


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


def _scratch(n: int, d: int, h: int, w: int, device) -> torch.Tensor:
    """The kernels' scratch: 16 bytes a band tap (every column and row of
    Rx^T and Ry of each (n, d)) and 4 bytes per (n, d), its longest
    extents."""
    taps = n * d * (2 * w + 2 * h) * 16
    return torch.empty(taps + -(-n * d * 4 // 16) * 16, dtype=torch.uint8,
                       device=device)


def launch_plan(n: int, v: int, c1: int, d: int, h: int, w: int) -> dict:
    """The launch shapes the kernels pick at these sizes (needs the
    library, so a CUDA machine): the forward's depth group, threads,
    shared bytes and blocks, the backward's channel group, threads, shared
    bytes, blocks (its dfr blocks included) and resident blocks per SM."""
    out = (ctypes.c_int * 9)()
    cuda_lib.library().call("sweep_stage2_plan", n, v, c1, d, h, w,
                            ctypes.addressof(out))
    keys = ("fwd_group", "fwd_threads", "fwd_smem", "fwd_blocks",
            "bwd_group", "bwd_threads", "bwd_smem", "bwd_blocks",
            "bwd_per_sm")
    return dict(zip(keys, list(out)))


def sweep_stage2_fwd(fa, ref, fr, rxt, ry, v: int):
    """The forward kernel (``csrc/sweep_stage2.cu``) on CUDA tensors: the
    contract of ``sweep_stage2_plain``, no autograd."""
    _check(fa, ref, fr, rxt, ry, v)
    n, c1, h, w = fa.shape
    d = fr.shape[1]
    cost = torch.empty((n, d, h, w), dtype=torch.float32, device=fa.device)
    diag = torch.empty_like(cost)
    scratch = _scratch(n, d, h, w, fa.device)
    cuda_lib.launch(
        "sweep_stage2_fwd", fa.data_ptr(), ref.data_ptr(), fr.data_ptr(),
        rxt.data_ptr(), ry.data_ptr(), cost.data_ptr(), diag.data_ptr(),
        scratch.data_ptr(), n, v, c1, d, h, w,
        cuda_lib.stream_ptr(fa.device), device=fa.device)
    sweep_stage2.launches += 1
    return cost, diag


class _Stage2(torch.autograd.Function):
    """Forward and backward of stage 2: the kernels for CUDA tensors, the
    plain versions for CPU tensors. Saves the five inputs only."""

    @staticmethod
    def forward(ctx, fa, ref, fr, rxt, ry, v):
        ctx.v = v
        ctx.save_for_backward(fa, ref, fr, rxt, ry)
        if fa.device.type == "cpu":
            return sweep_stage2_plain(fa, ref, fr, rxt, ry, v)
        return sweep_stage2_fwd(fa, ref, fr, rxt, ry, v)

    @staticmethod
    def backward(ctx, gcost, gdiag):
        fa, ref, fr, rxt, ry = ctx.saved_tensors
        gcost = gcost.to(torch.float32).contiguous()
        gdiag = gdiag.to(torch.float32).contiguous()
        bwd = (sweep_stage2_bwd_plain if fa.device.type == "cpu"
               else sweep_stage2_bwd)
        dfa, dref, dfr = bwd(fa, ref, fr, rxt, ry, gcost, gdiag, ctx.v)
        return (dfa.to(fa.dtype), dref.to(ref.dtype), dfr.to(fr.dtype),
                None, None, None)


def sweep_stage2_bwd(fa, ref, fr, rxt, ry, gcost, gdiag, v: int):
    """The backward kernel (``csrc/sweep_stage2.cu``) on CUDA tensors: the
    contract of ``sweep_stage2_bwd_plain``; gcost, gdiag f32 contiguous."""
    _check(fa, ref, fr, rxt, ry, v)
    for name, g in (("gcost", gcost), ("gdiag", gdiag)):
        if (g.device != fa.device or g.dtype != torch.float32
                or not g.is_contiguous() or g.shape != fr.shape):
            raise ValueError(f"sweep_stage2 backward: {name} must be a "
                             f"contiguous f32 {tuple(fr.shape)} tensor on "
                             f"{fa.device}")
    n, c1, h, w = fa.shape
    d = fr.shape[1]
    dfa = torch.empty((n, c1, h, w), dtype=torch.float32, device=fa.device)
    dref = torch.empty((n // v, c1, h, w), dtype=torch.float32,
                       device=fa.device)
    dfr = torch.empty((n, d, h, w), dtype=torch.float32, device=fa.device)
    scratch = _scratch(n, d, h, w, fa.device)
    cuda_lib.launch(
        "sweep_stage2_bwd", fa.data_ptr(), ref.data_ptr(), fr.data_ptr(),
        rxt.data_ptr(), ry.data_ptr(), gcost.data_ptr(), gdiag.data_ptr(),
        dfa.data_ptr(), dref.data_ptr(), dfr.data_ptr(), scratch.data_ptr(),
        n, v, c1, d, h, w, cuda_lib.stream_ptr(fa.device), device=fa.device)
    sweep_stage2.bwd_launches += 1
    return dfa, dref, dfr


def sweep_stage2(fa, ref, fr, rxt, ry, v: int):
    """Fused stage-2 sweep with its backward; see ``sweep_stage2_plain``
    and ``sweep_stage2_bwd_plain`` for the contract.

    A CPU tensor runs the plain versions. A CUDA tensor launches the
    kernels (bf16, contiguous, shapes as documented) or raises.
    """
    if fa.device.type != "cpu":
        _check(fa, ref, fr, rxt, ry, v)
    return _Stage2.apply(fa, ref, fr, rxt, ry, v)


#: kernel launches since the last reset (plain-version calls not counted):
#: ``launches`` of the forward, ``bwd_launches`` of the backward
sweep_stage2.launches = 0
sweep_stage2.bwd_launches = 0
