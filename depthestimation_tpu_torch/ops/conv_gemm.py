"""The GEMMs of the fused conv blocks, forward and backward, in the
orientation of the Hopper kernels (``csrc/convbn2d.cu``,
``csrc/convcomb.cu``).

Both forward kernels compute one implicit GEMM on the tensor cores,
``P[p, n] = sum_k A[p, k] B[k, n]`` over output pixels p (wgmma's M), with
``A = im2col(u)`` of the normalized input ``u = bf16(act(x a + b))`` (K
index ``s*Cp + c``: channel c at 3x3 shift s, s = kh*3 + kw) and ``B`` the
weights read from the module's layout, ``B[s*Cp + c, f] = W[f, c, s]``
(N = Fp). Base3D's layer stacks its three depth taps on N with a stride S
of 8, 16 or 32 (``tap_stride``): ``B[s*Cp + c, t*S + f] = wm[t*F + f, c,
s]``, so that one thread's accumulators hold all three taps of a channel
and the depth ring ``y(n) = bf16(bf16(t1(n) + t0(n-1)) + t2(n+1))`` runs on
them (taps rounded to bf16, masked at the item's depth edges).

Both backward kernels compute two products on the tensor cores:

- the data gradient, an implicit GEMM ``du[p, c] = sum_k A[p, k] B[k, c]``
  over output pixels p (wgmma's M), with ``A = im2col(ge)`` (K index
  ``s*Fp + f``: channel f of the cotangent at 3x3 shift s, s = kh*3 + kw)
  and ``B`` the flipped, transposed weights ``B[s*Fp + f, c] = W[f, c,
  8 - s]``, read from W's own layout. Base3D's layer stacks the three
  depth taps' matrices ([27 Fp, Cp]): slot q holds tap 2 - q, applied to
  the depth ring ``ge(n-1), ge(n), ge(n+1)``;
- the weight gradient ``P[s*Cp + c, n] = sum_p u[c, p + shift_s] G[p, n]``
  over every pixel (K), the long side 9 Cp on M and the short side on N:
  ``G = ge`` (N = F) for the 2D layer, the three taps ``g_0(n) =
  ge(n+1)[n%D < D-1], g_1(n) = ge(n), g_2(n) = ge(n-1)[n%D > 0]`` (N = 3F)
  for Base3D's; the second pass writes P into the weight's own layout.

The functions below compute the same products with ``torch.matmul`` in
f32, padded as the kernels pad, so the CPU tests hold this decomposition
against the plain versions; ``dw_split`` is the weight-gradient launch's
division of M among warpgroups, which the wrappers pass to the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round16(v: int) -> int:
    return (v + 15) // 16 * 16


def ceil_div(p: int, q: int) -> int:
    return -(-p // q)


def dw_split(m_rows: int) -> tuple[int, int]:
    """(nsplit, wgs): the weight-gradient kernel's M side of ``m_rows``
    rows in 64-row wgmma tiles, one per warpgroup, at most 3 warpgroups
    a block (csrc/conv_bwd.cuh kDwMaxWgs: 170 registers a thread) and
    ``nsplit`` blocks (``blockIdx.y``) over the tiles, with as few idle
    warpgroups as that allows."""
    tiles = ceil_div(m_rows, 64)
    nsplit = ceil_div(tiles, min(tiles, 3))
    return nsplit, ceil_div(tiles, nsplit)


def fold_ge(gy, y, gstats):
    """ge = gy + s0 + 2 y s1 in f32, rounded to ``y``'s dtype, per output
    channel (dim 1)."""
    shape = (1, -1) + (1,) * (gy.dim() - 2)
    s0 = gstats[:, 0].float().reshape(shape)
    s1 = gstats[:, 1].float().reshape(shape)
    return (gy.float() + s0 + 2.0 * y.float() * s1).to(y.dtype)


def im2col(t: torch.Tensor, kp: int) -> torch.Tensor:
    """t [N, K, H, W] -> [N*H*W, 9*kp]: column ``s*kp + k`` is channel k
    at 3x3 shift s (zero padding of the image and of channels K .. kp)."""
    n, k, h, w = t.shape
    tp = F.pad(t, (1, 1, 1, 1, 0, kp - k))
    cols = [tp[:, :, s // 3:s // 3 + h, s % 3:s % 3 + w] for s in range(9)]
    return torch.stack(cols, 1).permute(0, 3, 4, 1, 2).reshape(n * h * w,
                                                               9 * kp)


def dx_weights(w: torch.Tensor, fp: int, cp: int) -> torch.Tensor:
    """W [F, C, 3, 3] -> B [9*fp, cp], ``B[s*fp + f, c] = W[f, c, 8 - s]``
    (the kernels' shared-memory B of the data gradient)."""
    f, c = w.shape[:2]
    wf = w.reshape(f, c, 9).flip(-1).permute(2, 0, 1)            # [9, F, C]
    return F.pad(wf, (0, cp - c, 0, fp - f)).reshape(9 * fp, cp)


def convcomb_dx_weights(wm: torch.Tensor, fp: int, cp: int) -> torch.Tensor:
    """Base3D's wm [3F, C, 3, 3] -> [3, 9*fp, cp]: slot q holds tap 2 - q
    as ``dx_weights`` lays a 2D conv's (the [27 F, C] stack)."""
    f = wm.shape[0] // 3
    return torch.stack([dx_weights(wm[(2 - q) * f:(3 - q) * f], fp, cp)
                        for q in range(3)])


def weight_from_gemm(p: torch.Tensor, f: int, c: int,
                     cp: int) -> torch.Tensor:
    """P [9*cp, >= f] -> the conv weight's [f, c, 3, 3]:
    ``dW[f, c, s] = P[s*cp + c, f]`` (the second pass's write)."""
    return p[:, :f].reshape(9, cp, f)[:, :c].permute(2, 1, 0).reshape(
        f, c, 3, 3)


def _epilogue(du, x, a, b, act: str):
    """(dx, da, db) from du [N, C, H, W] f32: the mask of the activation
    at the f32 pre-activation, ``dx = dv a`` in x's dtype, f32 sums."""
    xf = x.float()
    v = xf * a[None, :, None, None] + b[None, :, None, None]
    if act == "relu":
        dv = torch.where(v > 0, du, 0.0)
    elif act == "leaky":
        dv = torch.where(v >= 0, du, 0.01 * du)
    else:
        dv = du
    dx = (dv * a[None, :, None, None]).to(x.dtype)
    return dx, (dv * xf).sum(dim=(0, 2, 3)), dv.sum(dim=(0, 2, 3))


def _u(x, a, b, act: str):
    """The normalized input, rounded to x's dtype as the kernels stage it."""
    v = x.float() * a[None, :, None, None] + b[None, :, None, None]
    if act == "relu":
        v = torch.relu(v)
    elif act == "leaky":
        v = torch.where(v >= 0, v, 0.01 * v)
    return v.to(x.dtype)


def convbn2d_bwd_gemm(x, w, a, b, y, gy, gstats, act: str = "none"):
    """The 2D layer's backward as the kernels' two GEMMs (f32 products of
    the bf16 operands): x [N, C, H, W], w [F, C, 3, 3]. Returns (dx, dw
    [F, C, 3, 3] f32, da, db), the contract of
    ``convbn2d_kernel.convbn2d_block_bwd_plain``."""
    n, c, h, wd = x.shape
    f = w.shape[0]
    cp, fp = round16(c), round16(f)
    ge = fold_ge(gy, y, gstats)
    du = im2col(ge.float(), fp) @ dx_weights(w.float(), fp, cp)
    du = du[:, :c].reshape(n, h, wd, c).permute(0, 3, 1, 2)
    dx, da, db = _epilogue(du, x, a, b, act)
    g = F.pad(ge.float(), (0, 0, 0, 0, 0, fp - f))
    g = g.permute(0, 2, 3, 1).reshape(n * h * wd, fp)           # [pixels, N]
    p = im2col(_u(x, a, b, act).float(), cp).t() @ g            # [9 cp, fp]
    return dx, weight_from_gemm(p, f, c, cp), da, db


def depth_taps(ge: torch.Tensor, depth: int) -> torch.Tensor:
    """ge [N, F, ...] -> [N, 3F, ...]: the taps' cotangents ``g_0(n) =
    ge(n+1)[n%D < D-1]``, ``g_1(n) = ge(n)``, ``g_2(n) = ge(n-1)[n%D >
    0]`` (the weight gradient's N side)."""
    row = torch.arange(ge.shape[0], device=ge.device) % depth
    shape = (-1,) + (1,) * (ge.dim() - 1)
    g0 = torch.roll(ge, -1, 0) * (row < depth - 1).reshape(shape)
    g2 = torch.roll(ge, 1, 0) * (row > 0).reshape(shape)
    return torch.cat([g0, ge, g2], 1)


def convcomb_bwd_gemm(x, wm, a, b, y, gy, gstats, depth: int, h: int,
                      w: int, relu_in: bool = False):
    """Base3D's layer backward as the kernels' GEMMs: the data gradient
    over the depth ring ``du(n) = P_1(n) + P_2(n-1)[n%D>0] +
    P_0(n+1)[n%D<D-1]`` with ``P_t`` tap t's product (slot 2 - t of
    ``convcomb_dx_weights``), the weight gradient over the stacked taps
    (N = 3F, padded to 16). x [N, C, h*w], wm [3F, C, 3, 3]. Returns (dx,
    dwm [3F, C, 3, 3] f32, da, db), the contract of
    ``convcomb_kernel.convbn_block_bwd_plain``."""
    n, c, _ = x.shape
    f = wm.shape[0] // 3
    cp, fp, np_ = round16(c), round16(f), round16(3 * f)
    act = "relu" if relu_in else "none"
    ge = fold_ge(gy, y, gstats).float().reshape(n, f, h, w)
    cols = im2col(ge, fp)                                        # [n h w, 9fp]
    bq = convcomb_dx_weights(wm.float(), fp, cp)
    prod = [(cols @ bq[q])[:, :c].reshape(n, h, w, c).permute(0, 3, 1, 2)
            for q in range(3)]                                   # P_{2-q}
    row = torch.arange(n) % depth
    up = (row < depth - 1).reshape(-1, 1, 1, 1)
    dn = (row > 0).reshape(-1, 1, 1, 1)
    du = (prod[1] + torch.roll(prod[0], 1, 0) * dn
          + torch.roll(prod[2], -1, 0) * up)
    xs = x.reshape(n, c, h, w)
    dx, da, db = _epilogue(du, xs, a, b, act)
    g = F.pad(depth_taps(ge, depth), (0, 0, 0, 0, 0, np_ - 3 * f))
    g = g.permute(0, 2, 3, 1).reshape(n * h * w, np_)
    p = im2col(_u(xs, a, b, act).float(), cp).t() @ g            # [9cp, np_]
    return (dx.reshape(n, c, h * w), weight_from_gemm(p, 3 * f, c, cp), da,
            db)


def tap_stride(f: int) -> int:
    """The column stride of Base3D's stacked taps in the forward's N
    (``csrc/convcomb.cu``, ``convcomb_fwd``): 8, 16 or 32, at least F."""
    return 8 if f <= 8 else 16 if f <= 16 else 32


def fwd_weights(w: torch.Tensor, cp: int, np_: int) -> torch.Tensor:
    """W [F, C, 3, 3] -> B [9*cp, np_], ``B[s*cp + c, f] = W[f, c, s]``
    (the forward kernels' shared-memory B, zero padded)."""
    f, c = w.shape[:2]
    wf = w.reshape(f, c, 9).permute(2, 1, 0)                     # [9, C, F]
    return F.pad(wf, (0, np_ - f, 0, cp - c)).reshape(9 * cp, np_)


def convcomb_fwd_weights(wm: torch.Tensor, cp: int) -> torch.Tensor:
    """Base3D's wm [3F, C, 3, 3] -> B [9*cp, 3*S] with the taps stacked on
    N at stride S = ``tap_stride(F)``: ``B[s*cp + c, t*S + f] = wm[t*F + f,
    c, s]``."""
    f = wm.shape[0] // 3
    st = tap_stride(f)
    return torch.cat([fwd_weights(wm[t * f:(t + 1) * f], cp, st)
                      for t in range(3)], 1)


def _stats(y: torch.Tensor) -> torch.Tensor:
    """(sum y, sum y^2) per channel (dim 1) in f32."""
    yf = y.float()
    dims = (0,) + tuple(range(2, y.dim()))
    return torch.stack([yf.sum(dim=dims), (yf * yf).sum(dim=dims)], dim=-1)


def convbn2d_fwd_gemm(x, w, a, b, act: str = "none"):
    """The 2D layer's forward as the kernel's GEMM (f32 products of the
    bf16 operands, y rounded to x's dtype): x [N, C, H, W], w [F, C, 3, 3].
    Returns (y, stats [F, 2] f32), the contract of
    ``convbn2d_kernel.convbn2d_block_plain``."""
    n, c, h, wd = x.shape
    f = w.shape[0]
    cp, fp = round16(c), round16(f)
    p = im2col(_u(x, a, b, act).float(), cp) @ fwd_weights(w.float(), cp, fp)
    y = p[:, :f].reshape(n, h, wd, f).permute(0, 3, 1, 2).to(x.dtype)
    return y, _stats(y)


def convcomb_fwd_gemm(x, wm, a, b, depth: int, h: int, w: int,
                      relu_in: bool = False):
    """Base3D's layer forward as the kernel's GEMM over the stacked taps,
    then the depth ring with the kernel's rounding points: each tap
    ``t_k = bf16(P[:, k*S + f])``, ``part(n) = bf16(t1(n) + t0(n-1))``
    (``t1(n)`` at an item's first row), ``y(n) = bf16(part(n) +
    t2(n+1))`` (``part(n)`` at its last). x [N, C, h*w], wm [3F, C, 3, 3].
    Returns (y [N, F, h*w], stats [F, 2] f32), the contract of
    ``convcomb_kernel.convbn_block_plain``."""
    n, c, _ = x.shape
    f = wm.shape[0] // 3
    cp, st = round16(c), tap_stride(f)
    xs = x.reshape(n, c, h, w)
    u = _u(xs, a, b, "relu" if relu_in else "none").float()
    p = im2col(u, cp) @ convcomb_fwd_weights(wm.float(), cp)
    taps = [p[:, k * st:k * st + f].reshape(n, h * w, f).transpose(1, 2)
            .to(x.dtype).float() for k in range(3)]
    row = torch.arange(n) % depth
    dn = (row > 0).reshape(-1, 1, 1)
    up = (row < depth - 1).reshape(-1, 1, 1)
    part = (taps[1] + torch.roll(taps[0], 1, 0) * dn).to(x.dtype).float()
    y = (part + torch.roll(taps[2], -1, 0) * up).to(x.dtype)
    return y, _stats(y)
