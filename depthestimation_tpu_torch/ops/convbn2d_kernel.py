"""Fused 2D ConvBN layer on hand-written Hopper kernels, and its plain
versions.

Counterpart of ``depthestimation_tpu/ops/convbn2d_pallas.py`` and its
custom VJP: normalize(+activation) on load -> 3x3 stride-1 'same' conv ->
BN statistics, the layer of the encoder's fused ConvBN chain and of the
decoder's refine tail.

Layout: JAX's strip layout ``[N_strips, C, rows*W]`` with ``rows = H``
(one strip per image) is PyTorch's contiguous ``[N, C, H, W]``, so the port
keeps NCHW and has no counterpart of ``to_strips``, ``from_strips``,
``_pick_rows``, the seam rings, ``_im2col3`` or ``_xla_seam_dw``: the
kernel's halo tile reads the neighbouring image rows directly. JAX's
channel padding to multiples of 8 (``layers.py:124-140``) is TPU sublane
padding; the kernel pads to 16 inside. In JAX's default ``seam_dw="xla"``
the seam rows of dW take f32 u and ge, while the port (and JAX's in-strip
rows) use bf16 operands in every row: a rounding difference inside the dW
tolerance, not a fault.

``convbn2d_block`` is one autograd Function on both devices: for a CUDA
tensor its forward and backward launch ``csrc/convbn2d.cu``, for a CPU
tensor they run ``convbn2d_block_plain`` and ``convbn2d_block_bwd_plain``.
It saves the raw input and output only (``x, w, a, b, y``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from depthestimation_tpu_torch.ops import cuda_lib

ACTS = ("none", "relu", "leaky")
_MAX_CH = 80        # csrc/convbn2d.cu kMaxMT * 16
_TILE = (8, 16)     # output pixels per unit of the conv kernels (kTH, kTW)
_DW_TILE = (4, 16)  # pixels per unit of the weight-gradient kernel
_DW_SLOTS = 16 * 5  # (m16, n16) tiles one weight-gradient block holds


def _act(v: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(v)
    if act == "leaky":
        return torch.where(v >= 0, v, 0.01 * v)
    return v


def _bc(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def convbn2d_block_plain(x, w, a, b, act: str = "none"):
    """``F.conv2d`` of the normalized input, with the kernel's rounding
    points (``convbn2d_pallas.py:142-198``).

    x [N, C, H, W] (dtype ``cdt``), w [F, C, 3, 3] (``cdt``), a, b [C] f32.
    ``u = act(x a + b)`` in f32 (``act`` in ``ACTS``) is rounded to ``cdt``
    before the conv; y comes out in ``cdt`` and the statistics are f32 sums
    of that ``cdt`` output.

    Returns (y [N, F, H, W] cdt, stats [F, 2] f32 = (sum y, sum y^2)).
    """
    cdt = x.dtype
    u = _act(x.to(torch.float32) * _bc(a) + _bc(b), act)
    y = F.conv2d(u.to(cdt), w.to(cdt), padding=1)
    yf = y.to(torch.float32)
    stats = torch.stack([yf.sum(dim=(0, 2, 3)),
                         (yf * yf).sum(dim=(0, 2, 3))], dim=-1)
    return y, stats


def convbn2d_block_bwd_plain(x, w, a, b, y, gy, gstats, act: str = "none"):
    """The backward of ``convbn2d_block_plain`` with the TPU kernel's
    rounding points (``convbn2d_pallas.py:237-353``):

    - ``ge = gy + s0 + 2 y s1`` (``s = gstats``), rounded to ``cdt``;
    - ``du`` = the transposed 3x3 conv of ge, products of ``cdt`` values
      summed in f32; the activation's mask on the f32 pre-activation
      ``v = x a + b`` (relu: ``v > 0``; leaky: slope 1 at ``v >= 0``);
    - ``dx = dv a`` in ``cdt``, ``da = sum dv x``, ``db = sum dv`` (f32);
    - ``dW = sum ge (x) im2col(u)`` (f32) with ``u`` rebuilt from ``x``.

    Returns (dx [N, C, H, W] cdt, dw [F, C, 3, 3] f32, da [C], db [C]).
    """
    cdt = x.dtype
    f32 = torch.float32
    s0 = gstats[:, 0].to(f32)
    s1 = gstats[:, 1].to(f32)
    ge = (gy.to(f32) + _bc(s0) + 2.0 * y.to(f32) * _bc(s1)).to(cdt).to(f32)
    du = F.conv_transpose2d(ge, w.to(f32), padding=1)
    xf = x.to(f32)
    v = xf * _bc(a) + _bc(b)
    if act == "relu":
        dv = torch.where(v > 0, du, 0.0)
    elif act == "leaky":
        dv = torch.where(v >= 0, du, 0.01 * du)
    else:
        dv = du
    dx = (dv * _bc(a)).to(cdt)
    da = (dv * xf).sum(dim=(0, 2, 3))
    db = dv.sum(dim=(0, 2, 3))
    u = _act(v, act).to(cdt).to(f32)
    dw = torch.nn.grad.conv2d_weight(u, w.shape, ge, padding=1)
    return dx, dw, da, db


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def _ceil_div(p: int, q: int) -> int:
    return -(-p // q)


def _units(n: int, h: int, w: int, tile) -> int:
    return n * _ceil_div(h, tile[0]) * _ceil_div(w, tile[1])


def _check(x, w, a, b, act):
    for name, t, dt in (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                        ("a", a, torch.float32), ("b", b, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"convbn2d_block: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dt:
            raise TypeError(f"convbn2d_block: the kernel takes {name} as "
                            f"{dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"convbn2d_block: {name} is not contiguous")
    if act not in ACTS:
        raise ValueError(f"convbn2d_block: act {act!r} not in {ACTS}")
    if x.dim() != 4:
        raise ValueError(f"convbn2d_block: x must be [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if (w.dim() != 4 or w.shape[1:] != (c, 3, 3) or a.shape != (c,)
            or b.shape != (c,)):
        raise ValueError(f"convbn2d_block: w {tuple(w.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} do not match "
                         f"C={c}")
    if c > _MAX_CH or w.shape[0] > _MAX_CH:
        raise ValueError(f"convbn2d_block: the kernels take C, F <= "
                         f"{_MAX_CH}, got C={c}, F={w.shape[0]}")


def _fwd(x, w, a, b, act):
    """The forward kernel on checked CUDA tensors."""
    n, c, h, wd = x.shape
    f = w.shape[0]
    cp, fp = _round16(c), _round16(f)
    dev = x.device
    # kernel weight layout [Fp, 9, Cp]: K index (kh*3 + kw)*Cp + c
    wk = torch.zeros((fp, 9, cp), dtype=torch.bfloat16, device=dev)
    wk[:f, :, :c] = w.reshape(f, c, 9).permute(0, 2, 1)
    y = torch.empty((n, f, h, wd), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((f, 2), dtype=torch.float32, device=dev)
    partials = torch.empty((f, _units(n, h, wd, _TILE), 2),
                           dtype=torch.float32, device=dev)
    cuda_lib.library().call(
        "convbn2d_fwd", x.data_ptr(), wk.data_ptr(), a.data_ptr(),
        b.data_ptr(), y.data_ptr(), stats.data_ptr(), partials.data_ptr(),
        n, c, cp, f, fp, h, wd, ACTS.index(act), cuda_lib.stream_ptr(dev))
    convbn2d_block.launches += 1
    return y, stats


def convbn2d_block_bwd(x, w, a, b, y, gy, gstats, act: str = "none"):
    """The backward kernels (``csrc/convbn2d.cu``, ``convbn2d_bwd``) on
    CUDA tensors: the contract of ``convbn2d_block_bwd_plain``; y, gy bf16
    and gstats f32, contiguous; C, F <= 80. Returns (dx, dw [F, C, 3, 3]
    f32, da, db)."""
    _check(x, w, a, b, act)
    n, c, h, wd = x.shape
    f = w.shape[0]
    for name, t, dt, shape in (("y", y, torch.bfloat16, (n, f, h, wd)),
                               ("gy", gy, torch.bfloat16, (n, f, h, wd)),
                               ("gstats", gstats, torch.float32, (f, 2))):
        if (t.device != x.device or t.dtype != dt or not t.is_contiguous()
                or t.shape != shape):
            raise ValueError(f"convbn2d_block backward: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {x.device}")
    dev = x.device
    cp, fp = _round16(c), _round16(f)
    # data-gradient weights [Cp, 9, Fp]: wkb[c, s, f] = W[f, c, 8 - s]
    wkb = torch.zeros((cp, 9, fp), dtype=torch.bfloat16, device=dev)
    wkb[:c, :, :f] = w.flip(-1).flip(-2).permute(1, 2, 3, 0).reshape(c, 9, f)
    pairs = (fp // 16) * (9 * cp // 16)
    nsplit = _ceil_div(pairs, _DW_SLOTS)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    dw_blocks = max(1, min(_units(n, h, wd, _DW_TILE), n_sm // nsplit))
    dx = torch.empty_like(x)
    dab = torch.empty((c, 2), dtype=torch.float32, device=dev)
    ab_partials = torch.empty((c, _units(n, h, wd, _TILE), 2),
                              dtype=torch.float32, device=dev)
    dw = torch.empty((fp, 9, cp), dtype=torch.float32, device=dev)
    dw_partials = torch.empty((dw_blocks, fp, 9, cp), dtype=torch.float32,
                              device=dev)
    s01 = gstats.t().contiguous()
    cuda_lib.library().call(
        "convbn2d_bwd", x.data_ptr(), wkb.data_ptr(), a.data_ptr(),
        b.data_ptr(), y.data_ptr(), gy.data_ptr(), s01.data_ptr(),
        dx.data_ptr(), dab.data_ptr(), ab_partials.data_ptr(), dw.data_ptr(),
        dw_partials.data_ptr(), n, c, cp, f, fp, h, wd, ACTS.index(act),
        dw_blocks, nsplit, cuda_lib.stream_ptr(dev))
    convbn2d_block.bwd_launches += 1
    # dW [Fp, 9, Cp] -> the conv weight's [F, C, 3, 3]
    dw = dw[:f, :, :c].permute(0, 2, 1).reshape(f, c, 3, 3)
    return dx, dw, dab[:, 0], dab[:, 1]


class _ConvBN2d(torch.autograd.Function):
    """Forward and backward of one layer: the kernels for CUDA tensors, the
    plain versions for CPU tensors. Saves x, w, a, b and y only."""

    @staticmethod
    def forward(ctx, x, w, a, b, act):
        ctx.act = act
        if x.device.type == "cpu":
            y, stats = convbn2d_block_plain(x, w, a, b, act)
        else:
            y, stats = _fwd(x, w, a, b, act)
        ctx.save_for_backward(x, w, a, b, y)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, w, a, b, y = ctx.saved_tensors
        gy = gy.to(y.dtype).contiguous()
        gstats = gstats.to(torch.float32).contiguous()
        bwd = (convbn2d_block_bwd_plain if x.device.type == "cpu"
               else convbn2d_block_bwd)
        dx, dw, da, db = bwd(x, w, a, b, y, gy, gstats, ctx.act)
        return dx, dw.to(w.dtype), da.to(a.dtype), db.to(b.dtype), None


def convbn2d_block(x, w, a, b, act: str = "none"):
    """Fused normalize(+act) -> 3x3 stride-1 conv -> BN stats, with its
    backward; see ``convbn2d_block_plain`` and ``convbn2d_block_bwd_plain``
    for the contract.

    A CPU tensor runs the plain versions. A CUDA tensor launches the
    kernels (x, w bf16; a, b f32; contiguous; C, F <= 80) or raises.
    """
    if x.device.type != "cpu":
        _check(x, w, a, b, act)
    return _ConvBN2d.apply(x, w, a, b, act)


#: kernel launches since the last reset (plain-version calls not counted):
#: ``launches`` of the forward, ``bwd_launches`` of the backward
convbn2d_block.launches = 0
convbn2d_block.bwd_launches = 0
