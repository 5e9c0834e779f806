"""Image resampling primitives.

Port of ``depthestimation_tpu/ops/resample.py``: ``fast_take`` (the
gather behind the plane sweep's 4-tap bilinear sampling),
``_unnormalize``, ``grid_sample``, ``hwarp``, ``static_row_resample``,
``grid_sample_pixel``, ``resize_bilinear_align_corners`` and
``shift_rows``. Geometry matches the
JAX functions exactly (zero padding, the same index and weight formulas).
``grid_sample`` and ``hwarp`` take a leading batch axis (the JAX per-item
functions vmapped). Two helpers stand in for JAX functions torch lacks:
``interp`` (``jnp.interp``) and ``resize_linear`` (``jax.image.resize``
with ``method="linear"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
           left=None, right=None) -> torch.Tensor:
    """``jnp.interp`` along the last axis, batched over leading axes:
    piecewise-linear ``fp(xp)`` at ``x``. xp, fp [..., N] with xp
    increasing along N; x [..., M] (the leading axes broadcast).
    ``left`` / ``right`` fill ``x < xp[0]`` / ``x > xp[-1]`` (default: the
    end values; NaN is a legal fill). The same index and weight formulas
    as JAX's, a zero-width segment taking its left value."""
    lead = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1],
                                  fp.shape[:-1])
    x = x.expand(lead + x.shape[-1:]).contiguous()
    xp = xp.expand(lead + xp.shape[-1:]).contiguous()
    fp = fp.expand(lead + fp.shape[-1:]).contiguous()
    n = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    lo = fp[..., :1] if left is None else torch.as_tensor(
        left, dtype=fp.dtype, device=fp.device)
    hi = fp[..., -1:] if right is None else torch.as_tensor(
        right, dtype=fp.dtype, device=fp.device)
    f = torch.where(x < xp[..., :1], lo, f)
    return torch.where(x > xp[..., -1:], hi, f)


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, x.shape[:-2] + size, method="linear")`` on the
    last two axes: half-pixel centres, with the triangle kernel widened
    when downsampling (JAX's default antialiasing) — torch's
    ``antialias=True`` bilinear is the same filter."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + x.shape[-2:]), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + y.shape[-2:])


def fast_take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take(flat, idx, axis=-1)`` batched over leading axes.

    flat: [..., C, L]; idx: [..., *S] integer indices into L (the same
    leading axes as ``flat``). Returns [..., C, *S].
    """
    lead = flat.shape[:-2]
    c = flat.shape[-2]
    s = idx.shape[len(lead):]
    gi = idx.reshape(lead + (1, -1)).expand(lead + (c, -1))
    return torch.gather(flat, -1, gi).reshape(lead + (c,) + s)


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool):
    """[-1, 1] grid coordinate -> pixel coordinate."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1.0)
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear", align_corners: bool = False):
    """Sample img [B, C, H, W] at normalized grid [B, ..., 2] (x, y in
    [-1, 1]) with zero padding -> [B, C, ...]. The JAX gather form: taps
    into a 1-px zero-padded flat image, border masks folded into per-sample
    weights; ``nearest`` rounds half up (``floor(x + 0.5)``)."""
    b, c, h, w = img.shape
    out_shape = grid.shape[1:-1]
    g = grid.reshape(b, -1, 2)
    x = _unnormalize(g[..., 0], w, align_corners)
    y = _unnormalize(g[..., 1], h, align_corners)
    wp = w + 2
    flat = torch.nn.functional.pad(img, (1, 1, 1, 1)).reshape(
        b, c, (h + 2) * wp)

    def tap(ix, iy, weight):
        valid = (ix >= -1) & (ix <= w) & (iy >= -1) & (iy <= h)
        ixc = torch.clamp(ix + 1, 0, wp - 1).long()
        iyc = torch.clamp(iy + 1, 0, h + 1).long()
        return iyc * wp + ixc, torch.where(valid, weight,
                                           0.0).to(img.dtype)

    if mode == "nearest":
        ix, iy = torch.floor(x + 0.5), torch.floor(y + 0.5)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx, wt = tap(ix, iy, valid.to(img.dtype))
        out = fast_take(flat, idx) * wt[:, None]
    elif mode == "bilinear":
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0).to(img.dtype), (y - y0).to(img.dtype)
        taps = [tap(x0, y0, (1 - fx) * (1 - fy)),
                tap(x0 + 1, y0, fx * (1 - fy)),
                tap(x0, y0 + 1, (1 - fx) * fy),
                tap(x0 + 1, y0 + 1, fx * fy)]
        n = x.shape[1]
        t = fast_take(flat, torch.cat([i for i, _ in taps], dim=1))
        wts = torch.stack([wt for _, wt in taps], dim=1)      # [B, 4, N]
        out = (t.reshape(b, c, 4, n) * wts[:, None]).sum(dim=2)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out.reshape((b, c) + out_shape)


def hwarp(img: torch.Tensor, xn: torch.Tensor, mode: str = "bilinear",
          band: int | None = None, align_corners: bool = False):
    """Horizontal-only warp of a rectified rig: row y of the output samples
    row y of ``img`` at normalized x ``xn`` (the ``grid_sample`` grid's x).

    img [B, C, H, W], xn [B, H, W]. Pixels whose source lies more than
    ``band - 1`` pixels from their own column (default band
    ``max(16, W // 6)``, at least the largest stereo disparity at KITTI
    scale) read zero and are false in the returned ``in_band``; fold it
    into validity. The JAX function computes the per-row linear map as a
    block-banded one-hot matmul for the TPU's matrix unit; here it is the
    same map as two taps gathered from the row padded by ``band`` zeros on
    each side (every in-band tap falls inside that padding), so the two
    agree to the order of a two-term sum. Returns (warped [B, C, H, W],
    in_band [B, H, W] bool).
    """
    b, c, h, w = img.shape
    if band is None:
        band = max(16, w // 6)
    x = _unnormalize(xn, w, align_corners)
    xg = torch.arange(w, dtype=x.dtype, device=x.device)
    in_band = (x - xg).abs() <= (band - 1)
    pad = torch.nn.functional.pad(img, (band, band))     # [B, C, H, W+2K]
    wpad = w + 2 * band

    def take(col):
        idx = torch.clamp(col + band, 0, wpad - 1).long()
        return torch.gather(pad, 3, idx[:, None].expand(b, c, h, w))

    if mode == "nearest":
        out = take(torch.floor(x + 0.5))
    elif mode == "bilinear":
        x0 = torch.floor(x)
        fx = (x - x0).to(img.dtype)[:, None]
        out = take(x0) * (1.0 - fx) + take(x0 + 1) * fx
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out * in_band[:, None].to(img.dtype), in_band


def static_row_resample(img: torch.Tensor, mode: str = "bilinear",
                        align_corners: bool = False):
    """Resample rows at ``y_eff = _unnormalize(yn_identity, H,
    align_corners)``: the fixed vertical blend that ``inverse_warp``'s
    align_corners=True grid sampled with align_corners=False applies even
    for a pure-x pose (the hwarp path applies it first). img [..., H, W]."""
    h = img.shape[-2]
    dev = img.device
    yn = 2.0 * torch.arange(h, dtype=torch.float32, device=dev) / max(
        h - 1, 1) - 1.0
    y = _unnormalize(yn, h, align_corners)
    pad = torch.nn.functional.pad(img, (0, 0, 1, 1))     # zero ring, 1 row
    if mode == "nearest":
        y0 = torch.clamp(torch.floor(y + 0.5).long() + 1, 0, h + 1)
        return pad.index_select(-2, y0)
    y0 = torch.floor(y)
    fy = (y - y0).to(img.dtype)[:, None]
    i0 = torch.clamp(y0.long() + 1, 0, h + 1)
    return (pad.index_select(-2, i0) * (1.0 - fy)
            + pad.index_select(-2, torch.clamp(i0 + 1, 0, h + 1)) * fy)


def grid_sample_pixel(img: torch.Tensor, pix: torch.Tensor,
                      mode: str = "bilinear") -> torch.Tensor:
    """Sample img [B, C, H, W] at PIXEL coordinates pix [B, ..., 2] (x, y)
    with zero padding -> [B, C, ...]. Rounds through the normalized
    coordinates (``align_corners=True``) as the JAX function does, so the
    two round alike."""
    h, w = img.shape[-2], img.shape[-1]
    x = pix[..., 0] * (2.0 / max(w - 1, 1)) - 1.0
    y = pix[..., 1] * (2.0 / max(h - 1, 1)) - 1.0
    return grid_sample(img, torch.stack([x, y], dim=-1), mode=mode,
                       align_corners=True)


def resize_bilinear_align_corners(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True. img: [..., H, W] ->
    [..., out_h, out_w]. The weights are float32, as in JAX, so a bf16
    input comes out float32."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    dev = img.device

    def axis_weights(n_in, n_out):
        if n_out == 1 or n_in == 1:
            idx0 = torch.zeros((n_out,), dtype=torch.long, device=dev)
            return idx0, idx0, torch.zeros((n_out,), dtype=torch.float32,
                                           device=dev)
        pos = (torch.arange(n_out, dtype=torch.float32, device=dev)
               * (n_in - 1) / (n_out - 1))
        i0 = torch.clamp(torch.floor(pos).long(), 0, n_in - 2)
        frac = pos - i0.float()
        return i0, i0 + 1, frac

    y0, y1, fy = axis_weights(h, oh)
    x0, x1, fx = axis_weights(w, ow)
    top = img.index_select(-2, y0)
    bot = img.index_select(-2, y1)
    rows = top * (1 - fy)[:, None] + bot * fy[:, None]
    left = rows.index_select(-1, x0)
    right = rows.index_select(-1, x1)
    return left * (1 - fx) + right * fx


def shift_rows(img: torch.Tensor, shift: int) -> torch.Tensor:
    """Shift an image down (positive) / up (negative) along H with zero
    fill. img: [..., H, W]."""
    if shift == 0:
        return img
    h = img.shape[-2]
    rolled = torch.roll(img, shift, dims=-2)
    rows = torch.arange(h, device=img.device)
    valid = rows >= shift if shift > 0 else rows < h + shift
    return rolled * valid[:, None].to(img.dtype)
