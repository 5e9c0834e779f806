"""Image resampling primitives the serving path uses.

Port of ``depthestimation_tpu/ops/resample.py``: ``fast_take`` (the
gather behind the plane sweep's 4-tap bilinear sampling),
``resize_bilinear_align_corners`` and ``shift_rows``. Geometry matches the
JAX functions exactly (zero padding, the same index and weight formulas).
"""

from __future__ import annotations

import torch


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
