# Frozen copy of the port's depthestimation_tpu_torch/losses/blocks.py for the
# benchmark's f32 reference; it imports nothing of the port.
"""Loss building blocks (port of ``depthestimation_tpu/losses/blocks.py``).

The JAX blocks work on one item and ``BaseLoss`` vmaps them; here each
block takes a leading batch axis and returns one value per item ([B]),
the vmapped result. ``ternary_loss`` and ``ssim``, the flow loss's blocks,
return maps as their JAX counterparts do.

Ties are common here (both camera sides of a step may see the same frame,
so a warped depth can equal the target depth exactly, and neighbouring
depths of a smooth map are equal), so the blocks keep JAX's subgradients
at them: ``|x|`` has slope 1 at 0 (PyTorch's ``abs`` has 0), and a clip
splits the gradient evenly at its bounds (PyTorch's ``clamp`` passes it
all).
"""

from __future__ import annotations

import torch

from ref.geometry import (inverse_warp, minpool,
                                                    transform_dmap)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's slope 1 at 0."""
    return torch.where(x >= 0, x, -x)


def _clip(x: torch.Tensor, lo: float, hi: float | None = None):
    """``jnp.clip``: min(max(x, lo), hi), the gradient split at a tie."""
    x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype,
                                          device=x.device))
    return x


def _per_item(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).sum(dim=1)


def mean_on_mask(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean per item, the mask broadcast over channels (the
    denominator is the EXPANDED mask sum). An empty mask gives 0, not NaN.
    diff [B, C, H, W]; mask broadcastable to it."""
    mask_full = torch.broadcast_to(mask, diff.shape)
    total = _per_item(mask_full)
    return torch.where(total > 0,
                       _per_item(diff * mask_full) / torch.clamp(total,
                                                                 min=1.0),
                       0.0)


def soft_cross_entropy_loss(soft_label, log_pred, mask=None):
    """-sum_d q(d) log p(d) per pixel, averaged over the mask.
    soft_label, log_pred [B, D, H, W]; mask [B, 1, H, W]."""
    loss = -(soft_label * log_pred).sum(dim=1)                # [B, H, W]
    if mask is None:
        return loss.mean(dim=(1, 2))
    m = mask[:, 0]
    count = _per_item(m == 1)
    return torch.where(count == 0, 0.0,
                       _per_item(loss * m) / torch.clamp(count, min=1))


def _tophalf_mask(h: int, w: int, device, frac: int = 3) -> torch.Tensor:
    """True below row h // frac (the reference zeroes the top third)."""
    rows = torch.arange(h, device=device) >= (h // frac)
    return rows[:, None].expand(h, w)


def rgb_stereo_consistency_loss(src_rgb, target_rgb, target_depth,
                                pose_target2src, intr, warp_impl="gather"):
    """Photometric L1 between the target and the source warped by the
    target depth. rgb [B, 3, H, W], depth [B, H, W], pose [B, 4, 4]."""
    warped, valid = inverse_warp(src_rgb, target_depth, pose_target2src,
                                 intr, impl=warp_impl)
    h, w = target_depth.shape[-2:]
    full = (valid & _tophalf_mask(h, w, valid.device)).to(
        src_rgb.dtype)[:, None]
    diff = _abs(target_rgb * full - warped * full)
    return mean_on_mask(diff, full)


def depth_stereo_consistency_loss(src_depth, target_depth, src_mask,
                                  pose_target2src, intr, warp_impl="gather"):
    """Warp the source depth into the target view and compare relative
    depth. depths [B, H, W], src_mask [B, 1, H, W], pose [B, 4, 4]."""
    src_trans = transform_dmap(src_depth, torch.linalg.inv(pose_target2src),
                               intr)
    src_trans = (src_trans * src_mask[:, 0])[:, None]        # [B, 1, H, W]
    warped, valid = inverse_warp(src_trans, target_depth, pose_target2src,
                                 intr, mode="nearest", impl=warp_impl)
    warped = warped[:, 0]
    h, w = target_depth.shape[-2:]
    full = (valid & _tophalf_mask(h, w, valid.device)
            & (warped > 0)).to(src_depth.dtype)
    t = _clip(target_depth * full, 1e-3)
    s = _clip(warped * full, 1e-3)
    diff = _clip(_abs(t - s) / _abs(t + s), 0.0, 1.0)
    return mean_on_mask(diff[:, None], full[:, None])


def depth_consistency_loss(large_dm, small_dm):
    """minpool(high-res depth) vs the low-res depth, relative difference.
    large_dm [B, H, W]; small_dm [B, h, w]."""
    down = minpool(large_dm, 4)
    s = _clip(small_dm, 1e-3)
    d = _clip(down, 1e-3)
    diff = _clip(_abs(d - s) / _abs(d + s), 0.0, 1.0)
    h, w = small_dm.shape[-2:]
    mask = _tophalf_mask(h, w, diff.device).to(diff.dtype)[None, None]
    return mean_on_mask(diff[:, None], mask)


def edge_aware_smoothness_loss(depth, rgb):
    """Edge-weighted first-order smoothness (single scale).
    depth [B, H, W]; rgb [B, 3, H, W]."""
    def gx(t):
        return t[..., :-1, :] - t[..., 1:, :]

    def gy(t):
        return t[..., :, :-1] - t[..., :, 1:]

    wx = torch.exp(-_abs(gx(rgb)).mean(dim=1))
    wy = torch.exp(-_abs(gy(rgb)).mean(dim=1))
    sx = _abs(gx(depth)) * wx
    sy = _abs(gy(depth)) * wy
    return sx.mean(dim=(1, 2)) + sy.mean(dim=(1, 2))


def ternary_loss(im: torch.Tensor, im_warp: torch.Tensor,
                 max_distance: int = 1) -> torch.Tensor:
    """Census / ternary-transform distance (after UnFlow). im, im_warp [B,
    3, H, W] RGB in [0, 1] -> [B, 1, H, W], zero on the ``max_distance``
    border."""
    md = max_distance
    k = 2 * md + 1

    def census(img):
        g = (img[:, 0] * 0.2989 + img[:, 1] * 0.5870
             + img[:, 2] * 0.1140)[:, None] * 255.0
        pad = torch.nn.functional.pad(g, (md, md, md, md))
        h, w = g.shape[-2:]
        patches = torch.cat([pad[:, :, dy:dy + h, dx:dx + w]
                             for dy in range(k) for dx in range(k)], dim=1)
        diff = patches - g
        return diff / torch.sqrt(0.81 + diff * diff)

    d = (census(im) - census(im_warp)) ** 2
    dist = (d / (0.1 + d)).mean(dim=1, keepdim=True)
    h, w = im.shape[-2:]
    mask = torch.zeros((1, 1, h, w), dtype=im.dtype, device=im.device)
    mask[..., md:h - md, md:w - md] = 1.0
    return dist * mask


def ssim(x: torch.Tensor, y: torch.Tensor, md: int = 1) -> torch.Tensor:
    """SSIM distance map of x, y [C, H, W] -> [C, H - 2 md, W - 2 md]:
    means and (co)variances over (2 md + 1)^2 windows, a 'valid' box
    convolution as JAX's ``convolve2d``."""
    k = 2 * md + 1
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    win = torch.full((x.shape[0], 1, k, k), 1.0 / (k * k), dtype=x.dtype,
                     device=x.device)

    def pool(t):
        return torch.nn.functional.conv2d(t[None], win,
                                          groups=t.shape[0])[0]

    mu_x, mu_y = pool(x), pool(y)
    sig_x = pool(x * x) - mu_x ** 2
    sig_y = pool(y * y) - mu_y ** 2
    sig_xy = pool(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sig_x + sig_y + c2)
    return _clip((1 - num / den) / 2, 0.0, 1.0)
