"""Sintel-size image pairs, made on the device from the seed.

The traffic file gives the sizes (``h100_bench/traffic/<name>.json``):

- ``batch`` pairs a step, ``groups`` batches cycled, ``size`` [H, W];
- the background: smooth texture (uniform noise on a grid of each of
  ``octaves``' cell sizes in px, upsampled bicubically, each octave half
  the weight of the one before), moved between the frames by one
  whole-pixel shift a pair of up to ``bg_shift`` px on each axis;
- ``rects`` textured rectangles a pair, each side drawn from
  ``rect_size`` [min, max] px, placed inside the first frame and
  moved by up to ``rect_shift`` px on each axis, painted in order, so
  later ones occlude earlier ones and the background; a rectangle may
  leave the frame.

Every seed gives the same sizes and the same work; the seed moves only the
pixels. Values are in [0, 1]. ``make_pairs`` returns the batches as
[B, 6, H, W] float32 tensors (both frames stacked on the channels, as the
flow trainers take them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _texture(gen, n: int, h: int, w: int, octaves, device):
    """[n, 3, h, w] smooth noise in [0, 1]."""
    out = torch.zeros((n, 3, h, w), device=device)
    total = 0.0
    for i, cells in enumerate(octaves):
        gh, gw = max(h // cells, 2), max(w // cells, 2)
        g = torch.rand((n, 3, gh + 3, gw + 3), generator=gen, device=device)
        up = F.interpolate(g, size=(h + 3 * cells, w + 3 * cells),
                           mode="bicubic", align_corners=False)
        wt = 0.5 ** i
        out += wt * up[..., cells:cells + h, cells:cells + w]
        total += wt
    return (out / total).clamp(0.0, 1.0)


def _paint(frame, tex, y: int, x: int):
    """Paint tex [3, th, tw] into frame [3, H, W] at (y, x), clipped."""
    _, hh, ww = frame.shape
    _, th, tw = tex.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + th, hh), min(x + tw, ww)
    if y1 > y0 and x1 > x0:
        frame[:, y0:y1, x0:x1] = tex[:, y0 - y:y1 - y, x0 - x:x1 - x]


def make_pairs(traffic: dict, seed: int, device, rank: int = 0,
               world: int = 1):
    """Rank ``rank``'s ``groups`` batches of ``batch`` pairs (of a global
    batch of ``batch * world``): a list of [B, 6, H, W] tensors."""
    b, groups = int(traffic["batch"]), int(traffic["groups"])
    h, w = traffic["size"]
    s, rs = int(traffic["bg_shift"]), int(traffic["rect_shift"])
    lo, hi = traffic["rect_size"]
    nr, octaves = int(traffic["rects"]), traffic["octaves"]
    n = b * world * groups
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 2_654_435_761 + 97) % (2 ** 62))
    bg = _texture(gen, n, h + 2 * s, w + 2 * s, octaves, device)
    rect_tex = _texture(gen, n * nr, hi, hi, octaves, device)
    # the layout: the shifts, the rectangles' sizes, places and moves
    shift = torch.randint(-s, s + 1, (n, 2), generator=gen, device=device)
    sizes = torch.randint(lo, hi + 1, (n, nr, 2), generator=gen,
                          device=device)
    at = torch.rand((n, nr, 2), generator=gen, device=device)
    moves = torch.randint(-rs, rs + 1, (n, nr, 2), generator=gen,
                          device=device)
    shift, sizes, moves = shift.tolist(), sizes.tolist(), moves.tolist()
    at = at.tolist()
    img1 = torch.empty((n, 3, h, w), device=device)
    img2 = torch.empty((n, 3, h, w), device=device)
    for i in range(n):
        dy, dx = shift[i]
        img1[i] = bg[i, :, s:s + h, s:s + w]
        # the second frame sees the background moved by (dx, dy)
        img2[i] = bg[i, :, s - dy:s - dy + h, s - dx:s - dx + w]
        for r in range(nr):
            th, tw = sizes[i][r]
            y = int(at[i][r][0] * (h - th + 1))
            x = int(at[i][r][1] * (w - tw + 1))
            my, mx = moves[i][r]
            tex = rect_tex[i * nr + r, :, :th, :tw]
            _paint(img1[i], tex, y, x)
            _paint(img2[i], tex, y + my, x + mx)
    out = []
    for g in range(groups):
        base = (g * world + rank) * b
        sl = slice(base, base + b)
        out.append(torch.cat([img1[sl], img2[sl]], 1).contiguous())
    return out
