"""The cell's weights, made on the device from the seed.

One ``torch.randn`` call on a generator seeded from the run's seed fills
every conv weight at once; each leaf then takes its slice, scaled to the
model's initializer (He normal, by default over the fan-out, ``std =
sqrt(2 / (k*k*out))`` for 2D convs and ``sqrt(2 / (27 * out))`` for 3D
ones, the depth network's; ``fan="in"``, ``sqrt(2 / (k*k*in))``, is
ARFlow's ``kaiming_normal_`` for PWCLite), a transposed conv the bilinear
kernel, BatchNorm scales one and every bias zero. The names and
shapes are the reference's parameter tree, which is the port's.
"""

from __future__ import annotations

import math

import torch


def _bilinear(k: int) -> torch.Tensor:
    factor = (k + 1) // 2
    center = factor - 1 if k % 2 == 1 else factor - 0.5
    ax = 1 - torch.abs(torch.arange(k, dtype=torch.float64) - center) / factor
    return torch.outer(ax, ax).float()


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "zero"
    if ".BatchNorm_0." in f".{name}" or len(shape) == 1:
        return "one"
    if "ConvTranspose" in name:
        return "bilinear"
    return "normal"


def make_weights(shapes: dict, seed: int, device, fan: str = "out") -> dict:
    """name -> f32 tensor on ``device`` for every (name, shape) of
    ``shapes``; ``fan`` ("out" or "in") is the initializer's fan."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = [(n, s) for n, s in shapes.items()
              if _kind(n, s) == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, s in normal:
        k = math.prod(s)
        # (out or in) x spatial taps
        f = (s[0] if fan == "out" else s[1]) * math.prod(s[2:])
        out[n] = flat[at:at + k].view(s) * math.sqrt(2.0 / f)
        at += k
    for n, s in shapes.items():
        kind = _kind(n, s)
        if kind == "zero":
            out[n] = torch.zeros(s, device=device)
        elif kind == "one":
            out[n] = torch.ones(s, device=device)
        elif kind == "bilinear":
            out[n] = _bilinear(s[-1]).to(device).expand(s).contiguous()
    return out
