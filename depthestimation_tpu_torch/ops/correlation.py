"""Cost-volume correlation (FlowNet / PWC style), the plain versions.

Port of ``depthestimation_tpu/ops/correlation.py``'s XLA form:

    out[b, (i, j), y, x] = mean_c x1[b, c, y, x] * x2p[b, c, y + i, x + j]

for i, j in [0, 2 md], with x2p = x2 zero-padded by md on each side of
H and W: (2 md + 1)^2 channels, 81 at md = 4. ``correlation_batched`` is
the JAX ``vmap`` written with the batch axis; ``correlation`` takes one
[C, H, W] item. ``correlation_bwd_plain`` is its backward written out
(the gradient ``jax.vjp`` of the XLA form gives), so the kernel's
backward has a plain counterpart to be held to. The kernels and the
autograd Function that routes between them and these are in
``ops/correlation_kernel.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation_batched(x1: torch.Tensor, x2: torch.Tensor,
                        max_displacement: int = 4) -> torch.Tensor:
    """x1, x2 [B, C, H, W] -> [B, (2 md + 1)^2, H, W]: 81 shifted
    products, each a mean over C (sum, then / C, as ``jnp.mean``)."""
    md = max_displacement
    h, w = x1.shape[-2:]
    x2p = F.pad(x2, (md, md, md, md))
    outs = [(x1 * x2p[:, :, i:i + h, j:j + w]).mean(dim=1)
            for i in range(2 * md + 1) for j in range(2 * md + 1)]
    return torch.stack(outs, dim=1)


def correlation(x1: torch.Tensor, x2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """x1, x2 [C, H, W] -> [(2 md + 1)^2, H, W]."""
    return correlation_batched(x1[None], x2[None], max_displacement)[0]


def correlation_bwd_plain(x1: torch.Tensor, x2: torch.Tensor,
                          g: torch.Tensor, max_displacement: int = 4):
    """The cotangents of ``correlation_batched`` for the output cotangent
    g [B, K, H, W]:

        dx1[c, y, x]   = sum_k g[k, y, x] / C * x2[c, y + i - md, x + j - md]
        dx2[c, y', x'] = sum_k g[k, y' - i + md, x' - j + md] / C
                               * x1[c, y' - i + md, x' - j + md]

    out-of-range terms zero; the k's summed in order (k = i (2 md + 1) +
    j). Returns (dx1, dx2), each shaped as its input."""
    md = max_displacement
    c, (h, w) = x1.shape[1], x1.shape[-2:]
    gc = g / c
    x2p = F.pad(x2, (md, md, md, md))
    dx1 = torch.zeros_like(x1)
    dx2p = torch.zeros_like(x2p)
    k = 0
    for i in range(2 * md + 1):
        for j in range(2 * md + 1):
            gk = gc[:, k:k + 1]
            dx1 = dx1 + gk * x2p[:, :, i:i + h, j:j + w]
            dx2p[:, :, i:i + h, j:j + w] += gk * x1
            k += 1
    return dx1, dx2p[:, :, md:md + h, md:md + w].contiguous()
