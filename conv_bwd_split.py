#!/usr/bin/env python3
"""Device time of the fused conv blocks' backward kernels at the B=8 train
step's shapes, split into the data gradient and the weight gradient.

    python3 conv_bwd_split.py [--root CHECKOUT] [--tag NAME]

``CHECKOUT`` (default: this file's directory) is the tree whose
``depthestimation_tpu_torch`` is imported and built, so two commits can be
held side by side in one run on one card (parent, change, change, parent).
The shapes and inputs are those of ``chip_smoke.py`` phase 3: Base3D's
layer (``convbn_block_bwd``) at N=512 (B=8, D=64), 64x96, C32->F32,
C5->F32 and C32->F1, and the encoder's 2D layer (``convbn2d_block_bwd``)
at N=16, 128x192 C=F=32 and 64x96 C=F=64.

Each backward runs ``ITERS`` times under ``torch.profiler``; its device
time is summed by kernel name: a kernel whose name holds "dw" is the
weight gradient (its GEMM and its reduce), one of PyTorch's own (``at::``,
a wrapper's weight packing) neither, every other one the data gradient
(the fold, the dx GEMM and the (da, db) reduce). Beside the split:
the whole call's ms from CUDA events and ``aten.convolution_backward``'s
(cuDNN, data and weight gradients in one call) on the same normalized
input. Prints one JSON line per shape and, last, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ITERS = 5


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split(fn, iters: int = ITERS) -> dict:
    """{"dx_ms", "dw_ms", "torch_ms", "kernels": {name: ms}} per call of
    ``fn`` from the profiler's device times: ``torch_ms`` is PyTorch's own
    kernels in the call (a wrapper's weight packing), not a gradient's
    (0.0 each if the profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and ev.key and not ev.key.startswith(("aten::", "cuda")):
            per[ev.key] = per.get(ev.key, 0.0) + us / 1e3 / iters
    dw = sum(v for k, v in per.items() if "dw" in k)
    own = sum(v for k, v in per.items() if "at::" in k)
    return {"dx_ms": sum(per.values()) - dw - own, "dw_ms": dw,
            "torch_ms": own,
            "kernels": {k[:60]: round(v, 4) for k, v in per.items()}}


def _conv_bwd(g, u, w):
    import torch
    k = u.dim() - 2
    return torch.ops.aten.convolution_backward(
        g, u, w, None, [1] * k, [1] * k, [1] * k, False, [0] * k, 1,
        [True, True, False])


def convcomb_cases(dev, gen):
    """(tag, backward call, cuDNN call) of Base3D's layer shapes."""
    import torch
    from depthestimation_tpu_torch.ops.convcomb_kernel import (
        convbn_block_bwd, convbn_block_plain)
    h, w, n = 64, 96, 512
    for c, f in ((32, 32), (5, 32), (32, 1)):
        relu = c != 5
        x = torch.randn(n, c, h * w, generator=gen).to(dev, torch.bfloat16)
        wm = (torch.randn(3 * f, c, 3, 3, generator=gen) * 0.2).to(
            dev, torch.bfloat16)
        a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
        b = (torch.randn(c, generator=gen) * 0.1).to(dev)
        y, _ = convbn_block_plain(x, wm, a, b, 64, h, w, relu)
        gy = (torch.randn(y.shape, generator=gen) * 0.1).to(dev,
                                                            torch.bfloat16)
        gs = (torch.randn(f, 2, generator=gen) * 1e-3).to(dev)
        args = (x, wm, a, b, y, gy, gs, 64, h, w, relu)
        u = x.float() * a[None, :, None] + b[None, :, None]
        u = (u.relu() if relu else u).to(torch.bfloat16)
        u5 = u.reshape(n // 64, 64, c, h, w).transpose(1, 2).contiguous()
        w5 = wm.reshape(3, f, c, 3, 3).permute(1, 2, 0, 3, 4).contiguous()
        g5 = gy.reshape(n // 64, 64, f, h, w).transpose(1, 2).contiguous()
        yield (f"convcomb N={n} C{c}->F{f} 64x96",
               lambda a_=args: convbn_block_bwd(*a_),
               lambda g_=g5, u_=u5, w_=w5: _conv_bwd(g_, u_, w_))


def convbn2d_cases(dev, gen):
    import torch
    from depthestimation_tpu_torch.ops.convbn2d_kernel import (
        convbn2d_block_bwd, convbn2d_block_plain)
    for tag, n, c, f, h, w in (("128x192 C=F=32", 16, 32, 32, 128, 192),
                               ("64x96 C=F=64", 16, 64, 64, 64, 96)):
        bf = torch.bfloat16
        x = torch.randn(n, c, h, w, generator=gen).to(dev, bf)
        wt = (torch.randn(f, c, 3, 3, generator=gen)
              * (2.0 / (9 * f)) ** 0.5).to(dev, bf)
        a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
        b = (torch.randn(c, generator=gen) * 0.1).to(dev)
        y, _ = convbn2d_block_plain(x, wt, a, b, "relu")
        gy = (torch.randn(y.shape, generator=gen) * 0.1).to(dev, bf)
        gs = (torch.randn(f, 2, generator=gen) * 1e-3).to(dev)
        args = (x, wt, a, b, y, gy, gs, "relu")
        u = (x.float() * a[None, :, None, None]
             + b[None, :, None, None]).relu().to(bf)
        yield (f"convbn2d N={n} {tag}",
               lambda a_=args: convbn2d_block_bwd(*a_),
               lambda g_=gy, u_=u, w_=wt: _conv_bwd(g_, u_, w_))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("conv_bwd_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for cases in (convcomb_cases, convbn2d_cases):
        for tag, run, lib in cases(dev, gen):
            row = {"tag": args.tag, "shape": tag,
                   "ms": cuda_ms(run, ITERS),
                   "library_ms": cuda_ms(lib, ITERS)}
            row.update(kernel_split(run))
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
