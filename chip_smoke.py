#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port on one NVIDIA GPU: the serving
path, the bf16 train step, the train step with the light-curtain loop
inside, and PWCLite optical-flow training.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero before the result):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds ``depthestimation_tpu_torch/csrc/*.cu``;
3. every kernel of the paths, forward and backward, against its plain
   PyTorch version on the card, at the shapes the main paths give it,
   with times from CUDA events beside the plain version's, one PyTorch
   library call's where one computes the same function (cuDNN's conv),
   and the bound (bytes over 3.35 TB/s or operations over the peak of
   their type, 989 bf16 tensor-core TFLOP/s or 67 f32 TFLOP/s, whichever
   is larger); the stage-2 sweep at N=1 and N=8 on a sideways and a
   forward camera step (its launch plan, event and device times, both
   directions bit-equal over two launches) and on dense matrices at a
   small shape; each forward and each backward of the two fused conv
   blocks twice, bit-equal; each forward's device time beside its event
   time (``conv_bwd_split.forward_split``, ``torch.profiler``: the host
   work of the wrapper shows apart from the kernels) and each backward's
   split into the data and the weight gradient (``kernel_split``); the
   correlation
   pair at the five pyramid levels of phase 9,
   and the flat conv3d op (forward, dx, dW) at Base3D's layer shape in
   bf16 and f32 beside cuDNN's conv3d and the port's flat ``Conv3d``;
4. the server: ``NetRuntime`` (mode ``mono_lc``, ``real_sensor.json``,
   320x256, feature_dim 64, D 64, bf16, seeded weights) answers 4 frames;
   every output must be finite with depth in [d_min, d_max], and each
   frame must launch the sweep kernel once and the Base3D kernel 8 times;
5. the flagship forward of ``bench.py`` (384x256, D 64, exp7_lc) at batch
   1 and 8, through the kernels and through the plain path with the same
   weights, both held to an f32 plain forward (tests/TOLERANCES.md rule 4),
   with ms and frames/s from CUDA events;
6. the train step of ``bench_train.py`` (exp7, 384x256, D 64, bf16, Adam
   lr 1e-5, both camera sides, BaseLoss, ``tpu.convbn2d`` "auto": the
   encoder's fused ConvBN chain) at batch 8 and 1 on synthetic batches
   with on-device soft labels: 4 Adam steps through the kernels (loss
   finite, lower after them; per step 2 sweep, 16 Base3D and 76 convbn2d
   launches forward and backward); the gradients of one step held to an
   f32 plain step by rule 4 against the plain bf16 step (both in the fused
   route); ms per step in turns of the plain path, the kernel path and the
   kernel path on the eager encoder (``tpu.convbn2d: false``), the kernel
   step's split into forward, backward and optimizer, and each path's
   peak memory;
7. the decoder's fused tail (``tpu.convbn2d: true``): one B=1 train step
   through the kernels with 38 + 3 convbn2d launches per forward, a finite
   loss, and rule-4 gradients against an f32 plain step;
8. the LC-on train step of ``bench_train.py --lc`` (exp7_lc, 384x256, D 64,
   bf16, B=8, ``trainer.default.fused_lc_fn`` at the production setting:
   5 iterations, the default planner, 64 -> 128 range bins): 4 Adam steps
   with ``prev_output`` and ``prev_lc`` fed back from ``aux``, (a) on the
   flat Base3D route (``tpu.convcomb_pallas: false, tpu.combine_pallas:
   true``: per step 2 sweep, 76 convbn2d and 16 tap_combine launches forward
   and backward, no convcomb launch; rule-4 gradients; one B=1 step for
   its counts) and (b) on the default route; for each the LC-on and LC-off
   step ms in turns, the step's split (forward, loss, backward, Adam,
   lc_process and the planner's DP inside it) and peak memory;
9. flow training (``configs/sintel_flow.json``: PWCLite, UnFlowLoss,
   SintelTrainer; f32, no TF32) at 384x832, B=8, on synthetic pairs:
   one step's loss and gradients through the correlation kernels against
   the plain path, and one trainer step with TF32 switched on globally
   held to the same bounds (the entry points scope it off; the same step
   without the scope is recorded); 4 Adam steps through ``_run_one_epoch``
   (loss finite
   and lower after them; per step 10 correlation launches forward and 5
   backward, the backward flows' pass taking no gradient, and no other
   kernel of the port); ms per step in 8 turns of the kernel and plain
   paths (the median of each path's 4, and all of them), split into
   forward, loss, backward and Adam, with peak memory;
   ``_validate_with_gt`` on 2 batches (finite EPE); one SintelARTrainer
   step at B=2 (20 + 15 correlation launches, finite l_atst and l_ot).

Then it prints the kernels' JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``. The f32 references run without TF32.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
D_MIN, D_MAX = 5.0, 40.0
# H100 SXM: HBM bytes/s, dense bf16 tensor-core FLOP/s and f32 FLOP/s
# outside the tensor cores (NVIDIA's data sheet; the peaks assume the full
# 700 W power limit)
HBM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` from CUDA events, after a warm-up."""
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, flops: float, peak: float = BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over HBM's rate and the operations over the
    peak of their type (bf16 tensor cores unless named)."""
    tb, tf = n_bytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def row(err, ms, plain_ms, library_ms, bound_):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_[0],
            "bound_by": bound_[1]}


def cfg_for(feature_dim, ndepth, w, h, dtype, nmode="exp7_lc", batch=1,
            convbn2d="auto", **tpu):
    """``__graft_entry__._cfg`` (the config of bench.py and
    bench_train.py) with ``tpu.dtype``, ``tpu.convbn2d`` and any further
    ``tpu`` key; the ``lc`` section keeps its defaults (5 iterations, the
    default planner, step [0.5], spread 2 x 5)."""
    from depthestimation_tpu_torch.config import config_from_dict
    return config_from_dict({
        "data": {"exp_name": "chip_smoke", "model_name": "base",
                 "loss_name": "base", "trainer_name": "default",
                 "dataset_path": "kitti", "dataset_split": "k1"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": D_MIN,
                "d_max": D_MAX, "feature_dim": feature_dim,
                "ndepth": ndepth, "softce": 0.3, "qpower": 1.0,
                "img_size": [w, h], "crop_w": w, "nmode": nmode,
                "bn_avg": False},
        "loss": {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0,
                 "smooth_mul": 0.5, "dc_mul": 0.25, "rsc_low_mul": 0.0},
        "train": {"batch_size": batch, "lr": 1e-5, "epoch_num": 1,
                  "n_gpu": 1, "optim": "adam", "beta": 0.999,
                  "momentum": 0.9, "weight_decay": 1e-6, "bias_decay": 0.0},
        "tpu": dict(dtype=dtype, convbn2d=convbn2d, **tpu),
    })


# ------------------------------------------------------------ phase 3

#: camera steps of the sweep's inputs: (up m, forward m, turn degrees),
#: each with a sideways part of 0.15 to 0.25 m. Driving (KITTI at 10 Hz)
#: moves 1 to 2.5 m a frame; the last two steps outgrow the backward's
#: buffers at the flagship's shape (some blocks take the separable path).
SWEEP_STEPS = {"sideways": (0.0, 0.0, 0.0), "forward": (0.02, 0.5, 0.0),
               "forward 1 m": (0.02, 1.0, 0.0),
               "forward 1.5 m": (0.02, 1.5, 0.0),
               "forward 2 m": (0.02, 2.0, 0.0), "back 2 m": (0.02, -2.0, 0.0),
               "turn 5 deg, 1.5 m": (0.02, 1.5, 5.0),
               "back 2.5 m": (0.02, -2.5, 0.0), "up 2 m": (2.0, 0.0, 0.0)}


def sweep_inputs(n, c1, d, h, w, gen, dev, step="sideways"):
    """Stage-2 inputs as the main path builds them: features, and the band
    matrices (sweep_mats) of the camera step ``step`` of SWEEP_STEPS: a
    sideways step has Ry = I; a forward part gives Ry two taps a row and
    Ry^T up to three."""
    import torch
    from depthestimation_tpu_torch.ops import dpv as dpv_ops
    from depthestimation_tpu_torch.ops.plane_sweep import sweep_mats
    up, fwd, turn = SWEEP_STEPS[step]
    bf = torch.bfloat16
    fa = torch.randn(n, c1, h, w, generator=gen).to(dev, bf)
    ref = torch.randn(n, c1, h, w, generator=gen).to(dev, bf)
    fr = torch.randn(n, d, h, w, generator=gen).to(dev, bf)
    c, s = np.cos(np.deg2rad(turn)), np.sin(np.deg2rad(turn))
    rot = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                       dtype=torch.float32).repeat(n, 1, 1).to(dev)
    tra = torch.zeros(n, 3)
    tra[:, 0] = -0.15 - 0.1 * torch.rand(n, generator=gen)
    tra[:, 1] = up
    tra[:, 2] = fwd
    intr = torch.tensor([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                         [0, 0, 1]]).repeat(n, 1, 1).to(dev)
    d_candi = torch.as_tensor(dpv_ops.powerf(D_MIN, D_MAX, d, 1.0),
                              dtype=torch.float32, device=dev)
    rx, ry = sweep_mats(d_candi, rot, tra.to(dev), intr, h, w)
    return (fa, ref, fr, rx.transpose(-1, -2).contiguous().to(bf),
            ry.contiguous().to(bf))


def sweep_flops(rxt, ry, c1):
    """Operations of one stage-2 forward on these band matrices, counted
    on their nonzeros (the products are sparse by data): per view, depth
    and channel (C1 features + the diagonal warp) ``F . Rx^T`` takes H MACs
    per nonzero of Rx^T and ``Ry . s`` X MACs per nonzero of Ry; the cost
    adds 3 operations per channel and output pixel."""
    n, d, _, x_out = rxt.shape
    y_out, h_in = ry.shape[-2:]
    nx = (rxt != 0).sum(dim=(-2, -1)).double()
    ny = (ry != 0).sum(dim=(-2, -1)).double()
    macs = ((c1 + 1) * (h_in * nx + ny * x_out)).sum().item()
    return 2.0 * macs + 3.0 * n * d * c1 * y_out * x_out


def phase_sweep(card, gen, dev, device_times):
    """Phase 3's sweep: both directions against the plain versions at the
    flagship 384x256 shape (h=64, w=96, C1 = 64 + 3, D=64) on the sideways
    step (the main path's; its times fill the kernels line) and on a
    forward step, at N=1 and N=8, with event and device times; both
    directions bit-equal over two launches; the other SWEEP_STEPS at N=8
    with device times and the blocks on each path; a dense-matrix case
    (the separable path) against the plain versions at a small shape."""
    import torch
    from depthestimation_tpu_torch.ops.sweep_kernel import (
        launch_plan, sweep_stage2, sweep_stage2_bwd, sweep_stage2_bwd_plain,
        sweep_stage2_plain)
    rows = {}
    for n in (1, 8):
        print(f"phase 3: sweep_stage2 launch plan N={n}: "
              f"{launch_plan(n, 1, 67, 64, 64, 96)}", flush=True)
        for step in ("sideways", "forward"):
            args = sweep_inputs(n, 67, 64, 64, 96, gen, dev, step)
            cost, diag = sweep_stage2(*args, 1)
            again = sweep_stage2(*args, 1)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip((cost, diag), again)),
                  f"sweep_stage2 N={n} {step}: two launches differ")
            cost_p, diag_p = sweep_stage2_plain(*args, 1)
            err = max((cost - cost_p).abs().max().item(),
                      (diag - diag_p).abs().max().item())
            # rule 3: one kernel call vs the plain version, 1% of max|plain|
            for got, want, nm in ((cost, cost_p, "cost"),
                                  (diag, diag_p, "diag")):
                bnd = 1e-2 * want.abs().max().item()
                e = (got - want).abs().max().item()
                check(np.isfinite(e) and e <= bnd,
                      f"sweep_stage2 N={n} {step} {nm}: max|err| {e} > {bnd}")
            ms = cuda_ms(lambda: sweep_stage2(*args, 1), 20)
            dev_ms = sum(device_times(lambda: sweep_stage2(*args, 1)).values())
            plain_ms = cuda_ms(lambda: sweep_stage2_plain(*args, 1), 5)
            flops = sweep_flops(args[3], args[4], 67)
            bd = bound(nbytes(*args, cost, diag), flops)
            print(f"phase 3: sweep_stage2 N={n} C1=67 D=64 64x96 bf16 {step}: "
                  f"max|err| {err:.4g} (cost max "
                  f"{cost_p.abs().max().item():.4g}), bit-equal; kernel "
                  f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} "
                  f"ms, bound {bd[0]:.4f} ms ({bd[1]}) [{card}]", flush=True)
            if step == "sideways":
                rows[("sweep_stage2", n)] = row(err, ms, plain_ms, None, bd)

            # backward, rule 3: within 3% of max|plain| per gradient
            gc = torch.randn(args[2].shape, generator=gen).to(dev)
            gd = torch.randn(args[2].shape, generator=gen).to(dev)
            got = sweep_stage2_bwd(*args, gc, gd, 1)
            again = sweep_stage2_bwd(*args, gc, gd, 1)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"sweep_stage2 backward N={n} {step}: two launches differ")
            want = sweep_stage2_bwd_plain(*args, gc, gd, 1)
            errs = []
            for g, p, nm in zip(got, want, ("dfa", "dref", "dfr")):
                e = (g - p).abs().max().item()
                bnd = 3e-2 * p.abs().max().item()
                check(np.isfinite(e) and e <= bnd,
                      f"sweep_stage2 backward N={n} {step} {nm}: max|err| "
                      f"{e} > {bnd}")
                errs.append(e)
            ms = cuda_ms(lambda: sweep_stage2_bwd(*args, gc, gd, 1), 20)
            dev_ms = sum(device_times(
                lambda: sweep_stage2_bwd(*args, gc, gd, 1)).values())
            plain_ms = cuda_ms(
                lambda: sweep_stage2_bwd_plain(*args, gc, gd, 1), 3)
            # the backward recomputes the forward's products and runs their
            # transposes: twice the forward's operations
            bd = bound(nbytes(*args, gc, gd, *got), 2.0 * flops)
            print(f"phase 3: sweep_stage2 backward N={n} {step}: max|err| "
                  f"dfa, dref, dfr {errs[0]:.4g}, {errs[1]:.4g}, "
                  f"{errs[2]:.4g} (max "
                  f"{max(p.abs().max().item() for p in want):.4g}), "
                  f"bit-equal; kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                  f"plain {plain_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}) "
                  f"[{card}]", flush=True)
            if step == "sideways":
                rows[("sweep_stage2_bwd", n)] = row(max(errs), ms, plain_ms,
                                                    None, bd)
    # the other steps at N=8: rule 3, each direction's device ms, and the
    # blocks on each path (ops/sweep_band.py's model of the decision)
    from depthestimation_tpu_torch.ops.sweep_band import block_paths
    for step in list(SWEEP_STEPS)[2:]:
        args = sweep_inputs(8, 67, 64, 64, 96, gen, dev, step)
        gc = torch.randn(args[2].shape, generator=gen).to(dev)
        gd = torch.randn(args[2].shape, generator=gen).to(dev)
        pairs = list(zip(sweep_stage2(*args, 1), sweep_stage2_plain(*args, 1),
                         (1e-2, 1e-2)))
        pairs += zip(sweep_stage2_bwd(*args, gc, gd, 1),
                     sweep_stage2_bwd_plain(*args, gc, gd, 1), (3e-2,) * 3)
        torch.cuda.synchronize()
        for (got, want, k), nm in zip(pairs, ("cost", "diag", "dfa", "dref",
                                              "dfr")):
            e = (got - want).abs().max().item()
            check(np.isfinite(e) and e <= k * want.abs().max().item(),
                  f"sweep_stage2 N=8 {step} {nm}: max|err| {e}")
        del pairs
        f_ms = sum(device_times(lambda: sweep_stage2(*args, 1)).values())
        b_ms = sum(device_times(
            lambda: sweep_stage2_bwd(*args, gc, gd, 1)).values())
        paths = block_paths(args[3], args[4], 1)
        print(f"phase 3: sweep_stage2 N=8 {step}: both directions within "
              f"rule 3; device ms forward {f_ms:.4f}, backward {b_ms:.4f}; "
              f"blocks band / separable: forward {paths['fwd']['band']} / "
              f"{paths['fwd']['separable']}, backward (item, strip) "
              f"{paths['bwd']['band']} / {paths['bwd']['separable']} "
              f"[{card}]", flush=True)
    # dense matrices: the separable path, at a small shape
    bf = torch.bfloat16
    n, c1, d, h, w = 4, 9, 8, 13, 21
    args = (torch.randn(n, c1, h, w, generator=gen).to(dev, bf),
            torch.randn(n // 2, c1, h, w, generator=gen).to(dev, bf),
            torch.randn(n, d, h, w, generator=gen).to(dev, bf),
            (torch.rand(n, d, w, w, generator=gen) * 0.2).to(dev, bf),
            (torch.rand(n, d, h, h, generator=gen) * 0.2).to(dev, bf))
    gc = torch.randn(n, d, h, w, generator=gen).to(dev)
    gd = torch.randn(n, d, h, w, generator=gen).to(dev)
    pairs = list(zip(sweep_stage2(*args, 2), sweep_stage2_plain(*args, 2),
                     (1e-2, 1e-2)))
    pairs += zip(sweep_stage2_bwd(*args, gc, gd, 2),
                 sweep_stage2_bwd_plain(*args, gc, gd, 2), (3e-2,) * 3)
    torch.cuda.synchronize()
    errs = []
    for got, want, k in pairs:
        e = (got - want).abs().max().item()
        check(np.isfinite(e) and e <= k * want.abs().max().item(),
              f"sweep_stage2 dense N={n} {h}x{w}: max|err| {e}")
        errs.append(e)
    print(f"phase 3: sweep_stage2 dense matrices N={n} V=2 C1={c1} D={d} "
          f"{h}x{w}: forward and backward within rule 3 (max|err| "
          f"{max(errs):.4g})", flush=True)
    return rows


def _conv_bwd(g, u, w):
    """cuDNN's backward of a stride-1 'same' conv (data and weight
    gradients, one call): the library yardstick of the backward kernels."""
    import torch
    k = u.dim() - 2
    return torch.ops.aten.convolution_backward(
        g, u, w, None, [1] * k, [1] * k, [1] * k, False, [0] * k, 1,
        [True, True, False])


def phase_kernels(card):
    import torch
    import torch.nn.functional as F
    from conv_bwd_split import device_times, forward_split, kernel_split
    from depthestimation_tpu_torch.ops.combine_kernel import (
        tap_combine, tap_combine_bwd, tap_combine_bwd_plain,
        tap_combine_plain)
    from depthestimation_tpu_torch.ops.convbn2d_kernel import (
        convbn2d_block, convbn2d_block_bwd, convbn2d_block_bwd_plain,
        convbn2d_block_plain)
    from depthestimation_tpu_torch.ops.convcomb_kernel import (
        convbn_block, convbn_block_bwd, convbn_block_bwd_plain,
        convbn_block_plain)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    rows.update(phase_sweep(card, gen, dev, device_times))

    # convbn_block: the issue's padded-TPU shapes (C=8, F=32), (C=32, F=8)
    # and the port's own layers (C=5 entry, C=32 -> 32, C=32 -> 1)
    h, w = 64, 96

    def conv3d_operands(x, wm, a, b, relu, c, f, n):
        """The normalized bf16 input as [B, C, D, H, W] and the Conv3d
        weight [F, C, 3, 3, 3]: cuDNN's conv3d computes the same conv."""
        u = x.float() * a[None, :, None] + b[None, :, None]
        u = (u.relu() if relu else u).to(torch.bfloat16)
        u5 = u.reshape(n // 64, 64, c, h, w).transpose(1, 2).contiguous()
        w5 = wm.reshape(3, f, c, 3, 3).permute(1, 2, 0, 3, 4).contiguous()
        return u5, w5

    for c, f in ((8, 32), (32, 8), (5, 32), (32, 32), (32, 1)):
        for n in (64, 512):
            for relu in (False, True):
                x = torch.randn(n, c, h * w, generator=gen).to(dev,
                                                               torch.bfloat16)
                wm = (torch.randn(3 * f, c, 3, 3, generator=gen) * 0.2).to(
                    dev, torch.bfloat16)
                a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
                b = (torch.randn(c, generator=gen) * 0.1).to(dev)
                y, st = convbn_block(x, wm, a, b, 64, h, w, relu)
                y2, st2 = convbn_block(x, wm, a, b, 64, h, w, relu)
                torch.cuda.synchronize()
                check(torch.equal(y, y2) and torch.equal(st, st2),
                      f"convbn_block N={n} C={c} F={f} relu={relu}: two "
                      f"launches differ")
                del y2, st2
                y_p, st_p = convbn_block_plain(x, wm, a, b, 64, h, w, relu)
                yf, ypf = y.float(), y_p.float()
                err = (yf - ypf).abs().max().item()
                scale = ypf.abs().max().item() + 1e-6
                # the bounds of tests/test_convcomb_pallas.py:68-72
                check(err <= 0.03 * scale,
                      f"convbn_block N={n} C={c} F={f} relu={relu}: y err "
                      f"{err} > 3% of {scale}")
                st_ok = torch.allclose(st, st_p, rtol=3e-2,
                                       atol=1e-2 * n * h * w)
                check(bool(st_ok), f"convbn_block N={n} C={c} F={f}: stats "
                      f"{st.tolist()[:2]} vs {st_p.tolist()[:2]}")
                line = (f"phase 3: convbn_block N={n} C={c} F={f} HW={h * w} "
                        f"relu={relu}: max|err| y {err:.4g} (max "
                        f"{scale:.4g}); bit-equal over two launches")
                if n == 512 and relu:
                    ms = cuda_ms(lambda: convbn_block(x, wm, a, b, 64, h, w,
                                                      relu), 10)
                    plain_ms = cuda_ms(lambda: convbn_block_plain(
                        x, wm, a, b, 64, h, w, relu), 10)
                    u5, w5 = conv3d_operands(x, wm, a, b, relu, c, f, n)
                    lib_ms = cuda_ms(lambda: F.conv3d(u5, w5, padding=1), 10)
                    bd = bound(nbytes(x, wm, a, b, y, st),
                               2.0 * n * h * w * 3 * f * 9 * c)
                    rows[("convbn_block", c, f)] = row(err, ms, plain_ms,
                                                       lib_ms, bd)
                    sp = forward_split(lambda: convbn_block(
                        x, wm, a, b, 64, h, w, relu), 10)
                    lib_dev = sum(device_times(
                        lambda: F.conv3d(u5, w5, padding=1), 10).values())
                    line += (f"; kernel {ms:.4f} ms (device "
                             f"{sp['device_ms']:.4f} ms, of it PyTorch's own "
                             f"kernels {sp['torch_ms']:.4f}), plain "
                             f"{plain_ms:.4f} ms, "
                             f"cuDNN conv3d {lib_ms:.4f} ms (device "
                             f"{lib_dev:.4f}), bound "
                             f"{bd[0]:.4f} ms ({bd[1]}) [{card}]")
                print(line, flush=True)

    # convbn_block backward at the path's (C, F): the bounds of
    # tests/test_convcomb_pallas.py:99-122 (dx 3% of max away from the
    # ReLU boundary, dW 3%, da and db 10%)
    for c, f in ((5, 32), (32, 32), (32, 1)):
        for n in (64, 512):
            relu = c != 5
            x = torch.randn(n, c, h * w, generator=gen).to(dev,
                                                           torch.bfloat16)
            wm = (torch.randn(3 * f, c, 3, 3, generator=gen) * 0.2).to(
                dev, torch.bfloat16)
            a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
            b = (torch.randn(c, generator=gen) * 0.1).to(dev)
            y, _ = convbn_block_plain(x, wm, a, b, 64, h, w, relu)
            gy = (torch.randn(y.shape, generator=gen) * 0.1).to(
                dev, torch.bfloat16)
            gs = (torch.randn(f, 2, generator=gen) * 1e-3).to(dev)
            bargs = (x, wm, a, b, y, gy, gs, 64, h, w, relu)
            got = convbn_block_bwd(*bargs)
            again = convbn_block_bwd(*bargs)
            torch.cuda.synchronize()
            check(all(torch.equal(g1, g2) for g1, g2 in zip(got, again)),
                  f"convbn_block backward N={n} C={c} F={f}: two launches "
                  f"differ")
            want = convbn_block_bwd_plain(*bargs)
            v = x.float() * a[None, :, None] + b[None, :, None]
            inner = v.abs() > 0.02 if relu else torch.ones_like(v, dtype=bool)
            errs = []
            for g, p, nm, tol in zip(got, want, ("dx", "dW", "da", "db"),
                                     (0.03, 0.03, 0.10, 0.10)):
                g, p = g.float(), p.float()
                d = (g - p).abs()
                e = (d[inner] if nm == "dx" else d).max().item()
                bnd = tol * p.abs().max().item()
                check(np.isfinite(e) and e <= bnd,
                      f"convbn_block backward N={n} C={c} F={f}: {nm} "
                      f"max|err| {e} > {bnd}")
                errs.append(e)
            line = (f"phase 3: convbn_block backward N={n} C={c} F={f} "
                    f"relu={relu}: max|err| dx, dW, da, db "
                    f"{', '.join(f'{e:.4g}' for e in errs)}")
            if n == 512:
                ms = cuda_ms(lambda: convbn_block_bwd(*bargs), 5)
                plain_ms = cuda_ms(lambda: convbn_block_bwd_plain(*bargs), 5)
                u5, w5 = conv3d_operands(x, wm, a, b, relu, c, f, n)
                g5 = gy.reshape(n // 64, 64, f, h, w).transpose(1, 2)
                g5 = g5.contiguous()
                lib_ms = cuda_ms(lambda: _conv_bwd(g5, u5, w5), 5)
                bd = bound(nbytes(x, wm, a, b, y, gy, gs, *got),
                           4.0 * n * h * w * 3 * f * 9 * c)
                rows[("convbn_block_bwd", c, f)] = row(max(errs), ms,
                                                       plain_ms, lib_ms, bd)
                sp = kernel_split(lambda: convbn_block_bwd(*bargs))
                line += (f"; bit-equal over two launches; kernel {ms:.4f} "
                         f"ms (device split: dx + (da, db) "
                         f"{sp['dx_ms']:.4f}, dW {sp['dw_ms']:.4f}), plain "
                         f"{plain_ms:.4f} ms, cuDNN conv3d backward "
                         f"{lib_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}) "
                         f"[{card}]")
            print(line, flush=True)

    # convbn2d at the train step's shapes (B=8): the encoder's stem and
    # stage 0 at half resolution and stage 1 at quarter resolution, 16
    # images a call; the decoder's refine tail at full resolution. The
    # bounds of tests/test_convbn2d_pallas.py: y 3% of max|y|, stats rtol
    # 3%; dx 3% of max away from the activation's kink, dW 3%, da, db 10%.
    for tag, n, c, f, h2, w2, acts in (
            ("half", 16, 32, 32, 128, 192, ("relu", "none")),
            ("quarter", 16, 64, 64, 64, 96, ("relu", "none")),
            ("tail 1", 8, 67, 67, 256, 384, ("none",)),
            ("tail 2", 8, 67, 64, 256, 384, ("leaky",)),
            ("tail 3", 8, 64, 64, 256, 384, ("leaky",))):
        for act in acts:
            bf = torch.bfloat16
            x = torch.randn(n, c, h2, w2, generator=gen).to(dev, bf)
            wt = (torch.randn(f, c, 3, 3, generator=gen)
                  * (2.0 / (9 * f)) ** 0.5).to(dev, bf)
            a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
            b = (torch.randn(c, generator=gen) * 0.1).to(dev)
            y, st = convbn2d_block(x, wt, a, b, act)
            y2, st2 = convbn2d_block(x, wt, a, b, act)
            torch.cuda.synchronize()
            check(torch.equal(y, y2) and torch.equal(st, st2),
                  f"convbn2d {tag} act={act}: two forward launches differ")
            del y2, st2
            y_p, st_p = convbn2d_block_plain(x, wt, a, b, act)
            err = (y.float() - y_p.float()).abs().max().item()
            scale = y_p.float().abs().max().item() + 1e-6
            check(np.isfinite(err) and err <= 0.03 * scale,
                  f"convbn2d {tag} act={act}: y err {err} > 3% of {scale}")
            check(bool(torch.allclose(st, st_p, rtol=3e-2,
                                      atol=1e-2 * n * h2 * w2)),
                  f"convbn2d {tag} act={act}: stats {st.tolist()[:2]} vs "
                  f"{st_p.tolist()[:2]}")
            gy = (torch.randn(y.shape, generator=gen) * 0.1).to(dev, bf)
            gs = (torch.randn(f, 2, generator=gen) * 1e-3).to(dev)
            bargs = (x, wt, a, b, y_p, gy, gs, act)
            got = convbn2d_block_bwd(*bargs)
            again = convbn2d_block_bwd(*bargs)
            torch.cuda.synchronize()
            check(all(torch.equal(g1, g2) for g1, g2 in zip(got, again)),
                  f"convbn2d backward {tag} act={act}: two launches differ")
            del again
            want = convbn2d_block_bwd_plain(*bargs)
            v = x.float() * a[None, :, None, None] + b[None, :, None, None]
            inner = (v.abs() > 0.02 if act != "none"
                     else torch.ones_like(v, dtype=torch.bool))
            errs = []
            for g, p, nm, tol in zip(got, want, ("dx", "dW", "da", "db"),
                                     (0.03, 0.03, 0.10, 0.10)):
                g, p = g.float(), p.float()
                d = (g - p).abs()
                e = (d[inner] if nm == "dx" else d).max().item()
                bnd = tol * p.abs().max().item()
                check(np.isfinite(e) and e <= bnd,
                      f"convbn2d backward {tag} act={act}: {nm} max|err| "
                      f"{e} > {bnd}")
                errs.append(e)
            line = (f"phase 3: convbn2d {tag} N={n} C={c} F={f} {h2}x{w2} "
                    f"act={act}: max|err| y {err:.4g} (max {scale:.4g}), "
                    f"forward bit-equal over two launches; backward dx, dW, "
                    f"da, db "
                    f"{', '.join(f'{e:.4g}' for e in errs)}")
            if act == acts[0]:
                flops = 2.0 * n * h2 * w2 * f * 9 * c
                ms = cuda_ms(lambda: convbn2d_block(x, wt, a, b, act), 10)
                plain_ms = cuda_ms(
                    lambda: convbn2d_block_plain(x, wt, a, b, act), 5)
                u = x.float() * a[None, :, None, None] \
                    + b[None, :, None, None]
                u = (u.relu() if act == "relu" else torch.where(
                    u >= 0, u, 0.01 * u) if act == "leaky" else u).to(bf)
                lib_ms = cuda_ms(lambda: F.conv2d(u, wt, padding=1), 10)
                bd = bound(nbytes(x, wt, a, b, y, st), flops)
                rows[("convbn2d", tag)] = row(err, ms, plain_ms, lib_ms, bd)
                bms = cuda_ms(lambda: convbn2d_block_bwd(*bargs), 5)
                bplain_ms = cuda_ms(lambda: convbn2d_block_bwd_plain(*bargs),
                                    3)
                blib_ms = cuda_ms(lambda: _conv_bwd(gy, u, wt), 5)
                bbd = bound(nbytes(x, wt, a, b, y_p, gy, gs, *got),
                            2.0 * flops)
                rows[("convbn2d_bwd", tag)] = row(max(errs), bms, bplain_ms,
                                                  blib_ms, bbd)
                fsp = forward_split(
                    lambda: convbn2d_block(x, wt, a, b, act), 10)
                lib_dev = sum(device_times(
                    lambda: F.conv2d(u, wt, padding=1), 10).values())
                sp = kernel_split(lambda: convbn2d_block_bwd(*bargs))
                line += (f"; forward kernel {ms:.4f} ms (device "
                         f"{fsp['device_ms']:.4f} ms, of it PyTorch's own "
                         f"kernels {fsp['torch_ms']:.4f}), plain "
                         f"{plain_ms:.4f} ms, cuDNN conv2d {lib_ms:.4f} ms "
                         f"(device {lib_dev:.4f}), "
                         f"bound {bd[0]:.4f} ms ({bd[1]}); backward "
                         f"bit-equal over two launches, kernel {bms:.4f} ms "
                         f"(device split: dx + (da, db) {sp['dx_ms']:.4f}, "
                         f"dW {sp['dw_ms']:.4f}), plain {bplain_ms:.4f} ms, "
                         f"cuDNN "
                         f"conv2d backward {blib_ms:.4f} ms, bound "
                         f"{bbd[0]:.4f} ms ({bbd[1]}) [{card}]")
            print(line, flush=True)
            del x, y, y_p, got, want, v, inner
        torch.cuda.empty_cache()

    # tap_combine at the flat Base3D route's shapes: no multiply and a
    # fixed order of f32 sums, so kernel and plain version must be EQUAL;
    # the bound is the bytes of t and y alone
    for dtype in (torch.bfloat16, torch.float32):
        for n in (512, 64):
            for f in (32, 1):
                t = torch.randn(n, 3 * f, 64, 96, generator=gen).to(dev,
                                                                    dtype)
                g = torch.randn(n, f, 64, 96, generator=gen).to(dev, dtype)
                y, dt = tap_combine(t, 64), tap_combine_bwd(g, 64)
                torch.cuda.synchronize()
                errs = ((y.float() - tap_combine_plain(t, 64).float())
                        .abs().max().item(),
                        (dt.float() - tap_combine_bwd_plain(g, 64).float())
                        .abs().max().item())
                check(errs == (0.0, 0.0),
                      f"tap_combine N={n} F={f} {dtype}: max|err| forward, "
                      f"backward {errs} != 0")
                ms = cuda_ms(lambda: tap_combine(t, 64), 10)
                plain_ms = cuda_ms(lambda: tap_combine_plain(t, 64), 5)
                bms = cuda_ms(lambda: tap_combine_bwd(g, 64), 10)
                bplain_ms = cuda_ms(lambda: tap_combine_bwd_plain(g, 64), 5)
                bd, bbd = bound(nbytes(t, y), 0.0), bound(nbytes(g, dt), 0.0)
                if dtype == torch.bfloat16 and n == 512:
                    rows[("tap_combine", f)] = row(errs[0], ms, plain_ms,
                                                   None, bd)
                    rows[("tap_combine_bwd", f)] = row(errs[1], bms,
                                                       bplain_ms, None, bbd)
                print(f"phase 3: tap_combine N={n} F={f} 64x96 "
                      f"{str(dtype)[6:]}: max|err| forward, backward "
                      f"{errs[0]:.4g}, {errs[1]:.4g}; forward kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bd[0]:.4f} ms ({bd[1]}); backward kernel {bms:.4f} "
                      f"ms, plain {bplain_ms:.4f} ms, bound {bbd[0]:.4f} ms "
                      f"({bbd[1]}) [{card}]", flush=True)
                del t, g, y, dt
        torch.cuda.empty_cache()
    return rows


def phase_kernels_flow(card):
    """Phase 3, the flow slice's kernels: the correlation pair at the five
    pyramid levels of phase 9's step, the flat conv3d op at Base3D's layer
    shape."""
    import torch
    import torch.nn.functional as F
    from depthestimation_tpu_torch.models.layers import Conv3d
    from depthestimation_tpu_torch.ops.conv3d_kernel import (
        conv3d_flat_dw, conv3d_flat_dw_plain, conv3d_flat_fwd,
        conv3d_flat_plain, flip_weight)
    from depthestimation_tpu_torch.ops.correlation import (
        correlation_batched, correlation_bwd_plain)
    from depthestimation_tpu_torch.ops.correlation_kernel import (
        correlate, correlate_bwd)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = {}

    # correlation, f32, md 4, B=8 at PWCLite's levels of a 384x832 pair;
    # within 1e-5 max|plain| (f32 sums in another order). The operations
    # are f32 FMAs on the CUDA cores: the bound uses the f32 peak.
    for c, h, w in ((192, 6, 13), (128, 12, 26), (96, 24, 52),
                    (64, 48, 104), (32, 96, 208)):
        x1 = torch.randn(8, c, h, w, generator=gen).to(dev)
        x2 = torch.randn(8, c, h, w, generator=gen).to(dev)
        g = torch.randn(8, 81, h, w, generator=gen).to(dev)
        out = correlate(x1, x2, 4)
        got = correlate_bwd(x1, x2, g, 4)
        torch.cuda.synchronize()
        want = (correlation_batched(x1, x2, 4),) + correlation_bwd_plain(
            x1, x2, g, 4)
        errs = []
        for a, b, nm in zip((out,) + got, want, ("out", "dx1", "dx2")):
            e = (a - b).abs().max().item()
            bnd = 1e-5 * b.abs().max().item()
            check(np.isfinite(e) and e <= bnd,
                  f"correlation C={c} {h}x{w} {nm}: max|err| {e} > {bnd}")
            errs.append(e)
        ms = cuda_ms(lambda: correlate(x1, x2, 4), 20)
        plain_ms = cuda_ms(lambda: correlation_batched(x1, x2, 4), 5)
        bms = cuda_ms(lambda: correlate_bwd(x1, x2, g, 4), 20)
        bplain_ms = cuda_ms(lambda: correlation_bwd_plain(x1, x2, g, 4), 3)
        flops = 2.0 * 81 * c * 8 * h * w
        bd = bound(nbytes(x1, x2, out), flops, FP32_FLOPS)
        bbd = bound(nbytes(x1, x2, g, *got), 2.0 * flops, FP32_FLOPS)
        rows[("correlation", c)] = row(errs[0], ms, plain_ms, None, bd)
        rows[("correlation_bwd", c)] = row(max(errs[1:]), bms, bplain_ms,
                                           None, bbd)
        print(f"phase 3: correlation B=8 C={c} {h}x{w} md=4 f32: max|err| "
              f"out, dx1, dx2 {errs[0]:.4g}, {errs[1]:.4g}, {errs[2]:.4g} "
              f"(max {want[0].abs().max().item():.4g}, "
              f"{want[1].abs().max().item():.4g}); forward kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd[0]:.4f} ms "
              f"({bd[1]}); backward kernel {bms:.4f} ms, plain "
              f"{bplain_ms:.4f} ms, bound {bbd[0]:.4f} ms ({bbd[1]}) "
              f"[{card}]", flush=True)
        del x1, x2, g, out, got, want

    # the flat conv3d op at Base3D's layer, [512, 32, 64, 96] -> 32, D=64:
    # rule 3 (3% of max|plain|) for y, dx and dW; the library yardsticks
    # cuDNN's conv3d on the 5-D volume and its backward, and the port's
    # flat Conv3d (cuDNN's stacked taps + tap_combine) beside them
    n, c, f, h, w, depth = 512, 32, 32, 64, 96, 64
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        x = torch.randn(n, c, h, w, generator=gen).to(dev, dtype)
        wt = (torch.randn(f, c, 3, 3, 3, generator=gen)
              * (2.0 / (27 * f)) ** 0.5).to(dev)
        dy = (torch.randn(n, f, h, w, generator=gen) * 0.1).to(dev, dtype)
        kt = flip_weight(wt)
        got = (conv3d_flat_fwd(x, wt, depth), conv3d_flat_fwd(dy, kt, depth),
               conv3d_flat_dw(x, dy, depth))
        torch.cuda.synchronize()
        want = (conv3d_flat_plain(x, wt, depth),
                conv3d_flat_plain(dy, kt, depth),
                conv3d_flat_dw_plain(x, dy, depth))
        errs = []
        for a, b, nm in zip(got, want, ("y", "dx", "dW")):
            e = (a.float() - b.float()).abs().max().item()
            bnd = 0.03 * b.float().abs().max().item()
            check(np.isfinite(e) and e <= bnd,
                  f"conv3d_flat {tag} {nm}: max|err| {e} > 3% ({bnd})")
            errs.append(e)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        flops = 2.0 * n * h * w * f * 27 * c
        ms = cuda_ms(lambda: conv3d_flat_fwd(x, wt, depth), 5)
        plain_ms = cuda_ms(lambda: conv3d_flat_plain(x, wt, depth), 5)
        dx_ms = cuda_ms(lambda: conv3d_flat_fwd(dy, kt, depth), 5)
        dw_ms = cuda_ms(lambda: conv3d_flat_dw(x, dy, depth), 5)
        dw_plain_ms = cuda_ms(lambda: conv3d_flat_dw_plain(x, dy, depth), 3)
        x5 = x.reshape(n // depth, depth, c, h, w).transpose(1, 2)
        x5 = x5.contiguous()
        dy5 = dy.reshape(n // depth, depth, f, h, w).transpose(1, 2)
        dy5 = dy5.contiguous()
        w5 = wt.to(dtype)
        lib_ms = cuda_ms(lambda: F.conv3d(x5, w5, padding=1), 5)
        blib_ms = cuda_ms(lambda: _conv_bwd(dy5, x5, w5), 5)
        layer = Conv3d(c, f, depth, dtype=dtype if dtype != torch.float32
                       else None, combine=True).to(dev)
        with torch.no_grad():
            layer.weight.copy_(wt)
            flat_ms = cuda_ms(lambda: layer(x), 5)
        bd = bound(nbytes(x, wt, got[0]), flops, peak)
        dbd = bound(nbytes(x, dy, got[2]), flops, peak)
        rows[("conv3d_flat", tag)] = row(max(errs[:2]), ms, plain_ms,
                                         lib_ms, bd)
        rows[("conv3d_flat_dw", tag)] = row(errs[2], dw_ms, dw_plain_ms,
                                            blib_ms, dbd)
        print(f"phase 3: conv3d_flat N={n} C={c} F={f} {h}x{w} D={depth} "
              f"{tag}: max|err| y, dx, dW {errs[0]:.4g}, {errs[1]:.4g}, "
              f"{errs[2]:.4g} (max {want[0].float().abs().max().item():.4g},"
              f" {want[1].float().abs().max().item():.4g}, "
              f"{want[2].abs().max().item():.4g}); forward kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, cuDNN conv3d {lib_ms:.4f} ms, "
              f"flat Conv3d (cuDNN taps + tap_combine) {flat_ms:.4f} ms, "
              f"bound {bd[0]:.4f} ms ({bd[1]}); dx kernel {dx_ms:.4f} ms; "
              f"dW kernel {dw_ms:.4f} ms, plain {dw_plain_ms:.4f} ms, cuDNN "
              f"conv3d backward (dx and dW) {blib_ms:.4f} ms, bound "
              f"{dbd[0]:.4f} ms ({dbd[1]}) [{card}]", flush=True)
        del x, dy, got, want, x5, dy5, layer
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 4

def phase_server(card):
    import torch
    from depthestimation_tpu_torch.ops.convcomb_kernel import convbn_block
    from depthestimation_tpu_torch.ops.sweep_kernel import sweep_stage2
    from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime

    cfg = cfg_for(64, 64, 320, 256, "bfloat16")
    rt = NetRuntime(cfg, os.path.join(ROOT, "configs", "sensors",
                                      "real_sensor.json"),
                    mode="mono_lc", seed=0, device="cuda")
    w, h = rt.size
    rng = np.random.default_rng(0)
    frames = [rng.random((3, h, w), dtype=np.float32) for _ in range(4)]
    sweep_stage2.launches = 0
    convbn_block.launches = 0
    times = []
    for i, frame in enumerate(frames):
        s0, c0 = sweep_stage2.launches, convbn_block.launches
        t0 = time.perf_counter()
        out = rt.process_frame(frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(sweep_stage2.launches - s0 == 1,
              f"frame {i}: {sweep_stage2.launches - s0} sweep launches")
        check(convbn_block.launches - c0 == 8,
              f"frame {i}: {convbn_block.launches - c0} Base3D launches")
        shapes = {"depth": (h, w), "dpv_refined": (64, h, w),
                  "uf": (64, w), "dpv_low": (64, h // 4, w // 4)}
        for k, shape in shapes.items():
            check(tuple(out[k].shape) == shape,
                  f"frame {i}: {k} shape {tuple(out[k].shape)} != {shape}")
        for k in ("depth", "dpv_refined", "dpv_low"):
            check(bool(torch.isfinite(out[k]).all()),
                  f"frame {i}: {k} not finite")
        dep = out["depth"]
        check(dep.min().item() >= D_MIN - 1e-3
              and dep.max().item() <= D_MAX + 1e-3,
              f"frame {i}: depth [{dep.min().item()}, {dep.max().item()}] "
              f"outside [{D_MIN}, {D_MAX}]")
        psum = torch.exp(out["dpv_refined"]).sum(0)
        check(bool(torch.allclose(psum, torch.ones_like(psum), atol=1e-3)),
              f"frame {i}: refined DPV does not normalize")
        check(rt.prev_output is not None
              and tuple(rt.prev_output.shape) == (1, 64, h // 4, w // 4),
              f"frame {i}: prev_output not carried")
    launches = {"sweep_stage2": sweep_stage2.launches,
                "convbn_block": convbn_block.launches}
    print(f"phase 4: NetRuntime mono_lc {w}x{h} fd=64 D=64 bf16 answered 4 "
          f"frames; launches {launches}; host ms per frame "
          f"{[round(t, 3) for t in times]} [{card}]", flush=True)


# ------------------------------------------------------------ phase 5

def _dist(a, b):
    import torch
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def phase_flagship(card):
    import torch
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.ops.dpv import dpv_to_depthmap

    w, h = 384, 256
    m_bf = get_model(cfg_for(64, 64, w, h, "bfloat16"), "cuda", seed=0)
    m_32 = get_model(cfg_for(64, 64, w, h, "float32"), "cuda", seed=0)
    floor = 4e-3
    for batch in (1, 8):
        mi_np, _ = make_batch(batch=batch, t_win=1, h=h, w=w, d_min=D_MIN,
                              d_max=D_MAX, ndepth=64, qpower=1.0, seed=0)
        mi = to_device(mi_np, "cuda")
        d_candi = mi["d_candi"]

        def run(model, kernels):
            model.use_kernels = kernels
            with torch.inference_mode():
                return model(mi)["output_refined"][-1]

        with torch.inference_mode():
            ref = run(m_32, False)
            outs = {"kernel": run(m_bf, True), "plain": run(m_bf, False)}
        depth_ref = dpv_to_depthmap(ref, d_candi, log=True)
        dists = {}
        for k, o in outs.items():
            check(bool(torch.isfinite(o).all()), f"B={batch} {k}: not finite")
            dists[k] = (_dist(dpv_to_depthmap(o, d_candi, log=True),
                              depth_ref),
                        _dist(torch.exp(o), torch.exp(ref)))
        for i, what in enumerate(("depth", "refined DPV")):
            bound = 3 * dists["plain"][i] + floor
            check(dists["kernel"][i] <= bound,
                  f"B={batch} {what}: kernel-vs-f32 {dists['kernel'][i]:.4g}"
                  f" > 3 x plain-vs-f32 + floor = {bound:.4g}")

        # timing in turns: plain, kernel, kernel, plain
        t = {"plain": [], "kernel": []}
        for k in ("plain", "kernel", "kernel", "plain"):
            t[k].append(cuda_ms(lambda: run(m_bf, k == "kernel"), 5))
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"phase 5: flagship exp7_lc {w}x{h} D=64 B={batch}: rel-L2 vs "
              f"f32 (depth, DPV) kernel {dists['kernel'][0]:.4g}, "
              f"{dists['kernel'][1]:.4g}; plain {dists['plain'][0]:.4g}, "
              f"{dists['plain'][1]:.4g}; kernel path {ms['kernel']:.3f} ms "
              f"({1e3 * batch / ms['kernel']:.2f} fps), plain path "
              f"{ms['plain']:.3f} ms ({1e3 * batch / ms['plain']:.2f} fps) "
              f"[{card}]", flush=True)


# ------------------------------------------------------------ phase 6

def _train_batch(batch, w, h, dev):
    """A synthetic batch on the card, its soft labels made there
    (``trainer/default._soft_labels``, variance 0.3, as bench_train.py)."""
    import torch
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.trainer.default import _soft_labels
    mi_np, gt_np = make_batch(batch=batch, t_win=1, h=h, w=w, d_min=D_MIN,
                              d_max=D_MAX, ndepth=64, qpower=1.0, seed=0)
    mi = to_device(mi_np, dev)
    gt = to_device({k: v for k, v in gt_np.items()
                    if not k.startswith("soft_labels")}, dev)
    d_candi = torch.as_tensor(mi_np["d_candi"], dtype=torch.float32,
                              device=dev)
    gt["soft_labels"] = _soft_labels(gt["dmaps"], gt["masks"], d_candi, 0.3)
    gt["soft_labels_imgsize"] = _soft_labels(
        gt["dmap_imgsizes"], gt["masks_imgsizes"], d_candi, 0.3)
    return mi, gt


def _grad_groups(model):
    groups = {"encoder": "base_encoder.", "BV head": "conv0",
              "Base3D": "based_3d.", "decoder": "base_decoder."}
    import torch
    return {g: torch.cat([p.grad.flatten() for k, p in
                          model.named_parameters() if k.startswith(pre)])
            for g, pre in groups.items()}


def _wrappers():
    from depthestimation_tpu_torch.ops.combine_kernel import tap_combine
    from depthestimation_tpu_torch.ops.convbn2d_kernel import convbn2d_block
    from depthestimation_tpu_torch.ops.convcomb_kernel import convbn_block
    from depthestimation_tpu_torch.ops.sweep_kernel import sweep_stage2
    return sweep_stage2, convbn_block, convbn2d_block, tap_combine


def launch_counts():
    """(sweep fwd, bwd, convcomb fwd, bwd, convbn2d fwd, bwd, tap_combine
    fwd, bwd) launches."""
    return tuple(getattr(k, a) for k in _wrappers()
                 for a in ("launches", "bwd_launches"))


def reset_counts():
    for k in _wrappers():
        k.launches = k.bwd_launches = 0


COUNT_NAMES = ("sweep_stage2", "sweep_stage2_bwd", "convbn_block",
               "convbn_block_bwd", "convbn2d", "convbn2d_bwd", "tap_combine",
               "tap_combine_bwd")


def rule4_step(cfg, cfg32, step, mi, gt, base, tag, want):
    """One step from ``base``'s weights through the kernels, through their
    plain versions and in f32; the kernel step must launch ``want`` and
    stay within 3x the plain step's distance from the f32 step plus 0.4%
    (tests/TOLERANCES.md rule 4) in the loss and each group's gradient.
    Returns the distances."""
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import init_state
    floor = 4e-3
    grads, losses0 = {}, {}
    for name, c, kernels in (("kernel", cfg, True), ("plain", cfg, False),
                             ("f32", cfg32, False)):
        model = get_model(c, "cuda")
        model.load_state_dict(base.state_dict())
        model.use_kernels = kernels
        before = launch_counts()
        state, loss, _ = step(init_state(model, c), mi, mi, gt, gt)
        got = tuple(a - b for a, b in zip(launch_counts(), before))
        check(got == (want if kernels else (0,) * len(want)),
              f"{tag} {name}: launches {got} != {want}")
        losses0[name] = loss.item()
        grads[name] = _grad_groups(model)
        del model, state
    check(all(np.isfinite(v) for v in losses0.values()),
          f"{tag}: first-step losses {losses0}")
    dists = {}
    for name in ("kernel", "plain"):
        d = {"loss": abs(losses0[name] - losses0["f32"])
             / abs(losses0["f32"])}
        d.update({g: _dist(grads[name][g], grads["f32"][g])
                  for g in grads["f32"]})
        dists[name] = d
    for k in dists["kernel"]:
        bnd = 3 * dists["plain"][k] + floor
        check(dists["kernel"][k] <= bnd,
              f"{tag} {k}: kernel-vs-f32 {dists['kernel'][k]:.4g} > 3 x "
              f"plain-vs-f32 + floor = {bnd:.4g}")
    return dists, losses0


def phase_train(card):
    import copy

    import torch
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    w, h = 384, 256
    dev = torch.device("cuda")
    want = (2, 2, 16, 16, 76, 76, 0, 0)
    launches = None
    for batch in (8, 1):
        cfg = cfg_for(64, 64, w, h, "bfloat16", nmode="exp7", batch=batch)
        cfg_e = cfg_for(64, 64, w, h, "bfloat16", nmode="exp7", batch=batch,
                        convbn2d=False)
        cfg32 = cfg_for(64, 64, w, h, "float32", nmode="exp7", batch=batch)
        step = make_train_step(get_loss(cfg))
        mi, gt = _train_batch(batch, w, h, dev)
        base = get_model(cfg, dev, seed=0)
        check(base.train().encoder_path(h, w) == "convbn2d",
              f"B={batch}: the train step's encoder is not the fused chain")

        # the gradients of one step from the same weights, three ways,
        # the kernel and plain steps both in the fused route
        dists, _ = rule4_step(cfg, cfg32, step, mi, gt, base, f"B={batch}",
                              want)

        # 4 Adam steps through the kernels: the main path, counted
        model = copy.deepcopy(base)
        state = init_state(model, cfg)
        reset_counts()
        losses = []
        for i in range(5):              # the 5th forward: after 4 updates
            before = launch_counts()
            state, loss, aux = step(state, mi, mi, gt, gt)
            losses.append(loss.item())
            got = tuple(a - b for a, b in zip(launch_counts(), before))
            check(got == want,
                  f"B={batch} step {i}: launches (sweep fwd, bwd, convcomb "
                  f"fwd, bwd, convbn2d fwd, bwd, tap_combine fwd, bwd) "
                  f"{got} != {want}")
            check(np.isfinite(losses[-1]), f"B={batch} step {i}: loss "
                  f"{losses[-1]}")
        counted = dict(zip(COUNT_NAMES, launch_counts()))
        check(losses[4] < losses[0],
              f"B={batch}: loss {losses[0]} -> {losses[4]} after 4 steps")
        check(tuple(aux["prev_output_left"].shape) == (batch, 64, h // 4,
                                                       w // 4),
              f"B={batch}: prev_output feedback "
              f"{tuple(aux['prev_output_left'].shape)}")
        if batch == 8:
            launches = counted

        # ms per step in turns: the plain path, the kernel path (fused
        # encoder) and the kernel path on the eager encoder
        # (tpu.convbn2d: false), with the peak memory of a step of each
        model_e = get_model(cfg_e, dev)
        model_e.load_state_dict(base.state_dict())
        runs = {"plain": (model, init_state(model, cfg), False),
                "fused": (model, state, True),
                "eager": (model_e, init_state(model_e, cfg_e), True)}

        def run(k):
            m, st, kernels = runs[k]
            m.use_kernels = kernels
            st, _, _ = step(st, mi, mi, gt, gt)
            runs[k] = (m, st, kernels)

        t = {k: [] for k in runs}
        peak = {}
        for k in ("plain", "fused", "eager", "eager", "fused", "plain"):
            run(k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t[k].append(cuda_ms(lambda: run(k), 3, warmup=0))
            peak[k] = torch.cuda.max_memory_allocated() / 2**30
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        check(model_e.train().encoder_path(h, w) == "eager",
              f"B={batch}: tpu.convbn2d false did not take the eager encoder")

        # one step through the kernels, split by CUDA events
        model.use_kernels = True
        opt = runs["fused"][1].optimizer
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        loss_fn = get_loss(cfg)
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        outs = [model(mi), model(mi)]
        ev[1].record()
        loss = loss_fn(outs, [gt, gt])
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        split = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
        trail = " -> ".join(f"{x:.5g}" for x in losses)
        rule4 = "; ".join(f"{k} {dists['kernel'][k]:.4g}, "
                          f"{dists['plain'][k]:.4g}" for k in dists["kernel"])
        fps = {k: 1e3 * batch / v for k, v in ms.items()}
        print(f"phase 6: train step exp7 {w}x{h} D=64 bf16 B={batch} "
              f"tpu.convbn2d auto: loss {trail} over 4 Adam steps; launches "
              f"per step (sweep fwd, bwd, convcomb fwd, bwd, convbn2d fwd, "
              f"bwd, tap_combine fwd, bwd) {want}, over the 5 steps "
              f"{counted}; rel dist from the "
              f"f32 step (kernel, plain): {rule4}; ms per step: fused "
              f"route {ms['fused']:.3f} ({fps['fused']:.2f} frames/s), "
              f"eager encoder (tpu.convbn2d false) {ms['eager']:.3f} "
              f"({fps['eager']:.2f}), plain path {ms['plain']:.3f} "
              f"({fps['plain']:.2f}); fused step split ms: forward x2 "
              f"{split[0]:.3f}, loss {split[1]:.3f}, backward "
              f"{split[2]:.3f}, Adam {split[3]:.3f}; peak memory GiB fused "
              f"{peak['fused']:.3f}, eager encoder {peak['eager']:.3f}, "
              f"plain {peak['plain']:.3f} [{card}]", flush=True)
        del model, model_e, runs, base, outs, loss, opt, state
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 7

def phase_tail(card):
    """The decoder's fused refine tail (tpu.convbn2d true) in one B=1
    train step: 38 + 3 convbn2d launches per forward, two forwards."""
    import torch
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import make_train_step

    w, h = 384, 256
    cfg = cfg_for(64, 64, w, h, "bfloat16", nmode="exp7", convbn2d=True)
    cfg32 = cfg_for(64, 64, w, h, "float32", nmode="exp7", convbn2d=True)
    mi, gt = _train_batch(1, w, h, torch.device("cuda"))
    base = get_model(cfg, "cuda", seed=0)
    check(base.base_decoder.use_fused(), "tpu.convbn2d true: no fused tail")
    want = (2, 2, 16, 16, 82, 82, 0, 0)
    reset_counts()
    dists, losses0 = rule4_step(cfg, cfg32, make_train_step(get_loss(cfg)),
                                mi, gt, base, "decoder tail B=1", want)
    counted = dict(zip(COUNT_NAMES, launch_counts()))
    rule4 = "; ".join(f"{k} {dists['kernel'][k]:.4g}, "
                      f"{dists['plain'][k]:.4g}" for k in dists["kernel"])
    print(f"phase 7: train step exp7 {w}x{h} D=64 bf16 B=1 tpu.convbn2d "
          f"true (encoder chain + decoder tail): loss "
          f"{losses0['kernel']:.5g} (f32 {losses0['f32']:.5g}); launches "
          f"{counted}; rel dist from the f32 step (kernel, plain): {rule4} "
          f"[{card}]", flush=True)
    del base
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 8

def _lc_route(card, tag, keys, want, rule4: bool):
    """The LC-on train step at B=8 on one Base3D route (``keys``: its
    ``tpu`` settings): 4 Adam steps with the ``prev_output`` / ``prev_lc``
    feedback, counted; LC-on and LC-off ms in turns; the step's split.
    Returns the launches counted over the main path's run."""
    import copy

    import torch
    from depthestimation_tpu_torch.lc.curtain import LightCurtain
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.ops.ufield import UFieldParams
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)
    from depthestimation_tpu_torch.trainer.default import fused_lc_fn

    w, h, batch = 384, 256, 8
    dev = torch.device("cuda")
    cfg = cfg_for(64, 64, w, h, "bfloat16", batch=batch, **keys)
    cfg32 = cfg_for(64, 64, w, h, "float32", batch=batch, **keys)
    mi, gt = _train_batch(batch, w, h, dev)
    base = get_model(cfg, dev, seed=0)
    path = base.conv3d_path(batch, 64, h // 4, w // 4)
    check(path == tag, f"{keys}: Base3D route {path!r}, not {tag!r}")
    check(base.train().encoder_path(h, w) == "convbn2d",
          f"{tag}: the train step's encoder is not the fused chain")

    lc = LightCurtain(dev)
    lc.init(lc.expand_params(lc.gen_params_from_model_input(mi), cfg, 64,
                             128))
    check(not lc.transform_needed and lc.planner_large.C == w,
          f"{tag}: the synthetic curtain is not the 384-ray co-located one")
    lc_fn = fused_lc_fn(cfg, lc, UFieldParams.for_dataset("kitti"))
    loss_fn = get_loss(cfg)
    step_on = make_train_step(loss_fn, lc_fn=lc_fn)
    step_off = make_train_step(loss_fn)

    rule4_txt = "not run on this route"
    if rule4:
        dists, _ = rule4_step(cfg, cfg32, step_off, mi, gt, base,
                              f"LC {tag} B={batch}", want)
        rule4_txt = "; ".join(f"{k} {dists['kernel'][k]:.4g}, "
                              f"{dists['plain'][k]:.4g}"
                              for k in dists["kernel"])

    def fed(aux, side):
        """The next step's input: the feedback of ``aux`` for ``side``."""
        if aux is None:
            return mi
        return dict(mi, prev_output=aux[f"prev_output_{side}"],
                    prev_lc=aux[f"prev_lc_{side}"])

    # 4 Adam steps with the feedback: the main path, counted
    model = copy.deepcopy(base)
    state = init_state(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    log_uniform = float(np.log(1.0 / 64))
    reset_counts()
    losses, aux = [], None
    for i in range(5):                  # the 5th forward: after 4 updates
        before = launch_counts()
        state, loss, aux = step_on(state, fed(aux, "left"),
                                   fed(aux, "right"), gt, gt, gen)
        losses.append(loss.item())
        got = tuple(a - b for a, b in zip(launch_counts(), before))
        check(got == want, f"LC {tag} step {i}: launches {got} != {want}")
        check(np.isfinite(losses[-1]), f"LC {tag} step {i}: loss {loss}")
        for side in ("left", "right"):
            pl = aux[f"prev_lc_{side}"]
            check(tuple(pl.shape) == (batch, 64, h // 4, w // 4)
                  and bool(torch.isfinite(pl).all()),
                  f"LC {tag} step {i}: prev_lc_{side} {tuple(pl.shape)}")
            psum = torch.exp(pl).sum(1)
            check(bool(torch.allclose(psum, torch.ones_like(psum),
                                      atol=1e-3)),
                  f"LC {tag} step {i}: prev_lc_{side} does not normalize")
            check((pl - log_uniform).abs().max().item() > 0.5,
                  f"LC {tag} step {i}: prev_lc_{side} is the log-uniform "
                  f"prior: the curtains sensed nothing")
    counted = dict(zip(COUNT_NAMES, launch_counts()))
    # the feedback changes the inputs from step to step, so the losses are
    # not one descent; with lr 1e-5 they stay near the first
    check(max(losses) <= 1.25 * losses[0],
          f"LC {tag}: loss {losses} left the first by more than a quarter")

    # ms per step in turns: LC on, off, off, on (inputs: the last feedback)
    mi_l, mi_r = fed(aux, "left"), fed(aux, "right")
    runs = {"on": (step_on, state), "off": (step_off, state)}

    def run(k):
        runs[k][0](runs[k][1], mi_l, mi_r, gt, gt, gen)

    t = {"on": [], "off": []}
    peak = {}
    for k in ("on", "off", "off", "on"):
        run(k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t[k].append(cuda_ms(lambda: run(k), 2, warmup=0))
        peak[k] = torch.cuda.max_memory_allocated() / 2**30
    ms = {k: sum(v) / len(v) for k, v in t.items()}

    # one LC-on step split by CUDA events; the planner's DP inside
    # lc_process from events around each of its solves
    dp_events = []
    solve = lc.planner_large.get_design_points

    def timed_solve(field):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = solve(field)
        ev[1].record()
        dp_events.append(ev)
        return out

    lc.planner_large.get_design_points = timed_solve
    opt = state.optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    opt.zero_grad(set_to_none=True)
    outs = [model(mi_l, generator=gen), model(mi_r, generator=gen)]
    ev[1].record()
    loss = loss_fn(outs, [gt, gt])
    ev[2].record()
    loss.backward()
    ev[3].record()
    opt.step()
    ev[4].record()
    refined = [o["output_refined"][-1].detach() for o in outs]
    lc_fn(refined[0], refined[1], mi_l, mi_r, gen)
    ev[5].record()
    torch.cuda.synchronize()
    lc.planner_large.get_design_points = solve
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
    dp_ms = sum(a.elapsed_time(b) for a, b in dp_events)
    check(len(dp_events) == 5, f"LC {tag}: {len(dp_events)} planner solves")

    trail = " -> ".join(f"{x:.5g}" for x in losses)
    print(f"phase 8: LC-on train step exp7_lc {w}x{h} D=64 bf16 B={batch} "
          f"route {tag} {keys}: loss {trail} over 4 Adam steps with "
          f"prev_output and prev_lc fed back; launches per step (sweep fwd, "
          f"bwd, convcomb fwd, bwd, convbn2d fwd, bwd, tap_combine fwd, bwd) "
          f"{want}, over the 5 steps {counted}; rel dist from the f32 step "
          f"(kernel, plain): {rule4_txt}; ms per step: LC on {ms['on']:.3f} "
          f"({1e3 * batch / ms['on']:.2f} frames/s), LC off {ms['off']:.3f} "
          f"({1e3 * batch / ms['off']:.2f}); LC-on step split ms: forward "
          f"x2 {split[0]:.3f}, loss {split[1]:.3f}, backward {split[2]:.3f}, "
          f"Adam {split[3]:.3f}, lc_process {split[4]:.3f} (planner DP, 5 "
          f"solves of [16, 3, 128, 384] {dp_ms:.3f}); peak memory GiB LC on "
          f"{peak['on']:.3f}, LC off {peak['off']:.3f} [{card}]", flush=True)
    del model, base, state, outs, loss, opt, runs, aux, refined
    torch.cuda.empty_cache()
    return counted


def phase_lc_train(card):
    """Phase 8: (a) the flat Base3D route with the combine kernel, its
    B=1 step for the counts, (b) the default (fused) route."""
    import torch
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    flat = {"convcomb_pallas": False, "combine_pallas": True}
    want_flat = (2, 2, 0, 0, 76, 76, 16, 16)
    launches = _lc_route(card, "flat+tap_combine", flat, want_flat,
                         rule4=True)

    cfg = cfg_for(64, 64, 384, 256, "bfloat16", **flat)
    mi, gt = _train_batch(1, 384, 256, torch.device("cuda"))
    model = get_model(cfg, "cuda", seed=0)
    before = launch_counts()
    _, loss, _ = make_train_step(get_loss(cfg))(init_state(model, cfg), mi,
                                                mi, gt, gt)
    got = tuple(a - b for a, b in zip(launch_counts(), before))
    check(got == want_flat and np.isfinite(loss.item()),
          f"flat route B=1: launches {got} != {want_flat}, loss {loss}")
    print(f"phase 8: flat route B=1 step: launches {got}, loss "
          f"{loss.item():.5g} [{card}]", flush=True)
    del model
    torch.cuda.empty_cache()

    _lc_route(card, "convcomb", {}, (2, 2, 16, 16, 76, 76, 0, 0),
              rule4=False)
    return launches


# ------------------------------------------------------------ phase 9

FLOW_COUNT_NAMES = ("correlation", "correlation_bwd", "conv3d_flat",
                    "conv3d_flat_dw")


def _flow_wrappers():
    from depthestimation_tpu_torch.ops.conv3d_kernel import conv3d_flat
    from depthestimation_tpu_torch.ops.correlation_kernel import correlate
    return ((correlate, "launches"), (correlate, "bwd_launches"),
            (conv3d_flat, "launches"), (conv3d_flat, "dw_launches"))


def flow_counts():
    """(correlation fwd, bwd, conv3d fwd, dw) launches."""
    return tuple(getattr(k, a) for k, a in _flow_wrappers())


def reset_flow_counts():
    for k, a in _flow_wrappers():
        setattr(k, a, 0)


def _flow_groups(model):
    import torch
    groups = ("extractor.", "estimator.", "context.", "conv1x1_")
    return {g.rstrip("._"): torch.cat([p.grad.flatten() for k, p in
                                       model.named_parameters()
                                       if k.startswith(g)])
            for g in groups}


def phase_flow(card):
    """Phase 9: PWCLite flow training through the normal entry points."""
    import copy

    import torch
    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.trainer.factory import get_trainer
    from depthestimation_tpu_torch.trainer.sintel import (
        synthetic_flow_batches)
    from depthestimation_tpu_torch.utils.logger import init_logger

    h, w, batch = 384, 832, 8
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(ROOT, "configs", "sintel_flow.json"))
    cfg.train.update(batch_size=batch, epoch_size=4, valid_size=2,
                     print_freq=4)
    t0 = time.perf_counter()
    train = synthetic_flow_batches(4, batch=batch, h=h, w=w, seed=0)
    val = synthetic_flow_batches(2, batch=batch, h=h, w=w, seed=1)
    data_s = time.perf_counter() - t0
    base = get_model(cfg, dev, seed=0)
    check(base.output_level == 4 and base.search_range == 4
          and next(base.parameters()).dtype == torch.float32,
          "get_model(pwclite) is not PWCLite at output level 4, md 4, f32")
    log = init_logger("chip_smoke")
    save_root = os.path.join(ROOT, "build", "chip_smoke_flow")

    def trainer(model, c=cfg, loaders=(train, val)):
        return get_trainer(c)(0, model, get_loss(c), log, save_root, c,
                              *loaders)

    def pair_of(data):
        return torch.cat([torch.as_tensor(data[k], dtype=torch.float32,
                                          device=dev)
                          for k in ("img1", "img2")], dim=1)

    # one step's loss and gradients from the same weights through the
    # correlation kernels and through the plain path, both f32
    pair0 = pair_of(train[0])
    losses0, grads, masks = {}, {}, {}
    for kernels in (True, False):
        m = copy.deepcopy(base).train()
        m.use_kernels = kernels
        loss, terms = get_loss(cfg)(m(pair0, with_bk=True), pair0,
                                    return_terms=True)
        loss.backward()
        losses0[kernels] = loss.item()
        masks[kernels] = terms["noc_mask"]
        grads[kernels] = _flow_groups(m)
        del m, loss, terms
    dloss = abs(losses0[True] - losses0[False]) / abs(losses0[False])
    check(np.isfinite(losses0[True]) and dloss <= 1e-4,
          f"flow step: kernel loss {losses0[True]} vs plain "
          f"{losses0[False]} ({dloss:.3g} > 1e-4 relative)")
    dists = {g: _dist(grads[True][g], grads[False][g]) for g in grads[True]}
    for g, d in dists.items():
        check(d <= 1e-3, f"flow step: {g} gradient rel-L2 {d:.4g} > 1e-3")
    mask_diff = int((masks[True] != masks[False]).sum().item())

    # cuDNN's and cuBLAS's TF32 on globally, as PyTorch leaves cuDNN by
    # default: the trainer's step scopes both off (utils/precision.py), so
    # its loss and gradients stay within the f32 bounds of the plain step;
    # then the same step with the scope taken out, recorded unchecked
    from depthestimation_tpu_torch.utils import precision
    tf32 = {}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    scoped = precision.no_tf32
    try:
        for name in ("scoped", "unscoped"):
            if name == "unscoped":
                precision.no_tf32 = contextlib.nullcontext
            m = copy.deepcopy(base)
            loss, _ = trainer(m)._step(pair0)
            g = _flow_groups(m)
            tf32[name] = (abs(loss.item() - losses0[False])
                          / abs(losses0[False]),
                          max(_dist(g[k], grads[False][k]) for k in g))
            del m, g
    finally:
        precision.no_tf32 = scoped
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    check(tf32["scoped"][0] <= 1e-4 and tf32["scoped"][1] <= 1e-3,
          f"flow step with TF32 on globally: loss rel {tf32['scoped'][0]:.3g}"
          f", gradient rel-L2 {tf32['scoped'][1]:.3g} (bounds 1e-4, 1e-3)")

    # the main path: 4 Adam steps through the trainer's epoch loop, counted
    model = copy.deepcopy(base)
    tr = trainer(model)
    with torch.no_grad():
        before_loss = tr.loss_func(model(pair0, with_bk=True), pair0).item()
    step, seen = tr._step, []

    def counted_step(img_pair, draws=None):
        c0 = flow_counts() + launch_counts()
        out = step(img_pair, draws)
        seen.append((out[0].item(), tuple(
            a - b for a, b in zip(flow_counts() + launch_counts(), c0))))
        return out

    tr._step = counted_step
    reset_counts()
    reset_flow_counts()
    tr._run_one_epoch()
    torch.cuda.synchronize()
    counted = dict(zip(FLOW_COUNT_NAMES, flow_counts()))
    others = launch_counts()
    tr._step = step
    want = (10, 5, 0, 0) + (0,) * len(others)
    for i, (loss, got) in enumerate(seen):
        check(got == want and np.isfinite(loss),
              f"flow step {i}: loss {loss}, launches (correlation fwd, bwd, "
              f"conv3d fwd, dw, sweep fwd, bwd, convcomb fwd, bwd, convbn2d "
              f"fwd, bwd, tap_combine fwd, bwd) {got} != {want}")
    check(len(seen) == 4 and tr.i_epoch == 1,
          f"flow: {len(seen)} steps in the epoch, not 4")
    with torch.no_grad():
        after_loss = tr.loss_func(model(pair0, with_bk=True), pair0).item()
    check(after_loss < before_loss,
          f"flow: loss on the first batch {before_loss} -> {after_loss} "
          f"after 4 steps")

    # validation: 2 batches, finite EPE
    epe = tr._validate_with_gt()
    check(np.isfinite(epe), f"flow: validation EPE {epe}")

    # ms per step in 8 turns of 3 steps (kernel, plain, plain, kernel,
    # ...: each path runs first as often), each after one untimed step;
    # peak memory; each path's split into forward, loss, backward and Adam
    runs = {}
    for kernels in (True, False):
        m = copy.deepcopy(base)
        m.use_kernels = kernels
        runs[kernels] = trainer(m)
    t = {True: [], False: []}
    peak = {}
    for kernels in (True, False, False, True) * 2:
        r = runs[kernels]
        r._step(pair0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t[kernels].append(cuda_ms(lambda: r._step(pair0), 3, warmup=0))
        peak[kernels] = torch.cuda.max_memory_allocated() / 2**30
    ms = {k: float(np.median(v)) for k, v in t.items()}
    split = {}
    for kernels, r in runs.items():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        r.optimizer.zero_grad(set_to_none=True)
        out = r.model(pair0, with_bk=True)
        ev[1].record()
        loss = r.loss_func(out, pair0)
        ev[2].record()
        loss.backward()
        ev[3].record()
        r.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        split[kernels] = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
        del out, loss
    del runs

    # one SintelARTrainer step at B=2: the with_bk pass and two student
    # passes forward (20), the forward flows' pass and the students'
    # backward (15); l_atst and l_ot finite
    cfg_ar = cfg.copy()
    cfg_ar.data.trainer_name = "sintel_ar"
    ar_pair = pair_of(synthetic_flow_batches(1, batch=2, h=h, w=w,
                                             seed=2)[0])
    ar = trainer(copy.deepcopy(base), cfg_ar)
    reset_flow_counts()
    ar_loss, ar_terms = ar._step(ar_pair)
    torch.cuda.synchronize()
    ar_got = flow_counts()
    check(ar_got == (20, 15, 0, 0) and np.isfinite(ar_loss.item())
          and all(np.isfinite(ar_terms[k].item()) for k in ("l_atst", "l_ot")),
          f"flow AR step: launches {ar_got} != (20, 15, 0, 0) or loss "
          f"{ar_loss.item()}, terms {ar_terms}")

    trail = " -> ".join(f"{loss:.5g}" for loss, _ in seen)
    grads_s = ", ".join(f"{g} {d:.3g}" for g, d in dists.items())
    fps = {k: 1e3 * batch / v for k, v in ms.items()}
    sp = {k: ", ".join(f"{x:.3f}" for x in v) for k, v in split.items()}
    print(f"phase 9: flow SintelTrainer PWCLite {w}x{h} B={batch} f32 "
          f"(synthetic pairs made in {data_s:.1f} s): kernel vs plain one "
          f"step: loss {losses0[True]:.6g} vs {losses0[False]:.6g} (rel "
          f"{dloss:.3g}), gradient rel-L2 {grads_s}, occlusion-mask pixels "
          f"that differ {mask_diff} of {masks[True].numel()}; TF32 on "
          f"globally, trainer step vs the plain f32 step: loss rel "
          f"{tf32['scoped'][0]:.3g}, largest gradient rel-L2 "
          f"{tf32['scoped'][1]:.3g} (without the scope: "
          f"{tf32['unscoped'][0]:.3g}, {tf32['unscoped'][1]:.3g}); 4 Adam steps "
          f"losses {trail}, loss on batch 0 {before_loss:.6g} -> "
          f"{after_loss:.6g}; launches per step (correlation fwd, bwd) "
          f"{want[:2]}, over the 4 steps {counted}, no other kernel; val EPE "
          f"{epe:.4f} (2 batches); ms per step, median of 4 turns of 3 "
          f"steps: kernel {ms[True]:.3f} ({fps[True]:.2f} pairs/s), plain "
          f"{ms[False]:.3f} ({fps[False]:.2f}); the turns: kernel "
          f"{', '.join(f'{x:.3f}' for x in t[True])}, plain "
          f"{', '.join(f'{x:.3f}' for x in t[False])}; split forward, loss, "
          f"backward, Adam ms: "
          f"kernel {sp[True]}, plain {sp[False]}; peak memory GiB kernel "
          f"{peak[True]:.3f}, plain {peak[False]:.3f}; AR step B=2: "
          f"launches {ar_got[:2]}, loss {ar_loss.item():.5g}, l_atst "
          f"{ar_terms['l_atst'].item():.5g}, l_ot "
          f"{ar_terms['l_ot'].item():.5g} [{card}]", flush=True)
    return counted


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from depthestimation_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        print(f"phase 1: device {torch.cuda.get_device_name(0)}; "
              f"{torch.cuda.device_count()} visible; nvidia-smi: {card}",
              flush=True)
        lib = cuda_lib.library()
        spills = [ln.strip() for ln in lib.build_log.splitlines()
                  if "registers" in ln or "spill" in ln]
        how = (f"built in {lib.build_seconds:.3f} s; ptxas: "
               f"{' | '.join(spills)}" if lib.build_log else
               "loaded the build an earlier run in this checkout made")
        print(f"phase 2: {os.path.relpath(lib.path, ROOT)} {how}",
              flush=True)
        rows = phase_kernels(card)
        rows.update(phase_kernels_flow(card))
        phase_server(card)
        phase_flagship(card)
        launches = phase_train(card)
        phase_tail(card)
        lc_launches = phase_lc_train(card)
        flow_launches = phase_flow(card)
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    src = "depthestimation_tpu_torch/csrc/"
    kernels = []
    for name, key, source, replaces in (
            ("sweep_stage2", ("sweep_stage2", 8), "sweep_stage2.cu",
             "depthestimation_tpu/ops/sweep_pallas.py:151"),
            ("sweep_stage2_bwd", ("sweep_stage2_bwd", 8), "sweep_stage2.cu",
             "depthestimation_tpu/ops/sweep_pallas.py:192"),
            ("convbn_block", ("convbn_block", 32, 32), "convcomb.cu",
             "depthestimation_tpu/ops/convcomb_pallas.py:140"),
            ("convbn_block_bwd", ("convbn_block_bwd", 32, 32), "convcomb.cu",
             "depthestimation_tpu/ops/convcomb_pallas.py:258"),
            ("convbn2d", ("convbn2d", "quarter"), "convbn2d.cu",
             "depthestimation_tpu/ops/convbn2d_pallas.py:201"),
            ("convbn2d_bwd", ("convbn2d_bwd", "quarter"), "convbn2d.cu",
             "depthestimation_tpu/ops/convbn2d_pallas.py:356"),
            ("tap_combine", ("tap_combine", 32), "tap_combine.cu",
             "depthestimation_tpu/ops/combine_pallas.py:63"),
            ("tap_combine_bwd", ("tap_combine_bwd", 32), "tap_combine.cu",
             "depthestimation_tpu/ops/combine_pallas.py:63"),
            ("correlation", ("correlation", 32), "correlation.cu",
             "depthestimation_tpu/ops/correlation.py:64"),
            ("correlation_bwd", ("correlation_bwd", 32), "correlation.cu",
             "depthestimation_tpu/ops/correlation.py:64"),
            ("conv3d_flat", ("conv3d_flat", "bfloat16"), "conv3d_flat.cu",
             "depthestimation_tpu/ops/conv3d_pallas.py:114"),
            ("conv3d_flat_dw", ("conv3d_flat_dw", "bfloat16"),
             "conv3d_flat.cu",
             "depthestimation_tpu/ops/conv3d_pallas.py:173")):
        # each kernel's launches on the path that runs it: the train step
        # (phase 6), the LC-on step on the flat route (phase 8), or the
        # flow trainer's 4 steps (phase 9; the conv3d op is an op-level
        # entry that no path calls, so 0)
        counted = (lc_launches if name.startswith("tap_") else
                   flow_launches if name in FLOW_COUNT_NAMES else launches)
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": replaces, "launches": counted[name],
                        **rows[key]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
