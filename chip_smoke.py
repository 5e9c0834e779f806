#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port on one NVIDIA GPU: the serving
path, the bf16 train step, the train step with the light-curtain loop
inside, PWCLite optical-flow training, light-curtain serving with the
recorded-sweep paths, the real-data loaders, data parallel, the KITTI eval
harness, the sweep converter and the LC sandbox.

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
   correlation pair at the five pyramid levels of phase 9 (with their
   device times and the sum a flow step launches), and the flat conv3d op
   (forward, dx, dW) at Base3D's layer shape in bf16 and f32 beside
   cuDNN's conv3d and the port's flat ``Conv3d``, each bit-equal over two
   launches; and the shapes of phase 11's training paths (nmode lc's
   Base3D entry layer C=4 -> F=32 at N=128, 64x80; the encoder's fused
   layers at 320x256 with 4 images a call), forward and backward;
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
   forward, loss, backward and Adam, with the correlation kernels' device
   ms in one step and peak memory;
   ``_validate_with_gt`` on 2 batches (finite EPE); one SintelARTrainer
   step at B=2 (20 + 15 correlation launches, finite l_atst and l_ot);
10. the depth trainer through its CLI (``python -m
   depthestimation_tpu_torch.train``'s ``main``) in ``build/phase10``, on
   bf16 copies of ``configs/synthetic_tpu.json`` (exp7, 384x256, D 64, fd
   64, ``-b 8``): one epoch (8 steps, batches from the spawned loader
   process, then the validation: 2 frames), ``--resume`` for a second
   epoch (the thread loader), ``--eval`` at batch 1; losses finite, per
   step 2, 2, 16, 16, 76, 76 launches (sweep, Base3D, convbn2d, forward and
   backward), per validation frame 1 sweep and 8 Base3D, ``{exp}.json``
   with five finite metrics per epoch, ``_ckpt`` and ``_model_best``, the
   resume at epoch 1, ``--eval``'s metrics within 1e-4 relative of
   ``_model_best``'s weights validated in memory at batch 1, and
   ``NetRuntime(save_root=...)`` answering a frame from ``_model_best``;
   then one ``--lc`` epoch of ``configs/synthetic_tpu_lc.json`` (exp7_lc,
   B=2) with ``prev_lc`` fed back; the median step ms (CUDA events), the
   epoch's seconds and its share spent waiting on the loader;
11. light-curtain serving and the recorded-sweep paths: (a) ``NetRuntime``
   (mono_lc, ``real_sensor.json``, 320x256, fd 64, D 64, bf16, seeded
   weights) with ``planner="default"`` answers 4 frames with
   ``depth_sense`` from a ray-cast basement: per frame 1 sweep and 8
   Base3D launches, ``lc_depth`` finite in [s_range, e_range] where
   ``lc_mask`` is set, ``prev_lc`` (1, 64, 64, 80) finite and
   normalized, no carry after ``reset()``; ms per frame with and without
   the planner (CUDA events, host wall beside them) and the planner
   round's split (planning, of it the DP; sensing; integrating); (b)
   ``PlannerRuntime`` sim, 20 rounds scored before each, noise off, on
   ``basement_sensor.json`` at full size for the deterministic
   configurations of ``benchmarks/uf_convergence.py``: ``sweep`` within 2%
   of ``uf_convergence_curves.json`` from round 2 on, the other three's
   final score within 20%; ``m1`` on the port's generator, printed; ms per
   round; (c) the real path against a serial device with a 5 ms
   exposure, pipelined (``send_fn`` / ``recv_fn``) and through
   ``sense_fn``: the round's wall ms, the measurement DPVs equal; (d)
   ``DefaultTrainer`` on a bf16 copy of
   ``configs/default_318_lc_sweep.json`` (nmode lc, 320x256, D 64, fd 64,
   LC on; its curtains on the synthetic camera's bundle, the frame the
   synthetic sweep is recorded in) over ``SyntheticSweepVideoDataset``
   with 128 planes, B=2, 2 steps: every LC call through
   ``lc_process_real``, ``prev_lc`` finite, per step (0, 0, 16, 16, 76,
   76, 0, 0) launches, rule-4 gradients against an f32 plain step; the
   step and ``lc_process_real`` ms; (e) ``SweepTrainer`` on
   ``configs/sweep_model.json`` (320x256, f32) over synthetic sweeps, B=2,
   2 steps and a validation: finite losses, no kernel launch, ms per step;
12. the real-data loaders and the rest of the model family, on a fixture
   tree the script writes to ``build/phase12`` (PNGs from ``write_png``,
   zlib and struct: the card's host has no Pillow): (a) two raw KITTI
   drives of 16 frames at 1242x375 with 2011_09_26's calibration, OXTS
   packets 1 m apart and 120,000-point scans, a 2-frame validation drive,
   and an ILIM sweep drive of 4 frames with 128-plane sweeps; (b) ms per
   cold ``KittiVideoDataset.frame`` split into PNG decode, resize and
   velodyne, the native and numpy ``generate_depth`` on one scan (the
   same pixels, z within 1e-4 m), an ILIM sweep frame and
   ``lcsweep_to_rgbsweep``; (c) ``python -m depthestimation_tpu_torch.
   train`` on a bf16 copy of ``configs/default_exp7.json`` on the KITTI
   tree (768x256 crop 384, ``-b 8``, the spawned loader): 16 steps with
   the sweep, Base3D and convbn2d kernels launched, the median step ms and
   the loader's wait share, then ``--eval``; (d) one step of nmodes
   default, exp2 (``tofuse_dpv`` from the batch's depth), exp3 and lc with
   the sweep in bf16 at 384x256, D 64, B=8 on a fixture batch, each with
   its launches and rule-4 gradients against an f32 plain step and its
   step ms; exp7 on the gather sweep in f32, its loss and gradients held
   to the decomposed sweep's from the same weights; exp8's forward
   raising ``ValueError``; one f32 step of ``DefaultModel`` and of
   ``PackNetModel`` at B=2 with no kernel launched. Phase 3 also holds
   exp3's first Base3D layer (C=3 -> F=32) forward and backward;
13. data-parallel training (``parallel/mesh.py``), work files in
   ``build/phase13``: (a) phase 6's B=8 step in an NCCL group of one
   (a ``FileStore``) bit-equal to the step without a group, the same
   launches, with ``torch.use_deterministic_algorithms`` on; and
   ``init_distributed`` under ``torchrun``'s variables joining NCCL on
   ``cuda:0``; (b) two spawned ranks on the one card over gloo, B=4 each
   of the same batch: the ranks' parameters bit-equal, each rank's
   launches the B=8 step's, the global loss and each group's gradient and
   parameters within 1e-3 plus 3x the single-process B=8 step's motion
   under a 1e-6 image change; per-rank step ms beside one process's B=8
   and B=4 steps in the same call, and the all-reduces' host split; (c)
   the same over NCCL, one rank a card, where two cards are visible (else
   a line saying it was not run); (d) ``train.main`` in two spawned ranks
   on the card (gloo) on the bf16 ``synthetic_tpu.json`` copy at ``-b 4``
   a rank with 15 trajectories (8 and 4 steps: both run 4), one epoch and
   its validation: equal steps, bit-equal parameters, one ``_ckpt`` from
   rank 0, the same five metrics; step ms, epoch s and loader wait a
   rank;
14. the last modules, work files in ``build/phase14``: (a) ``python -m
   depthestimation_tpu_torch.eval_parity``'s ``main`` on phase 12 (c)'s
   ``_model_best`` over the KITTI fixture's validation split (bf16, B=1):
   one eval forward a frame, all 2 x 9 devkit metrics finite, the table's
   rmse, rmse_refined, both scale-invariant logs and rmse_unc within 1e-5
   relative of ``train.main([... "--eval"])``'s on the same weights and
   frames, the sweep and Base3D forward launches a frame (both > 0) and
   the forward's ms a frame (CUDA events); an orbax directory raising the
   importer's ``ValueError``; (b) ``sweep_convert`` on a capture at the
   rig's stored size (128 planes of 320x256x2 f32, a 120,000-point scan,
   the rig's LC distortion): the card's undistort (one gather and
   weighted sum, its taps built once) against its plain numpy version on
   the same quantized map (max abs diff 1e-5 of the planes' range), ms a frame split into undistort, depth maps and
   projection, ``convert_frame`` and the CLI on one frame; (c)
   ``examples/lc_sandbox_torch.py`` on the card: six rounds, the last
   error below the first, each within the sandbox's ``BOUND`` of the
   JAX script's printed curve (its ``JAX_CURVE``).

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

    for c, f in ((8, 32), (32, 8), (5, 32), (3, 32), (32, 32), (32, 1)):
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
    for c, f in ((5, 32), (3, 32), (32, 32), (32, 1)):
        for n in (64, 512):
            relu = c not in (3, 5)      # the entry layers take no ReLU
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
                # device ms with t (g) warm in the L2 from the last call,
                # and cold: read from HBM, as in a step
                dev_ms, bdev_ms = (sum(device_times(fn).values()) for fn in (
                    lambda: tap_combine(t, 64),
                    lambda: tap_combine_bwd(g, 64)))
                cold_ms, bcold_ms = (sum(device_times(fn, cold=True).values())
                                     for fn in (lambda: tap_combine(t, 64),
                                                lambda: tap_combine_bwd(g, 64)))
                if dtype == torch.bfloat16 and n == 512:
                    rows[("tap_combine", f)] = row(errs[0], ms, plain_ms,
                                                   None, bd)
                    rows[("tap_combine_bwd", f)] = row(errs[1], bms,
                                                       bplain_ms, None, bbd)
                print(f"phase 3: tap_combine N={n} F={f} 64x96 "
                      f"{str(dtype)[6:]}: max|err| forward, backward "
                      f"{errs[0]:.4g}, {errs[1]:.4g}; forward kernel "
                      f"{ms:.4f} ms (device {dev_ms:.4f} warm, "
                      f"{cold_ms:.4f} L2 cold), plain "
                      f"{plain_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}); "
                      f"backward kernel {bms:.4f} ms (device {bdev_ms:.4f} "
                      f"warm, {bcold_ms:.4f} L2 cold), "
                      f"plain {bplain_ms:.4f} ms, bound {bbd[0]:.4f} ms "
                      f"({bbd[1]}) [{card}]", flush=True)
                del t, g, y, dt
        torch.cuda.empty_cache()
    return rows


def phase_kernels_flow(card):
    """Phase 3, the flow slice's kernels: the correlation pair at the five
    pyramid levels of phase 9's step, the flat conv3d op at Base3D's layer
    shape; each bit-equal over two launches, with device times."""
    import torch
    import torch.nn.functional as F
    from conv_bwd_split import device_times
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

    def dev_ms(fn, iters=10):
        return sum(device_times(fn, iters).values())

    # correlation, f32, md 4, B=8 at PWCLite's levels of a 384x832 pair;
    # within 1e-5 max|plain| (f32 sums in another order), equal bits over
    # two launches. The operations are f32 FMAs on the CUDA cores: the
    # bound uses the f32 peak. A flow step launches the forward twice and
    # the backward once at each level.
    step_dev = 0.0
    for c, h, w in ((192, 6, 13), (128, 12, 26), (96, 24, 52),
                    (64, 48, 104), (32, 96, 208)):
        x1 = torch.randn(8, c, h, w, generator=gen).to(dev)
        x2 = torch.randn(8, c, h, w, generator=gen).to(dev)
        g = torch.randn(8, 81, h, w, generator=gen).to(dev)
        out = correlate(x1, x2, 4)
        got = correlate_bwd(x1, x2, g, 4)
        again = (correlate(x1, x2, 4),) + correlate_bwd(x1, x2, g, 4)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((out,) + got, again)),
              f"correlation C={c} {h}x{w}: two launches differ")
        del again
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
        fdev = dev_ms(lambda: correlate(x1, x2, 4), 20)
        bdev = dev_ms(lambda: correlate_bwd(x1, x2, g, 4), 20)
        step_dev += 2 * fdev + bdev
        flops = 2.0 * 81 * c * 8 * h * w
        bd = bound(nbytes(x1, x2, out), flops, FP32_FLOPS)
        bbd = bound(nbytes(x1, x2, g, *got), 2.0 * flops, FP32_FLOPS)
        rows[("correlation", c)] = row(errs[0], ms, plain_ms, None, bd)
        rows[("correlation_bwd", c)] = row(max(errs[1:]), bms, bplain_ms,
                                           None, bbd)
        print(f"phase 3: correlation B=8 C={c} {h}x{w} md=4 f32: max|err| "
              f"out, dx1, dx2 {errs[0]:.4g}, {errs[1]:.4g}, {errs[2]:.4g} "
              f"(max {want[0].abs().max().item():.4g}, "
              f"{want[1].abs().max().item():.4g}), bit-equal over two "
              f"launches; forward kernel {ms:.4f} ms (device {fdev:.4f}), "
              f"plain {plain_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}); "
              f"backward kernel {bms:.4f} ms (device {bdev:.4f}), plain "
              f"{bplain_ms:.4f} ms, bound {bbd[0]:.4f} ms ({bbd[1]}) "
              f"[{card}]", flush=True)
        del x1, x2, g, out, got, want
    print(f"phase 3: correlation device ms of one flow step (10 forward, 5 "
          f"backward launches): {step_dev:.4f} [{card}]", flush=True)

    # the flat conv3d op at Base3D's layer, [512, 32, 64, 96] -> 32, D=64:
    # rule 3 (3% of max|plain|) for y, dx (the kernel reading the weight
    # flipped) and dW, equal bits over two launches; the library
    # yardsticks cuDNN's conv3d on the 5-D volume and its backward, and
    # the port's flat Conv3d (cuDNN's stacked taps + tap_combine)
    n, c, f, h, w, depth = 512, 32, 32, 64, 96, 64
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        x = torch.randn(n, c, h, w, generator=gen).to(dev, dtype)
        wt = (torch.randn(f, c, 3, 3, 3, generator=gen)
              * (2.0 / (27 * f)) ** 0.5).to(dev)
        dy = (torch.randn(n, f, h, w, generator=gen) * 0.1).to(dev, dtype)

        def run():
            return (conv3d_flat_fwd(x, wt, depth),
                    conv3d_flat_fwd(dy, wt, depth, flip=True),
                    conv3d_flat_dw(x, dy, depth))
        got = run()
        again = run()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"conv3d_flat {tag}: two launches differ")
        del again
        want = (conv3d_flat_plain(x, wt, depth),
                conv3d_flat_plain(dy, flip_weight(wt), depth),
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
        dx_ms = cuda_ms(lambda: conv3d_flat_fwd(dy, wt, depth, flip=True), 5)
        dw_ms = cuda_ms(lambda: conv3d_flat_dw(x, dy, depth), 5)
        dw_plain_ms = cuda_ms(lambda: conv3d_flat_dw_plain(x, dy, depth), 3)
        fdev = dev_ms(lambda: conv3d_flat_fwd(x, wt, depth), 5)
        dxdev = dev_ms(lambda: conv3d_flat_fwd(dy, wt, depth, flip=True), 5)
        dwdev = dev_ms(lambda: conv3d_flat_dw(x, dy, depth), 5)
        x5 = x.reshape(n // depth, depth, c, h, w).transpose(1, 2)
        x5 = x5.contiguous()
        dy5 = dy.reshape(n // depth, depth, f, h, w).transpose(1, 2)
        dy5 = dy5.contiguous()
        w5 = wt.to(dtype)
        lib_ms = cuda_ms(lambda: F.conv3d(x5, w5, padding=1), 5)
        blib_ms = cuda_ms(lambda: _conv_bwd(dy5, x5, w5), 5)
        lib_dev = dev_ms(lambda: F.conv3d(x5, w5, padding=1), 5)
        blib_dev = dev_ms(lambda: _conv_bwd(dy5, x5, w5), 5)
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
              f"{want[2].abs().max().item():.4g}), bit-equal over two "
              f"launches; forward kernel {ms:.4f} ms (device {fdev:.4f}), "
              f"plain {plain_ms:.4f} ms, cuDNN conv3d {lib_ms:.4f} ms "
              f"(device {lib_dev:.4f}), flat Conv3d (cuDNN taps + "
              f"tap_combine) {flat_ms:.4f} ms, bound {bd[0]:.4f} ms "
              f"({bd[1]}); dx kernel {dx_ms:.4f} ms (device {dxdev:.4f}); "
              f"dW kernel {dw_ms:.4f} ms (device {dwdev:.4f}), plain "
              f"{dw_plain_ms:.4f} ms, cuDNN conv3d backward (dx and dW) "
              f"{blib_ms:.4f} ms (device {blib_dev:.4f}), bound "
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
    """Each group's gradient as one vector (default and exp2 have no
    Base3D)."""
    groups = {"encoder": "base_encoder.", "BV head": "conv0",
              "Base3D": "based_3d.", "decoder": "base_decoder."}
    import torch
    named = list(model.named_parameters())
    return {g: torch.cat([p.grad.flatten() for k, p in named
                          if k.startswith(pre)])
            for g, pre in groups.items()
            if any(k.startswith(pre) for k, _ in named)}


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
    # the correlation kernels' device ms in one kernel step (profiler)
    from conv_bwd_split import device_times
    per = device_times(lambda: runs[True]._step(pair0), 1)
    corr_dev = {d: sum(v for k, v in per.items() if f"corr_{d}" in k)
                for d in ("fwd", "bwd", "reduce")}
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
          f"kernel {sp[True]}, plain {sp[False]}; the correlation "
          f"kernels' device ms in a kernel step: forward "
          f"{corr_dev['fwd'] + corr_dev['reduce']:.4f} (of it the group "
          f"sums {corr_dev['reduce']:.4f}), backward {corr_dev['bwd']:.4f} "
          f"of {sum(per.values()):.3f} device ms; peak memory GiB kernel "
          f"{peak[True]:.3f}, plain {peak[False]:.3f}; AR step B=2: "
          f"launches {ar_got[:2]}, loss {ar_loss.item():.5g}, l_atst "
          f"{ar_terms['l_atst'].item():.5g}, l_ot "
          f"{ar_terms['l_ot'].item():.5g} [{card}]", flush=True)
    return counted


# ------------------------------------------------------------ phase 10

def _phase10_config(work, name, epochs):
    """A bf16 copy of ``configs/{name}.json`` with ``epoch_num`` set, in
    ``work``: the kernels run for a bf16 model only."""
    with open(os.path.join(ROOT, "configs", name + ".json")) as f:
        raw = json.load(f)
    raw["tpu"] = {"dtype": "bfloat16"}
    raw["train"]["epoch_num"] = epochs
    path = os.path.join(work, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _sensor(w, h, d):
    """A sensor JSON for ``NetRuntime`` at the synthetic camera (focal
    0.58 w, principal point at the centre)."""
    intr = [[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h], [0, 0, 1]]
    return {"intr_rgb": intr, "intr_lc": intr, "dist_rgb": [0] * 5,
            "dist_lc": [0] * 5, "size_rgb": [w, h], "size_lc": [w, h],
            "rTc": np.eye(4).tolist(),
            "lTc": [[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]],
            "N": d, "s_range": D_MIN, "e_range": D_MAX, "q_power": 1.0,
            "laser_fov": 80.0, "laser_timestep": 2e-4}


def phase_trainer(card):
    """The depth trainer through its CLI (``depthestimation_tpu_torch.
    train.main``) in ``build/phase10``: one bf16 epoch at B=8 with its
    validation, ``--resume`` for a second, ``--eval``,
    ``NetRuntime(save_root=...)``, then one ``--lc`` epoch at B=2."""
    import shutil

    import torch
    from depthestimation_tpu_torch import train as ttrain
    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.data.video_synthetic import (
        SyntheticStereoVideoDataset)
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime
    from depthestimation_tpu_torch.trainer import checkpoint as ckpt
    from depthestimation_tpu_torch.trainer import default as tdefault
    from depthestimation_tpu_torch.utils.logger import init_logger

    work = os.path.join(ROOT, "build", "phase10")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    per_step = (2, 2, 16, 16, 76, 76, 0, 0)
    per_val_frame = (1, 0, 8, 0, 0, 0, 0, 0)
    keys = ("rmse", "rmse_refined", "sil", "sil_refined", "rmse_unc")
    steps = []          # (launches, start event, end event, prev_lc fed)
    real_make = tdefault.make_train_step

    def counted_make(loss_fn, lc_fn=None):
        step = real_make(loss_fn, lc_fn=lc_fn)

        def run(state, mi_l, mi_r, gt_l, gt_r, generator):
            before = launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, mi_l, mi_r, gt_l, gt_r, generator)
            end.record()
            steps.append((tuple(a - b for a, b in
                                zip(launch_counts(), before)),
                          start, end, mi_l["prev_lc"] is not None))
            return out
        return run

    def history(exp):
        with open(os.path.join("outputs", "checkpoints", exp,
                               exp + ".json")) as f:
            return json.load(f)

    def step_ms(run):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for _, s, e, _ in run]

    cwd = os.getcwd()
    os.chdir(work)
    tdefault.make_train_step = counted_make
    try:
        # epoch 1: dataset_path "synthetic" is no directory and the config
        # sets var.mload, so the batches come from a spawned loader process
        path = _phase10_config(work, "synthetic_tpu", 1)
        reset_counts()
        t0 = time.perf_counter()
        first = ttrain.main(["--config", path, "-b", "8"])
        wall1 = time.perf_counter() - t0
        total = launch_counts()
        run1 = list(steps)
        check(len(run1) == 8, f"epoch 1 ran {len(run1)} steps, not 8")
        for i, (got, _, _, _) in enumerate(run1):
            check(got == per_step, f"epoch 1 step {i}: launches {got} != "
                  f"{per_step}")
        want = tuple(8 * a + 2 * b for a, b in zip(per_step, per_val_frame))
        check(total == want, f"epoch 1 + validation: launches {total} != "
              f"{want} (8 steps, 2 validation frames of 1 sweep and 8 "
              "Base3D launches)")
        losses1 = first._last_epoch_losses
        check(all(np.isfinite(losses1)), f"epoch 1 losses {losses1}")
        exp, save_root = "synthetic_tpu", first.save_root
        for best in (False, True):
            check(ckpt.checkpoint_exists(save_root, exp, best=best),
                  f"no {'_model_best' if best else '_ckpt'} after epoch 1")
        ms1 = step_ms(run1)
        wait1 = first.loader_wait_seconds / first.epoch_seconds

        # epoch 2 by --resume, the in-process thread loader (--synthetic)
        path = _phase10_config(work, "synthetic_tpu", 2)
        second = ttrain.main(["--config", path, "-b", "8", "--resume",
                              "--synthetic"])
        run2 = steps[len(run1):]
        check(len(run2) == 8 and second.i_epoch == 2,
              f"--resume ran {len(run2)} steps to epoch {second.i_epoch}: "
              "it must start at epoch 1")
        check(all(r[0] == per_step for r in run2), "epoch 2 launches")
        check(all(np.isfinite(second._last_epoch_losses)),
              f"epoch 2 losses {second._last_epoch_losses}")
        hist = history(exp)
        check(all(len(hist[k]) == 2 and np.isfinite(hist[k]).all()
                  for k in keys), f"{exp}.json after 2 epochs: {hist}")
        _, best_epoch = ckpt.load_checkpoint(save_root, exp, best=True)
        check(best_epoch == 2, f"_model_best from epoch {best_epoch}, not "
              "the resumed epoch (the best resets on resume)")
        ms2 = step_ms(run2)
        wait2 = second.loader_wait_seconds / second.epoch_seconds

        # --eval restores _model_best and validates at batch 1; the same
        # weights in memory (the resumed trainer's) validated at batch 1
        # must give its metrics (BatchNorm takes batch statistics)
        third = ttrain.main(["--config", path, "--eval", "--synthetic"])
        got = [history(exp)[k][-1] for k in keys]
        cfg1 = load_config(path)
        cfg1.train.batch_size = 1
        ref = tdefault.DefaultTrainer(
            0, second.model, get_loss(cfg1), init_logger("phase10_ref"),
            os.path.join(work, "ref"), cfg1,
            val_loader=ttrain.build_loaders(cfg1, True)[1])
        want_m, _ = ref.eval()
        check(third.cfg.train.batch_size == 1 and len(history(exp)["rmse"])
              == 3, "--eval did not append one batch-1 validation")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want_m))
        check(rel <= 1e-4, f"--eval metrics {got} vs _model_best's weights "
              f"validated in memory {want_m}: rel {rel:.3g} > 1e-4")

        # the server restores _model_best and answers one frame
        state, _ = ckpt.load_checkpoint(save_root, exp, best=True)
        rt = NetRuntime(load_config(path), _sensor(384, 256, 64),
                        mode="mono", save_root=save_root)
        same = all(torch.equal(v, state["model"][k].to(v.device))
                   for k, v in rt.model.state_dict().items())
        check(same, "NetRuntime(save_root=...) weights differ from "
              "_model_best")
        frame = SyntheticStereoVideoDataset(
            n_traj=1, traj_len=1, h=256, w=384, ndepth=64,
            seed=2).frame(0, 0)["rgb_left"][-1]
        out = rt.process_frame(frame)
        dep = out["depth"]
        check(bool(torch.isfinite(dep).all()) and dep.min().item() >=
              D_MIN - 1e-3 and dep.max().item() <= D_MAX + 1e-3,
              "NetRuntime depth from _model_best not finite in range")

        # one --lc epoch (exp7_lc, B=2, the LC loop inside the step)
        lc_path = _phase10_config(work, "synthetic_tpu_lc", 1)
        n0 = len(steps)
        t0 = time.perf_counter()
        lc = ttrain.main(["--config", lc_path, "--synthetic", "--lc"])
        wall_lc = time.perf_counter() - t0
        run_lc = steps[n0:]
        check(len(run_lc) == 8 and all(r[0] == per_step for r in run_lc),
              f"LC epoch launches {[r[0] for r in run_lc]}")
        fed = [r[3] for r in run_lc]
        check(fed == [f > 0 for _ in range(2) for f in range(4)],
              f"prev_lc fed back at {fed}: every frame after the first of "
              "a trajectory must take the last step's feedback")
        check(all(np.isfinite(lc._last_epoch_losses)),
              f"LC losses {lc._last_epoch_losses}")
        lc_hist = history("synthetic_tpu_lc")
        check(all(np.isfinite(lc_hist[k][-1]) for k in keys),
              f"LC validation {lc_hist}")
        ms_lc = step_ms(run_lc)
    finally:
        tdefault.make_train_step = real_make
        os.chdir(cwd)

    def fmt(xs):
        return [round(x, 3) for x in xs]

    print(f"phase 10: trainer CLI exp7 384x256 fd=64 D=64 bf16 B=8: epoch 1 "
          f"(spawned loader) losses {fmt(losses1)}, step ms median "
          f"{float(np.median(ms1)):.3f} (CUDA events: {fmt(ms1)}), epoch "
          f"{first.epoch_seconds:.3f} s of which loader wait "
          f"{first.loader_wait_seconds:.3f} s ({100 * wait1:.1f}%), main() "
          f"{wall1:.3f} s; launches per step {per_step}, per validation "
          f"frame {per_val_frame}; epoch 2 (--resume, thread loader) step "
          f"ms median {float(np.median(ms2)):.3f} ({fmt(ms2)}), epoch "
          f"{second.epoch_seconds:.3f} s, loader wait "
          f"{second.loader_wait_seconds:.3f} s ({100 * wait2:.1f}%); "
          f"validation by epoch {({k: fmt(hist[k]) for k in keys})}; "
          f"--eval (B=1, _model_best of epoch "
          f"{best_epoch}) {fmt(got)} vs in memory rel {rel:.3g}; NetRuntime "
          f"from _model_best depth [{dep.min().item():.3f}, "
          f"{dep.max().item():.3f}] [{card}]", flush=True)
    print(f"phase 10: --lc epoch exp7_lc 384x256 bf16 B=2: losses "
          f"{fmt(lc._last_epoch_losses)}, prev_lc fed back at steps "
          f"{[i for i, f in enumerate(fed) if f]}, step ms median "
          f"{float(np.median(ms_lc)):.3f} ({fmt(ms_lc)}), epoch "
          f"{lc.epoch_seconds:.3f} s, main() {wall_lc:.3f} s; validation "
          f"{dict(zip(keys, fmt([lc_hist[k][-1] for k in keys])))} "
          f"[{card}]", flush=True)


def phase_kernels_lc(card):
    """Phase 3, the shapes of phase 11's training paths that the rows above
    do not cover: nmode lc's first Base3D layer (C=4 -> F=32, no ReLU on
    the raw volume) at B=2, D=64, 64x80, and the encoder's two fused
    layers at 320x256 with 4 images a call (B=2, two frames); forward and
    backward, the bounds above, bit-equal over two launches."""
    import torch
    import torch.nn.functional as F
    from conv_bwd_split import device_times
    from depthestimation_tpu_torch.ops.convbn2d_kernel import (
        convbn2d_block, convbn2d_block_bwd, convbn2d_block_bwd_plain,
        convbn2d_block_plain)
    from depthestimation_tpu_torch.ops.convcomb_kernel import (
        convbn_block, convbn_block_bwd, convbn_block_bwd_plain,
        convbn_block_plain)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(11)

    def operands(x_shape, w_shape, c, wscale):
        x = torch.randn(x_shape, generator=gen).to(dev, bf)
        wt = (torch.randn(w_shape, generator=gen) * wscale).to(dev, bf)
        a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
        b = (torch.randn(c, generator=gen) * 0.1).to(dev)
        return x, wt, a, b

    def both(tag, fwd, fwd_plain, bwd, bwd_plain, x, wt, a, b, act_on,
             args, flops, lib_operands):
        """One layer forward and backward against the plain versions;
        ``lib_operands(gy)`` gives cuDNN's conv (forward and backward) on
        the normalized input, the library yardsticks."""
        y, st = fwd(x, wt, a, b, *args)
        y2, st2 = fwd(x, wt, a, b, *args)
        torch.cuda.synchronize()
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"{tag}: two forward launches differ")
        y_p, st_p = fwd_plain(x, wt, a, b, *args)
        err = (y.float() - y_p.float()).abs().max().item()
        scale = y_p.float().abs().max().item() + 1e-6
        check(err <= 0.03 * scale, f"{tag}: y err {err} > 3% of {scale}")
        check(bool(torch.allclose(st, st_p, rtol=3e-2,
                                  atol=1e-2 * y.numel() / y.shape[1])),
              f"{tag}: stats {st.tolist()[:2]} vs {st_p.tolist()[:2]}")
        gy = (torch.randn(y.shape, generator=gen) * 0.1).to(dev, bf)
        gs = (torch.randn(y.shape[1], 2, generator=gen) * 1e-3).to(dev)
        bargs = (x, wt, a, b, y_p, gy, gs, *args)
        got, again = bwd(*bargs), bwd(*bargs)
        torch.cuda.synchronize()
        check(all(torch.equal(g1, g2) for g1, g2 in zip(got, again)),
              f"{tag}: two backward launches differ")
        want = bwd_plain(*bargs)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        v = x.float() * a.reshape(shape) + b.reshape(shape)
        inner = (v.abs() > 0.02 if act_on
                 else torch.ones_like(v, dtype=torch.bool))
        errs = []
        for g, p, nm, tol in zip(got, want, ("dx", "dW", "da", "db"),
                                 (0.03, 0.03, 0.10, 0.10)):
            d = (g.float() - p.float()).abs()
            e = (d[inner] if nm == "dx" else d).max().item()
            bnd = tol * p.float().abs().max().item()
            check(np.isfinite(e) and e <= bnd,
                  f"{tag} backward: {nm} max|err| {e} > {bnd}")
            errs.append(e)
        ms = cuda_ms(lambda: fwd(x, wt, a, b, *args), 10)
        plain_ms = cuda_ms(lambda: fwd_plain(x, wt, a, b, *args), 5)
        dev_ms = sum(device_times(lambda: fwd(x, wt, a, b, *args)).values())
        bms = cuda_ms(lambda: bwd(*bargs), 5)
        bplain_ms = cuda_ms(lambda: bwd_plain(*bargs), 3)
        bdev_ms = sum(device_times(lambda: bwd(*bargs)).values())
        lib_fwd, lib_bwd = lib_operands(gy)
        lib_ms, blib_ms = cuda_ms(lib_fwd, 10), cuda_ms(lib_bwd, 5)
        bd = bound(nbytes(x, wt, a, b, y, st), flops)
        bbd = bound(nbytes(x, wt, a, b, y_p, gy, gs, *got), 2.0 * flops)
        print(f"phase 3: {tag}: max|err| y {err:.4g} (max {scale:.4g}), "
              f"backward dx, dW, da, db "
              f"{', '.join(f'{e:.4g}' for e in errs)}; bit-equal over two "
              f"launches each; forward kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, cuDNN {lib_ms:.4f} "
              f"ms, bound {bd[0]:.4f} ms ({bd[1]}); backward kernel "
              f"{bms:.4f} ms (device {bdev_ms:.4f}), plain {bplain_ms:.4f} "
              f"ms, cuDNN {blib_ms:.4f} ms, bound {bbd[0]:.4f} ms "
              f"({bbd[1]}) [{card}]", flush=True)

    # Base3D's entry layer of nmode lc: [bv, prev_output, prev_lc, feat]
    n, c, f, h, w = 128, 4, 32, 64, 80
    x, wm, a, b = operands((n, c, h * w), (3 * f, c, 3, 3), c, 0.2)

    def conv3d_lib(gy):
        """cuDNN's conv3d on the [B, C, D, H, W] volume, and its
        backward."""
        u = (x.float() * a[None, :, None] + b[None, :, None]).to(bf)
        u5 = u.reshape(n // 64, 64, c, h, w).transpose(1, 2).contiguous()
        w5 = wm.reshape(3, f, c, 3, 3).permute(1, 2, 0, 3, 4).contiguous()
        g5 = gy.reshape(n // 64, 64, f, h, w).transpose(1, 2).contiguous()
        return (lambda: F.conv3d(u5, w5, padding=1),
                lambda: _conv_bwd(g5, u5, w5))

    both(f"convbn_block lc entry N={n} C={c} F={f} {h}x{w}", convbn_block,
         convbn_block_plain, convbn_block_bwd, convbn_block_bwd_plain, x, wm,
         a, b, False, (64, h, w, False), 2.0 * n * h * w * 3 * f * 9 * c,
         conv3d_lib)
    # the encoder's fused chain at 320x256, B=2 x 2 frames
    for tag, n, c, h2, w2 in (("half", 4, 32, 128, 160),
                              ("quarter", 4, 64, 64, 80)):
        x, wt, a, b = operands((n, c, h2, w2), (c, c, 3, 3), c,
                               (2.0 / (9 * c)) ** 0.5)

        def conv2d_lib(gy, x=x, wt=wt, a=a, b=b):
            u = (x.float() * a[None, :, None, None]
                 + b[None, :, None, None]).relu().to(bf)
            return (lambda: F.conv2d(u, wt, padding=1),
                    lambda: _conv_bwd(gy, u, wt))

        both(f"convbn2d {tag} N={n} C=F={c} {h2}x{w2}", convbn2d_block,
             convbn2d_block_plain, convbn2d_block_bwd,
             convbn2d_block_bwd_plain, x, wt, a, b, True, ("relu",),
             2.0 * n * h2 * w2 * c * 9 * c, conv2d_lib)
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 11

def make_basement_scene(intr, w: int, h: int, far_wall: float = 16.5,
                        side_x: float = 10.0, floor_y: float = 1.6):
    """Ray-cast a basement corridor (a copy of
    ``benchmarks/uf_convergence.py:make_basement_scene``): far wall, side
    walls, floor, ceiling and two crates. Returns depth [h, w] in metres."""
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    dx = (u - cx) / fx
    dy = (v - cy) / fy
    depth = np.full((h, w), far_wall, np.float64)
    with np.errstate(divide="ignore"):
        z_side = np.where(np.abs(dx) > 1e-9, side_x / np.abs(dx), np.inf)
    depth = np.minimum(depth, z_side)
    with np.errstate(divide="ignore"):
        z_floor = np.where(dy > 1e-9, floor_y / dy, np.inf)
        z_ceil = np.where(dy < -1e-9, -1.0 / dy, np.inf)
    depth = np.minimum(depth, np.minimum(z_floor, z_ceil))
    for x0, x1, y0, y1, z in ((-1.2, -0.8, 0.6, 1.8, 8.0),
                              (1.0, 1.4, 0.8, 1.8, 11.0)):
        px, py = dx * z, dy * z
        hit = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1) & (depth > z)
        depth = np.where(hit, z, depth)
    return depth.astype(np.float32)


def _sensor_path(name):
    return os.path.join(ROOT, "configs", "sensors", name + ".json")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _quiet(rt):
    """Hit noise off on a PlannerRuntime's simulated devices."""
    for lc in (rt.real_lc, rt.algo_lc):
        for d in (lc.lightcurtain_large, lc.lightcurtain_small):
            d.hit_noise = 0.0
    return rt


class _Events:
    """CUDA event pairs around calls of a method, by name."""

    def __init__(self):
        import torch
        self.torch = torch
        self.pairs = {}

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            ev = [self.torch.cuda.Event(enable_timing=True)
                  for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            self.pairs.setdefault(name, []).append(ev)
            return out

        setattr(obj, attr, timed)

    def ms(self, name):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs.get(name, [])]


def phase_lc_server(card):
    """Phase 11 (a): ``NetRuntime`` with its planner on the real sensor."""
    import torch
    from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime

    sensor = _sensor_path("real_sensor")
    raw = _load_json(sensor)
    cfg = cfg_for(64, 64, 320, 256, "bfloat16")
    rt = NetRuntime(cfg, sensor, mode="mono_lc", seed=0, device="cuda",
                    planner="default")
    bare = NetRuntime(cfg_for(64, 64, 320, 256, "bfloat16"), sensor,
                      mode="mono_lc", seed=0, device="cuda")
    prt = rt.planner_rt
    prior = prt.final.clone()
    w, h = rt.size
    depth = make_basement_scene(np.asarray(raw["intr_rgb"], np.float64), w, h)
    rng = np.random.default_rng(0)
    frames = [rng.random((3, h, w), dtype=np.float32) for _ in range(4)]
    ev = _Events()
    ev.wrap(prt, "run", "round")
    ev.wrap(prt, "_plan", "plan")
    ev.wrap(prt.algo_lc.planner_large, "get_design_points", "dp")
    ev.wrap(prt, "_sense_sim", "sense")
    ev.wrap(prt, "integrate", "integrate")
    want = (1, 0, 8, 0, 0, 0, 0, 0)
    s_range, e_range = float(raw["s_range"]), float(raw["e_range"])
    t = {"planner": [], "bare": []}
    wall = {"planner": [], "bare": []}
    mask_share = []
    reset_counts()
    for i, frame in enumerate(frames):
        order = ("bare", "planner") if i % 2 == 0 else ("planner", "bare")
        for k in order:
            before = launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            if k == "planner":
                out = rt.process_frame(frame, depth_sense=depth)
            else:
                bare.process_frame(frame)
            end.record()
            torch.cuda.synchronize()
            wall[k].append((time.perf_counter() - t0) * 1e3)
            t[k].append(start.elapsed_time(end))
            got = tuple(a - b for a, b in zip(launch_counts(), before))
            check(got == want, f"frame {i} {k}: launches {got} != {want}")
        lc_depth, mask = out["lc_depth"], out["lc_mask"]
        check(bool(torch.isfinite(lc_depth).all()),
              f"frame {i}: lc_depth not finite")
        set_ = mask > 0
        if bool(set_.any()):
            dd = lc_depth[set_]
            check(dd.min().item() >= s_range - 1e-3
                  and dd.max().item() <= e_range + 1e-3,
                  f"frame {i}: lc_depth [{dd.min().item()}, "
                  f"{dd.max().item()}] outside [{s_range}, {e_range}]")
        mask_share.append(set_.float().mean().item())
        pl = rt.prev_lc
        check(pl is not None and tuple(pl.shape) == (1, 64, h // 4, w // 4)
              and bool(torch.isfinite(pl).all()),
              f"frame {i}: prev_lc {None if pl is None else tuple(pl.shape)}")
        psum = torch.exp(pl).sum(1)
        check(bool(torch.allclose(psum, torch.ones_like(psum), atol=1e-3)),
              f"frame {i}: prev_lc does not normalize")
    counted = dict(zip(COUNT_NAMES, launch_counts()))
    rt.reset()
    check(rt.prev_lc is None and rt.prev_output is None
          and prt.counter == 0 and torch.equal(prt.final, prior),
          "reset() left a carry: prev_lc, prev_output or the planner field")

    def med(x):
        return float(np.median(x))

    split = {k: ev.ms(k) for k in ("round", "plan", "dp", "sense",
                                   "integrate")}
    print(f"phase 11a: NetRuntime mono_lc {w}x{h} fd=64 D=64 bf16 "
          f"planner=default on real_sensor.json, 4 frames of "
          f"make_basement_scene: launches per frame {want} (both runtimes), "
          f"over the run {counted}; lc_mask share per frame "
          f"{[round(x, 4) for x in mask_share]}; prev_lc (1, 64, {h // 4}, "
          f"{w // 4}) normalizes; reset() clears the carry; ms per frame "
          f"with the planner {[round(x, 3) for x in t['planner']]} (median "
          f"{med(t['planner']):.3f}; host wall "
          f"{[round(x, 3) for x in wall['planner']]}), without "
          f"{[round(x, 3) for x in t['bare']]} (median {med(t['bare']):.3f};"
          f" host wall {[round(x, 3) for x in wall['bare']]}); planner "
          f"round ms {[round(x, 3) for x in split['round']]}: planning "
          f"{[round(x, 3) for x in split['plan']]} of it the DP "
          f"{[round(x, 3) for x in split['dp']]}, sensing "
          f"{[round(x, 3) for x in split['sense']]}, integrating (the "
          f"network's DPV, then the curtains') "
          f"{[round(x, 3) for x in split['integrate']]} [{card}]",
          flush=True)
    del rt, bare
    torch.cuda.empty_cache()


#: ``benchmarks/uf_convergence.py:138-155``: the deterministic planner
#: configurations of the convergence ablation, (planner, params, bins)
UF_RUNS = {
    "default": ("default", {"step": [0.75], "std_div": 5.0}, 64),
    "default_128_3modes": ("default", {"step": [0.25, 0.5, 0.75],
                                       "std_div": 5.0}, 128),
    "sweep": ("sweep", {"start": 4.0, "end": 17.0, "step": 0.25}, 64),
    "sweep_sparse4": ("sweep", {"start": 4.0, "end": 17.0, "step": 3.25,
                                "phases": 5}, 64),
}
UF_M1 = ("m1", {"step": 3, "interval": 15, "std_div": 3.0}, 64)


def _uf_runtime(planner, params, bins):
    """``uf_convergence.run_config``'s runtime on basement_sensor.json,
    on the card, noise off."""
    from depthestimation_tpu_torch.runtime.planner_runtime import (
        PlannerRuntime)
    raw = _load_json(_sensor_path("basement_sensor"))
    raw["N"] = bins
    raw.setdefault("beam_width", 0.025)
    raw.setdefault("beam_divergence", 3.0e-3)
    raw.setdefault("sin_clip", 0.02)
    rt = PlannerRuntime(raw, mode="sim", planner=planner, params=params,
                        device="cuda", seed=0)
    return _quiet(rt), raw


def _uf_curve(rt, depth, rounds=20):
    """Scores before each round (as ``run_config``) and each round's ms."""
    import torch
    scores, ms = [], []
    for _ in range(rounds):
        scores.append(rt.score(depth))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rt.run(None, depth)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return scores, ms


def phase_uf_convergence(card):
    """Phase 11 (b): 20 sim rounds of each deterministic configuration of
    the convergence ablation against ``uf_convergence_curves.json``."""
    import torch
    ref = _load_json(os.path.join(ROOT, "benchmarks",
                                  "uf_convergence_curves.json"))
    lines = []
    for name, (planner, params, bins) in UF_RUNS.items():
        rt, raw = _uf_runtime(planner, params, bins)
        w, h = raw["size_rgb"]
        depth = make_basement_scene(np.asarray(raw["intr_rgb"], np.float64),
                                    w, h)
        scores, ms = _uf_curve(rt, depth)
        want = ref[name]
        check(all(np.isfinite(scores)), f"{name}: scores {scores}")
        if name == "sweep":
            rel = [abs(a - b) / b for a, b in zip(scores[1:], want[1:])]
            check(max(rel) <= 0.02,
                  f"sweep: curve {scores} vs {want}: rel {max(rel):.4f} "
                  f"> 2% from round 2 on")
            how = f"max rel from round 2 {max(rel):.4f}"
        else:
            rel = abs(scores[-1] - want[-1]) / want[-1]
            check(rel <= 0.2, f"{name}: final {scores[-1]:.4f} vs "
                  f"{want[-1]:.4f}: rel {rel:.4f} > 20%")
            how = f"final rel {rel:.4f}"
        lines.append(f"{name} (N={bins}) {[round(s, 4) for s in scores]} "
                     f"vs the file's final {want[-1]}: {how}; ms per round "
                     f"median {float(np.median(ms)):.3f} "
                     f"(first {ms[0]:.3f})")
        del rt
        torch.cuda.empty_cache()
    planner, params, bins = UF_M1
    rt, raw = _uf_runtime(planner, params, bins)
    w, h = raw["size_rgb"]
    depth = make_basement_scene(np.asarray(raw["intr_rgb"], np.float64), w, h)
    scores, ms = _uf_curve(rt, depth)
    check(all(np.isfinite(scores)), f"m1: scores {scores}")
    lines.append(f"m1 (N={bins}, the port's generator, seed 0, unbound) "
                 f"{[round(s, 4) for s in scores]}; the file's seed-0 JAX "
                 f"final {ref['m1'][-1]}; ms per round median "
                 f"{float(np.median(ms)):.3f}")
    print(f"phase 11b: PlannerRuntime sim on basement_sensor.json "
          f"{w}x{h}, noise off, 20 rounds scored before each: "
          + "; ".join(lines) + f" [{card}]", flush=True)


class _SerialDevice:
    """A serial curtain device with a fixed exposure: ``send`` starts one,
    ``recv`` waits until it has lasted ``exposure_s`` and hands back the
    return of the true LC-frame depth as host arrays (the device's own
    work, the same in both loops)."""

    def __init__(self, lcdev, depth_lc, exposure_s=0.005):
        self.lcdev, self.depth_lc = lcdev, depth_lc
        self.exposure_s = exposure_s
        self.t_send = self.path = None

    def send(self, path):
        self.t_send, self.path = time.perf_counter(), path

    def recv(self):
        import torch
        time.sleep(max(0.0, self.t_send + self.exposure_s
                       - time.perf_counter()))
        out, thick = self.lcdev.get_return(
            self.depth_lc, torch.as_tensor(self.path,
                                           device=self.depth_lc.device))
        return out.cpu().numpy(), thick.cpu().numpy()

    def sense(self, path):
        self.send(path)
        return self.recv()


def phase_pipelined(card):
    """Phase 11 (c): the real path against a serial device with a 5 ms
    exposure, pipelined (send / receive) and not (``sense_fn``)."""
    import torch
    from depthestimation_tpu_torch.runtime.planner_runtime import (
        PlannerRuntime)
    sensor = _sensor_path("real_sensor")
    raw = _load_json(sensor)
    params = {"step": [0.75], "std_div": 5.0}
    probe = PlannerRuntime(raw, device="cuda")
    w, h = raw["size_rgb"]
    depth = make_basement_scene(np.asarray(raw["intr_rgb"], np.float64), w, h)
    dev = _SerialDevice(probe.real_lc.lightcurtain_large,
                        probe._depth_lc(depth))
    runs = {"pipelined": dict(send_fn=dev.send, recv_fn=dev.recv),
            "sense_fn": dict(sense_fn=dev.sense)}
    rts, dpvs, ms = {}, {}, {}
    for k, fns in runs.items():
        rts[k] = PlannerRuntime(raw, mode="real", planner="default",
                                params=params, device="cuda", **fns)
        dpvs[k], ms[k] = [], []
        real = rts[k]._measurement_dpv

        def keep(*a, _real=real, _k=k):
            out = _real(*a)
            dpvs[_k].append(out)
            return out

        rts[k]._measurement_dpv = keep
    for k in runs:                  # one untimed round each (first use)
        rts[k].run(None)
    for i in range(4):              # in turns, each side first as often
        for k in (("pipelined", "sense_fn") if i % 2 == 0
                  else ("sense_fn", "pipelined")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rts[k].run(None)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    check(len(dpvs["pipelined"]) == len(dpvs["sense_fn"]) == 15,
          f"measurements {len(dpvs['pipelined'])}, "
          f"{len(dpvs['sense_fn'])}: 3 curtains a round")
    same = all(torch.equal(a, b) for a, b in zip(dpvs["pipelined"],
                                                 dpvs["sense_fn"]))
    check(same and torch.equal(rts["pipelined"].final,
                               rts["sense_fn"].final),
          "the pipelined and unpipelined rounds' measurement DPVs differ")
    print(f"phase 11c: the real path on real_sensor.json against a serial "
          f"device (5 ms exposure a curtain, 3 curtains a round, "
          f"default planner), after one untimed round each: round wall ms "
          f"pipelined (send_fn / recv_fn) "
          f"{[round(x, 3) for x in ms['pipelined']]} (median "
          f"{float(np.median(ms['pipelined'])):.3f}), unpipelined "
          f"(sense_fn) {[round(x, 3) for x in ms['sense_fn']]} (median "
          f"{float(np.median(ms['sense_fn'])):.3f}); the 15 measurement "
          f"DPVs and the fields equal [{card}]", flush=True)
    del rts, probe
    torch.cuda.empty_cache()


def _synthetic_lc_sensor(w, h, n):
    """The synthetic camera (``_sensor``) as a light-curtain bundle: the
    frame the synthetic sweep is recorded in."""
    s = _sensor(w, h, n)
    s.update({"name": "synthetic_camera", "unc_shift": 1.0,
              "unc_span": 0.3, "unc_ang": 0, "laser_fov": 40.0,
              "laser_timestep": 3.5e-5, "expand_A": n, "expand_B": n})
    s["e_range"], s["s_range"] = 18.0, 3.0
    return s


def _sweep_dataset(w, h, ndepth, d_min, d_max, traj_len):
    """``SyntheticSweepVideoDataset`` (2 trajectories of ``traj_len``
    frames, 128 planes) at w x h. Its block-depth map tiles w // 6
    columns (the JAX dataset renders only widths that 6 divides): at 320
    each scene's map is padded by its last column."""
    from depthestimation_tpu_torch.data.video_synthetic import (
        SyntheticSweepVideoDataset)
    ds = SyntheticSweepVideoDataset(n_traj=2, traj_len=traj_len, h=h, w=w,
                                    ndepth=ndepth, d_min=d_min, d_max=d_max,
                                    planes=128)
    ds.scenes = [(np.pad(d, ((0, 0), (0, w - d.shape[1])), mode="edge"), t)
                 for d, t in ds.scenes]
    return ds


def _counted_steps(tdefault, steps):
    """``make_train_step`` wrapped: each step's launches and events."""
    import torch
    real_make = tdefault.make_train_step

    def counted_make(loss_fn, lc_fn=None):
        step = real_make(loss_fn, lc_fn=lc_fn)

        def run(*a):
            before = launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(*a)
            ev[1].record()
            steps.append((tuple(x - y for x, y in
                                zip(launch_counts(), before)), ev))
            return out
        return run
    return real_make, counted_make


def phase_lc_real_train(card):
    """Phase 11 (d): ``DefaultTrainer`` on a bf16 copy of
    ``configs/default_318_lc_sweep.json`` with the recorded-sweep fusion."""
    import torch
    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.data.scheduler import BatchScheduler
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.trainer import default as tdefault
    from depthestimation_tpu_torch.trainer.factory import get_trainer
    from depthestimation_tpu_torch.utils.logger import init_logger

    work = os.path.join(ROOT, "build", "phase11")
    os.makedirs(work, exist_ok=True)
    raw = _load_json(os.path.join(ROOT, "configs",
                                  "default_318_lc_sweep.json"))
    w, h = raw["var"]["img_size"]
    bundle = os.path.join(work, "synthetic_camera.json")
    with open(bundle, "w") as f:
        json.dump(_synthetic_lc_sensor(w, h, 128), f)
    raw["lc"].update(enabled=True, algo_lc_config=bundle,
                     real_lc_config=bundle)
    raw["train"].update(batch_size=2, epoch_num=1, print_freq=1)
    raw["tpu"] = {"dtype": "bfloat16"}
    path = os.path.join(work, "default_318_lc_sweep_bf16.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    cfg = load_config(path)
    d = int(cfg.var.ndepth)
    # one frame: the config's self_recurse (2) makes it 2 steps, the
    # second fed the first's prev_lc
    ds = _sweep_dataset(w, h, d, cfg.var.d_min, cfg.var.d_max, 1)
    loader = BatchScheduler(ds, 2, shuffle=False, prefetch=False)
    base = get_model(cfg, "cuda", seed=0)
    model = get_model(cfg, "cuda")
    model.load_state_dict(base.state_dict())
    tr = get_trainer(cfg)(0, model, get_loss(cfg),
                          init_logger("phase11d", work), work, cfg, loader,
                          loader)
    calls = []
    real_fn, sim_fn = tdefault.lc_process_real, tdefault.lc_process

    def timed(kind, fn):
        def run(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            calls.append((kind, ev, out))
            return out
        return run

    steps = []
    real_make, counted_make = _counted_steps(tdefault, steps)
    tdefault.make_train_step = counted_make
    tdefault.lc_process_real = timed("real", real_fn)
    tdefault.lc_process = timed("sim", sim_fn)
    want = (0, 0, 16, 16, 76, 76, 0, 0)
    try:
        reset_counts()
        tr._run_one_epoch()
        counted = dict(zip(COUNT_NAMES, launch_counts()))
    finally:
        tdefault.make_train_step = real_make
        tdefault.lc_process_real, tdefault.lc_process = real_fn, sim_fn
    check(tr.real_lc is not None and tr._fused_lc_fn() is None,
          "the real device was not built, or the LC loop stayed in the step")
    check(len(steps) == 2 and all(s[0] == want for s in steps),
          f"launches per step {[s[0] for s in steps]} != {want}")
    check([c[0] for c in calls] == ["real"] * 4,
          f"LC calls {[c[0] for c in calls]}: every one must sample the "
          "recorded sweep")
    losses = tr._last_epoch_losses
    check(len(losses) == 1 and all(np.isfinite(losses)),
          f"losses {losses}: one frame")
    # each call's fused DPV, the next step's prev_lc at every 4th pixel
    for _, _, out in calls:
        check(tuple(out.shape) == (2, d, h, w)
              and bool(torch.isfinite(out).all()),
              f"lc_process_real output {tuple(out.shape)} not finite")
    # rule 4: one step's gradients against an f32 plain step
    batch = next(iter(loader.enumerate()))
    _, mi, gt = tr._side_inputs(batch, "left")
    gt = tr._with_soft_labels(gt)
    cfg32 = load_config(path)
    cfg32["tpu"] = {"dtype": "float32"}
    dists, _ = rule4_step(cfg, cfg32, real_make(get_loss(cfg)), mi, gt,
                          base, "lc real B=2", want)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for _, (a, b) in steps]
    lc_ms = [a.elapsed_time(b) for _, (a, b), _ in calls]
    rule4_txt = "; ".join(f"{k} {dists['kernel'][k]:.4g}, "
                          f"{dists['plain'][k]:.4g}"
                          for k in dists["kernel"])
    print(f"phase 11d: DefaultTrainer nmode lc {w}x{h} fd=64 D={d} bf16 B=2 "
          f"(default_318_lc_sweep.json, lc on, 128-plane synthetic sweeps, "
          f"the curtains on the synthetic camera's bundle), one frame of "
          f"self_recurse 2: the frame's loss {losses[0]:.5f}; launches per "
          f"step {want}, over the run {counted}; 4 LC calls, all "
          f"lc_process_real, their fused DPVs finite; rel dist from the "
          f"f32 step (kernel, plain): {rule4_txt}; step ms "
          f"{[round(x, 3) for x in step_ms]}, lc_process_real ms "
          f"{[round(x, 3) for x in lc_ms]} [{card}]", flush=True)
    del tr, model, base
    torch.cuda.empty_cache()
    return counted


def phase_sweep_train(card):
    """Phase 11 (e): ``SweepTrainer`` on ``configs/sweep_model.json``."""
    import torch
    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.data.scheduler import BatchScheduler
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.trainer import default as tdefault
    from depthestimation_tpu_torch.trainer.factory import get_trainer
    from depthestimation_tpu_torch.utils.logger import init_logger

    work = os.path.join(ROOT, "build", "phase11")
    os.makedirs(work, exist_ok=True)
    cfg = load_config(os.path.join(ROOT, "configs", "sweep_model.json"))
    cfg.train.batch_size = 2
    w, h = cfg.var.crop_w, cfg.var.img_size[1]
    ds = _sweep_dataset(w, h, cfg.var.ndepth, cfg.var.d_min, cfg.var.d_max,
                        2)
    loader = BatchScheduler(ds, 2, shuffle=False, prefetch=False)
    tr = get_trainer(cfg)(0, get_model(cfg, "cuda", seed=0), get_loss(cfg),
                          init_logger("phase11e", work), work, cfg, loader,
                          loader)
    steps = []
    real_make, counted_make = _counted_steps(tdefault, steps)
    tdefault.make_train_step = counted_make
    try:
        reset_counts()
        tr._run_one_epoch()
        counted = dict(zip(COUNT_NAMES, launch_counts()))
        err, keys = tr._validate_with_gt()
    finally:
        tdefault.make_train_step = real_make
    losses = tr._last_epoch_losses
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"sweep losses {losses}")
    check(keys == ["peak_int_err"] and np.isfinite(err[0]),
          f"sweep validation {keys} {err}")
    check(all(v == 0 for v in counted.values()),
          f"the sweep model launched a kernel of the port: {counted}")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for _, (a, b) in steps]
    print(f"phase 11e: SweepTrainer sweep_model.json {w}x{h} f32 B=2 on "
          f"128-plane synthetic sweeps: losses "
          f"{[round(x, 5) for x in losses]}, validation peak_int_err "
          f"{err[0]:.5f}; step ms {[round(x, 3) for x in step_ms]}; kernel "
          f"launches {counted} (every conv is PyTorch's f32) [{card}]",
          flush=True)
    del tr
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 12

#: 2011_09_26's calibration (the KITTI raw layout: P_rect, R_rect_00,
#: S_rect; velo -> cam0; imu -> velo)
KITTI_CALIB = {
    "calib_cam_to_cam.txt": (
        "calib_time: 09-Jan-2012 13:57:47\n"
        "R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 "
        "9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01\n"
        "S_rect_02: 1.242000e+03 3.750000e+02\n"
        "P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 "
        "0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 "
        "0.000000e+00 1.000000e+00 2.745884e-03\n"
        "S_rect_03: 1.242000e+03 3.750000e+02\n"
        "P_rect_03: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 "
        "0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 "
        "0.000000e+00 1.000000e+00 2.729905e-03\n"),
    "calib_velo_to_cam.txt": (
        "R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 "
        "7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02\n"
        "T: -4.069766e-03 -7.631618e-02 -2.717806e-01\n"),
    "calib_imu_to_velo.txt": (
        "R: 9.999976e-01 7.553071e-04 -2.035826e-03 -7.854027e-04 "
        "9.998898e-01 -1.482298e-02 2.024406e-03 1.482454e-02 9.998881e-01\n"
        "T: -8.086759e-01 3.195559e-01 -7.997231e-01\n"),
}


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit gray or RGB PNG of ``img`` from ``zlib`` and ``struct``
    (the card's host has no Pillow): every row takes the Sub filter, so a
    smooth texture compresses well."""
    import struct
    import zlib
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch)
    sub = rows.copy()
    sub[:, ch:] = rows[:, ch:] - rows[:, :-ch]        # uint8 wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def _texture(rng, h, w):
    """A smooth RGB street-like texture with a little noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 6.3, 4)
    img = np.stack([np.sin(x / 37 + ph[0]) + np.cos(y / 23 + ph[1]),
                    np.sin((x + 2 * y) / 51 + ph[2]),
                    np.cos(x / 17 - y / 41 + ph[3])], axis=-1)
    img = 120 + 55 * img + rng.normal(0, 3, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _velodyne_scan(rng, beams=64, azimuths=1875):
    """One HDL-64-like scan (64 x 1875 = 120,000 points, x forward, y
    left, z up, 1.73 m above a ground plane, walls at 7 m either side):
    [N, 4] float32 with reflectance."""
    el = np.radians(np.linspace(-24.9, 2.0, beams))[:, None]
    az = np.radians(np.linspace(-180.0, 180.0, azimuths,
                                endpoint=False))[None]
    dx, dy, dz = np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(dz < 0, -1.73 / dz, np.inf)
        t_wall = np.where(np.abs(dy) > 1e-6, 7.0 / np.abs(dy), np.inf)
    r = np.minimum(np.minimum(t_ground, t_wall), 80.0)
    r = r + rng.normal(0, 0.02, r.shape)
    pts = np.stack([r * dx, r * dy, r * dz,
                    rng.uniform(0, 1, r.shape)], axis=-1)
    return pts.reshape(-1, 4).astype(np.float32)


def write_kitti_fixture(root: str):
    """Two raw KITTI drives of 16 frames at 1242x375 with 2011_09_26's
    calibration and OXTS packets about 1 m apart, a 2-frame drive for
    validation, and their splits (the training split lists each 16-frame
    drive 4 times: 8 trajectories, one batch of 8). Returns the split
    directory."""
    date = "2011_09_26"
    rng = np.random.default_rng(12)
    os.makedirs(os.path.join(root, date), exist_ok=True)
    for name, text in KITTI_CALIB.items():
        with open(os.path.join(root, date, name), "w") as f:
            f.write(text)
    for drive, frames in (("0001", 16), ("0002", 16), ("0005", 2)):
        dpath = os.path.join(root, date, f"{date}_drive_{drive}_sync")
        for sub in ("image_02/data", "image_03/data",
                    "velodyne_points/data", "oxts/data"):
            os.makedirs(os.path.join(dpath, sub), exist_ok=True)
        for t in range(frames):
            for cam in ("02", "03"):
                write_png(os.path.join(dpath, f"image_{cam}", "data",
                                       f"{t:010d}.png"),
                          _texture(rng, 375, 1242))
            _velodyne_scan(rng).tofile(os.path.join(
                dpath, "velodyne_points", "data", f"{t:010d}.bin"))
            oxts = np.zeros(30)
            # heading east, 1 m a frame at 49 degrees north (mercator)
            oxts[:3] = 49.011, 8.4166 + t * 1.37e-5, 112.8
            np.savetxt(os.path.join(dpath, "oxts", "data",
                                    f"{t:010d}.txt"), oxts)
    split = os.path.join(root, "split_kitti")
    os.makedirs(split, exist_ok=True)
    with open(os.path.join(split, "training.txt"), "w") as f:
        f.write("".join(f"{date}_drive_{d}_sync\n"
                        for d in ("0001", "0002") * 4))
    with open(os.path.join(split, "testing.txt"), "w") as f:
        f.write(f"{date}_drive_0005_sync\n" * 8)
    return split


def write_ilim_fixture(root: str, lc_w: int = 160, lc_h: int = 128):
    """One ILIM sweep drive of 4 frames: 640x512 left / right / NIR PNGs,
    a lidar scan each, and 128-plane sweeps [128, lc_h, lc_w, 2] (z,
    intensity). Returns the split directory."""
    date, drive = "2021_02_25", "0003"
    rng = np.random.default_rng(13)
    dpath = os.path.join(root, date, f"{date}_drive_{drive}_sweep")
    for sub in ("left_img", "right_img", "lidar", "sweep", "nir_img"):
        os.makedirs(os.path.join(dpath, sub), exist_ok=True)
    left_2_lidar = np.eye(4)
    left_2_lidar[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    left_2_right = np.eye(4)
    left_2_right[0, 3] = -0.24
    p = [[600.0, 0, 320.0, 0], [0, 600.0, 256.0, 0], [0, 0, 1, 0]]
    with open(os.path.join(dpath, "calib.json"), "w") as f:
        json.dump({"left_2_lidar": left_2_lidar.tolist(),
                   "left_2_right": left_2_right.tolist(),
                   "left_P": p, "right_P": p}, f)
    for t in range(4):
        for sub in ("left_img", "right_img", "nir_img"):
            write_png(os.path.join(dpath, sub, f"{t:06d}.png"),
                      _texture(rng, 512, 640))
        _velodyne_scan(rng).tofile(os.path.join(dpath, "lidar",
                                                f"{t:06d}.bin"))
        z = rng.uniform(1.0, 20.0, (128, lc_h, lc_w)).astype(np.float32)
        inten = rng.uniform(0.0, 1.0, (128, lc_h, lc_w)).astype(np.float32)
        np.save(os.path.join(dpath, "sweep", f"{t:06d}.npy"),
                np.stack([z, inten], -1))
    split = os.path.join(root, "split_sweep")
    os.makedirs(split, exist_ok=True)
    for name in ("training.txt", "testing.txt"):
        with open(os.path.join(split, name), "w") as f:
            f.write(f"{date}_drive_{drive}_sweep\n")
    return split


def _real_cfg(root, split, name, **var):
    """The port's config ``configs/{name}.json`` on the fixture tree."""
    from depthestimation_tpu_torch.config import config_from_dict
    raw = _load_json(os.path.join(ROOT, "configs", name + ".json"))
    raw["data"].update(dataset_path=root, dataset_split=split)
    raw["var"].update(var)
    return raw, config_from_dict(raw)


def phase_loader(card, root, ksplit, isplit):
    """Phase 12 (b): ms per ``KittiVideoDataset.frame`` from cold caches
    on the card's host, split into PNG decode, resize and the velodyne
    projection; the native and numpy backends on one full-size scan; an
    ILIM sweep frame and ``lcsweep_to_rgbsweep``."""
    from depthestimation_tpu_torch.data import ilim, kitti, velodyne
    from depthestimation_tpu_torch.ops import geometry

    spent = {"decode": 0.0, "resize": 0.0, "velodyne": 0.0}

    def timed(kind, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[kind] += time.perf_counter() - t0
            return out
        return run

    real = kitti.read_png, kitti.resize_bilinear, kitti.generate_depth
    kitti.read_png = timed("decode", real[0])
    kitti.resize_bilinear = timed("resize", real[1])
    kitti.generate_depth = timed("velodyne", real[2])
    try:
        _, cfg = _real_cfg(root, ksplit, "default_exp7")
        ds = kitti.KittiVideoDataset(cfg)
        ds.frame(0, 0)          # the native library builds here
        ds = kitti.KittiVideoDataset(cfg)
        for k in spent:
            spent[k] = 0.0
        frame_ms = []
        for t in range(1, 5):   # a sliding window: one new view a side
            t0 = time.perf_counter()
            f = ds.frame(0, t)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            check(f.get("success", True), f"KITTI frame {t}: {f}")
    finally:
        kitti.read_png, kitti.resize_bilinear, kitti.generate_depth = real
    n = len(frame_ms)
    check(f["rgb_left"].shape == (2, 3, 256, 384)
          and f["dmap_up_left"].shape == (256, 384)
          and int((f["dmap_up_left"] > 0).sum()) > 1000,
          f"KITTI frame shapes {f['rgb_left'].shape}, depth points "
          f"{int((f['dmap_up_left'] > 0).sum())}")
    # native against numpy on one full-size scan, at the frame's geometry
    drive = ds.drives[0]
    k34 = np.concatenate([drive.get_left_K(), np.zeros((3, 1))], 1)
    intr = geometry.intr_scale(k34, drive.get_left_size(), (768, 256))
    velo = drive.get_lidar(3)
    args = (velo, intr, drive.get_lidar_2_leftcam(), 768, 256,
            {"filtering": 2, "upsample": 0})
    t0 = time.perf_counter()
    nat = velodyne.generate_depth(*args)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = velodyne.generate_depth(*args, backend="numpy")
    np_ms = (time.perf_counter() - t0) * 1e3
    # the same pixels; z within float rounding (the native transform sums
    # in order, numpy's matmul does not)
    z_err = float(np.abs(nat - ref).max())
    check(np.array_equal(nat > 0, ref > 0) and z_err <= 1e-4,
          f"generate_depth: native and numpy differ: "
          f"{int(((nat > 0) != (ref > 0)).sum())} pixels, z by {z_err}")
    # ILIM sweep drive: one frame, its sweep in the RGB frame
    _, icfg = _real_cfg(root, isplit, "default_ilim", img_size=[320, 256],
                        crop_w=320)
    ids = ilim.IlimVideoDataset(icfg)
    t0 = time.perf_counter()
    fi = ids.frame(0, 1)
    ilim_ms = (time.perf_counter() - t0) * 1e3
    check(fi.get("success", True) and fi["sweep_arr"].shape ==
          (128, 128, 160, 2) and fi["nir_img"].shape == (512, 640),
          f"ILIM sweep frame {fi.get('error', '')}")
    lc_intr = np.array([[150.0, 0, 80.0], [0, 150.0, 64.0], [0, 0, 1]])
    t0 = time.perf_counter()
    with np.errstate(divide="ignore", invalid="ignore"):   # depth-0 pixels
        feat_int, feat_z, mask, _, _ = ilim.lcsweep_to_rgbsweep(
            fi["sweep_arr"], fi["dmap_up_left"], fi["intrinsics_up"],
            (320, 256), lc_intr, (160, 128), np.eye(4),
            np.zeros((128, 160), np.float32))
    sweep_ms = (time.perf_counter() - t0) * 1e3
    check(feat_int.shape == (128, 256, 320) and mask.sum() > 100,
          f"lcsweep_to_rgbsweep: {int(mask.sum())} pixels gathered")
    print(f"phase 12b: KittiVideoDataset.frame 1242x375 -> 768x256 crop 384, "
          f"cold caches (one new view a side, depth for the reference): "
          f"{[round(x, 3) for x in frame_ms]} ms, per frame decode "
          f"{spent['decode'] * 1e3 / n:.3f} ms, resize "
          f"{spent['resize'] * 1e3 / n:.3f} ms, velodyne "
          f"{spent['velodyne'] * 1e3 / n:.3f} ms ({len(velo)} points a "
          f"scan); generate_depth at 768x256 native {nat_ms:.3f} ms, numpy "
          f"{np_ms:.3f} ms, the same {int((nat > 0).sum())} pixels, z within "
          f"{z_err:.3g} m; ILIM sweep frame 640x512 -> 320x256 "
          f"{ilim_ms:.3f} ms, lcsweep_to_rgbsweep {sweep_ms:.3f} ms "
          f"({int(mask.sum())} pixels) [{card}]", flush=True)


def phase_trainer_kitti(card, root, ksplit):
    """Phase 12 (c): ``python -m depthestimation_tpu_torch.train`` on a bf16
    copy of ``configs/default_exp7.json`` on the fixture tree: one epoch at
    ``-b 8`` from the spawned loader, its validation, then ``--eval``."""
    import shutil

    import torch
    from depthestimation_tpu_torch import train as ttrain
    from depthestimation_tpu_torch.trainer import default as tdefault

    work = os.path.join(ROOT, "build", "phase12", "trainer")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    raw, _ = _real_cfg(root, ksplit, "default_exp7")
    raw["tpu"] = {"dtype": "bfloat16"}
    raw["train"].update(epoch_num=1, print_freq=4)
    raw["data"]["exp_name"] = "kitti_exp7"
    path = os.path.join(work, "default_exp7_kitti.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    steps = []
    real_make, counted_make = _counted_steps(tdefault, steps)
    cwd = os.getcwd()
    os.chdir(work)
    tdefault.make_train_step = counted_make
    try:
        t0 = time.perf_counter()
        tr = ttrain.main(["--config", path, "-b", "8"])
        wall = time.perf_counter() - t0
        ev = ttrain.main(["--config", path, "--eval"])
    finally:
        tdefault.make_train_step = real_make
        os.chdir(cwd)
    check(type(tr.train_loader.dataset).__name__ == "KittiVideoDataset"
          and tr.train_loader.mload, "the CLI did not train on the KITTI "
          "tree from the spawned loader")
    losses = tr._last_epoch_losses
    check(len(steps) == 16 and len(losses) == 16
          and all(np.isfinite(losses)),
          f"{len(steps)} steps, losses {losses}: 8 trajectories of 16 "
          "frames at B=8 are 16 steps")
    per_step = {s[0] for s in steps}
    check(len(per_step) == 1, f"launches vary by step: {per_step}")
    launches = dict(zip(COUNT_NAMES, steps[0][0]))
    for k in ("sweep_stage2", "sweep_stage2_bwd", "convbn_block",
              "convbn_block_bwd", "convbn2d", "convbn2d_bwd"):
        check(launches[k] > 0, f"the KITTI step launched no {k}")
    check(ev.cfg.train.batch_size == 1, "--eval did not validate at B=1")
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for _, (a, b) in steps]
    wait = tr.loader_wait_seconds / tr.epoch_seconds
    print(f"phase 12c: trainer CLI on the KITTI tree (default_exp7.json, "
          f"bf16, 768x256 crop 384, fd=64 D=64, -b 8, spawned loader): 16 "
          f"steps, losses {[round(x, 4) for x in losses]}, step ms median "
          f"{float(np.median(ms)):.3f} (CUDA events: "
          f"{[round(x, 3) for x in ms]}), epoch {tr.epoch_seconds:.3f} s of "
          f"which loader wait {tr.loader_wait_seconds:.3f} s "
          f"({100 * wait:.1f}%), main() {wall:.3f} s; launches a step "
          f"{launches}; --eval at B=1 done [{card}]", flush=True)


def _kitti_batch(cfg, dev, batch=8):
    """The second frame of the first fixture batch (a 1 m step between the
    views), one camera side on the card with its soft labels."""
    import torch
    from depthestimation_tpu_torch.data.kitti import KittiVideoDataset
    from depthestimation_tpu_torch.data.scheduler import BatchScheduler
    from depthestimation_tpu_torch.data.video_synthetic import (
        assemble_inputs, to_device)
    from depthestimation_tpu_torch.trainer.default import _soft_labels
    ds = KittiVideoDataset(cfg)
    it = BatchScheduler(ds, batch, shuffle=False, prefetch=False).enumerate()
    next(it)
    b = next(it)
    it.close()
    mi_np, gt_np = assemble_inputs(b, "left")
    moved = {}
    mi = to_device({k: v for k, v in mi_np.items()
                    if k not in ("prev_output", "prev_lc")}, dev, moved)
    gt = to_device(gt_np, dev, moved)
    d_candi = torch.as_tensor(mi_np["d_candi"], dtype=torch.float32,
                              device=dev)
    gt["soft_labels"] = _soft_labels(gt["dmaps"], gt["masks"], d_candi, 0.3)
    gt["soft_labels_imgsize"] = _soft_labels(
        gt["dmap_imgsizes"], gt["masks_imgsizes"], d_candi, 0.3)
    return mi, gt


def gather_hold(cfg, cfg_dec, step, mi, gt, base, tag):
    """The f32 gather sweep's first step against the decomposed sweep's
    from the same weights. The fixture's poses are pure translation
    (R = I), where the two sweeps sample the same points, so they differ
    by rounding only. The loss and each group's gradient must lie within
    1e-3 plus three times the most the decomposed step moves when the
    images move by one part in 10^6 (two draws: the rule of
    tests/test_torch_train_step.py). Both steps launch no kernel.
    Returns the gather step's distances and their bounds."""
    import torch
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import init_state
    gen = torch.Generator(device="cuda").manual_seed(1)
    runs = [("gather", cfg, mi), ("decomposed", cfg_dec, mi)]
    for k in range(2):
        noise = torch.randn(mi["rgb"].shape, generator=gen,
                            device=mi["rgb"].device)
        runs.append((f"moved {k}", cfg_dec,
                     dict(mi, rgb=mi["rgb"] * (1 + 1e-6 * noise))))
    got = {}
    for name, c, x in runs:
        model = get_model(c, "cuda")
        model.load_state_dict(base.state_dict())
        before = launch_counts()
        state, loss, _ = step(init_state(model, c), x, x, gt, gt)
        n = tuple(a - b for a, b in zip(launch_counts(), before))
        check(n == (0,) * len(n), f"{tag} {name}: launches {n}")
        check(np.isfinite(loss.item()), f"{tag} {name}: loss {loss.item()}")
        got[name] = {"loss": loss.detach().reshape(1), **_grad_groups(model)}
        del model, state
    ref = got["decomposed"]
    dists = {k: _dist(got["gather"][k], ref[k]) for k in ref}
    bounds = {k: 1e-3 + 3 * max(_dist(got[f"moved {i}"][k], ref[k])
                                for i in range(2)) for k in ref}
    for k in ref:
        check(dists[k] <= bounds[k],
              f"{tag} {k}: gather-vs-decomposed {dists[k]:.4g} > 1e-3 + "
              f"3 x the decomposed step's motion = {bounds[k]:.4g}")
    return dists, bounds


def phase_nmodes(card, root, ksplit):
    """Phase 12 (d): one train step of each new nmode at full width on a
    fixture KITTI batch (384x256, D 64, fd 64, bf16, B 8) with rule-4
    gradients against an f32 plain step; the f32 gather sweep's step held
    to the decomposed sweep's (``gather_hold``); exp8; one f32 step of
    DefaultModel and of PackNet at B=2."""
    import torch
    from depthestimation_tpu_torch.config import config_from_dict
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.ops.dpv import gen_dpv_withmask
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)
    dev = torch.device("cuda")
    lines = []
    cases = (  # tag, config, var overrides, tpu dtype, launches per step
        ("default", "default", {}, "bfloat16", (0, 0, 0, 0, 76, 76, 0, 0)),
        ("exp2", "default_exp2", {}, "bfloat16", (0, 0, 0, 0, 76, 76, 0, 0)),
        ("exp3", "default_exp3", {}, "bfloat16",
         (2, 2, 16, 16, 76, 76, 0, 0)),
        ("lc with the sweep", "default_318_lc",
         {"diffhomo": True, "d_min": D_MIN, "d_max": D_MAX}, "bfloat16",
         (0, 0, 16, 16, 76, 76, 0, 0)),
        ("exp7 gather", "default_exp7", {"sweep_impl": "gather"}, "float32",
         (0,) * 8))
    mi = gt = None
    for tag, name, var, dtype, want in cases:
        raw, _ = _real_cfg(root, ksplit, name, **var)
        raw["tpu"] = {"dtype": dtype}
        cfg = config_from_dict(raw)
        raw32 = json.loads(json.dumps(raw))
        raw32["tpu"] = {"dtype": "float32"}
        cfg32 = config_from_dict(raw32)
        if mi is None:
            mi, gt = _kitti_batch(cfg, dev)
        m = dict(mi)
        if tag == "exp2":
            m["tofuse_dpv"] = gen_dpv_withmask(mi["dmaps"], mi["masks"],
                                               mi["d_candi"], 0.3)
        base = get_model(cfg, "cuda", seed=0)
        step = make_train_step(get_loss(cfg))
        if tag == "exp7 gather":
            raw_d = json.loads(json.dumps(raw))
            raw_d["var"]["sweep_impl"] = "decomposed"
            dists, bounds = gather_hold(cfg, config_from_dict(raw_d), step,
                                        m, gt, base, f"phase 12d {tag}")
        else:
            dists, _ = rule4_step(cfg, cfg32, step, m, gt, base,
                                  f"phase 12d {tag}", want)
        model = get_model(cfg, "cuda")
        model.load_state_dict(base.state_dict())
        state = init_state(model, cfg)
        ms = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, loss, _ = step(state, m, m, gt, gt)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        if tag == "exp7 gather":
            held = ", ".join(f"{k} {dists[k]:.4g} <= {bounds[k]:.4g}"
                             for k in dists)
            held = f"rel dist from the decomposed sweep's step: {held}"
        else:
            held = ", ".join(f"{k} {dists['kernel'][k]:.4g} / "
                             f"{dists['plain'][k]:.4g}"
                             for k in dists["kernel"])
            held = f"rel dist from the f32 step (kernel / plain): {held}"
        lines.append(f"phase 12d: {tag} ({name}.json, {dtype}) 384x256 "
                     f"fd=64 D=64 B=8 on the KITTI batch: launches a step "
                     f"{want}; {held}; step ms "
                     f"{[round(x, 3) for x in ms]} [{card}]")
        print(lines[-1], flush=True)
        del base, model, state
        torch.cuda.empty_cache()
    # exp8 builds and its forward raises, as in JAX
    raw, _ = _real_cfg(root, ksplit, "default_exp8")
    raw["tpu"] = {"dtype": "bfloat16"}
    m8 = get_model(config_from_dict(raw), "cuda", seed=0)
    try:
        m8(mi)
        raised = False
    except ValueError:
        raised = True
    check(raised, "nmode exp8's forward did not raise ValueError")
    del m8
    # DefaultModel and PackNet, f32, B=2: no kernel of the port
    for name in ("default", "packnet"):
        raw, _ = _real_cfg(root, ksplit, "default_exp7")
        raw["data"]["model_name"] = name
        cfg = config_from_dict(raw)
        def first2(d):
            return {k: (v[:2] if torch.is_tensor(v) and v.dim() > 1
                        and v.shape[0] == 8 else v) for k, v in d.items()}

        small, small_gt = first2(mi), first2(gt)
        model = get_model(cfg, "cuda", seed=0)
        state = init_state(model, cfg)
        step = make_train_step(get_loss(cfg))
        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts()
        ms = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, loss, _ = step(state, small, small, small_gt, small_gt,
                                  gen)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        got = launch_counts()
        check(np.isfinite(loss.item()) and got == (0,) * 8,
              f"{name}: loss {loss.item()}, launches {got}")
        print(f"phase 12d: model_name {name} f32 384x256 D=64 B=2: loss "
              f"{loss.item():.5f}, step ms {[round(x, 3) for x in ms]}, "
              f"launches {got} [{card}]", flush=True)
        del model, state
        torch.cuda.empty_cache()
    print(f"phase 12d: exp8 raises ValueError [{card}]", flush=True)


def phase_real_data(card):
    """Phase 12: the real-data loaders and the rest of the model family on
    a fixture tree at KITTI's size, written to ``build/phase12``."""
    import shutil
    root = os.path.join(ROOT, "build", "phase12", "data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    ksplit = write_kitti_fixture(root)
    isplit = write_ilim_fixture(root)
    print(f"phase 12a: fixture tree (2 KITTI drives of 16 frames at "
          f"1242x375 and one of 2, 120,000 points a scan; one ILIM sweep "
          f"drive of 4 frames, 128 planes) written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    phase_loader(card, root, ksplit, isplit)
    phase_trainer_kitti(card, root, ksplit)
    phase_nmodes(card, root, ksplit)


# ------------------------------------------------------------ phase 13

#: phase 13's step: phase 6's B=8 exp7 bf16 384x256 D=64 fused step
P13_W, P13_H, P13_B = 384, 256, 8
#: batch entries every item shares (no leading batch axis to split)
_P13_SHARED = ("d_candi", "d_candi_up", "T_left2right")
#: phase 13d's CLI run: 15 training trajectories at -b 4 per rank (rank 0
#: loads 8, rank 1 loads 7: 2 batches against 1)
P13_TRAJ, P13_CLI_B = 15, 4
#: each rank's launches a step: phase 6's (sweep, Base3D, convbn2d,
#: tap_combine; forward and backward)
P13_WANT = (2, 2, 16, 16, 76, 76, 0, 0)


def _rank_half(d: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s items of a batch dict of card tensors."""
    import torch
    n = P13_B // world
    return {k: (v[rank * n:(rank + 1) * n] if torch.is_tensor(v) and
                v.dim() >= 1 and v.shape[0] == P13_B and
                k not in _P13_SHARED else v) for k, v in d.items()}


def _p13_group(backend: str, rank: int, world: int, work: str, tag: str):
    """Join phase 13's group (a ``FileStore`` ``store_{tag}`` in ``work``,
    one for each group) on the card this rank runs on: ``cuda:rank`` for
    NCCL, ``cuda:0`` for gloo (the ranks share one card)."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = dist.FileStore(os.path.join(work, f"store_{tag}"), world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    return dev


def _p13_step_rank(rank: int, backend: str, world: int, work: str) -> None:
    """Phase 13b / 13c, one rank: the first step of phase 6's B=8 batch
    from ``base.pt``'s weights on this rank's half, then 4 more timed by
    CUDA events and 2 with each all-reduce split on the host clock."""
    import torch
    import torch.distributed as dist
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)
    dev = _p13_group(backend, rank, world, work, backend)
    try:
        cfg = cfg_for(64, 64, P13_W, P13_H, "bfloat16", nmode="exp7",
                      batch=P13_B // world)
        step = make_train_step(get_loss(cfg))
        mi, gt = _train_batch(P13_B, P13_W, P13_H, dev)
        mi, gt = _rank_half(mi, rank, world), _rank_half(gt, rank, world)
        model = get_model(cfg, dev)
        model.load_state_dict(torch.load(os.path.join(work, "base.pt"),
                                         map_location=dev))
        state = init_state(model, cfg)
        reset_counts()
        state, loss, _ = step(state, mi, mi, gt, gt)
        counts = launch_counts()
        out = {"loss": loss.item(), "counts": counts,
               "grads": {k: v.cpu() for k, v in _grad_groups(model).items()},
               "params": {k: p.detach().cpu()
                          for k, p in model.named_parameters()}}
        ms = []
        for _ in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, loss, _ = step(state, mi, mi, gt, gt)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        out["ms"] = ms
        # two more steps with every all-reduce split on the host clock into
        # the wait for the card's queue and the collective itself
        from depthestimation_tpu_torch.parallel import mesh
        real, calls = mesh.all_reduce_, []

        def timed(t):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            real(t)
            calls.append((t1 - t0, time.perf_counter() - t1, t.numel()))
            return t
        mesh.all_reduce_ = timed
        try:
            t0 = time.perf_counter()
            for _ in range(2):
                state, loss, _ = step(state, mi, mi, gt, gt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            mesh.all_reduce_ = real
        big = max(c[2] for c in calls)
        out["split"] = {
            "calls": len(calls) / 2, "wall_ms": 1e3 * wall / 2,
            "wait_ms": 1e3 * sum(c[0] for c in calls) / 2,
            "reduce_ms": 1e3 * sum(c[1] for c in calls) / 2,
            "grad_ms": 1e3 * sum(c[1] for c in calls if c[2] == big) / 2,
            "grad_elems": big}
        torch.save(out, os.path.join(work, f"{backend}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _p13_cli_rank(rank: int, world: int, work: str) -> None:
    """Phase 13d, one rank: ``train.main`` on phase 10's bf16
    ``synthetic_tpu.json`` copy at ``-b 4`` (``--synthetic``: the thread
    loader) with 15 training trajectories, one epoch and its validation;
    the steps' launches and CUDA-event ms, the checkpoint writes."""
    import torch
    import torch.distributed as dist
    from depthestimation_tpu_torch import train as ttrain
    from depthestimation_tpu_torch.data import video_synthetic as vs
    from depthestimation_tpu_torch.parallel import mesh
    from depthestimation_tpu_torch.trainer import checkpoint as ckpt
    from depthestimation_tpu_torch.trainer import default as tdefault
    _p13_group("gloo", rank, world, work, "cli")
    base = vs.SyntheticStereoVideoDataset

    class Uneven(base):
        def __init__(self, n_traj, seed=0, **kw):
            super().__init__(n_traj=P13_TRAJ if seed == 1 else n_traj,
                             seed=seed, **kw)

    steps, saves = [], []
    real_make, real_save = tdefault.make_train_step, ckpt.save_checkpoint

    def counted_make(loss_fn, lc_fn=None):
        run = real_make(loss_fn, lc_fn=lc_fn)

        def timed(*a):
            before = launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = run(*a)
            ev[1].record()
            steps.append((tuple(x - y for x, y in
                                zip(launch_counts(), before)), ev))
            return out
        return timed

    def save(*a, **k):
        saves.append(rank)
        return real_save(*a, **k)

    vs.SyntheticStereoVideoDataset = Uneven
    tdefault.make_train_step = counted_make
    tdefault.ckpt.save_checkpoint = save
    os.chdir(work)
    try:
        path = os.path.join(work, "synthetic_tpu.json")
        if rank == 0:
            _phase10_config(work, "synthetic_tpu", 1)
        mesh.barrier("config")
        tr = ttrain.main(["--config", path, "-b", str(P13_CLI_B),
                          "--synthetic"])
        torch.cuda.synchronize()
        torch.save({
            "steps": len(tr._last_epoch_losses),
            "epoch_length": tr.train_loader.epoch_length(),
            "launches": [s[0] for s in steps],
            "ms": [e[0].elapsed_time(e[1]) for _, e in steps],
            "losses": tr._last_epoch_losses, "metrics": tr.last_metrics,
            "epoch_seconds": tr.epoch_seconds,
            "wait_seconds": tr.loader_wait_seconds, "saves": saves,
            "params": {k: v.cpu() for k, v in
                       tr.model.state_dict().items()}},
            os.path.join(work, f"cli_rank{rank}.pt"))
    finally:
        vs.SyntheticStereoVideoDataset = base
        tdefault.make_train_step = real_make
        tdefault.ckpt.save_checkpoint = real_save
        dist.destroy_process_group()


def _spawn(fn, args, nprocs: int) -> float:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; a rank
    that fails fails the phase (``ProcessRaisedException``). Returns the
    wall seconds."""
    import torch.multiprocessing as tmp
    t0 = time.perf_counter()
    tmp.start_processes(fn, args=args, nprocs=nprocs, join=True,
                        start_method="spawn")
    return time.perf_counter() - t0


def _same_params(a: dict, b: dict) -> bool:
    """Two {name: tensor} dicts equal bit for bit."""
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _hold_ranks(tag, results, ref, bounds, want):
    """The ranks of one data-parallel step against the single-process B=8
    step: their parameters bit-equal to each other, each rank's launches
    ``want``, the global loss and each group's gradient and parameters
    within ``bounds``. Returns the distances."""
    check(all(_same_params(r["params"], results[0]["params"])
              for r in results[1:]),
          f"{tag}: the ranks' parameters differ after the step")
    for i, r in enumerate(results):
        check(tuple(r["counts"]) == want,
              f"{tag} rank {i}: launches {tuple(r['counts'])} != {want}")
    check(all(r["loss"] == results[0]["loss"] for r in results),
          f"{tag}: the ranks' global losses differ "
          f"{[r['loss'] for r in results]}")
    r0 = results[0]
    got = {"loss": abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])}
    got.update({f"grad {g}": _dist(r0["grads"][g].cuda(),
                                   ref["grads"][g]) for g in ref["grads"]})
    p0 = {k: v.cuda() for k, v in r0["params"].items()}
    got.update({f"param {g}": _dist(v, ref["params"][g])
                for g, v in _groups_of(p0).items()})
    for k, v in got.items():
        check(v <= bounds[k], f"{tag} {k}: {v:.4g} from the B=8 step > "
              f"1e-3 + 3 x its motion under a 1e-6 image change = "
              f"{bounds[k]:.4g}")
    return got


def _groups_of(params: dict) -> dict:
    """{name: parameter} -> each group's parameters as one vector (the
    groups of ``_grad_groups``)."""
    import torch
    return {g: torch.cat([v.flatten() for k, v in params.items()
                          if k.startswith(pre)])
            for g, pre in (("encoder", "base_encoder."), ("BV head", "conv0"),
                           ("Base3D", "based_3d."),
                           ("decoder", "base_decoder."))}


def _p13_setup():
    """Phase 13's shared inputs in a fresh ``build/phase13``: phase 6's
    B=8 batch, seeded weights (saved for the spawned ranks), the step, and
    ``one_step(mi)``: one single-process step from those weights with its
    launches, loss, gradient groups and parameters."""
    import shutil
    import types

    import torch
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    work = os.path.join(ROOT, "build", "phase13")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev = torch.device("cuda", 0)
    cfg = cfg_for(64, 64, P13_W, P13_H, "bfloat16", nmode="exp7",
                  batch=P13_B)
    step = make_train_step(get_loss(cfg))
    mi, gt = _train_batch(P13_B, P13_W, P13_H, dev)
    base = get_model(cfg, dev, seed=0)
    torch.save(base.state_dict(), os.path.join(work, "base.pt"))

    def one_step(x=mi):
        model = get_model(cfg, dev)
        model.load_state_dict(base.state_dict())
        before = launch_counts()
        state, loss, _ = step(init_state(model, cfg), x, x, gt, gt)
        n = tuple(a - b for a, b in zip(launch_counts(), before))
        return {"loss": loss.item(), "counts": n,
                "grads": _grad_groups(model),
                "params": {k: p.detach().clone()
                           for k, p in model.named_parameters()}}

    def alone_ms(batch):
        """The single process's median step ms at ``batch`` (phase 6's
        batch, or its first ``batch`` items), CUDA events."""
        c = cfg_for(64, 64, P13_W, P13_H, "bfloat16", nmode="exp7",
                    batch=batch)
        x, y = (_rank_half(d, 0, P13_B // batch) for d in (mi, gt))
        model = get_model(c, dev)
        model.load_state_dict(base.state_dict())
        state = init_state(model, c)
        state, _, _ = step(state, x, x, y, y)
        return float(np.median([cuda_ms(lambda: step(state, x, x, y, y), 1,
                                        warmup=0) for _ in range(4)]))

    return types.SimpleNamespace(
        work=work, dev=dev, mi=mi, one_step=one_step, alone_ms=alone_ms,
        want=P13_WANT)


def _p13_group_of_one(card, p13):
    """Phase 13a: the B=8 step in an NCCL group of one (a ``FileStore``)
    against the step without a group, deterministic algorithms on; then
    ``init_distributed`` under ``torchrun``'s variables. Returns the step
    without a group."""
    import contextlib
    import socket
    import warnings

    import torch
    import torch.distributed as dist
    from depthestimation_tpu_torch.parallel import mesh

    @contextlib.contextmanager
    def deterministic():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                yield
        finally:
            torch.use_deterministic_algorithms(False)

    want = p13.want
    with deterministic():
        plain = p13.one_step()
        dist.init_process_group(
            "nccl",
            store=dist.FileStore(os.path.join(p13.work, "store_a"), 1),
            rank=0, world_size=1, device_id=p13.dev)
        try:
            check(mesh.world() == 1 and dist.get_backend() == "nccl",
                  "13a: no NCCL group of one")
            grouped = p13.one_step()
        finally:
            dist.destroy_process_group()
        again = p13.one_step()
    repeat = (plain["loss"] == again["loss"]
              and _same_params(plain["params"], again["params"]))
    same = (grouped["loss"] == plain["loss"]
            and _same_params(grouped["params"], plain["params"]))
    check(grouped["counts"] == plain["counts"] == want,
          f"13a: launches {grouped['counts']} (group of one) vs "
          f"{plain['counts']} (no group), want {want}")
    check(same or not repeat, "13a: the step in a group of one differs from "
          "the single process's, which repeats bit for bit")
    if not same:    # the single process does not repeat: hold to its spread
        spread = max(_dist(again["params"][k], plain["params"][k])
                     for k in plain["params"])
        off = max(_dist(grouped["params"][k], plain["params"][k])
                  for k in plain["params"])
        check(off <= spread, f"13a: group of one {off:.4g} from the single "
              f"process, further than its own repeat {spread:.4g}")
    # torchrun's path: RANK / WORLD_SIZE / LOCAL_RANK and a TCP store on
    # localhost make init_distributed join an NCCL group on cuda:LOCAL_RANK
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        got_dev = mesh.init_distributed("cuda")
        check(got_dev == p13.dev and dist.get_backend() == "nccl"
              and mesh.world() == 1,
              f"13a: init_distributed under torchrun's variables gave "
              f"{got_dev}, {dist.get_backend()}")
        dist.destroy_process_group()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    held = "bit-equal to" if same else "within the repeat of"
    print(f"phase 13a: exp7 384x256 D=64 bf16 B=8 step in an NCCL group of "
          f"one (FileStore) {held} the single process's (loss "
          f"{grouped['loss']:.6g}, every parameter; the single process "
          f"repeats {'bit for bit' if repeat else 'not bit for bit'} under "
          f"torch.use_deterministic_algorithms), launches {grouped['counts']}"
          f" both; init_distributed under torchrun's variables: NCCL on "
          f"{got_dev} [{card}]", flush=True)
    return plain


def _p13_reference(p13, plain):
    """The B=8 step ``plain`` as the ranks' reference, with the bounds:
    1e-3 plus 3x the most two moved B=8 steps (the images changed by one
    part in 10^6) lie from it, for the loss and each group's gradient and
    parameters; and one process's step ms at B=8 and B=4 in this call."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    moved = []
    for _ in range(2):
        noise = torch.randn(p13.mi["rgb"].shape, generator=gen,
                            device=p13.dev)
        moved.append(p13.one_step(dict(p13.mi, rgb=p13.mi["rgb"]
                                       * (1 + 1e-6 * noise))))
    ref = {"loss": plain["loss"], "grads": plain["grads"],
           "params": _groups_of(plain["params"])}

    def motion(dist_of):
        return 1e-3 + 3 * max(dist_of(m) for m in moved)

    bounds = {"loss": motion(lambda m: abs(m["loss"] - ref["loss"])
                             / abs(ref["loss"]))}
    for g in ref["grads"]:
        bounds[f"grad {g}"] = motion(lambda m: _dist(m["grads"][g],
                                                     ref["grads"][g]))
        bounds[f"param {g}"] = motion(lambda m: _dist(
            _groups_of(m["params"])[g], ref["params"][g]))
    del moved
    alone = {b: p13.alone_ms(b) for b in (8, 4)}
    torch.cuda.empty_cache()
    return ref, bounds, alone


def _p13_ranks(card, p13, backend, ref, bounds, alone):
    """Phase 13b (gloo, the two ranks on one card) or 13c (NCCL, one rank
    a card): two spawned ranks at B=4 each against the B=8 step."""
    import torch
    tag, where = (("13b", "on one card over gloo") if backend == "gloo"
                  else ("13c", "on cuda:0 and cuda:1 over NCCL"))
    wall = _spawn(_p13_step_rank, (backend, 2, p13.work), 2)
    res = [torch.load(os.path.join(p13.work, f"{backend}_rank{r}.pt"))
           for r in range(2)]
    got = _hold_ranks(tag, res, ref, bounds, p13.want)
    ms = [round(float(np.median(r["ms"])), 3) for r in res]
    held = ", ".join(f"{k} {v:.4g} (bound {bounds[k]:.4g})"
                     for k, v in got.items())
    split = "; ".join(
        f"rank {i}: {r['split']['calls']:.0f} all-reduces a step, "
        f"{r['split']['wall_ms']:.3f} ms a step of which waiting for the "
        f"card before them {r['split']['wait_ms']:.3f}, in them "
        f"{r['split']['reduce_ms']:.3f} (the gradient's "
        f"{r['split']['grad_elems']} floats {r['split']['grad_ms']:.3f})"
        for i, r in enumerate(res))
    print(f"phase {tag}: two ranks {where}, B=4 each of the B=8 batch: "
          f"parameters bit-equal across ranks, launches per rank "
          f"{tuple(res[0]['counts'])}; from the single-process B=8 step: "
          f"{held}; step ms median per rank (CUDA events, steps 2-5) {ms} "
          f"(one process alone in this call: B=8 {alone[8]:.3f}, B=4 "
          f"{alone[4]:.3f}); host split of 2 more steps: {split}; spawn to "
          f"join {wall:.3f} s [{card}]", flush=True)


def _p13_cli(card, work):
    """Phase 13d: ``train.main`` in two spawned ranks on the card (gloo)."""
    import torch
    want = P13_WANT
    wall_d = _spawn(_p13_cli_rank, (2, work), 2)
    cli = [torch.load(os.path.join(work, f"cli_rank{r}.pt"))
           for r in range(2)]
    lengths = [c["epoch_length"] for c in cli]
    check(lengths == [8, 4], f"13d: epoch lengths {lengths}, want [8, 4]")
    check(all(c["steps"] == min(lengths) for c in cli),
          f"13d: steps {[c['steps'] for c in cli]}, want {min(lengths)} on "
          "each rank")
    check(all(s == want for c in cli for s in c["launches"]),
          f"13d: launches {[c['launches'] for c in cli]}")
    check(cli[0]["losses"] == cli[1]["losses"]
          and all(np.isfinite(cli[0]["losses"])),
          f"13d: global losses {[c['losses'] for c in cli]}")
    check(_same_params(cli[0]["params"], cli[1]["params"]),
          "13d: the ranks' parameters differ after the epoch")
    check(cli[0]["saves"] == [0] and cli[1]["saves"] == [],
          f"13d: checkpoint writes rank 0 {cli[0]['saves']}, rank 1 "
          f"{cli[1]['saves']}")
    saved = sorted(os.listdir(os.path.join(work, "outputs", "checkpoints",
                                           "synthetic_tpu")))
    check([f for f in saved if f.endswith("_ckpt")] == ["synthetic_tpu_ckpt"],
          f"13d: checkpoints {saved}")
    check(cli[0]["metrics"] == cli[1]["metrics"]
          and len(cli[0]["metrics"]) == 5
          and all(np.isfinite(cli[0]["metrics"])),
          f"13d: metrics {[c['metrics'] for c in cli]}")
    ms_d = [float(np.median(c["ms"])) for c in cli]
    wait = [c["wait_seconds"] / c["epoch_seconds"] for c in cli]
    print(f"phase 13d: train.main in two ranks on one card over gloo, "
          f"synthetic_tpu.json bf16 384x256 -b 4 per rank, 15 trajectories "
          f"(epoch lengths {lengths}): {min(lengths)} steps on each rank, "
          f"launches per step {want}, losses "
          f"{[round(x, 4) for x in cli[0]['losses']]}, parameters bit-equal, "
          f"one _ckpt (rank 0), validation "
          f"{[round(x, 4) for x in cli[0]['metrics']]} on both; step ms "
          f"median per rank {[round(x, 3) for x in ms_d]} (CUDA events), "
          f"epoch s {[round(c['epoch_seconds'], 3) for c in cli]}, loader "
          f"wait share {[round(100 * x, 1) for x in wait]}%; spawn to join "
          f"{wall_d:.3f} s [{card}]", flush=True)


def phase_data_parallel(card):
    """Phase 13: data-parallel training (``parallel/mesh.py``) of phase
    6's B=8 exp7 bf16 step and of the CLI, in ``build/phase13``."""
    import torch
    t0 = time.perf_counter()
    p13 = _p13_setup()
    plain = _p13_group_of_one(card, p13)
    ref, bounds, alone = _p13_reference(p13, plain)
    del plain
    _p13_ranks(card, p13, "gloo", ref, bounds, alone)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        _p13_ranks(card, p13, "nccl", ref, bounds, alone)
    else:
        print(f"phase 13c: not run: {n_cards} CUDA device visible, one rank "
              f"per card over NCCL needs two", flush=True)
    _p13_cli(card, p13.work)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phase 14

#: phase 12 (c)'s work directory: the bf16 default_exp7 copy on the KITTI
#: fixture tree and the ``_model_best`` its trainer wrote
P12_TRAINER = os.path.join("build", "phase12", "trainer")
P12_EXP = "kitti_exp7"


@contextlib.contextmanager
def quiet_stdout():
    """The entry points' own printing (a table, a line a frame) kept out of
    this script's output."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _counted_eval(tdefault, forwards):
    """``make_eval_step`` wrapped: each forward's CUDA events."""
    import torch
    real_make = tdefault.make_eval_step

    def counted_make(model):
        step = real_make(model)

        def run(mi):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(mi)
            ev[1].record()
            forwards.append(ev)
            return out
        return run

    return real_make, counted_make


def phase_eval_harness(card):
    """Phase 14 (a): ``eval_parity.main`` on phase 12 (c)'s ``_model_best``
    over the KITTI fixture's validation split, held to ``train.main
    --eval``'s metrics on the same weights and frames; an orbax
    directory raising the importer's error."""
    import torch
    from depthestimation_tpu_torch import eval_parity
    from depthestimation_tpu_torch import train as ttrain
    from depthestimation_tpu_torch.trainer import default as tdefault

    work = os.path.join(ROOT, P12_TRAINER)
    path = os.path.join(work, "default_exp7_kitti.json")
    save_root = os.path.join(work, "outputs", "checkpoints", P12_EXP)
    check(os.path.isdir(os.path.join(save_root, P12_EXP + "_model_best")),
          f"phase 12c left no _model_best under {save_root}")
    forwards = []
    real_make, counted_make = _counted_eval(tdefault, forwards)
    cwd = os.getcwd()
    os.chdir(work)
    tdefault.make_eval_step = counted_make
    try:
        reset_counts()
        t0 = time.perf_counter()
        with quiet_stdout():
            table = eval_parity.main(["--config", path, "--ckpt", save_root])
        wall = time.perf_counter() - t0
        counts = dict(zip(COUNT_NAMES, launch_counts()))
        n_fwd = len(forwards)
        torch.cuda.synchronize()
        fwd_ms = [a.elapsed_time(b) for a, b in forwards]
        ev = ttrain.main(["--config", path, "--eval"])
    finally:
        tdefault.make_eval_step = real_make
        os.chdir(cwd)
    frames = table["frames"]
    check(frames > 0 and n_fwd == frames,
          f"{frames} frames, {n_fwd} eval forwards: one a frame")
    for scale in ("low_res", "refined"):
        check(len(table[scale]) == 9 and all(
            np.isfinite(v).all() for v in table[scale].values()),
            f"the {scale} metrics are not all finite: {table[scale]}")
    got = [table["low_res"]["rmse"][0], table["refined"]["rmse"][0],
           table["low_res"]["scale invariant log"][0],
           table["refined"]["scale invariant log"][0], table["rmse_unc"]]
    want = ev.last_metrics
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(err <= 1e-5, f"eval_parity's table {got} against train --eval's "
                       f"{want}: {err:.3g} relative (1e-5)")
    per = {k: counts[k] / frames for k in ("sweep_stage2", "convbn_block")}
    check(per["sweep_stage2"] > 0 and per["convbn_block"] > 0
          and counts["convbn_block_bwd"] == counts["sweep_stage2_bwd"] == 0,
          f"the eval path's launches {counts}")
    # a JAX (orbax) checkpoint directory: the importer's error, not a
    # random-weight table
    orbax = os.path.join(ROOT, "build", "phase14", "orbax")
    best = os.path.join(orbax, P12_EXP + "_model_best")
    os.makedirs(best, exist_ok=True)
    with open(os.path.join(best, "_CHECKPOINT_METADATA"), "w") as f:
        f.write("{}")
    try:
        with quiet_stdout():
            eval_parity.main(["--config", path, "--ckpt", orbax,
                              "--limit", "1"])
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("jax_checkpoint_to_torch" in raised,
          f"an orbax directory did not raise the importer's error "
          f"({raised!r})")
    print(f"phase 14a: eval_parity on the KITTI fixture (default_exp7.json "
          f"bf16, 384x256, D 64, B=1, phase 12c's _model_best): {frames} "
          f"frames, eval forward ms a frame median "
          f"{float(np.median(fwd_ms)):.3f} (CUDA events: "
          f"{[round(x, 3) for x in fwd_ms]}), main() {wall:.3f} s "
          f"({wall * 1e3 / frames:.1f} ms a frame on the host clock, the "
          f"spawned loader's start and the model's build included); "
          f"launches a frame: sweep {per['sweep_stage2']:g}, convcomb "
          f"{per['convbn_block']:g}; rmse {got[0]:.5f}, rmse_refined "
          f"{got[1]:.5f}, sil {got[2]:.5f}, sil_refined {got[3]:.5f}, "
          f"rmse_unc {got[4]:.5f}, train --eval's within {err:.3g} "
          f"relative (1e-5); all 2 x 9 metrics finite; an orbax directory "
          f"raises ValueError [{card}]", flush=True)
    return per


def write_sweep_capture(root: str, frames: int = 2):
    """A raw sweep capture at the rig's stored size: 128 planes of 320x256
    (z, intensity) f32 a frame (84 MB), 1280x1024 RGB and 512x640 NIR
    PNGs, a 120,000-point scan, the rig's LC distortion in calib.json.
    Returns the drive name."""
    date, drive = "2021_03_05", "2021_03_05_drive_0004_sweep"
    base = os.path.join(root, date, drive)
    for sub in ("sweep", "left_img", "right_img", "nir_img", "lidar"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.default_rng(14)
    left_2_lidar = np.eye(4)
    left_2_lidar[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    calib = {
        "left_P": [[1024.0, 0, 640.0, 0], [0, 1024.0, 512.0, 0],
                   [0, 0, 1, 0]],
        "left_2_lidar": left_2_lidar.tolist(),
        "left_2_right": [[1, 0, 0, -0.24], [0, 1, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]],
        "left_2_lc": [[1, 0, 0, 0.1], [0, 1, 0, 0], [0, 0, 1, 0.05],
                      [0, 0, 0, 1]],
        "D_lc": [-0.033918, 0.027494, -0.001691, -0.001078, 0.0]}
    with open(os.path.join(base, "calib.json"), "w") as f:
        json.dump(calib, f)
    zs = np.linspace(3.0, 18.0, 128, dtype=np.float32)
    for t in range(frames):
        s = f"{t:06d}"
        sweep = np.empty((128, 320, 256, 2), np.float32)
        sweep[..., 0] = zs[:, None, None]
        sweep[..., 1] = rng.uniform(0, 255, (128, 320, 256))
        np.save(os.path.join(base, "sweep", s + ".npy"), sweep)
        _velodyne_scan(rng).tofile(os.path.join(base, "lidar", s + ".bin"))
        for side in ("left_img", "right_img"):
            write_png(os.path.join(base, side, s + ".png"),
                      _texture(rng, 1024, 1280))
        write_png(os.path.join(base, "nir_img", s + ".png"),
                  _texture(rng, 640, 512)[..., 0])
    return drive


def phase_sweep_convert(card):
    """Phase 14 (b): the converter on a capture at the rig's stored size:
    the card's undistort against its plain version on the same quantized
    map, ms a frame split into undistort, depth maps and projection, and
    ``convert_frame`` and the CLI on the card."""
    import shutil

    import torch
    from depthestimation_tpu_torch import sweep_convert as tsc

    root = os.path.join(ROOT, "build", "phase14", "capture")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    drive = write_sweep_capture(root)
    write_s = time.perf_counter() - t0
    frame = tsc.load_frame(root, drive, 0)
    p, h, w, c = frame["sweep_arr"].shape
    planes = np.ascontiguousarray(frame["sweep_arr"].transpose(
        0, 3, 1, 2)).reshape(p * c, h, w)
    umap = tsc.undistort_map(frame["K_lc"], frame["D_lc"], h, w)
    t0 = time.perf_counter()
    plain = tsc.remap_np(planes, umap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    dev = torch.from_numpy(planes).cuda()
    tsc._device_taps.cache_clear()
    t0 = time.perf_counter()
    idx, wts = tsc.undistort_taps(frame["K_lc"], frame["D_lc"], h, w, "cuda")
    torch.cuda.synchronize()
    taps_ms = (time.perf_counter() - t0) * 1e3
    got = tsc.remap_torch(dev, idx, wts)
    gather_ms = cuda_ms(lambda: tsc.remap_torch(dev, idx, wts), 5)
    diff = float(np.abs(got.cpu().numpy() - plain).max())
    span = float(planes.max() - planes.min())
    check(diff <= 1e-5 * span, f"the card's undistort differs from its "
                               f"plain version by {diff} (range {span})")
    split = {"undistort": [], "depth": [], "projection": [], "frame": []}
    for t in range(2):
        frame = tsc.load_frame(root, drive, t)
        t0 = time.perf_counter()
        und, nir = tsc.undistort_frame(frame, "cuda")
        t1 = time.perf_counter()
        depths = tsc.depth_maps(frame)
        t2 = time.perf_counter()
        out = tsc.project(frame, und, nir, depths[0], depths[1])
        t3 = time.perf_counter()
        whole = tsc.convert_frame(frame, device="cuda")
        t4 = time.perf_counter()
        for k, a, b in (("undistort", t0, t1), ("depth", t1, t2),
                        ("projection", t2, t3), ("frame", t3, t4)):
            split[k].append((b - a) * 1e3)
    check(whole["sweep_arr"].shape == (128, 320, 256, 2)
          and whole["left_feat_int"].shape == (128, 256, 320)
          and float(whole["left_mask"].sum()) > 1000
          and np.isfinite(whole["left_depth"]).all()
          and np.array_equal(whole["left_feat_int"], out["left_feat_int"],
                             equal_nan=True),
          "convert_frame's outputs: shapes, mask "
          f"{float(whole['left_mask'].sum())}")
    out_dir = os.path.join(root, "converted")
    t0 = time.perf_counter()
    with quiet_stdout():
        done = tsc.main(["--root", root, "--drive", drive, "--frames", "1:2",
                         "--out", out_dir])
    cli_s = time.perf_counter() - t0
    with np.load(os.path.join(out_dir, "000001.npz")) as npz:
        names = sorted(npz.files)
    check(done == [1] and names == sorted(whole), f"the CLI wrote {names}")
    print(f"phase 14b: sweep_convert on a capture at the rig's stored size "
          f"(128 planes of 320x256x2 f32, 1280x1024 RGB, 512x640 NIR, "
          f"{len(frame['velodata'])} points; written in {write_s:.3f} s): "
          f"the card's undistort of 256 planes {gather_ms:.3f} ms (CUDA "
          f"events: the pad, the gather of four taps and the weighted sum, "
          f"on planes and taps already on the card) against the plain "
          f"numpy {plain_ms:.3f} ms, max abs diff {diff:.3g} (range "
          f"{span:.1f}); the map's taps built once in {taps_ms:.3f} ms "
          f"(host clock, numpy and the copy to the card); ms a frame: "
          f"undistort (host to card and back, the taps kept) "
          f"{[round(x, 3) for x in split['undistort']]}, depth maps "
          f"{[round(x, 3) for x in split['depth']]}, projection "
          f"{[round(x, 3) for x in split['projection']]}, convert_frame "
          f"{[round(x, 3) for x in split['frame']]}; the CLI on one frame "
          f"{cli_s:.3f} s (npz compressed, {len(names)} keys) [{card}]",
          flush=True)


def phase_lc_sandbox(card):
    """Phase 14 (c): the LC sandbox's six rounds on the card, held to the
    JAX script's curve."""
    import importlib.util

    import torch
    spec = importlib.util.spec_from_file_location(
        "lc_sandbox_torch", os.path.join(ROOT, "examples",
                                         "lc_sandbox_torch.py"))
    sandbox = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sandbox)
    sandbox.run("cuda", quiet=True)               # the first call's set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet_stdout():
        errors = sandbox.run("cuda")
    ms = (time.perf_counter() - t0) * 1e3 / len(errors)
    off = max(abs(a - b) for a, b in zip(errors, sandbox.JAX_CURVE))
    check(errors[-1] < errors[0] and off <= sandbox.BOUND,
          f"the sandbox's curve {errors} against JAX's "
          f"{sandbox.JAX_CURVE}: {off:.3g} m (bound {sandbox.BOUND})")
    print(f"phase 14c: lc_sandbox_torch on the card (96x64, D 32, 6 rounds "
          f"of lc_process, planner default): mean depth errors "
          f"{[round(e, 4) for e in errors]} m, within {off:.3g} m of JAX's "
          f"printed curve (bound {sandbox.BOUND}); {ms:.3f} ms a round on "
          f"the host clock [{card}]", flush=True)


def phase_last_modules(card):
    """Phase 14: the eval harness, the sweep converter and the LC
    sandbox."""
    t0 = time.perf_counter()
    phase_eval_harness(card)
    phase_sweep_convert(card)
    phase_lc_sandbox(card)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)


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
        phase_kernels_lc(card)
        phase_server(card)
        phase_flagship(card)
        launches = phase_train(card)
        phase_tail(card)
        lc_launches = phase_lc_train(card)
        flow_launches = phase_flow(card)
        phase_trainer(card)
        phase_lc_server(card)
        phase_uf_convergence(card)
        phase_pipelined(card)
        phase_lc_real_train(card)
        phase_sweep_train(card)
        phase_real_data(card)
        phase_data_parallel(card)
        phase_last_modules(card)
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
