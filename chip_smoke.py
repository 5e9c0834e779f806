#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port on one NVIDIA GPU: the serving
path and the bf16 train step.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero before the result):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds ``depthestimation_tpu_torch/csrc/*.cu``;
3. every kernel of the paths, forward and backward, against its plain
   PyTorch version on the card, at the shapes the main paths give it,
   with times from CUDA events;
4. the server: ``NetRuntime`` (mode ``mono_lc``, ``real_sensor.json``,
   320x256, feature_dim 64, D 64, bf16, seeded weights) answers 4 frames;
   every output must be finite with depth in [d_min, d_max], and each
   frame must launch the sweep kernel once and the Base3D kernel 8 times;
5. the flagship forward of ``bench.py`` (384x256, D 64, exp7_lc) at batch
   1 and 8, through the kernels and through the plain path with the same
   weights, both held to an f32 plain forward (tests/TOLERANCES.md rule 4),
   with ms and frames/s from CUDA events;
6. the train step of ``bench_train.py`` (exp7, 384x256, D 64, bf16, Adam
   lr 1e-5, both camera sides, BaseLoss) at batch 8 and 1 on synthetic
   batches with on-device soft labels: 4 Adam steps through the kernels
   (loss finite, lower after them; per step 2 sweep and 16 Base3D launches
   forward and backward); the gradients of one step held to an f32 plain
   step by rule 4 against the plain bf16 step; ms per step of both paths
   in turns, its split into forward, backward and optimizer, and the peak
   memory.

Then it prints the kernels' JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``. The f32 references run without TF32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
D_MIN, D_MAX = 5.0, 40.0


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


def cfg_for(feature_dim, ndepth, w, h, dtype, nmode="exp7_lc", batch=1):
    """``__graft_entry__._cfg`` (the config of bench.py and
    bench_train.py) with ``tpu.dtype``."""
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
        "tpu": {"dtype": dtype},
    })


# ------------------------------------------------------------ phase 3

def sweep_inputs(n, c1, d, h, w, gen, dev):
    """Stage-2 inputs as the main path builds them: features, and the band
    matrices of a small sideways camera step (sweep_mats)."""
    import torch
    from depthestimation_tpu_torch.ops import dpv as dpv_ops
    from depthestimation_tpu_torch.ops.plane_sweep import sweep_mats
    bf = torch.bfloat16
    fa = torch.randn(n, c1, h, w, generator=gen).to(dev, bf)
    ref = torch.randn(n, c1, h, w, generator=gen).to(dev, bf)
    fr = torch.randn(n, d, h, w, generator=gen).to(dev, bf)
    rot = torch.eye(3).repeat(n, 1, 1).to(dev)
    tra = torch.zeros(n, 3)
    tra[:, 0] = -0.15 - 0.1 * torch.rand(n, generator=gen)
    intr = torch.tensor([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                         [0, 0, 1]]).repeat(n, 1, 1).to(dev)
    d_candi = torch.as_tensor(dpv_ops.powerf(D_MIN, D_MAX, d, 1.0),
                              dtype=torch.float32, device=dev)
    rx, ry = sweep_mats(d_candi, rot, tra.to(dev), intr, h, w)
    return (fa, ref, fr, rx.transpose(-1, -2).contiguous().to(bf),
            ry.contiguous().to(bf))


def phase_kernels(card):
    import torch
    from depthestimation_tpu_torch.ops.convcomb_kernel import (
        convbn_block, convbn_block_bwd, convbn_block_bwd_plain,
        convbn_block_plain)
    from depthestimation_tpu_torch.ops.sweep_kernel import (
        sweep_stage2, sweep_stage2_bwd, sweep_stage2_bwd_plain,
        sweep_stage2_plain)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # sweep_stage2 at the flagship 384x256 shape: h=64, w=96, C1 = 64 + 3
    for n in (1, 8):
        args = sweep_inputs(n, 67, 64, 64, 96, gen, dev)
        cost, diag = sweep_stage2(*args, 1)
        torch.cuda.synchronize()
        cost_p, diag_p = sweep_stage2_plain(*args, 1)
        err = max((cost - cost_p).abs().max().item(),
                  (diag - diag_p).abs().max().item())
        # rule 3: one kernel call vs the plain version, k = 1% of max|plain|
        for got, want, nm in ((cost, cost_p, "cost"), (diag, diag_p, "diag")):
            bound = 1e-2 * want.abs().max().item()
            e = (got - want).abs().max().item()
            check(np.isfinite(e) and e <= bound,
                  f"sweep_stage2 N={n} {nm}: max|err| {e} > {bound}")
        ms = cuda_ms(lambda: sweep_stage2(*args, 1), 10)
        plain_ms = cuda_ms(lambda: sweep_stage2_plain(*args, 1), 5)
        print(f"phase 3: sweep_stage2 N={n} C1=67 D=64 64x96 bf16: max|err| "
              f"{err:.4g} (cost max {cost_p.abs().max().item():.4g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]",
              flush=True)
        rows[("sweep_stage2", n)] = (err, ms, plain_ms)

        # backward, rule 3: within 3% of max|plain| per gradient
        gc = torch.randn(args[2].shape, generator=gen).to(dev)
        gd = torch.randn(args[2].shape, generator=gen).to(dev)
        got = sweep_stage2_bwd(*args, gc, gd, 1)
        torch.cuda.synchronize()
        want = sweep_stage2_bwd_plain(*args, gc, gd, 1)
        errs = []
        for g, p, nm in zip(got, want, ("dfa", "dref", "dfr")):
            e = (g - p).abs().max().item()
            bound = 3e-2 * p.abs().max().item()
            check(np.isfinite(e) and e <= bound,
                  f"sweep_stage2 backward N={n} {nm}: max|err| {e} > {bound}")
            errs.append(e)
        ms = cuda_ms(lambda: sweep_stage2_bwd(*args, gc, gd, 1), 5)
        plain_ms = cuda_ms(lambda: sweep_stage2_bwd_plain(*args, gc, gd, 1),
                           3)
        print(f"phase 3: sweep_stage2 backward N={n}: max|err| dfa, dref, "
              f"dfr {errs[0]:.4g}, {errs[1]:.4g}, {errs[2]:.4g} (max "
              f"{max(p.abs().max().item() for p in want):.4g}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
        rows[("sweep_stage2_bwd", n)] = (max(errs), ms, plain_ms)

    # convbn_block: the issue's padded-TPU shapes (C=8, F=32), (C=32, F=8)
    # and the port's own layers (C=5 entry, C=32 -> 32, C=32 -> 1)
    h, w = 64, 96
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
                torch.cuda.synchronize()
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
                        f"relu={relu}: max|err| y {err:.4g} (max {scale:.4g})")
                if n == 512 and relu:
                    ms = cuda_ms(lambda: convbn_block(x, wm, a, b, 64, h, w,
                                                      relu), 10)
                    plain_ms = cuda_ms(lambda: convbn_block_plain(
                        x, wm, a, b, 64, h, w, relu), 10)
                    rows[("convbn_block", c, f)] = (err, ms, plain_ms)
                    line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                             f"[{card}]")
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
            torch.cuda.synchronize()
            want = convbn_block_bwd_plain(*bargs)
            v = x.float() * a[None, :, None] + b[None, :, None]
            inner = v.abs() > 0.02 if relu else torch.ones_like(v, dtype=bool)
            errs = []
            for g, p, nm, tol in zip(got, want, ("dx", "dW", "da", "db"),
                                     (0.03, 0.03, 0.10, 0.10)):
                g, p = g.float(), p.float()
                d = (g - p).abs()
                e = (d[inner] if nm == "dx" else d).max().item()
                bound = tol * p.abs().max().item()
                check(np.isfinite(e) and e <= bound,
                      f"convbn_block backward N={n} C={c} F={f}: {nm} "
                      f"max|err| {e} > {bound}")
                errs.append(e)
            line = (f"phase 3: convbn_block backward N={n} C={c} F={f} "
                    f"relu={relu}: max|err| dx, dW, da, db "
                    f"{', '.join(f'{e:.4g}' for e in errs)}")
            if n == 512:
                ms = cuda_ms(lambda: convbn_block_bwd(*bargs), 5)
                plain_ms = cuda_ms(lambda: convbn_block_bwd_plain(*bargs), 5)
                rows[("convbn_block_bwd", c, f)] = (max(errs), ms, plain_ms)
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]"
            print(line, flush=True)
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


def phase_train(card):
    import copy

    import torch
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.ops.convcomb_kernel import convbn_block
    from depthestimation_tpu_torch.ops.sweep_kernel import sweep_stage2
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    w, h = 384, 256
    dev = torch.device("cuda")
    floor = 4e-3
    launches = None
    for batch in (8, 1):
        cfg = cfg_for(64, 64, w, h, "bfloat16", nmode="exp7", batch=batch)
        cfg32 = cfg_for(64, 64, w, h, "float32", nmode="exp7", batch=batch)
        step = make_train_step(get_loss(cfg))
        mi, gt = _train_batch(batch, w, h, dev)
        base = get_model(cfg, dev, seed=0)

        # the gradients of one step from the same weights, three ways
        grads, losses0 = {}, {}
        for name, c, kernels in (("kernel", cfg, True), ("plain", cfg, False),
                                 ("f32", cfg32, False)):
            model = get_model(c, dev)
            model.load_state_dict(base.state_dict())
            model.use_kernels = kernels
            state, loss, _ = step(init_state(model, c), mi, mi, gt, gt)
            losses0[name] = loss.item()
            grads[name] = _grad_groups(model)
            del model, state
        check(all(np.isfinite(v) for v in losses0.values()),
              f"B={batch}: first-step losses {losses0}")
        dists = {}
        for name in ("kernel", "plain"):
            d = {"loss": abs(losses0[name] - losses0["f32"])
                 / abs(losses0["f32"])}
            d.update({g: _dist(grads[name][g], grads["f32"][g])
                      for g in grads["f32"]})
            dists[name] = d
        for k in dists["kernel"]:
            bound = 3 * dists["plain"][k] + floor
            check(dists["kernel"][k] <= bound,
                  f"B={batch} {k}: kernel-vs-f32 {dists['kernel'][k]:.4g} >"
                  f" 3 x plain-vs-f32 + floor = {bound:.4g}")
        del grads

        # 4 Adam steps through the kernels: the main path, counted
        model = copy.deepcopy(base)
        state = init_state(model, cfg)
        sweep_stage2.launches = sweep_stage2.bwd_launches = 0
        convbn_block.launches = convbn_block.bwd_launches = 0
        losses = []
        for i in range(5):              # the 5th forward: after 4 updates
            before = (sweep_stage2.launches, sweep_stage2.bwd_launches,
                      convbn_block.launches, convbn_block.bwd_launches)
            state, loss, aux = step(state, mi, mi, gt, gt)
            losses.append(loss.item())
            got = tuple(a - b for a, b in zip(
                (sweep_stage2.launches, sweep_stage2.bwd_launches,
                 convbn_block.launches, convbn_block.bwd_launches), before))
            check(got == (2, 2, 16, 16),
                  f"B={batch} step {i}: launches (sweep fwd, bwd, convcomb "
                  f"fwd, bwd) {got} != (2, 2, 16, 16)")
            check(np.isfinite(losses[-1]), f"B={batch} step {i}: loss "
                  f"{losses[-1]}")
        check(losses[4] < losses[0],
              f"B={batch}: loss {losses[0]} -> {losses[4]} after 4 steps")
        check(tuple(aux["prev_output_left"].shape) == (batch, 64, h // 4,
                                                       w // 4),
              f"B={batch}: prev_output feedback "
              f"{tuple(aux['prev_output_left'].shape)}")
        if batch == 8:
            launches = {
                "sweep_stage2": sweep_stage2.launches,
                "sweep_stage2_bwd": sweep_stage2.bwd_launches,
                "convbn_block": convbn_block.launches,
                "convbn_block_bwd": convbn_block.bwd_launches}

        # ms per step, in turns (plain, kernel, kernel, plain), and the
        # peak memory of one step of each path
        def run(kernels, n):
            model.use_kernels = kernels
            nonlocal state
            for _ in range(n):
                state, _, _ = step(state, mi, mi, gt, gt)

        t = {"plain": [], "kernel": []}
        peak = {}
        for k in ("plain", "kernel", "kernel", "plain"):
            run(k == "kernel", 1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t[k].append(cuda_ms(lambda: run(k == "kernel", 1), 3, warmup=0))
            peak[k] = torch.cuda.max_memory_allocated() / 2**30
        ms = {k: sum(v) / len(v) for k, v in t.items()}

        # one step through the kernels, split by CUDA events
        model.use_kernels = True
        opt = state.optimizer
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
        print(f"phase 6: train step exp7 {w}x{h} D=64 bf16 B={batch}: loss "
              f"{trail} over 4 Adam steps; launches per step (sweep fwd, "
              f"bwd, convcomb fwd, bwd) (2, 2, 16, 16); rel dist from the "
              f"f32 step (kernel, plain): {rule4}; ms per step kernel "
              f"{ms['kernel']:.3f} ({fps['kernel']:.2f} frames/s), plain "
              f"{ms['plain']:.3f} ({fps['plain']:.2f}); kernel step split "
              f"ms: forward x2 {split[0]:.3f}, loss {split[1]:.3f}, "
              f"backward {split[2]:.3f}, Adam {split[3]:.3f}; peak memory "
              f"GiB kernel {peak['kernel']:.3f}, plain {peak['plain']:.3f} "
              f"[{card}]", flush=True)
        del model, state, base, outs, loss, opt
        torch.cuda.empty_cache()
    return launches


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
        phase_server(card)
        phase_flagship(card)
        launches = phase_train(card)
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
             "depthestimation_tpu/ops/convcomb_pallas.py:258")):
        err, ms, plain_ms = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
