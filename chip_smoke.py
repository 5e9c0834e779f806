#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port's serving path on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero before the result):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds ``depthestimation_tpu_torch/csrc/*.cu``;
3. every kernel of the path against its plain PyTorch version on the card,
   at the shapes the main path gives it, with times from CUDA events;
4. the server: ``NetRuntime`` (mode ``mono_lc``, ``real_sensor.json``,
   320x256, feature_dim 64, D 64, bf16, seeded weights) answers 4 frames;
   every output must be finite with depth in [d_min, d_max], and each
   frame must launch the sweep kernel once and the Base3D kernel 8 times;
5. the flagship forward of ``bench.py`` (384x256, D 64, exp7_lc) at batch
   1 and 8, through the kernels and through the plain path with the same
   weights, both held to an f32 plain forward (tests/TOLERANCES.md rule 4),
   with ms and frames/s from CUDA events.

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


def cfg_for(feature_dim, ndepth, w, h, dtype):
    from depthestimation_tpu_torch.config import config_from_dict
    return config_from_dict({
        "data": {"exp_name": "chip_smoke", "model_name": "base",
                 "loss_name": "base", "trainer_name": "default",
                 "dataset_path": "kitti", "dataset_split": "k1"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": D_MIN,
                "d_max": D_MAX, "feature_dim": feature_dim,
                "ndepth": ndepth, "softce": 0.3, "qpower": 1.0,
                "img_size": [w, h], "crop_w": w, "nmode": "exp7_lc",
                "bn_avg": False},
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
        convbn_block, convbn_block_plain)
    from depthestimation_tpu_torch.ops.sweep_kernel import (
        sweep_stage2, sweep_stage2_plain)
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
    return launches


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
        launches = phase_server(card)
        phase_flagship(card)
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    err_s, ms_s, pms_s = rows[("sweep_stage2", 8)]
    err_c, ms_c, pms_c = rows[("convbn_block", 32, 32)]
    kernels = [
        {"name": "sweep_stage2", "route": "cuda",
         "source": "depthestimation_tpu_torch/csrc/sweep_stage2.cu",
         "replaces": "depthestimation_tpu/ops/sweep_pallas.py:151",
         "launches": launches["sweep_stage2"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": pms_s},
        {"name": "convbn_block", "route": "cuda",
         "source": "depthestimation_tpu_torch/csrc/convcomb.cu",
         "replaces": "depthestimation_tpu/ops/convcomb_pallas.py:140",
         "launches": launches["convbn_block"], "max_abs_err": err_c,
         "ms": ms_c, "plain_ms": pms_c},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
