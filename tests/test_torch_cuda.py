"""The port's CUDA kernels on the card: each, forward and backward,
against its plain PyTorch version, the wrappers' input checks, their
launch counters, the bf16 forward through the sweep and Base3D forward
kernels, and the bf16 train step through all six (the encoder's fused
ConvBN chain in its training route).

Marked ``cuda``: a hand-written kernel has no CPU mode, so these skip with
a reason on a machine without a CUDA device. The file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from depthestimation_tpu_torch.ops import convbn2d_kernel as c2
from depthestimation_tpu_torch.ops import convcomb_kernel as ck
from depthestimation_tpu_torch.ops import sweep_kernel as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.parametrize("n,v,c1,d,h,w", [(2, 1, 5, 8, 12, 16),
                                          (4, 2, 67, 16, 13, 21),
                                          (1, 1, 67, 64, 64, 96)])
def test_sweep_kernel_matches_plain(dev, n, v, c1, d, h, w):
    gen = torch.Generator().manual_seed(n + c1 + h)
    bf = torch.bfloat16
    fa = _randn(gen, n, c1, h, w).to(dev, bf)
    ref = _randn(gen, n // v, c1, h, w).to(dev, bf)
    fr = _randn(gen, n, d, h, w).to(dev, bf)
    rxt = (torch.rand(n, d, w, w, generator=gen) * 0.2).to(dev, bf)
    ry = (torch.rand(n, d, h, h, generator=gen) * 0.2).to(dev, bf)
    before = sk.sweep_stage2.launches
    cost, diag = sk.sweep_stage2(fa, ref, fr, rxt, ry, v)
    torch.cuda.synchronize()
    assert sk.sweep_stage2.launches == before + 1
    cost_p, diag_p = sk.sweep_stage2_plain(fa, ref, fr, rxt, ry, v)
    for got, want in ((cost, cost_p), (diag, diag_p)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-2 * want.abs().max().item())


# the main path's shape and small ones, then the wgmma tiling's edges:
# h and w no multiple of the 4x16 tile, odd w, w % 8 == 0 with a tile half
# outside, depth shorter than a segment and one item, C = 5, F = 1, and a
# tap stride of 32 for F = 20
_CC_SHAPES = [(16, 8, 5, 32, 12, 16), (16, 8, 32, 1, 7, 9),
              (40, 20, 8, 16, 9, 11), (3, 1, 5, 8, 6, 10),
              (64, 64, 32, 32, 64, 96), (8, 4, 32, 32, 9, 23),
              (1, 1, 16, 1, 5, 7), (6, 3, 17, 11, 3, 33),
              (24, 24, 5, 1, 7, 19), (20, 20, 32, 20, 6, 24),
              (128, 64, 3, 32, 64, 96)]     # exp3's first layer, C3 -> F32


@pytest.mark.parametrize("n,depth,c,f,h,w", _CC_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_convcomb_kernel_matches_plain(dev, n, depth, c, f, h, w, relu):
    gen = torch.Generator().manual_seed(n + c + f + relu)
    x = _randn(gen, n, c, h * w).to(dev, torch.bfloat16)
    wm = _randn(gen, 3 * f, c, 3, 3, scale=0.2).to(dev, torch.bfloat16)
    a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
    b = _randn(gen, c, scale=0.1).to(dev)
    before = ck.convbn_block.launches
    y, st = ck.convbn_block(x, wm, a, b, depth, h, w, relu)
    torch.cuda.synchronize()
    assert ck.convbn_block.launches == before + 1
    y_p, st_p = ck.convbn_block_plain(x, wm, a, b, depth, h, w, relu)
    scale = y_p.float().abs().max().item()
    torch.testing.assert_close(y.float(), y_p.float(), rtol=0,
                               atol=0.03 * scale)
    torch.testing.assert_close(st, st_p, rtol=3e-2, atol=1e-2 * n * h * w)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(8, 4, 6, device=dev)
    wm = torch.zeros(3, 4, 3, 3, device=dev, dtype=torch.bfloat16)
    ab = torch.ones(4, device=dev)
    with pytest.raises(TypeError):                 # f32 activations
        ck.convbn_block(x, wm, ab, ab, 8, 2, 3)
    with pytest.raises(ValueError):                # depth does not divide N
        ck.convbn_block(x.bfloat16(), wm, ab, ab, 3, 2, 3)
    t = torch.zeros(2, 3, 4, 5, device=dev, dtype=torch.bfloat16)
    band_w = torch.zeros(2, 3, 5, 5, device=dev, dtype=torch.bfloat16)
    band_h = torch.zeros(2, 3, 4, 4, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        sk.sweep_stage2(t.float(), t, t, band_w, band_h, 1)
    with pytest.raises(ValueError):                # not contiguous
        sk.sweep_stage2(t.transpose(2, 3).contiguous().transpose(2, 3), t, t,
                        band_w, band_h, 1)


def test_bf16_forward_through_both_kernels(dev):
    from depthestimation_tpu_torch.config import config_from_dict
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.models import get_model

    def cfg(dtype):
        return config_from_dict({
            "data": {"model_name": "base"},
            "var": {"sigma_soft_max": 10.0, "t_win": 1, "feature_dim": 16,
                    "ndepth": 16, "nmode": "exp7_lc", "bn_avg": False},
            "tpu": {"dtype": dtype}})

    mi = to_device(make_batch(batch=2, h=48, w=72, d_min=3.0, d_max=30.0,
                              ndepth=16)[0], dev)
    m_bf, m_32 = get_model(cfg("bfloat16"), dev, 0), get_model(
        cfg("float32"), dev, 0)
    s0, c0 = sk.sweep_stage2.launches, ck.convbn_block.launches
    with torch.inference_mode():
        kern = m_bf(mi)["output_refined"][0]
        assert (sk.sweep_stage2.launches - s0,
                ck.convbn_block.launches - c0) == (1, 8)
        m_bf.use_kernels = False
        plain = m_bf(mi)["output_refined"][0]
        assert (sk.sweep_stage2.launches - s0,
                ck.convbn_block.launches - c0) == (1, 8)
        oracle = m_32(mi)["output_refined"][0]
    assert torch.isfinite(kern).all()

    def dist(x):
        return (torch.linalg.vector_norm(x.exp() - oracle.exp())
                / torch.linalg.vector_norm(oracle.exp())).item()

    assert dist(kern) <= 3 * dist(plain) + 4e-3
    assert np.isfinite(dist(kern))


@pytest.mark.parametrize("n,v,c1,d,h,w", [(2, 1, 5, 8, 12, 16),
                                          (4, 2, 67, 16, 13, 21),
                                          (6, 3, 7, 4, 9, 30),
                                          (1, 1, 67, 64, 64, 96)])
def test_sweep_backward_kernel_matches_plain(dev, n, v, c1, d, h, w):
    gen = torch.Generator().manual_seed(n + c1 + h + 1)
    bf = torch.bfloat16
    args = (_randn(gen, n, c1, h, w).to(dev, bf),
            _randn(gen, n // v, c1, h, w).to(dev, bf),
            _randn(gen, n, d, h, w).to(dev, bf),
            (torch.rand(n, d, w, w, generator=gen) * 0.2).to(dev, bf),
            (torch.rand(n, d, h, h, generator=gen) * 0.2).to(dev, bf))
    gc = _randn(gen, n, d, h, w).to(dev)
    gd = _randn(gen, n, d, h, w).to(dev)
    before = sk.sweep_stage2.bwd_launches
    got = sk.sweep_stage2_bwd(*args, gc, gd, v)
    torch.cuda.synchronize()
    assert sk.sweep_stage2.bwd_launches == before + 1
    want = sk.sweep_stage2_bwd_plain(*args, gc, gd, v)
    for g, p_ in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == p_.shape
        torch.testing.assert_close(g, p_, rtol=0,
                                   atol=3e-2 * p_.abs().max().item())


def _sweep_band_args(gen, n, v, c1, d, h, w, tz, dev, ty=0.02):
    """Stage-2 inputs with the band matrices of ``sweep_mats`` (a camera
    step with a sideways part, ``ty`` m up and ``tz`` m forward), bf16 on
    the card, and f32 cotangents."""
    from depthestimation_tpu_torch.ops.plane_sweep import sweep_mats
    bf = torch.bfloat16
    tra = torch.zeros(n, 3)
    tra[:, 0] = -0.15 - 0.1 * torch.rand(n, generator=gen)
    tra[:, 1] = ty
    tra[:, 2] = tz
    intr = torch.tensor([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                         [0, 0, 1]]).repeat(n, 1, 1)
    rx, ry = sweep_mats(torch.linspace(5.0, 40.0, d), torch.eye(3).repeat(
        n, 1, 1), tra, intr, h, w)
    args = (_randn(gen, n, c1, h, w).to(dev, bf),
            _randn(gen, n // v, c1, h, w).to(dev, bf),
            _randn(gen, n, d, h, w).to(dev, bf),
            rx.transpose(-1, -2).contiguous().to(dev, bf),
            ry.contiguous().to(dev, bf))
    return args, (_randn(gen, n, d, h, w).to(dev),
                  _randn(gen, n, d, h, w).to(dev))


# the main path's shape (B=8 train step, V=1) and two odd ones
_SWEEP_BAND = [(8, 1, 67, 64, 64, 96), (4, 2, 67, 16, 13, 21),
               (6, 3, 7, 4, 9, 30)]
# (ty, tz) of the camera step: sideways, forward 0.5 m and 1.5 m (band
# path); 2.5 m back and 2 m up, whose near planes outgrow the buffers at
# the main path's shape, so one launch mixes band and separable blocks
# (the vertical step also leaves the image: all-zero rows of Ry)
_SWEEP_STEPS = {"sideways": (0.0, 0.0), "forward": (0.02, 0.5),
                "forward1.5": (0.02, 1.5), "back2.5": (0.02, -2.5),
                "up2": (2.0, 0.0)}


@pytest.mark.parametrize("n,v,c1,d,h,w", _SWEEP_BAND)
@pytest.mark.parametrize("step", list(_SWEEP_STEPS))
def test_sweep_kernels_on_band_inputs_match_plain(dev, n, v, c1, d, h, w,
                                                 step):
    """sweep_mats' matrices: cost and diag within 1% of max|plain|, the
    gradients 3% (rule 3)."""
    ty, tz = _SWEEP_STEPS[step]
    gen = torch.Generator().manual_seed(n + c1 + h + int(10 * tz))
    args, (gc, gd) = _sweep_band_args(gen, n, v, c1, d, h, w, tz, dev, ty)
    got = sk.sweep_stage2(*args, v)
    want = sk.sweep_stage2_plain(*args, v)
    for g, p_ in zip(got, want):
        torch.testing.assert_close(g, p_, rtol=0,
                                   atol=1e-2 * p_.abs().max().item())
    got = sk.sweep_stage2_bwd(*args, gc, gd, v)
    want = sk.sweep_stage2_bwd_plain(*args, gc, gd, v)
    for g, p_ in zip(got, want):
        torch.testing.assert_close(g, p_, rtol=0,
                                   atol=3e-2 * p_.abs().max().item())


@pytest.mark.parametrize("shift", [1, -3])
def test_sweep_kernels_on_shifted_rows_match_plain(dev, shift):
    """Ry a one-tap row shift at every depth (an integer vertical step):
    the sideways path's taps with Ry != I, so the rows of dw a strip needs
    lie outside it; rule 3 at the main path's shape."""
    gen = torch.Generator().manual_seed(16 + shift)
    n, h = 2, 64
    args, (gc, gd) = _sweep_band_args(gen, n, 1, 67, 16, h, 96, 0.0, dev,
                                      0.0)
    ry = torch.eye(h).roll(shift, 1)
    ry = ry.triu(shift) if shift > 0 else ry.tril(shift)
    args = args[:4] + (ry.expand(n, 16, h, h).contiguous().to(
        dev, torch.bfloat16),)
    for got, want, k in (
            (sk.sweep_stage2(*args, 1), sk.sweep_stage2_plain(*args, 1),
             1e-2),
            (sk.sweep_stage2_bwd(*args, gc, gd, 1),
             sk.sweep_stage2_bwd_plain(*args, gc, gd, 1), 3e-2)):
        for g, p_ in zip(got, want):
            torch.testing.assert_close(g, p_, rtol=0,
                                       atol=k * p_.abs().max().item())


@pytest.mark.parametrize("tz", [0.0, 0.5, -2.5])
def test_sweep_kernels_repeat_bit_for_bit(dev, tz):
    """No atomics: two launches of each direction give equal bits (at
    -2.5 m a launch at the main path's shape mixes both paths)."""
    gen = torch.Generator().manual_seed(14)
    n, v, c1, d, h, w = ((2, 1, 67, 64, 64, 96) if tz < -2
                         else (4, 2, 67, 16, 13, 21))
    args, (gc, gd) = _sweep_band_args(gen, n, v, c1, d, h, w, tz, dev)
    first = sk.sweep_stage2(*args, v) + sk.sweep_stage2_bwd(*args, gc, gd, v)
    second = sk.sweep_stage2(*args, v) + sk.sweep_stage2_bwd(*args, gc, gd,
                                                              v)
    torch.cuda.synchronize()
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_sweep_call_launches_only_its_kernels(dev, direction):
    """A call runs the band-taps pass and its direction's kernel, no
    PyTorch kernel (no zero fill, no helper op), and counts one launch."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(15)
    args, (gc, gd) = _sweep_band_args(gen, 2, 1, 67, 16, 64, 96, 0.5, dev)
    if direction == "forward":
        run, count, want = (lambda: sk.sweep_stage2(*args, 1)), "launches", \
            "sweep_fwd_kernel"
    else:
        run, count, want = (lambda: sk.sweep_stage2_bwd(*args, gc, gd, 1)), \
            "bwd_launches", "sweep_bwd_kernel"
    run()
    torch.cuda.synchronize()
    before = getattr(sk.sweep_stage2, count)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    assert getattr(sk.sweep_stage2, count) == before + 1
    names = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and ev.key and not ev.key.startswith("cuda"):
            names.append(ev.key)
    assert len(names) == 2, names
    assert any(want in nm for nm in names), names
    assert any("band_taps_kernel" in nm for nm in names), names


# the forward's shapes, then the wgmma tiling's edges: widths and heights
# no multiple of the 8x16 unit, one row, C = 32 with F = 32 at a ragged
# width
_CC_BWD_SHAPES = [(16, 8, 5, 32, 12, 16), (16, 8, 32, 1, 7, 9),
                  (40, 20, 8, 16, 9, 11), (3, 1, 5, 8, 6, 10),
                  (64, 64, 32, 32, 64, 96), (8, 4, 32, 32, 9, 23),
                  (1, 1, 16, 1, 5, 7), (6, 3, 17, 11, 3, 33),
                  (128, 64, 3, 32, 64, 96)]


@pytest.mark.parametrize("n,depth,c,f,h,w", _CC_BWD_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_convcomb_backward_kernel_matches_plain(dev, n, depth, c, f, h, w,
                                               relu):
    """The bounds of tests/test_convcomb_pallas.py:99-122: dx within 3% of
    max away from the ReLU boundary, dW 3%, da and db 10%."""
    gen = torch.Generator().manual_seed(n + c + f + relu + 1)
    bf = torch.bfloat16
    x = _randn(gen, n, c, h * w).to(dev, bf)
    wm = _randn(gen, 3 * f, c, 3, 3, scale=0.2).to(dev, bf)
    a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
    b = _randn(gen, c, scale=0.1).to(dev)
    y, _ = ck.convbn_block_plain(x, wm, a, b, depth, h, w, relu)
    gy = _randn(gen, n, f, h * w, scale=0.1).to(dev, bf)
    gs = _randn(gen, f, 2, scale=1e-3).to(dev)
    args = (x, wm, a, b, y, gy, gs, depth, h, w, relu)
    before = ck.convbn_block.bwd_launches
    got = ck.convbn_block_bwd(*args)
    torch.cuda.synchronize()
    assert ck.convbn_block.bwd_launches == before + 1
    want = ck.convbn_block_bwd_plain(*args)
    v = x.float() * a[None, :, None] + b[None, :, None]
    inner = v.abs() > 0.02 if relu else torch.ones_like(v, dtype=torch.bool)
    assert got[0].dtype == torch.bfloat16 and got[1].shape == wm.shape
    for g, p_, tol, m in zip(got, want, (0.03, 0.03, 0.10, 0.10),
                             (inner, None, None, None)):
        g, p_ = g.float(), p_.float()
        if m is not None:
            g, p_ = g[m], p_[m]
        torch.testing.assert_close(g, p_, rtol=0,
                                   atol=tol * p_.abs().max().item() + 1e-6)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    bf = torch.bfloat16
    t = torch.zeros(2, 3, 4, 5, device=dev, dtype=bf)
    bw = torch.zeros(2, 3, 5, 5, device=dev, dtype=bf)
    bh = torch.zeros(2, 3, 4, 4, device=dev, dtype=bf)
    g = torch.zeros(2, 3, 4, 5, device=dev)
    with pytest.raises(ValueError):                # bf16 cotangent
        sk.sweep_stage2_bwd(t, t, t, bw, bh, g.to(bf), g, 1)
    with pytest.raises(ValueError):                # wrong shape
        sk.sweep_stage2_bwd(t, t, t, bw, bh, g[:, :2], g, 1)
    x = torch.zeros(8, 33, 6, device=dev, dtype=bf)
    wm = torch.zeros(3, 33, 3, 3, device=dev, dtype=bf)
    ab = torch.ones(33, device=dev)
    y = torch.zeros(8, 1, 6, device=dev, dtype=bf)
    st = torch.zeros(1, 2, device=dev)
    with pytest.raises(ValueError):                # C > 32
        ck.convbn_block_bwd(x, wm, ab, ab, y, y, st, 8, 2, 3)
    with pytest.raises(ValueError):                # f32 output cotangent
        ck.convbn_block_bwd(x[:, :4], wm[:, :4], ab[:4], ab[:4], y,
                            y.float(), st, 8, 2, 3)


def _train_cfg(dtype, convbn2d):
    from depthestimation_tpu_torch.config import config_from_dict
    return config_from_dict({
        "data": {"model_name": "base", "loss_name": "base"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "feature_dim": 16,
                "ndepth": 16, "nmode": "exp7_lc", "bn_avg": False},
        "loss": {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0,
                 "smooth_mul": 0.5, "dc_mul": 0.25, "rsc_low_mul": 0.0},
        "train": {"lr": 1e-5, "optim": "adam", "weight_decay": 1e-6},
        "tpu": {"dtype": dtype, "convbn2d": convbn2d}})


def _counts():
    return (sk.sweep_stage2.launches, sk.sweep_stage2.bwd_launches,
            ck.convbn_block.launches, ck.convbn_block.bwd_launches,
            c2.convbn2d_block.launches, c2.convbn2d_block.bwd_launches)


def _step_rule4(dev, convbn2d, want):
    """One train step at a small size through the kernels, through their
    plain versions and in f32 from the same weights: the kernel step
    launches ``want`` (sweep fwd, bwd, convcomb fwd, bwd, convbn2d fwd,
    bwd), and its loss and gradients are held to the f32 step by rule 4
    against the plain bf16 step."""
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    mi_np, gt_np = make_batch(batch=2, h=48, w=72, d_min=3.0, d_max=30.0,
                              ndepth=16)
    mi, gt = to_device(mi_np, dev), to_device(gt_np, dev)
    base = get_model(_train_cfg("bfloat16", convbn2d), dev, 0)
    grads, losses = {}, {}
    for name, dtype, kernels in (("kernel", "bfloat16", True),
                                 ("plain", "bfloat16", False),
                                 ("f32", "float32", False)):
        cfg = _train_cfg(dtype, convbn2d)
        model = get_model(cfg, dev)
        model.load_state_dict(base.state_dict())
        model.use_kernels = kernels
        counts = _counts()
        step = make_train_step(get_loss(cfg))
        _, loss, _ = step(init_state(model, cfg), mi, mi, gt, gt)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), counts))
        assert got == (want if kernels else (0,) * 6), name
        losses[name] = loss.item()
        grads[name] = torch.cat([p.grad.flatten()
                                 for p in model.parameters()])
        assert np.isfinite(losses[name])
        assert torch.isfinite(grads[name]).all()

    def dist(k):
        return (torch.linalg.vector_norm(grads[k] - grads["f32"])
                / torch.linalg.vector_norm(grads["f32"])).item()

    assert dist("kernel") <= 3 * dist("plain") + 4e-3
    assert (abs(losses["kernel"] - losses["f32"])
            <= 3 * abs(losses["plain"] - losses["f32"])
            + 4e-3 * abs(losses["f32"]))


def test_bf16_train_step_through_all_four_kernels(dev):
    """The eager encoder and decoder (``tpu.convbn2d: false``): the sweep
    and Base3D kernels per camera side (sweep 1 + 1, Base3D 8 + 8)."""
    _step_rule4(dev, False, (2, 2, 16, 16, 0, 0))


def test_bf16_train_step_through_the_convbn2d_kernels(dev):
    """``tpu.convbn2d`` "auto" (the encoder's fused chain in training, 14
    layers at feature_dim 16) and True (plus the decoder's tail, 3 more):
    every kernel of the step, per camera side."""
    _step_rule4(dev, "auto", (2, 2, 16, 16, 28, 28))
    _step_rule4(dev, True, (2, 2, 16, 16, 34, 34))


def _convbn2d_data(gen, n, c, f, h, w, dev):
    bf = torch.bfloat16
    x = _randn(gen, n, c, h, w).to(dev, bf)
    wt = _randn(gen, f, c, 3, 3, scale=0.2).to(dev, bf)
    a = (torch.rand(c, generator=gen) * 0.5 + 0.75).to(dev)
    b = _randn(gen, c, scale=0.1).to(dev)
    return x, wt, a, b


_C2_SHAPES = [(2, 8, 8, 8, 16), (3, 12, 12, 9, 13), (2, 5, 40, 7, 21),
              (4, 32, 32, 16, 24), (2, 64, 64, 16, 24), (1, 67, 67, 12, 20),
              (1, 67, 64, 8, 16), (2, 80, 33, 10, 35)]
# the wgmma tiling's edges: C = F = 80, one image, F = 1, odd widths, h
# and w no multiple of the 8x16 unit, the decoder tail's C = 67 -> 67, 64
# at a width that is a multiple of 8 with a ragged last tile
_C2_EDGES = [(1, 80, 80, 9, 37), (1, 16, 1, 3, 5), (3, 48, 17, 17, 33),
             (1, 67, 67, 10, 40), (2, 67, 64, 9, 24)]


@pytest.mark.parametrize("n,c,f,h,w", _C2_SHAPES + _C2_EDGES)
@pytest.mark.parametrize("act", c2.ACTS)
def test_convbn2d_kernel_matches_plain(dev, n, c, f, h, w, act):
    """The bounds of tests/test_convbn2d_pallas.py: y within 3% of max|y|,
    stats rtol 3% and atol 1e-2 N H W."""
    gen = torch.Generator().manual_seed(n + c + f + h)
    x, wt, a, b = _convbn2d_data(gen, n, c, f, h, w, dev)
    before = c2.convbn2d_block.launches
    y, st = c2.convbn2d_block(x, wt, a, b, act)
    torch.cuda.synchronize()
    assert c2.convbn2d_block.launches == before + 1
    y_p, st_p = c2.convbn2d_block_plain(x, wt, a, b, act)
    assert y.dtype == torch.bfloat16 and y.shape == y_p.shape
    scale = y_p.float().abs().max().item()
    torch.testing.assert_close(y.float(), y_p.float(), rtol=0,
                               atol=0.03 * scale)
    torch.testing.assert_close(st, st_p, rtol=3e-2, atol=1e-2 * n * h * w)


# the forward's shapes, then the wgmma tiling's edges: C = F = 80, one
# image, widths no multiple of the 8x16 unit
_C2_BWD_SHAPES = _C2_SHAPES + _C2_EDGES[:3]


@pytest.mark.parametrize("n,c,f,h,w", _C2_BWD_SHAPES)
@pytest.mark.parametrize("act", c2.ACTS)
def test_convbn2d_backward_kernel_matches_plain(dev, n, c, f, h, w, act):
    """dx within 3% of max where |v| > 0.02 (away from the activation's
    kink), dW 3%, da and db 10% (tests/test_convbn2d_pallas.py)."""
    gen = torch.Generator().manual_seed(n + c + f + h + 1)
    x, wt, a, b = _convbn2d_data(gen, n, c, f, h, w, dev)
    y, _ = c2.convbn2d_block_plain(x, wt, a, b, act)
    gy = _randn(gen, n, f, h, w, scale=0.1).to(dev, torch.bfloat16)
    gs = _randn(gen, f, 2, scale=1e-3).to(dev)
    args = (x, wt, a, b, y, gy, gs, act)
    before = c2.convbn2d_block.bwd_launches
    got = c2.convbn2d_block_bwd(*args)
    torch.cuda.synchronize()
    assert c2.convbn2d_block.bwd_launches == before + 1
    want = c2.convbn2d_block_bwd_plain(*args)
    v = x.float() * a[None, :, None, None] + b[None, :, None, None]
    inner = (v.abs() > 0.02 if act != "none"
             else torch.ones_like(v, dtype=torch.bool))
    assert got[0].dtype == torch.bfloat16 and got[1].shape == wt.shape
    for g, p_, tol, m in zip(got, want, (0.03, 0.03, 0.10, 0.10),
                             (inner, None, None, None)):
        g, p_ = g.float(), p_.float()
        if m is not None:
            g, p_ = g[m], p_[m]
        torch.testing.assert_close(g, p_, rtol=0,
                                   atol=tol * p_.abs().max().item() + 1e-6)


@pytest.mark.parametrize("layer", ["convbn2d", "convcomb"])
def test_backward_kernels_repeat_bit_for_bit(dev, layer):
    """No atomics: two launches on the same inputs give equal dx, dW, da
    and db."""
    gen = torch.Generator().manual_seed(11)
    bf = torch.bfloat16
    if layer == "convbn2d":
        x, wt, a, b = _convbn2d_data(gen, 4, 64, 64, 19, 37, dev)
        y, _ = c2.convbn2d_block_plain(x, wt, a, b, "relu")
        args = (x, wt, a, b, y,
                _randn(gen, *y.shape, scale=0.1).to(dev, bf),
                _randn(gen, 64, 2, scale=1e-3).to(dev), "relu")
        run = c2.convbn2d_block_bwd
    else:
        x = _randn(gen, 64, 32, 24 * 40).to(dev, bf)
        wt = _randn(gen, 96, 32, 3, 3, scale=0.2).to(dev, bf)
        a = (torch.rand(32, generator=gen) * 0.5 + 0.75).to(dev)
        b = _randn(gen, 32, scale=0.1).to(dev)
        y, _ = ck.convbn_block_plain(x, wt, a, b, 16, 24, 40, True)
        args = (x, wt, a, b, y, _randn(gen, *y.shape, scale=0.1).to(dev, bf),
                _randn(gen, 32, 2, scale=1e-3).to(dev), 16, 24, 40, True)
        run = ck.convbn_block_bwd
    first = run(*args)
    second = run(*args)
    torch.cuda.synchronize()
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


def _forward_case(layer, gen, dev):
    """(the forward wrapper's call, its launch counter) at a ragged shape"""
    if layer == "convbn2d":
        x, wt, a, b = _convbn2d_data(gen, 4, 64, 64, 19, 37, dev)
        return (lambda: c2.convbn2d_block(x, wt, a, b, "relu"),
                c2.convbn2d_block)
    x = _randn(gen, 64, 32, 24 * 40).to(dev, torch.bfloat16)
    wm = _randn(gen, 96, 32, 3, 3, scale=0.2).to(dev, torch.bfloat16)
    a = (torch.rand(32, generator=gen) * 0.5 + 0.75).to(dev)
    b = _randn(gen, 32, scale=0.1).to(dev)
    return (lambda: ck.convbn_block(x, wm, a, b, 16, 24, 40, True),
            ck.convbn_block)


@pytest.mark.parametrize("layer", ["convbn2d", "convcomb"])
def test_forward_kernels_repeat_bit_for_bit(dev, layer):
    """No atomics: two launches on the same inputs give equal y and
    stats."""
    run, _ = _forward_case(layer, torch.Generator().manual_seed(12), dev)
    first = run()
    second = run()
    torch.cuda.synchronize()
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("layer", ["convbn2d", "convcomb"])
def test_forward_call_launches_only_its_kernels(dev, layer):
    """A forward call runs the layer's kernel and its stats reduce and no
    PyTorch kernel of its own (the weights are read in the module's
    layout, not packed per call)."""
    from torch.profiler import ProfilerActivity, profile
    run, counter = _forward_case(layer, torch.Generator().manual_seed(13),
                                 dev)
    run()
    torch.cuda.synchronize()
    before = counter.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    assert counter.launches == before + 1
    names = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and ev.key and not ev.key.startswith(("aten::", "cuda")):
            names.append(ev.key)
    want = "convbn2d_kernel" if layer == "convbn2d" else "ring_kernel"
    assert len(names) == 2, names
    assert any(want in nm for nm in names), names
    assert any("stats_reduce_kernel" in nm for nm in names), names
    assert not any("at::" in nm or "aten" in nm for nm in names), names


def test_convbn2d_autograd_runs_the_kernels(dev):
    """Gradients through the autograd Function equal the backward kernel's
    on the same cotangents, and each direction counts one launch."""
    gen = torch.Generator().manual_seed(3)
    x, wt, a, b = _convbn2d_data(gen, 2, 32, 32, 16, 24, dev)
    leaves = [t.clone().requires_grad_() for t in (x, wt, a, b)]
    f0, b0 = c2.convbn2d_block.launches, c2.convbn2d_block.bwd_launches
    y, st = c2.convbn2d_block(*leaves, "relu")
    gy = _randn(gen, *y.shape, scale=0.1).to(dev, torch.bfloat16)
    gs = _randn(gen, 32, 2, scale=1e-3).to(dev)
    torch.autograd.backward((y, st), (gy, gs))
    torch.cuda.synchronize()
    assert (c2.convbn2d_block.launches - f0,
            c2.convbn2d_block.bwd_launches - b0) == (1, 1)
    want = c2.convbn2d_block_bwd(x, wt, a, b, y.detach(), gy, gs, "relu")
    for leaf, w_ in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w_.to(leaf.dtype), rtol=0,
                                   atol=0)


def test_convbn2d_wrappers_refuse_what_the_kernels_do_not_take(dev):
    bf = torch.bfloat16
    x = torch.zeros(2, 4, 6, 8, device=dev, dtype=bf)
    wt = torch.zeros(5, 4, 3, 3, device=dev, dtype=bf)
    ab = torch.ones(4, device=dev)
    with pytest.raises(TypeError):                 # f32 activations
        c2.convbn2d_block(x.float(), wt, ab, ab)
    with pytest.raises(TypeError):                 # bf16 coefficients
        c2.convbn2d_block(x, wt, ab.to(bf), ab)
    with pytest.raises(ValueError):                # not contiguous
        c2.convbn2d_block(x.transpose(2, 3).contiguous().transpose(2, 3),
                          wt, ab, ab)
    with pytest.raises(ValueError):                # unknown activation
        c2.convbn2d_block(x, wt, ab, ab, "gelu")
    with pytest.raises(ValueError):                # 5x5 kernel
        c2.convbn2d_block(x, torch.zeros(5, 4, 5, 5, device=dev, dtype=bf),
                          ab, ab)
    with pytest.raises(ValueError):                # C > 80
        big = torch.ones(81, device=dev)
        c2.convbn2d_block(torch.zeros(1, 81, 4, 4, device=dev, dtype=bf),
                          torch.zeros(8, 81, 3, 3, device=dev, dtype=bf),
                          big, big)
    with pytest.raises(ValueError):                # F > 80
        c2.convbn2d_block(x, torch.zeros(96, 4, 3, 3, device=dev, dtype=bf),
                          ab, ab)
    y = torch.zeros(2, 5, 6, 8, device=dev, dtype=bf)
    st = torch.zeros(5, 2, device=dev)
    with pytest.raises(ValueError):                # f32 output cotangent
        c2.convbn2d_block_bwd(x, wt, ab, ab, y, y.float(), st)
    with pytest.raises(ValueError):                # wrong stats shape
        c2.convbn2d_block_bwd(x, wt, ab, ab, y, y, st[:4])


# ---- tap_combine: the flat Conv3d's depth-tap combine (csrc/tap_combine.cu)

from depthestimation_tpu_torch.ops import combine_kernel as tc  # noqa: E402

# (N, depth, F, H, W): the vector path, runs that are no multiple of the
# 16-byte vector (the scalar path), F = 1, depth 1 (both edges on every row)
_TC_SHAPES = [(16, 8, 32, 12, 16), (6, 3, 1, 5, 7), (8, 4, 3, 3, 5),
              (4, 1, 2, 4, 4), (64, 64, 1, 64, 96), (128, 64, 32, 64, 96)]


@pytest.mark.parametrize("n,depth,f,h,w", _TC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tap_combine_kernels_equal_plain_bit_for_bit(dev, n, depth, f, h, w,
                                                     dtype):
    """No multiply and a fixed order of f32 sums: forward and backward
    equal their plain versions exactly, in bf16 and in f32."""
    gen = torch.Generator().manual_seed(n + f + h)
    t = _randn(gen, n, 3 * f, h, w).to(dev, dtype)
    before = (tc.tap_combine.launches, tc.tap_combine.bwd_launches)
    y = tc.tap_combine(t, depth)
    g = _randn(gen, n, f, h, w).to(dev, dtype)
    dt = tc.tap_combine_bwd(g, depth)
    torch.cuda.synchronize()
    assert (tc.tap_combine.launches, tc.tap_combine.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == dtype and y.shape == (n, f, h, w)
    assert torch.equal(y, tc.tap_combine_plain(t, depth))
    assert dt.dtype == dtype and dt.shape == t.shape
    assert torch.equal(dt, tc.tap_combine_bwd_plain(g, depth))


def test_tap_combine_takes_an_unaligned_view(dev):
    """A contiguous view whose storage does not start on 16 bytes takes
    the scalar kernel and still equals the plain version."""
    gen = torch.Generator().manual_seed(3)
    buf = _randn(gen, 8 * 12 * 4 * 8 + 1).to(dev, torch.bfloat16)
    t = buf[1:].reshape(8, 12, 4, 8)
    assert t.is_contiguous() and t.data_ptr() % 16
    assert torch.equal(tc.tap_combine(t, 4), tc.tap_combine_plain(t, 4))


def test_tap_combine_autograd_runs_the_backward_kernel(dev):
    gen = torch.Generator().manual_seed(4)
    t = _randn(gen, 8, 6, 5, 7).to(dev).requires_grad_()
    g = _randn(gen, 8, 2, 5, 7).to(dev)
    before = tc.tap_combine.bwd_launches
    tc.tap_combine(t, 4).backward(g)
    torch.cuda.synchronize()
    assert tc.tap_combine.bwd_launches == before + 1
    tp = t.detach().clone().requires_grad_()
    tc.tap_combine_plain(tp, 4).backward(g)
    assert torch.equal(t.grad, tp.grad)


def test_tap_combine_refuses_what_the_kernel_does_not_take(dev):
    t = torch.zeros(8, 6, 4, 4, device=dev)
    with pytest.raises(TypeError):                 # f16
        tc.tap_combine(t.half(), 4)
    with pytest.raises(ValueError):                # rows not a multiple of D
        tc.tap_combine(t, 3)
    with pytest.raises(ValueError):                # channels not 3F
        tc.tap_combine(t[:, :5].contiguous(), 4)
    with pytest.raises(ValueError):                # not contiguous
        tc.tap_combine(t.transpose(2, 3), 4)
    with pytest.raises(ValueError):
        tc.tap_combine_bwd(t.transpose(2, 3), 4)


def test_bf16_train_step_through_the_flat_route(dev):
    """``tpu.convcomb_pallas: false, tpu.combine_pallas: true``: Base3D
    runs the flat stack and each of its 8 convs combines through the
    kernel, per camera side, forward and backward; the fused Base3D kernel
    is not launched. Loss and gradients by rule 4 against the same route
    on the plain version."""
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    def cfg_of(dtype):
        cfg = _train_cfg(dtype, "auto")
        cfg.tpu.convcomb_pallas = False
        cfg.tpu.combine_pallas = True
        return cfg

    mi_np, gt_np = make_batch(batch=2, h=48, w=72, d_min=3.0, d_max=30.0,
                              ndepth=16)
    mi, gt = to_device(mi_np, dev), to_device(gt_np, dev)
    base = get_model(cfg_of("bfloat16"), dev, 0)
    assert base.conv3d_path() == "flat+tap_combine"
    grads, losses = {}, {}
    for name, dtype, kernels in (("kernel", "bfloat16", True),
                                 ("plain", "bfloat16", False),
                                 ("f32", "float32", False)):
        cfg = cfg_of(dtype)
        model = get_model(cfg, dev)
        model.load_state_dict(base.state_dict())
        model.use_kernels = kernels
        counts = _counts() + (tc.tap_combine.launches,
                              tc.tap_combine.bwd_launches)
        step = make_train_step(get_loss(cfg))
        _, loss, _ = step(init_state(model, cfg), mi, mi, gt, gt)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(
            _counts() + (tc.tap_combine.launches,
                         tc.tap_combine.bwd_launches), counts))
        assert got == ((2, 2, 0, 0, 28, 28, 16, 16) if kernels
                       else (0,) * 8), name
        losses[name] = loss.item()
        grads[name] = torch.cat([p.grad.flatten()
                                 for p in model.parameters()])
        assert torch.isfinite(grads[name]).all()

    def dist(k):
        return (torch.linalg.vector_norm(grads[k] - grads["f32"])
                / torch.linalg.vector_norm(grads["f32"])).item()

    assert dist("kernel") <= 3 * dist("plain") + 4e-3
    assert (abs(losses["kernel"] - losses["f32"])
            <= 3 * abs(losses["plain"] - losses["f32"])
            + 4e-3 * abs(losses["f32"]))


@pytest.mark.parametrize("max_alpha", [None, 4.0e7])
def test_planner_on_the_card_gives_the_cpu_design_points(dev, max_alpha):
    """Ties decide paths: the batched DP's ``max`` and ``argmax`` must
    return the first maximum on the card as on the CPU (infeasible hops
    all score exactly -1e30)."""
    from depthestimation_tpu_torch.lc import LCDevice, PlannerRT
    from depthestimation_tpu_torch.ops.dpv import powerf

    w, r = 48, 24
    intr = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, 16], [0, 0, 1]],
                    np.float32)
    ltc = np.eye(4, dtype=np.float32)
    ltc[0, 3] = 0.2
    laser = {"lTc": ltc, "fov": 80.0, "laser_timestep": 2e-4}
    if max_alpha is not None:
        laser["max_alpha"] = max_alpha
    cam = {"width": w, "height": 32, "matrix": intr,
           "distortion": [0.0] * 5, "hit_mode": 1, "hit_noise": 0.0}
    rs = np.random.RandomState(0)
    field = rs.rand(3, r, w).astype(np.float32)
    field[1] = np.round(field[1] * 4) / 4          # many exact ties
    field[2, :, ::3] = 0.0
    pts = {}
    for d in ("cpu", dev):
        planner = PlannerRT(LCDevice(cam, laser, d), powerf(3, 30, r, 1.0), w)
        pts[str(d)] = planner.get_design_points(
            torch.from_numpy(field).to(d)).cpu()
    assert torch.equal(pts["cpu"], pts[str(dev)])


def _dp_planners(dev, w, r, max_omega=None, timestep=3.5e-5):
    """The same planner on the CPU and on the card: ``w`` rays of a 80
    degree fan, ``r`` ranges from 3 to 30 m, the laser 0.2 m to the side."""
    from depthestimation_tpu_torch.lc import LCDevice, PlannerRT
    from depthestimation_tpu_torch.ops.dpv import powerf

    intr = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, 16], [0, 0, 1]],
                    np.float32)
    ltc = np.eye(4, dtype=np.float32)
    ltc[0, 3] = 0.2
    laser = {"lTc": ltc, "fov": 80.0, "laser_timestep": timestep}
    if max_omega is not None:
        laser["max_omega"] = max_omega
    cam = {"width": w, "height": 32, "matrix": intr,
           "distortion": [0.0] * 5, "hit_mode": 1, "hit_noise": 0.0}
    return tuple(PlannerRT(LCDevice(cam, laser, d), powerf(3, 30, r, 1.0), w)
                 for d in ("cpu", dev))


def _dp_fields(m, r, w, seed):
    """m fields cycling through: uniform, many exact ties, flat columns,
    scattered NaN and +-inf, whole NaN columns."""
    rs = np.random.RandomState(seed)
    f = rs.rand(m, r, w).astype(np.float32)
    for i in range(m):
        kind = i % 5
        if kind == 1:
            f[i] = np.round(f[i] * 4) / 4
        elif kind == 2:
            f[i, :, ::3] = 0.0
        elif kind == 3:
            n = max(1, r * w // 50)
            for v in (np.nan, np.inf, -np.inf):
                f[i, rs.randint(0, r, n), rs.randint(0, w, n)] = v
        elif kind == 4:
            f[i, :, rs.randint(0, w, max(1, w // 8))] = np.nan
    return torch.from_numpy(f)


# (M, R, C, max_omega): the LC-on train step's solve (48 fields of 128
# ranges on 768 rays) and planner_small's 192 rays; one field; R no
# multiple of 32 (S = 16, 8, 2 lanes a node); R > 256 (16-bit
# back-pointers) and R = 1024 with them in device memory; and a galvo so
# slow that some nodes have no feasible predecessor
_DP_SHAPES = [(48, 128, 768, None), (48, 128, 192, None), (1, 128, 768, None),
              (3, 24, 48, None), (5, 37, 40, None), (7, 200, 96, None),
              (2, 300, 64, None), (2, 1024, 160, None), (6, 128, 768, 1500.0),
              (5, 40, 64, 800.0)]


@pytest.mark.parametrize("m,r,w,omega", _DP_SHAPES)
def test_planner_dp_kernel_equals_the_plain_solve(dev, m, r, w, omega):
    """The kernel's range indices and design points equal ``_dp_solve``'s
    on the CPU to the bit, ties, NaN and infinities included, with one
    launch a solve."""
    from depthestimation_tpu_torch.lc.planner import _dp_solve
    from depthestimation_tpu_torch.ops import planner_dp_kernel as pk

    cpu, card = _dp_planners(dev, w, r, omega)
    pen = cpu._penalty_of(0, w - 1)
    if omega is not None:        # some node has no feasible predecessor
        assert not bool((pen == 0).any(dim=1).all())
    field = _dp_fields(m, r, w, seed=m + r + w)
    want_idx = _dp_solve(field, pen)
    want = cpu._xz[torch.arange(w), want_idx]
    before = pk.planner_dp.launches
    got, idx = pk.planner_dp(field.to(dev), card._kernel_bits(), card._xz)
    torch.cuda.synchronize()
    assert pk.planner_dp.launches == before + 1
    assert torch.equal(idx.cpu(), want_idx)
    assert torch.equal(got.cpu(), want)
    again, _ = pk.planner_dp(field.to(dev), card._kernel_bits(), card._xz)
    assert torch.equal(again, got)
    pts = card.get_design_points(field.to(dev).reshape(1, m, r, w))
    assert pk.planner_dp.launches == before + 3
    assert torch.equal(pts.cpu(), want.reshape(1, m, w, 2))


def test_planner_solve_launches_only_its_kernel(dev):
    """``get_design_points`` on the card at the LC-on step's shape runs the
    kernel and no PyTorch kernel (once the bits exist), and counts one
    launch; a CPU field leaves it as it was."""
    from conv_bwd_split import device_launches, device_times
    from depthestimation_tpu_torch.ops import planner_dp_kernel as pk

    cpu, card = _dp_planners(dev, 768, 128)
    field = _dp_fields(48, 128, 768, seed=3).to(dev)
    card.get_design_points(field)
    torch.cuda.synchronize()
    before = pk.planner_dp.launches
    names = list(device_times(lambda: card.get_design_points(field), 1))
    assert len(names) == 1 and "planner_dp_kernel" in names[0], names
    assert device_launches(lambda: card.get_design_points(field)) == 1
    assert pk.planner_dp.launches == before + 4
    cpu.get_design_points(field.cpu()[:2])
    assert pk.planner_dp.launches == before + 4


# ---- correlation (csrc/correlation.cu) and the flat conv3d op
#      (csrc/conv3d_flat.cu), and a flow train step on the card

from depthestimation_tpu_torch.ops import conv3d_kernel as c3  # noqa: E402
from depthestimation_tpu_torch.ops import correlation as cr  # noqa: E402
from depthestimation_tpu_torch.ops import correlation_kernel as crk  # noqa: E402,E501

# (B, C, H, W, md): odd sizes, tiles cut at both edges, PWCLite's coarsest
# level, a search range below 4, fewer channels than a chunk; then
# PWCLite's five levels of a 384x832 pair at B=8 (the channels split
# across blocks at the coarse ones)
_CORR_SHAPES = [(2, 8, 11, 13, 4), (1, 192, 6, 13, 4), (3, 32, 20, 40, 2),
                (2, 16, 9, 70, 1), (1, 5, 3, 5, 3),
                (8, 192, 6, 13, 4), (8, 128, 12, 26, 4), (8, 96, 24, 52, 4),
                (8, 64, 48, 104, 4), (8, 32, 96, 208, 4)]


@pytest.mark.parametrize("b,c,h,w,md", _CORR_SHAPES)
def test_correlation_kernels_match_plain(dev, b, c, h, w, md):
    """Forward and backward within 1e-5 max|plain| (f32 sums in another
    order)."""
    gen = torch.Generator().manual_seed(b + c + h + md)
    x1 = _randn(gen, b, c, h, w).to(dev)
    x2 = _randn(gen, b, c, h, w).to(dev)
    g = _randn(gen, b, (2 * md + 1) ** 2, h, w).to(dev)
    before = (crk.correlate.launches, crk.correlate.bwd_launches)
    out = crk.correlate(x1, x2, md)
    dx1, dx2 = crk.correlate_bwd(x1, x2, g, md)
    torch.cuda.synchronize()
    assert (crk.correlate.launches, crk.correlate.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = cr.correlation_batched(x1, x2, md)
    assert out.shape == want.shape and out.dtype == torch.float32
    for got, ref in ((out, want),) + tuple(zip(
            (dx1, dx2), cr.correlation_bwd_plain(x1, x2, g, md))):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("b,c,h,w", [(8, 192, 6, 13), (8, 32, 96, 208)])
def test_correlation_kernels_repeat_bit_for_bit(dev, b, c, h, w):
    """No atomics: two launches give equal out (its channel groups added
    in a fixed order at the coarse level), dx1 and dx2."""
    gen = torch.Generator().manual_seed(c + h)
    x1 = _randn(gen, b, c, h, w).to(dev)
    x2 = _randn(gen, b, c, h, w).to(dev)
    g = _randn(gen, b, 81, h, w).to(dev)
    first = (crk.correlate(x1, x2),) + crk.correlate_bwd(x1, x2, g)
    second = (crk.correlate(x1, x2),) + crk.correlate_bwd(x1, x2, g)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_correlation_autograd_runs_the_backward_kernel(dev):
    gen = torch.Generator().manual_seed(5)
    x1 = _randn(gen, 2, 16, 12, 20).to(dev).requires_grad_()
    x2 = _randn(gen, 2, 16, 12, 20).to(dev).requires_grad_()
    g = _randn(gen, 2, 81, 12, 20).to(dev)
    before = crk.correlate.bwd_launches
    crk.correlate(x1, x2).backward(g)
    torch.cuda.synchronize()
    assert crk.correlate.bwd_launches == before + 1
    p1 = x1.detach().clone().requires_grad_()
    p2 = x2.detach().clone().requires_grad_()
    cr.correlation_batched(p1, p2).backward(g)
    for a, b in ((x1.grad, p1.grad), (x2.grad, p2.grad)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def test_correlation_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 4, 6, 8, device=dev)
    with pytest.raises(TypeError):                 # bf16: f32 only
        crk.correlate(x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError):                # md 5: 1 to 4 only
        crk.correlate(x, x, 5)
    with pytest.raises(ValueError):                # not contiguous
        crk.correlate(x.transpose(2, 3), x.transpose(2, 3))
    with pytest.raises(ValueError):                # shapes differ
        crk.correlate(x, x[:, :3].contiguous())
    with pytest.raises(ValueError):                # g of the wrong md
        crk.correlate_bwd(x, x, torch.zeros(1, 25, 6, 8, device=dev))


# (N, depth, C, F, H, W): chunks cut in C and F, tiles cut at both edges,
# depth 1 (both depth edges on every row), F = 3, Base3D's layer, and C > 32
# with F > 32 (two K chunks, two output groups; dx the other way round)
_C3_SHAPES = [(16, 8, 32, 32, 16, 24), (6, 3, 5, 40, 7, 9),
              (4, 4, 20, 3, 33, 37), (2, 1, 8, 8, 5, 6),
              (64, 64, 32, 32, 64, 96), (8, 4, 40, 36, 9, 20)]


@pytest.mark.parametrize("n,depth,c,f,h,w", _C3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_kernels_match_plain(dev, n, depth, c, f, h, w, dtype):
    """Forward, dx (the forward kernel reading the weight flipped and
    I/O-swapped, and the same over a flipped copy) and dW against the
    plain versions: f32 within 1e-4 max|plain|; bf16 y and dx (taps
    rounded to bf16) within 2^-6 max|plain|, dW (f32 sums) 1e-3."""
    gen = torch.Generator().manual_seed(n + c + f + h)
    x = _randn(gen, n, c, h, w).to(dev, dtype)
    wt = _randn(gen, f, c, 3, 3, 3, scale=0.1).to(dev)
    dy = _randn(gen, n, f, h, w, scale=0.1).to(dev, dtype)
    before = (c3.conv3d_flat.launches, c3.conv3d_flat.dw_launches)
    y = c3.conv3d_flat_fwd(x, wt, depth)
    dx = c3.conv3d_flat_fwd(dy, wt, depth, flip=True)
    dx_copy = c3.conv3d_flat_fwd(dy, c3.flip_weight(wt), depth)
    dw = c3.conv3d_flat_dw(x, dy, depth)
    torch.cuda.synchronize()
    assert (c3.conv3d_flat.launches, c3.conv3d_flat.dw_launches) == (
        before[0] + 3, before[1] + 1)
    assert torch.equal(dx, dx_copy)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for got, ref in ((y, c3.conv3d_flat_plain(x, wt, depth)),
                     (dx, c3.conv3d_flat_plain(dy, c3.flip_weight(wt),
                                               depth))):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=tol * ref.float().abs().max().item())
    ref = c3.conv3d_flat_dw_plain(x, dy, depth)
    assert dw.dtype == torch.float32 and dw.shape == wt.shape
    torch.testing.assert_close(dw, ref, rtol=0, atol=(
        1e-4 if dtype == torch.float32 else 1e-3) * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_kernels_repeat_bit_for_bit(dev, dtype):
    """No atomics: two launches give equal y, dx and dW (Base3D's layer
    shape, and C > 32 with F > 32)."""
    gen = torch.Generator().manual_seed(9)
    for n, depth, c, f, h, w in (_C3_SHAPES[4], _C3_SHAPES[5]):
        x = _randn(gen, n, c, h, w).to(dev, dtype)
        wt = _randn(gen, f, c, 3, 3, 3, scale=0.1).to(dev)
        dy = _randn(gen, n, f, h, w, scale=0.1).to(dev, dtype)

        def run():
            return (c3.conv3d_flat_fwd(x, wt, depth),
                    c3.conv3d_flat_fwd(dy, wt, depth, flip=True),
                    c3.conv3d_flat_dw(x, dy, depth))
        first, second = run(), run()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_conv3d_autograd_runs_the_kernels(dev):
    gen = torch.Generator().manual_seed(6)
    x = _randn(gen, 8, 6, 10, 12).to(dev).requires_grad_()
    wt = _randn(gen, 5, 6, 3, 3, 3, scale=0.2).to(dev).requires_grad_()
    g = _randn(gen, 8, 5, 10, 12).to(dev)
    before = (c3.conv3d_flat.launches, c3.conv3d_flat.dw_launches)
    c3.conv3d_flat(x, wt, 4).backward(g)
    torch.cuda.synchronize()
    assert (c3.conv3d_flat.launches, c3.conv3d_flat.dw_launches) == (
        before[0] + 2, before[1] + 1)
    xp = x.detach().clone().requires_grad_()
    wp = wt.detach().clone().requires_grad_()
    c3.conv3d_flat_plain(xp, wp, 4).backward(g)
    for a, b in ((x.grad, xp.grad), (wt.grad, wp.grad)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * b.abs().max().item())


def test_conv3d_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(8, 4, 5, 6, device=dev)
    wt = torch.zeros(3, 4, 3, 3, 3, device=dev)
    with pytest.raises(TypeError):                 # f16
        c3.conv3d_flat(x.half(), wt, 4)
    with pytest.raises(ValueError):                # rows not a multiple of D
        c3.conv3d_flat(x, wt, 3)
    with pytest.raises(ValueError):                # weight's C is not x's
        c3.conv3d_flat(x, wt[:, :3], 4)
    with pytest.raises(ValueError):                # not contiguous
        c3.conv3d_flat(x.transpose(2, 3), wt, 4)
    with pytest.raises(ValueError):                # dy of another dtype
        c3.conv3d_flat_dw(x, torch.zeros(8, 3, 5, 6, device=dev).bfloat16(),
                          4)


def test_flow_train_step_through_the_correlation_kernels(dev):
    """One SintelTrainer step on the card (PWCLite at output level 2,
    64x64, B=2): 3 correlation launches per two-frame pass forward, 6 in
    all, and 3 backward: the backward flows reach the loss only through
    the occlusion mask, a comparison, so no gradient runs through their
    pass (JAX's is zero there too). The loss and gradients of the kernel
    path against the plain path (f32 both): loss 1e-4 relative, gradient
    rel-L2 1e-3."""
    from depthestimation_tpu_torch.config import load_config
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models.pwclite import PWCLite, init_weights
    from depthestimation_tpu_torch.trainer.factory import get_trainer
    from depthestimation_tpu_torch.trainer.sintel import (
        synthetic_flow_batches)
    from depthestimation_tpu_torch.utils.logger import init_logger

    cfg = load_config("configs/sintel_flow.json")
    data = synthetic_flow_batches(1, batch=2, h=64, w=64)[0]
    base = PWCLite(output_level=2)
    init_weights(base, torch.Generator().manual_seed(0))
    losses, grads = {}, {}
    for kernels in (True, False):
        model = PWCLite(output_level=2).to(dev)
        model.load_state_dict(base.state_dict())
        model.use_kernels = kernels
        tr = get_trainer(cfg)(0, model, get_loss(cfg), init_logger(), "",
                              cfg)
        before = (crk.correlate.launches, crk.correlate.bwd_launches)
        loss, _ = tr._step(tr._img_pair(data))
        torch.cuda.synchronize()
        got = (crk.correlate.launches - before[0],
               crk.correlate.bwd_launches - before[1])
        assert got == ((6, 3) if kernels else (0, 0))
        losses[kernels] = loss.item()
        grads[kernels] = torch.cat([p.grad.flatten()
                                    for p in model.parameters()])
    assert np.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) <= 1e-4 * abs(losses[False])
    dist = (torch.linalg.vector_norm(grads[True] - grads[False])
            / torch.linalg.vector_norm(grads[False])).item()
    assert dist <= 1e-3, dist


def _second_card(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch on cuda:1 while "
                    "cuda:0 is current")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("layer", ["sweep", "convcomb", "convbn2d"])
def test_kernels_launch_on_their_tensors_card(dev, layer):
    """A data-parallel rank's tensors live on cuda:k: with cuda:0 current,
    the forward and backward on cuda:1 tensors launch there
    (``cuda_lib.launch``) and equal the same launches on cuda:0 bit for
    bit; the current device stays 0."""
    d0, d1 = _second_card(dev)
    gen = torch.Generator().manual_seed(21)
    bf = torch.bfloat16
    if layer == "sweep":
        n, v, c1, d, h, w = 2, 1, 5, 8, 12, 16
        args = [_randn(gen, n, c1, h, w), _randn(gen, n // v, c1, h, w),
                _randn(gen, n, d, h, w),
                torch.rand(n, d, w, w, generator=gen) * 0.2,
                torch.rand(n, d, h, h, generator=gen) * 0.2]
        args = [a.to(bf) for a in args]

        def run(t):
            return sk.sweep_stage2(*t, v)
    elif layer == "convcomb":
        args = [_randn(gen, 16, 32, 12 * 16).to(bf),
                _randn(gen, 96, 32, 3, 3, scale=0.2).to(bf),
                torch.rand(32, generator=gen) * 0.5 + 0.75,
                _randn(gen, 32, scale=0.1)]

        def run(t):
            return ck.convbn_block(*t, 8, 12, 16, True)
    else:
        x, wt, a, b = _convbn2d_data(gen, 2, 32, 32, 16, 24, "cpu")
        args = [x, wt, a, b]

        def run(t):
            return c2.convbn2d_block(*t, "relu")
    outs = {}
    with torch.cuda.device(d0):
        for card in (d1, d0):
            leaves = [a.to(card).requires_grad_() for a in args]
            ys = run(leaves)
            cot = [torch.ones_like(y) * 0.01 for y in ys]
            torch.autograd.backward(ys, cot)
            torch.cuda.synchronize(card)
            assert all(y.device == card for y in ys)
            outs[card] = [y.detach().cpu() for y in ys] + [
                leaf.grad.cpu() for leaf in leaves
                if leaf.grad is not None]
            assert torch.cuda.current_device() == 0
    for got, want in zip(outs[d1], outs[d0]):
        assert torch.equal(got, want)
