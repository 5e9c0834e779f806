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


@pytest.mark.parametrize("n,depth,c,f,h,w", [(16, 8, 5, 32, 12, 16),
                                             (16, 8, 32, 1, 7, 9),
                                             (40, 20, 8, 16, 9, 11),
                                             (3, 1, 5, 8, 6, 10),
                                             (64, 64, 32, 32, 64, 96)])
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


@pytest.mark.parametrize("n,depth,c,f,h,w", [(16, 8, 5, 32, 12, 16),
                                             (16, 8, 32, 1, 7, 9),
                                             (40, 20, 8, 16, 9, 11),
                                             (3, 1, 5, 8, 6, 10),
                                             (64, 64, 32, 32, 64, 96)])
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


@pytest.mark.parametrize("n,c,f,h,w", _C2_SHAPES)
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


@pytest.mark.parametrize("n,c,f,h,w", _C2_SHAPES)
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
