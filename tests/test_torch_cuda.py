"""The port's CUDA kernels on the card: each, forward and backward,
against its plain PyTorch version, the wrappers' input checks, their
launch counters, the bf16 forward through both forward kernels and the
bf16 train step through all four.

Marked ``cuda``: a hand-written kernel has no CPU mode, so these skip with
a reason on a machine without a CUDA device. The file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

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


def test_bf16_train_step_through_all_four_kernels(dev):
    """One train step at a small size launches each kernel per camera side
    (sweep 1 + 1, Base3D 8 + 8), and its gradients are held to an f32 step
    from the same weights by rule 4 against the plain bf16 step."""
    from depthestimation_tpu_torch.config import config_from_dict
    from depthestimation_tpu_torch.data.synthetic import make_batch, to_device
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models import get_model
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)

    def cfg(dtype):
        return config_from_dict({
            "data": {"model_name": "base", "loss_name": "base"},
            "var": {"sigma_soft_max": 10.0, "t_win": 1, "feature_dim": 16,
                    "ndepth": 16, "nmode": "exp7_lc", "bn_avg": False},
            "loss": {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0,
                     "smooth_mul": 0.5, "dc_mul": 0.25, "rsc_low_mul": 0.0},
            "train": {"lr": 1e-5, "optim": "adam", "weight_decay": 1e-6},
            "tpu": {"dtype": dtype}})

    mi_np, gt_np = make_batch(batch=2, h=48, w=72, d_min=3.0, d_max=30.0,
                              ndepth=16)
    mi, gt = to_device(mi_np, dev), to_device(gt_np, dev)
    base = get_model(cfg("bfloat16"), dev, 0)
    grads, losses = {}, {}
    for name, dtype, kernels in (("kernel", "bfloat16", True),
                                 ("plain", "bfloat16", False),
                                 ("f32", "float32", False)):
        model = get_model(cfg(dtype), dev)
        model.load_state_dict(base.state_dict())
        model.use_kernels = kernels
        counts = (sk.sweep_stage2.launches, sk.sweep_stage2.bwd_launches,
                  ck.convbn_block.launches, ck.convbn_block.bwd_launches)
        step = make_train_step(get_loss(cfg(dtype)))
        _, loss, _ = step(init_state(model, cfg(dtype)), mi, mi, gt, gt)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(
            (sk.sweep_stage2.launches, sk.sweep_stage2.bwd_launches,
             ck.convbn_block.launches, ck.convbn_block.bwd_launches),
            counts))
        assert got == ((2, 2, 16, 16) if kernels else (0, 0, 0, 0)), name
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
