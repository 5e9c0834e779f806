"""The backward of the port's two kernel modules against the JAX package.

- ``sweep_stage2_bwd_plain`` against ``jax.vjp`` of the Pallas
  ``sweep_stage2`` in interpret mode (its custom VJP runs the backward
  kernel): bf16 within 3% of max|want| (one kernel call each,
  tests/TOLERANCES.md rule 3), f32 at rtol = atol = 1e-4 (the bound of
  tests/test_sweep_pallas.py:73-76);
- ``convbn_block_bwd_plain`` against ``jax.vjp`` of the Pallas
  ``convbn_block`` in interpret mode, with the bounds of
  tests/test_convcomb_pallas.py:99-122 (dx within 3% of max away from the
  ReLU boundary, dW 3%, da and db 10%);
- the autograd Functions on CPU tensors reach the plain backwards and
  launch nothing; the band matrices take no gradient.
The CUDA backward kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops.convcomb_pallas import (convbn_block as jblock,
                                                     pack_wm as jpack,
                                                     to_transposed)
from depthestimation_tpu.ops.sweep_pallas import sweep_stage2 as jax_stage2
from depthestimation_tpu_torch.ops import convcomb_kernel as ck
from depthestimation_tpu_torch.ops import sweep_kernel as sk

C1, D, H, W = 6, 8, 8, 12


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _stage2_inputs(seed, n, v):
    rs = np.random.RandomState(seed)
    fa = rs.randn(n, C1, H, W).astype(np.float32)
    ref = rs.randn(n // v, C1, H, W).astype(np.float32)
    fr = rs.randn(n, D, H, W).astype(np.float32)

    def band(size):     # at most two nonzeros per row, rows sum <= 1
        m = np.zeros((n, D, size, size), np.float32)
        for i in range(size):
            j = rs.randint(0, size - 1, (n, D))
            f = rs.rand(n, D).astype(np.float32)
            np.put_along_axis(m[:, :, i], j[..., None], (1 - f)[..., None], -1)
            np.put_along_axis(m[:, :, i], j[..., None] + 1, f[..., None], -1)
        return m
    gcost = rs.randn(n, D, H, W).astype(np.float32)
    gdiag = rs.randn(n, D, H, W).astype(np.float32)
    return ((fa, ref, fr, band(W).transpose(0, 1, 3, 2).copy(), band(H)),
            (gcost, gdiag))


def _jax_stage2_vjp(args, cts, v, dtype):
    xs = [jnp.asarray(a, dtype) for a in args]
    _, vjp = jax.vjp(lambda fa, ref, fr: jax_stage2(fa, ref, fr, xs[3],
                                                    xs[4], v, True),
                     *xs[:3])
    return [np.asarray(g, np.float32)
            for g in vjp(tuple(jnp.asarray(c) for c in cts))]


@pytest.mark.parametrize("v", [1, 2])
def test_sweep_bwd_bf16_matches_pallas_interpret(v):
    args, cts = _stage2_inputs(v, 2 * v, v)
    want = _jax_stage2_vjp(args, cts, v, jnp.bfloat16)
    tb = [_t(a).to(torch.bfloat16) for a in args]
    got = sk.sweep_stage2_bwd_plain(*tb, _t(cts[0]), _t(cts[1]), v)
    for g, w_, name in zip(got, want, ("dfa", "dref", "dfr")):
        assert g.dtype == torch.float32 and g.shape == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_,
                                   atol=0.03 * np.abs(w_).max(),
                                   err_msg=name)


def test_sweep_bwd_f32_matches_pallas_interpret():
    args, cts = _stage2_inputs(5, 4, 2)
    want = _jax_stage2_vjp(args, cts, 2, jnp.float32)
    got = sk.sweep_stage2_bwd_plain(*[_t(a) for a in args], _t(cts[0]),
                                    _t(cts[1]), 2)
    for g, w_, name in zip(got, want, ("dfa", "dref", "dfr")):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_sweep_function_on_cpu_reaches_the_plain_backward(monkeypatch):
    calls = []
    plain = sk.sweep_stage2_bwd_plain

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(sk, "sweep_stage2_bwd_plain", spy)
    args, cts = _stage2_inputs(3, 2, 1)
    tb = [_t(a).to(torch.bfloat16).requires_grad_() for a in args]
    before = (sk.sweep_stage2.launches, sk.sweep_stage2.bwd_launches)
    cost, diag = sk.sweep_stage2(*tb, 1)
    torch.autograd.backward([cost, diag], [_t(cts[0]), _t(cts[1])])
    assert calls == [1]
    assert (sk.sweep_stage2.launches, sk.sweep_stage2.bwd_launches) == before
    want = plain(*[t.detach() for t in tb], _t(cts[0]), _t(cts[1]), 1)
    for t, w_ in zip(tb[:3], want):
        assert t.grad.dtype == torch.bfloat16
        torch.testing.assert_close(t.grad, w_.to(torch.bfloat16))
    assert tb[3].grad is None and tb[4].grad is None     # rxt, ry


B, DB, HB, WB = 2, 8, 8, 16
NB = B * DB


def _block_data(seed, c, f):
    rs = np.random.RandomState(seed)
    bf = jnp.bfloat16
    x4 = np.asarray(jnp.asarray(rs.randn(NB, HB, WB, c), bf), np.float32)
    k3 = np.asarray(jnp.asarray(rs.randn(3, 3, 3, c, f) * 0.2, bf),
                    np.float32)
    a = (rs.rand(c) * 0.5 + 0.75).astype(np.float32)
    b = (rs.randn(c) * 0.1).astype(np.float32)
    gy = np.asarray(jnp.asarray(rs.randn(NB, f, HB * WB) * 0.1, bf),
                    np.float32)
    gs = (rs.randn(f, 2) * 1e-3).astype(np.float32)
    return x4, k3, a, b, gy, gs


@pytest.mark.parametrize("c,f", [(8, 8), (16, 8)])
@pytest.mark.parametrize("relu", [False, True])
def test_convcomb_bwd_matches_pallas_interpret(c, f, relu):
    x4, k3, a, b, gy, gs = _block_data(c + 3 * f + relu, c, f)
    bf = jnp.bfloat16
    xt = to_transposed(jnp.asarray(x4, bf))
    wm_j = jpack(jnp.asarray(k3)).astype(bf)
    (_, _), vjp = jax.vjp(
        lambda x_, w_, a_, b_: jblock(x_, w_, a_, b_, DB, HB, WB, relu, True),
        xt, wm_j, jnp.asarray(a), jnp.asarray(b))
    dx_j, dw_j, da_j, db_j = [np.asarray(g, np.float32) for g in
                              vjp((jnp.asarray(gy, bf), jnp.asarray(gs)))]

    x = _t(x4).permute(0, 3, 1, 2).reshape(NB, c, HB * WB).to(torch.bfloat16)
    wm = ck.pack_wm(_t(k3).permute(4, 3, 0, 1, 2)).to(torch.bfloat16)
    y, _ = ck.convbn_block_plain(x, wm, _t(a), _t(b), DB, HB, WB, relu)
    dx, dwm, da, db = ck.convbn_block_bwd_plain(
        x, wm, _t(a), _t(b), y, _t(gy).to(torch.bfloat16), _t(gs), DB, HB,
        WB, relu)
    assert dx.dtype == torch.bfloat16 and dwm.shape == wm.shape

    # the ReLU boundary: near-zero pre-activations may round either way
    v = x.float().numpy() * a[:, None] + b[:, None]
    interior = np.abs(v) > 0.02 if relu else np.ones(v.shape, bool)
    scale = np.abs(dx_j).max() + 1e-6
    np.testing.assert_allclose(dx.float().numpy()[interior],
                               dx_j[interior], atol=0.03 * scale,
                               err_msg="dx")
    # wm [3F, C, 3, 3] -> the Pallas layout [3F, 9C]
    dw_t = dwm.permute(0, 2, 3, 1).reshape(3 * f, 9 * c).numpy()
    for got, want, name, tol in ((dw_t, dw_j, "dW", 0.03),
                                 (da.numpy(), da_j, "da", 0.10),
                                 (db.numpy(), db_j, "db", 0.10)):
        np.testing.assert_allclose(got, want,
                                   atol=tol * (np.abs(want).max() + 1e-6),
                                   err_msg=name)


def test_convcomb_function_on_cpu_reaches_the_plain_backward(monkeypatch):
    calls = []
    plain = ck.convbn_block_bwd_plain

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(ck, "convbn_block_bwd_plain", spy)
    x4, k3, a, b, gy, gs = _block_data(7, 8, 8)
    x = _t(x4).permute(0, 3, 1, 2).reshape(NB, 8, HB * WB).to(
        torch.bfloat16).requires_grad_()
    wm = ck.pack_wm(_t(k3).permute(4, 3, 0, 1, 2)).to(
        torch.bfloat16).requires_grad_()
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    before = (ck.convbn_block.launches, ck.convbn_block.bwd_launches)
    y, st = ck.convbn_block(x, wm, ta, tb, DB, HB, WB, True)
    torch.autograd.backward([y, st], [_t(gy).to(torch.bfloat16), _t(gs)])
    assert calls == [1]
    assert (ck.convbn_block.launches, ck.convbn_block.bwd_launches) == before
    want = plain(x.detach(), wm.detach(), ta.detach(), tb.detach(),
                 y.detach(), _t(gy).to(torch.bfloat16), _t(gs), DB, HB, WB,
                 True)
    for t, w_ in zip((x, wm, ta, tb), want):
        assert t.grad.dtype == t.dtype
        torch.testing.assert_close(t.grad, w_.to(t.dtype))
