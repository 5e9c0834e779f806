"""The port's fused 2D ConvBN layer (ops/convbn2d_kernel.py) against the
JAX package's Pallas strip kernel in interpret mode, and the fused BN
coefficients against ``BatchNorm._fused_coeffs``.

- ``convbn2d_block`` on CPU tensors (its plain versions) against
  ``convbn2d_block(..., interpret=True)`` on the same numpy inputs, with
  JAX at rows 8, 4 and 2 (1, 2 and 4 strips per image, so with its seam
  rings): the port's whole-image math equals JAX's seamed strips. Forward
  for every activation; backward through ``jax.vjp`` with a nonzero
  statistics cotangent. The bounds of tests/test_convbn2d_pallas.py (one
  block: tests/TOLERANCES.md rule 3).
- ``BatchNorm.fused_coeffs`` at a variance of exactly 0: its gradient with
  respect to the statistics equals JAX's (``jnp.maximum`` splits it at the
  tie, where ``torch.clamp`` would pass all of it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.models import layers as jl
from depthestimation_tpu.ops.convbn2d_pallas import (convbn2d_block as jblock,
                                                     from_strips, pack_wm2d,
                                                     to_strips)
from depthestimation_tpu_torch.models import layers as tl
from depthestimation_tpu_torch.ops import convbn2d_kernel as c2

N, H, W = 2, 8, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _bf16_np(a):
    """Round to bf16 and back, so both sides start from the same values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _data(seed, c, f):
    rs = np.random.RandomState(seed)
    x4 = _bf16_np(rs.randn(N, H, W, c))
    k = _bf16_np(rs.randn(3, 3, c, f) * 0.2)           # HWIO
    a = (rs.rand(c) * 0.5 + 0.75).astype(np.float32)
    b = (rs.randn(c) * 0.1).astype(np.float32)
    gy4 = _bf16_np(rs.randn(N, H, W, f) * 0.1)
    gs = (rs.randn(f, 2) * 1e-3).astype(np.float32)
    return x4, k, a, b, gy4, gs


def _jax_call(x4, k, a, b, rows, act):
    """JAX's fused layer as ``layers.Conv._fused`` calls it: channels
    zero-padded to 8, the input in strips of ``rows`` image rows."""
    c, f = k.shape[-2:]
    cp, fp = (-c) % 8, (-f) % 8
    x4p = np.pad(x4, ((0, 0),) * 3 + ((0, cp),))
    kp = np.pad(k, ((0, 0), (0, 0), (0, cp), (0, fp)))
    ap = np.concatenate([a, np.ones(cp, np.float32)])
    bp = np.concatenate([b, np.zeros(cp, np.float32)])
    xt = to_strips(jnp.asarray(x4p, jnp.bfloat16), rows)
    wm = pack_wm2d(jnp.asarray(kp)).astype(jnp.bfloat16)

    def fn(xt_, wm_, a_, b_):
        return jblock(xt_, wm_, a_, b_, H // rows, rows, W, act, True)

    return fn, (xt, wm, jnp.asarray(ap), jnp.asarray(bp)), cp, fp


def _port_inputs(x4, k, a, b):
    x = _t(np.moveaxis(x4, -1, 1)).to(torch.bfloat16)
    w = _t(np.transpose(k, (3, 2, 0, 1))).to(torch.bfloat16)   # OIHW
    return x, w, _t(a), _t(b)


CASES = [(c, rows, act) for c in (8, 12) for rows in (8, 4, 2)
         for act in c2.ACTS]


@pytest.mark.parametrize("c,rows,act", CASES)
def test_forward_matches_jax(c, rows, act):
    x4, k, a, b, _, _ = _data(c + rows, c, c)
    fn, args, _, fp = _jax_call(x4, k, a, b, rows, act)
    y_j, st_j = fn(*args)
    y_j = np.asarray(from_strips(y_j, rows, H), np.float32)[..., :c]
    st_j = np.asarray(st_j)[:c]
    y, st = c2.convbn2d_block(*_port_inputs(x4, k, a, b), act)
    assert y.dtype == torch.bfloat16 and y.shape == (N, c, H, W)
    assert c2.convbn2d_block.launches == 0
    y = np.moveaxis(y.float().numpy(), 1, -1)
    scale = np.abs(y_j).max() + 1e-6
    np.testing.assert_allclose(y, y_j, rtol=0, atol=0.03 * scale)
    np.testing.assert_allclose(st.numpy(), st_j, rtol=3e-2,
                               atol=1e-2 * N * H * W)


@pytest.mark.parametrize("c,rows,act", CASES)
def test_backward_matches_jax(c, rows, act):
    """dx within 3% of max where |v| > 0.02 (the JAX kernel and the port
    both mask the f32 pre-activation; the exclusion keeps the bound to
    summation order), dW 3%, da and db 10% of max."""
    x4, k, a, b, gy4, gs = _data(c + rows + 1, c, c)
    fn, args, cp, fp = _jax_call(x4, k, a, b, rows, act)
    (y_j, st_j), vjp = jax.vjp(fn, *args)
    gy_t = to_strips(jnp.asarray(np.pad(gy4, ((0, 0),) * 3 + ((0, fp),)),
                                 jnp.bfloat16), rows)
    gs_p = jnp.asarray(np.pad(gs, ((0, fp), (0, 0))))
    dxt, dwm, da_j, db_j = vjp((gy_t, gs_p))
    dx_j = np.asarray(from_strips(dxt, rows, H), np.float32)[..., :c]
    # wm [Fp, 9Cp] -> OIHW [F, C, 3, 3]
    dw_j = np.asarray(dwm, np.float32).reshape(c + fp, 3, 3, c + cp)
    dw_j = np.transpose(dw_j, (0, 3, 1, 2))[:c, :c]
    da_j, db_j = np.asarray(da_j)[:c], np.asarray(db_j)[:c]

    leaves = [t.requires_grad_() for t in _port_inputs(x4, k, a, b)]
    y, st = c2.convbn2d_block(*leaves, act)
    gy = _t(np.moveaxis(gy4, -1, 1)).to(torch.bfloat16)
    torch.autograd.backward((y, st), (gy, _t(gs)))
    assert c2.convbn2d_block.bwd_launches == 0
    dx = np.moveaxis(leaves[0].grad.float().numpy(), 1, -1)
    v = x4 * a + b
    inner = (np.abs(v) > 0.02 if act != "none"
             else np.ones_like(v, dtype=bool))
    assert inner.mean() > 0.97
    for got, want, tol, name in (
            (dx[inner], dx_j[inner], 0.03, "dx"),
            (leaves[1].grad.float().numpy(), dw_j, 0.03, "dW"),
            (leaves[2].grad.numpy(), da_j, 0.10, "da"),
            (leaves[3].grad.numpy(), db_j, 0.10, "db")):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max() + 1e-6,
                                   err_msg=name)


def test_fused_coeffs_gradient_at_zero_variance_matches_jax():
    """stats = [[count, count]] per channel gives mean 1 and var exactly 0:
    the gradient of (a, b) with respect to the stats splits at the tie of
    max(var, 0) as JAX's does."""
    count = 6.0
    c = 3
    rs = np.random.RandomState(9)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    stats = np.full((c, 2), count, np.float32)
    ga, gb = rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}

    def jloss(s):
        a, b = jl.BatchNorm().apply(params, None, True,
                                    fused_stats=(s, count))
        return jnp.sum(a * ga) + jnp.sum(b * gb)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(stats)))

    bn = tl.BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    s = _t(stats).requires_grad_()
    a, b = bn.fused_coeffs(s, count)
    ((a * _t(ga)).sum() + (b * _t(gb)).sum()).backward()
    np.testing.assert_allclose(s.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    # the half share at the tie is not zero: the repair is visible
    assert np.abs(want[:, 1]).min() > 0
