"""The flat Conv3d op (``ops/conv3d_kernel.py``) against JAX's
``conv3d_flat_pallas`` run in interpret mode, at the shapes of
tests/test_conv3d_pallas.py (B=2, D=8, 16x24, C=F=32), forward, dx and dW.

- f32: rtol 1e-4, atol 1e-5 max|JAX| (sums of 288 products in another
  order).
- bf16: the taps are rounded to bf16 and the combine summed in f32 and
  rounded once, in both. So nearly every element is bit-equal (a tap whose
  f32 sum lands within an ulp of a bf16 rounding boundary may round the
  other way): at least 99% equal (rounding the combine in bf16 gives 83%)
  and the rest within 2^-6 max|JAX|. dW is
  an f32 sum of bf16 products in both: rtol 1e-3.
The JAX side runs once per dtype under ``jax.jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops.conv3d_pallas import conv3d_flat_pallas
from depthestimation_tpu_torch.ops import conv3d_kernel as ck

B, D, H, W, C, F = 2, 8, 16, 24, 32, 32


@functools.lru_cache(maxsize=None)
def _case(dtype_name):
    rs = np.random.RandomState(0)
    x = rs.randn(B * D, H, W, C).astype(np.float32)
    k = (rs.randn(3, 3, 3, C, F) * 0.05).astype(np.float32)
    g = (rs.randn(B * D, H, W, F) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    x = np.asarray(xj.astype(jnp.float32))     # the values JAX sees

    def fwd_bwd(xj, kj, gj):
        y, pull = jax.vjp(lambda a, q: conv3d_flat_pallas(a, q, D, True),
                          xj, kj)
        return (y,) + pull(gj)

    y, dx, dk = jax.jit(fwd_bwd)(xj, jnp.asarray(k),
                                 jnp.asarray(g).astype(jdt))
    g = np.asarray(jnp.asarray(g).astype(jdt).astype(jnp.float32))
    want = [np.asarray(t.astype(jnp.float32)) for t in (y, dx, dk)]
    return x, k, g, want


def _nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _torch_side(dtype_name):
    x, k, g, want = _case(dtype_name)
    dt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    xt = _nchw(x, dt).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(
        k.transpose(4, 3, 0, 1, 2))).requires_grad_()     # [F, C, kd, kh, kw]
    y = ck.conv3d_flat(xt, wt, D)
    y.backward(_nchw(g, dt))
    dk = wt.grad.numpy().transpose(2, 3, 4, 1, 0)        # -> [kd,kh,kw,C,F]
    return (y, xt.grad, dk), want


def test_f32_forward_dx_dw_match_the_pallas_kernel():
    (y, dx, dk), (wy, wdx, wdk) = _torch_side("f32")
    assert y.dtype == torch.float32 and ck.conv3d_flat.launches == 0
    for got, want in ((_nhwc(y), wy), (_nhwc(dx), wdx), (dk, wdk)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_rounds_where_the_pallas_kernel_does():
    (y, dx, dk), (wy, wdx, wdk) = _torch_side("bf16")
    assert y.dtype == torch.bfloat16 and dx.dtype == torch.bfloat16
    for got, want in ((_nhwc(y), wy), (_nhwc(dx), wdx)):
        equal = np.mean(got == want)
        assert equal >= 0.99, equal
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(dk, wdk, rtol=1e-3,
                               atol=1e-4 * np.abs(wdk).max())


def test_plain_pieces_agree_with_the_autograd_op():
    x, k, g, _ = _case("f32")
    xt, gt = _nchw(x, torch.float32), _nchw(g, torch.float32)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))
    dx = ck.conv3d_flat_plain(gt, ck.flip_weight(wt), D)
    dw = ck.conv3d_flat_dw_plain(xt, gt, D)
    xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    ck.conv3d_flat(xr, wr, D).backward(gt)
    torch.testing.assert_close(xr.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(wr.grad, dw, rtol=0, atol=0)
    # the forward is a 3x3x3 'same' conv over each item's depth
    y = ck.conv3d_flat_plain(xt, wt, D)
    x5 = xt.reshape(B, D, C, H, W).transpose(1, 2)
    y5 = torch.nn.functional.conv3d(x5, wt, padding=1)
    torch.testing.assert_close(y, y5.transpose(1, 2).reshape(B * D, F, H, W),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "depth"])
def test_cpu_path_needs_no_card_and_checks_nothing_of_the_kernel(bad):
    # on a CPU tensor the op is the plain version: a float64 input or a
    # depth that does not divide N is the plain version's business
    x = torch.randn(4, 3, 5, 6, dtype=torch.float64)
    wt = torch.randn(2, 3, 3, 3, 3, dtype=torch.float64)
    if bad == "dtype":
        assert ck.conv3d_flat(x, wt, 2).shape == (4, 2, 5, 6)
    else:
        assert ck.conv3d_flat(x.float(), wt.float(), 4).shape == (4, 2, 5, 6)
