"""Correlation (``ops/correlation.py``, ``ops/correlation_kernel.py``)
against the JAX package on the same numpy inputs.

- The plain ``correlation_batched`` (what ``correlate`` runs on a CPU
  tensor, and what the CUDA kernel is held to on the card) against JAX's
  ``correlation_batched`` (the XLA form) and against the Pallas kernel
  ``_correlation_pallas_fwd`` run in interpret mode, f32: max|diff| <=
  1e-6 max|JAX|, at md = 4 and md = 2, at odd H and W. The Pallas kernel
  takes no ``interpret`` argument, so the test patches ``pallas_call`` to
  interpret (nothing in the JAX package changes).
- ``correlate``'s backward (the plain backward written out,
  ``correlation_bwd_plain``) against ``jax.vjp`` of JAX's
  ``correlation``: max|diff| <= 1e-5 max|JAX| (sums of K products in
  another order).
- ``torch.autograd.gradcheck`` of that backward in f64.
"""

import functools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops import correlation as jcorr
from depthestimation_tpu_torch.ops.correlation import (correlation,
                                                       correlation_batched)
from depthestimation_tpu_torch.ops.correlation_kernel import correlate

SHAPES = [(2, 8, 11, 13, 4), (1, 5, 12, 16, 2), (2, 3, 6, 13, 4)]


def _pair(b, c, h, w, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, c, h, w).astype(np.float32),
            rs.randn(b, c, h, w).astype(np.float32))


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,c,h,w,md", SHAPES)
def test_plain_forward_matches_jax_xla_form(b, c, h, w, md):
    x1, x2 = _pair(b, c, h, w, b + c + md)
    want = jax.jit(jcorr.correlation_batched, static_argnums=2)(
        jnp.asarray(x1), jnp.asarray(x2), md)
    got = correlation_batched(torch.from_numpy(x1), torch.from_numpy(x2), md)
    assert got.shape == (b, (2 * md + 1) ** 2, h, w)
    _close(got.numpy(), want, 1e-6)
    one = correlation(torch.from_numpy(x1[0]), torch.from_numpy(x2[0]), md)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


@pytest.mark.parametrize("b,c,h,w,md", SHAPES[:2])
def test_plain_forward_matches_the_pallas_kernel(monkeypatch, b, c, h, w,
                                                 md):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x1, x2 = _pair(b, c, h, w, 7 + md)
    got = correlate(torch.from_numpy(x1), torch.from_numpy(x2), md)
    assert correlate.launches == 0                 # CPU: the plain version
    for i in range(b):
        want = jcorr._correlation_pallas_fwd(jnp.asarray(x1[i]),
                                             jnp.asarray(x2[i]), md)
        _close(got[i].numpy(), want, 1e-6)


@pytest.mark.parametrize("b,c,h,w,md", SHAPES)
def test_backward_matches_jax_vjp(b, c, h, w, md):
    x1, x2 = _pair(b, c, h, w, 11 + md)
    g = np.random.RandomState(3).randn(
        b, (2 * md + 1) ** 2, h, w).astype(np.float32)
    _, pull = jax.vjp(lambda a, q: jcorr.correlation_batched(a, q, md),
                      jnp.asarray(x1), jnp.asarray(x2))
    want1, want2 = pull(jnp.asarray(g))
    t1 = torch.from_numpy(x1).requires_grad_()
    t2 = torch.from_numpy(x2).requires_grad_()
    correlate(t1, t2, md).backward(torch.from_numpy(g))
    assert correlate.bwd_launches == 0
    _close(t1.grad.numpy(), want1, 1e-5)
    _close(t2.grad.numpy(), want2, 1e-5)
    # the plain autograd form of the forward gives the same gradients
    p1 = torch.from_numpy(x1).requires_grad_()
    p2 = torch.from_numpy(x2).requires_grad_()
    correlation_batched(p1, p2, md).backward(torch.from_numpy(g))
    _close(t1.grad.numpy(), p1.grad.numpy(), 1e-5)
    _close(t2.grad.numpy(), p2.grad.numpy(), 1e-5)


@pytest.mark.parametrize("md", [1, 2])
def test_plain_backward_passes_gradcheck_in_f64(md):
    gen = torch.Generator().manual_seed(md)
    x1 = torch.randn(2, 3, 5, 6, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    x2 = torch.randn(2, 3, 5, 6, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, q: correlate(a, q, md),
                                    (x1, x2))
