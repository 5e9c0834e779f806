"""The flow loss (``losses/flow_loss.py``, ``losses/blocks.py:ssim`` and
``ternary_loss``, ``ops/resample.resize_linear``) against the JAX package
on the same numpy inputs.

- ``ssim``: 1e-4 max|JAX| (its variances are differences of box means,
  which cancel, so their rounding shows); ``ternary_loss``: 1e-5.
- ``occlusion_mask_bidirection``: the same mask (a pixel whose consistency
  test lands within rounding of its threshold may flip: at most 0.5% of
  pixels differ).
- ``UnFlowLoss``, total and terms, with ``w_ternary`` 0 and 1, on a
  five-level flow pyramid whose coarsest level is constant (as PWCLite's
  is when upsampled from 1x1, so ``|grad flow|`` is exactly 0 there): 1e-5
  relative; its gradient with respect to every flow level: 1e-4 max|JAX|
  (JAX's slope 1 of ``|x|`` at 0 is kept); the backward flows reach the
  loss through the mask alone, so their gradient is zero in JAX and none
  in PyTorch.
- ``resize_linear`` against ``jax.image.resize(..., "linear")`` at the
  loss's factors (x1 to x1/16) and upsampling: 1e-5.
- The reference seam, pinned: ``photometric`` takes SSIM of item 0 only.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.losses import blocks as jb
from depthestimation_tpu.losses import flow_loss as jf
from depthestimation_tpu_torch.losses import blocks as tb
from depthestimation_tpu_torch.losses import flow_loss as tf
from depthestimation_tpu_torch.ops.resample import resize_linear

HW = 64
LEVELS = (64, 32, 16, 8, 4)


def _cfg(w_ternary=0.0):
    return types.SimpleNamespace(loss={"w_ssim": 0.85, "w_smooth": 75.0,
                                       "w_ternary": w_ternary})


def _case(b=2, seed=0):
    """Images in [0, 1] and flow pyramids (finest first) in the
    magnitudes PWCLite gives; the coarsest level constant per item."""
    rs = np.random.RandomState(seed)
    target = rs.uniform(0, 1, (b, 6, HW, HW)).astype(np.float32)
    flows = {}
    for key in ("flows_fw", "flows_bw"):
        lv = [(rs.randn(b, 2, s, s) * 2).astype(np.float32)
              for s in LEVELS[:-1]]
        lv.append(np.broadcast_to(rs.randn(b, 2, 1, 1) * 2,
                                  (b, 2, 4, 4)).astype(np.float32))
        flows[key] = lv
    return target, flows


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (err, want.max())


def test_ssim_and_ternary_match_jax():
    rs = np.random.RandomState(1)
    x = rs.uniform(0, 1, (2, 3, 12, 14)).astype(np.float32)
    y = np.clip(x + rs.randn(*x.shape).astype(np.float32) * 0.1, 0, 1)
    _close(tb.ssim(torch.from_numpy(x[0]), torch.from_numpy(y[0])).numpy(),
           jb.ssim(jnp.asarray(x[0]), jnp.asarray(y[0])), 1e-4)
    _close(tb.ternary_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
           jb.ternary_loss(jnp.asarray(x), jnp.asarray(y)), 1e-5)


def test_occlusion_mask_matches_jax():
    rs = np.random.RandomState(2)
    fw = (rs.randn(2, 2, 1, 1) * 3 + rs.randn(2, 2, 24, 20) * 0.3).astype(
        np.float32)
    bw = (-fw + rs.randn(*fw.shape) * 0.6).astype(np.float32)
    want = np.asarray(jf.occlusion_mask_bidirection(jnp.asarray(fw),
                                                    jnp.asarray(bw)))
    got = tf.occlusion_mask_bidirection(torch.from_numpy(fw),
                                        torch.from_numpy(bw)).numpy()
    assert got.shape == want.shape == (2, 1, 24, 20)
    assert 0.05 < want.mean() < 0.95            # both values occur
    assert np.mean(got != want) <= 0.005


@pytest.mark.parametrize("w_ternary", [0.0, 1.0])
def test_unflow_loss_total_terms_and_gradient_match_jax(w_ternary):
    target, flows = _case()
    jloss = jf.UnFlowLoss(_cfg(w_ternary))

    def jfun(fl):
        total, terms = jloss(fl, jnp.asarray(target), return_terms=True)
        return total, terms

    (want, wterms), wgrad = jax.jit(jax.value_and_grad(jfun, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, flows))
    tflows = {k: [torch.from_numpy(np.ascontiguousarray(f)).requires_grad_()
                  for f in v] for k, v in flows.items()}
    got, terms = tf.UnFlowLoss(_cfg(w_ternary))(
        tflows, torch.from_numpy(target), return_terms=True)
    got.backward()
    _close(got.item(), want, 1e-5)
    for k in ("l_ph", "l_sm", "flow_mean"):
        _close(terms[k].item(), wterms[k], 1e-5)
    np.testing.assert_array_equal(terms["noc_mask"].numpy(),
                                  np.asarray(wterms["noc_mask"]))
    for g, w in zip(tflows["flows_fw"], wgrad["flows_fw"]):
        _close(g.grad.numpy(), w, 1e-4)
    for g, w in zip(tflows["flows_bw"], wgrad["flows_bw"]):
        assert g.grad is None and not np.any(np.asarray(w))


def test_loss_without_backward_flows_takes_no_mask():
    target, flows = _case(seed=3)
    want = jax.jit(lambda fl, t: jf.UnFlowLoss(_cfg())({"flows_fw": fl}, t))(
        [jnp.asarray(f) for f in flows["flows_fw"]], jnp.asarray(target))
    got = tf.UnFlowLoss(_cfg())({"flows_fw": [torch.from_numpy(
        np.ascontiguousarray(f)) for f in flows["flows_fw"]]},
        torch.from_numpy(target))
    _close(got.item(), want, 1e-5)


@pytest.mark.parametrize("size", [(64, 64), (32, 32), (16, 16), (8, 8),
                                  (4, 4), (96, 80), (64, 40)])
def test_resize_linear_matches_jax_image_resize(size):
    rs = np.random.RandomState(4)
    src = (rs.uniform(0, 1, (2, 3, 64, 64)) if size[0] <= 64 else
           rs.randn(2, 3, 24, 20)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(src), src.shape[:2] + size,
                            "linear")
    got = resize_linear(torch.from_numpy(src), size)
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


def test_photometric_takes_ssim_of_item_zero_only():
    rs = np.random.RandomState(5)
    img1 = torch.from_numpy(rs.uniform(0, 1, (2, 3, 16, 16)).astype(
        np.float32))
    img2 = torch.from_numpy(rs.uniform(0, 1, (2, 3, 16, 16)).astype(
        np.float32))
    mask = torch.ones(2, 1, 16, 16)
    loss = tf.UnFlowLoss(_cfg())
    want = (0.15 * (img1 - img2).abs().mean()
            + 0.85 * tb.ssim(img1[0], img2[0]).mean())
    torch.testing.assert_close(loss.photometric(img1, img2, mask), want)
    # item 1's SSIM does not count: swapping its warped image for one with
    # the same L1 distance leaves the loss as it was
    img2b = img2.clone()
    img2b[1] = 2 * img1[1] - img2[1]
    torch.testing.assert_close(loss.photometric(img1, img2b, mask),
                               loss.photometric(img1, img2, mask))
    jwant = jf.UnFlowLoss(_cfg()).photometric(
        jnp.asarray(img1.numpy()), jnp.asarray(img2b.numpy()),
        jnp.ones((2, 1, 16, 16)))
    _close(loss.photometric(img1, img2b, mask).item(), jwant, 1e-5)
