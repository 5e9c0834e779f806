"""The port's loss path against the JAX package, in f32 on the same numpy
inputs: the warps and geometry the loss uses (``hwarp``,
``static_row_resample``, ``grid_sample``, ``inverse_warp`` with both
impls, ``transform_dmap``, ``minpool``), every BaseLoss block, and
``BaseLoss`` itself: the scalar and its gradient with respect to the
output DPVs. The port's functions take a leading batch axis; each is held
to the JAX per-item function under ``jax.vmap``. Bounds: f32 round-off,
rtol 1e-5 / atol 1e-5 on values of order 1, the loss at rtol 1e-5 and
its gradient at 1e-4 of the gradient's largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg
from depthestimation_tpu.losses import blocks as jblocks
from depthestimation_tpu.losses.base_loss import BaseLoss as JBaseLoss
from depthestimation_tpu.ops import geometry as jgeo
from depthestimation_tpu.ops import resample as jres
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.losses import blocks, get_loss
from depthestimation_tpu_torch.losses.base_loss import BaseLoss, DefaultLoss
from depthestimation_tpu_torch.ops import geometry as geo
from depthestimation_tpu_torch.ops import resample as res

B, H, W = 2, 24, 36


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _intr(b=B, h=H, w=W):
    k = np.array([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                  [0, 0, 1]], np.float32)
    return np.tile(k[None], (b, 1, 1))


def _poses(seed, pure_x):
    rs = np.random.RandomState(seed)
    p = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    p[:, 0, 3] = rs.uniform(0.3, 0.6, B)
    if not pure_x:
        a = rs.uniform(-0.02, 0.02, B)
        p[:, 0, 0], p[:, 0, 2] = np.cos(a), np.sin(a)
        p[:, 2, 0], p[:, 2, 2] = -np.sin(a), np.cos(a)
        p[:, 1, 3] = rs.uniform(-0.05, 0.05, B)
    return p


def _depth(seed, h=H, w=W):
    return np.random.RandomState(seed).uniform(3.0, 30.0, (B, h, w)).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_hwarp_and_row_resample_match_jax(mode):
    rs = np.random.RandomState(1)
    img = rs.randn(B, 3, H, W).astype(np.float32)
    # sources inside, at and beyond the band (default band max(16, W//6))
    xn = rs.uniform(-1.6, 1.6, (B, H, W)).astype(np.float32)
    out_j, inb_j = jax.vmap(lambda i, x: jres.hwarp(i, x, mode=mode))(
        jnp.asarray(img), jnp.asarray(xn))
    out_t, inb_t = res.hwarp(_t(img), _t(xn), mode=mode)
    np.testing.assert_array_equal(inb_t.numpy(), np.asarray(inb_j))
    assert 0 < inb_t.float().mean() < 1
    _close(out_t.numpy(), out_j)
    _close(res.static_row_resample(_t(img), mode=mode).numpy(),
           jax.vmap(lambda i: jres.static_row_resample(i, mode=mode))(
               jnp.asarray(img)))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(mode, align_corners):
    rs = np.random.RandomState(2)
    img = rs.randn(B, 4, H, W).astype(np.float32)
    grid = rs.uniform(-1.1, 1.1, (B, 5, 7, 2)).astype(np.float32)
    want = jax.vmap(lambda i, g: jres.grid_sample(
        i, g, mode=mode, align_corners=align_corners))(jnp.asarray(img),
                                                       jnp.asarray(grid))
    got = res.grid_sample(_t(img), _t(grid), mode=mode,
                          align_corners=align_corners)
    assert got.shape == (B, 4, 5, 7)
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl,pure_x", [("gather", False), ("gather", True),
                                         ("hwarp", True)])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_inverse_warp_matches_jax(impl, pure_x, mode):
    img = np.random.RandomState(3).rand(B, 3, H, W).astype(np.float32)
    depth, pose, intr = _depth(4), _poses(5, pure_x), _intr()
    w_j, v_j = jax.vmap(lambda i, d, p, k: jgeo.inverse_warp(
        i, d, p, k, mode=mode, impl=impl))(*map(jnp.asarray,
                                                (img, depth, pose, intr)))
    w_t, v_t = geo.inverse_warp(_t(img), _t(depth), _t(pose), _t(intr),
                                mode=mode, impl=impl)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    _close(w_t.numpy(), w_j)


def test_transform_dmap_and_minpool_match_jax():
    depth, pose, intr = _depth(6), _poses(7, False), _intr()
    want = jax.vmap(jgeo.transform_dmap)(*map(jnp.asarray,
                                              (depth, pose, intr)))
    _close(geo.transform_dmap(_t(depth), _t(pose), _t(intr)).numpy(), want,
           tol=1e-4)
    x = depth * (np.random.RandomState(8).rand(B, H, W) > 0.2)
    for default in (0.0, 100.0):
        np.testing.assert_array_equal(
            geo.minpool(_t(x), 4, default).numpy(),
            np.asarray(jgeo.minpool(jnp.asarray(x), 4, default)))


def _log_dpv(rs, b, d, h, w):
    x = rs.randn(b, d, h, w).astype(np.float32)
    return x - np.log(np.exp(x).sum(1, keepdims=True))


@pytest.mark.parametrize("warp_impl", ["gather", "hwarp"])
def test_loss_blocks_match_jax(warp_impl):
    rs = np.random.RandomState(9)
    d = 8
    soft = np.exp(_log_dpv(rs, B, d, H, W))
    logp = _log_dpv(rs, B, d, H, W)
    mask = (rs.rand(B, 1, H, W) > 0.3).astype(np.float32)
    mask[1] = 0.0                                       # an empty mask
    _close(blocks.soft_cross_entropy_loss(_t(soft), _t(logp),
                                          _t(mask)).numpy(),
           jax.vmap(jblocks.soft_cross_entropy_loss)(soft, logp, mask))
    diff = rs.rand(B, 3, H, W).astype(np.float32)
    _close(blocks.mean_on_mask(_t(diff), _t(mask)).numpy(),
           jax.vmap(jblocks.mean_on_mask)(diff, mask))

    rgb_s, rgb_t = rs.rand(2, B, 3, H, W).astype(np.float32)
    depth_s, depth_t = _depth(10), _depth(11)
    pose, intr = _poses(12, True), _intr()
    args = tuple(map(jnp.asarray, (rgb_s, rgb_t, depth_t, pose, intr)))
    _close(blocks.rgb_stereo_consistency_loss(
        *map(_t, (rgb_s, rgb_t, depth_t, pose, intr)),
        warp_impl=warp_impl).numpy(),
        jax.vmap(lambda *a: jblocks.rgb_stereo_consistency_loss(
            *a, warp_impl=warp_impl))(*args))
    m1 = mask.copy()
    m1[1] = 1.0
    args = tuple(map(jnp.asarray, (depth_s, depth_t, m1, pose, intr)))
    _close(blocks.depth_stereo_consistency_loss(
        *map(_t, (depth_s, depth_t, m1, pose, intr)),
        warp_impl=warp_impl).numpy(),
        jax.vmap(lambda *a: jblocks.depth_stereo_consistency_loss(
            *a, warp_impl=warp_impl))(*args))
    small = _depth(13, H // 4, W // 4)
    _close(blocks.depth_consistency_loss(_t(depth_s), _t(small)).numpy(),
           jax.vmap(jblocks.depth_consistency_loss)(depth_s, small))
    _close(blocks.edge_aware_smoothness_loss(_t(depth_s),
                                             _t(rgb_s)).numpy(),
           jax.vmap(jblocks.edge_aware_smoothness_loss)(depth_s, rgb_s),
           tol=1e-4)


_LOSS = {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0, "smooth_mul": 0.5,
         "dc_mul": 0.25, "rsc_low_mul": 0.5}


def _loss_cfg(mod, warp_impl, loss_name="base"):
    return mod({"data": {"exp_name": "t", "model_name": "base",
                         "loss_name": loss_name},
                "loss": dict(_LOSS, warp_impl=warp_impl)})


@pytest.mark.parametrize("warp_impl", ["hwarp", "gather"])
def test_base_loss_and_its_gradient_match_jax(warp_impl):
    d, h, w = 8, 32, 48
    rs = np.random.RandomState(14)
    _, gt_np = tsyn.make_batch(batch=B, h=h, w=w, d_min=3.0, d_max=30.0,
                               ndepth=d, seed=3)
    # a rig 1 cm off rectified: with a pure-x baseline the warp grid of the
    # first and last rows lies exactly on the validity edge |y| = 1, where
    # the last bit of the depth (a sum whose order differs between the
    # frameworks) decides the mask
    gt_np["T_left2right"] = gt_np["T_left2right"].copy()
    gt_np["T_left2right"][1, 3] = 0.01
    gts_np = [gt_np, dict(gt_np, rgb=gt_np["rgb"][:, ::-1].copy())]
    outs = [[_log_dpv(rs, B, d, h // 4, w // 4) for _ in range(2)]
            + [_log_dpv(rs, B, d, h, w)] for _ in range(2)]

    def pack(o):
        return {"output": o[:2], "output_refined": o[2:]}

    jl = JBaseLoss(_loss_cfg(jcfg, warp_impl))
    gts_j = [{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in g.items()} for g in gts_np]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda o: jl([pack(o[0]), pack(o[1])], gts_j)))(
            jax.tree_util.tree_map(jnp.asarray, outs))

    tl = get_loss(_loss_cfg(tcfg.config_from_dict, warp_impl))
    assert isinstance(tl, BaseLoss)
    outs_t = [[_t(x).requires_grad_() for x in o] for o in outs]
    gts_t = [tsyn.to_device(g, "cpu") for g in gts_np]
    loss_t = tl([pack(outs_t[0]), pack(outs_t[1])], gts_t)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for side_t, side_j in zip(outs_t, grads_j):
        for x, g in zip(side_t, side_j):
            g = np.asarray(g)
            np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                       atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("warp_impl", ["gather", "hwarp"])
def test_loss_gradients_at_ties_match_jax(warp_impl):
    """Ties are the rule when both camera sides see the same frame: the
    warped depth equals the target depth exactly where the depth map is
    flat, and so do neighbouring depths. The blocks keep JAX's
    subgradients there (|x|' = 1 at 0, a clip's gradient split at a
    bound); PyTorch's own (0 and all) give another gradient."""
    rs = np.random.RandomState(16)
    blocks_hw = np.kron(rs.uniform(5.0, 20.0, (B, 3, 3)), np.ones((8, 12)))
    depth = blocks_hw.astype(np.float32)                  # [B, 24, 36]
    mask = np.ones((B, 1, H, W), np.float32)
    pose, intr = _poses(17, True), _intr()
    small = np.asarray(jgeo.minpool(jnp.asarray(depth), 4))
    rgb = rs.rand(B, 3, H, W).astype(np.float32)

    def jax_terms(d_s, d_t, d_small):
        return (jnp.sum(jax.vmap(lambda *a: jblocks.
                                 depth_stereo_consistency_loss(
                                     *a, warp_impl=warp_impl))(
                    d_s, d_t, mask, pose, intr))
                + jnp.sum(jax.vmap(jblocks.edge_aware_smoothness_loss)(
                    d_t, rgb))
                + jnp.sum(jax.vmap(jblocks.depth_consistency_loss)(
                    d_t, d_small)))

    gj = jax.grad(jax_terms, argnums=(0, 1, 2))(
        jnp.asarray(depth), jnp.asarray(depth), jnp.asarray(small))
    xs = [_t(a).requires_grad_() for a in (depth, depth, small)]
    loss = (blocks.depth_stereo_consistency_loss(
        xs[0], xs[1], _t(mask), _t(pose), _t(intr),
        warp_impl=warp_impl).sum()
        + blocks.edge_aware_smoothness_loss(xs[1], _t(rgb)).sum()
        + blocks.depth_consistency_loss(xs[1], xs[2]).sum())
    loss.backward()
    for x, g in zip(xs, gj):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


def test_default_loss_and_factory():
    rs = np.random.RandomState(15)
    o = [{"output": [_t(rs.randn(B, 4, 6, 6))]} for _ in range(2)]
    want = sum(np.abs(x["output"][-1].numpy()).sum() for x in o)
    got = get_loss(_loss_cfg(tcfg.config_from_dict, "hwarp", "default"))
    assert isinstance(got, DefaultLoss)
    np.testing.assert_allclose(got(o, [None, None]).item(), want, rtol=1e-6)
    from depthestimation_tpu_torch.losses.sweep_loss import SweepLoss
    assert isinstance(get_loss(_loss_cfg(tcfg.config_from_dict, "hwarp",
                                         "sweep")), SweepLoss)
    from depthestimation_tpu_torch.losses.flow_loss import UnFlowLoss
    assert isinstance(get_loss(_loss_cfg(tcfg.config_from_dict, "hwarp",
                                         "unflow")), UnFlowLoss)
