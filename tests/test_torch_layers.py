"""The port's layers, encoder and decoder (depthestimation_tpu_torch/models)
against the flax modules, with the flax parameters carried over by the
weight bridge (depthestimation_tpu_torch/weights.py). f32 on the CPU on
both sides; tolerances are f32 round-off through the stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.models import layers as jl
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu.models.decoder import BaseDecoder as JDecoder
from depthestimation_tpu.models.encoder import BaseEncoder as JEncoder
from depthestimation_tpu_torch.models import layers as tl
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.models.decoder import BaseDecoder
from depthestimation_tpu_torch.models.encoder import BaseEncoder
from depthestimation_tpu_torch.weights import (from_jax_params,
                                               load_jax_params)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(variables, seed):
    """Replace every leaf with random values (the flax inits have zero
    biases and unit BN scales, which would hide layout mistakes)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 0.3 + (a.mean() if a.size else 0))
        .astype(np.float32), _np(variables))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,stride,pad,dil,bias", [
    (3, 1, 1, 1, True), (3, 2, 1, 1, False), (1, 1, 0, 1, False),
    (3, 1, 2, 2, False)])
def test_conv(k, stride, pad, dil, bias):
    x = _x(0, (2, 9, 12, 5))
    jm = jl.Conv(7, k, stride, pad, dil, use_bias=bias)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tm = tl.Conv(5, 7, k, stride, pad, dil, use_bias=bias)
    load_jax_params(tm, v)
    _close(_nhwc(tm(_nchw(x))), jm.apply(v, jnp.asarray(x)))


def test_conv_transpose_matches_flax_and_torch_geometry():
    """flax's flipped-kernel dilated conv == ConvTranspose2d(4, 2, 1) with
    the bridged weight (the two kernel flips cancel)."""
    x = _x(2, (2, 5, 6, 4))
    jm = jl.ConvTranspose(3, 4, 2, 1)
    v0 = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = tl.ConvTranspose(4, 3, 4, 2, 1)
    holder = torch.nn.Module()        # the bridge reads the module's name
    holder.ConvTranspose_0 = tm
    tl.init_weights(holder, torch.Generator().manual_seed(0))

    def named(v):
        return {"params": {"ConvTranspose_0": v["params"]}}

    np.testing.assert_allclose(               # bilinear init agrees
        from_jax_params(named(v0))["ConvTranspose_0.weight"].numpy(),
        tm.weight.detach().numpy())
    v = _randomize(v0, 3)
    load_jax_params(holder, named(v))
    out = tm(_nchw(x))
    assert out.shape == (2, 3, 10, 12)
    _close(_nhwc(out), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("running", [False, True])
def test_batchnorm_eval(running):
    x = _x(4, (3, 5, 6, 8)) * 2 + 1
    jm = jl.BatchNorm(track_running_stats=running)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 5)
    if running:
        v["batch_stats"]["var"] = np.abs(v["batch_stats"]["var"]) + 0.5
    tm = tl.BatchNorm(8, track_running_stats=running).eval()
    load_jax_params(tm, v)
    _close(_nhwc(tm(_nchw(x))), jm.apply(v, jnp.asarray(x), False))


def test_batchnorm_running_update_in_train():
    """track_running_stats=True in train: torch momentum 0.1, unbiased
    variance, batch statistics for the output (layers.py:470-482)."""
    x = _x(6, (3, 5, 6, 8))
    jm = jl.BatchNorm(track_running_stats=True)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    y_j, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    tm = tl.BatchNorm(8, track_running_stats=True).train()
    load_jax_params(tm, v)
    _close(_nhwc(tm(_nchw(x))), y_j)
    _close(tm.running_mean.numpy(), upd["batch_stats"]["mean"])
    _close(tm.running_var.numpy(), upd["batch_stats"]["var"])


def test_convbn_and_activations():
    x = _x(7, (2, 8, 10, 6))
    jm = jl.ConvBN(9, 3, 1, 1, 2)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 8)
    tm = tl.ConvBN(6, 9, 3, 1, 1, 2).eval()
    load_jax_params(tm, v)
    y = tm(_nchw(x))
    _close(_nhwc(y), jm.apply(v, jnp.asarray(x), False))
    _close(tl.leaky_relu(y).detach().numpy(),
           jl.leaky_relu(jnp.asarray(y.detach().numpy())))
    _close(_nhwc(tl.avg_pool(_nchw(x), 2)), jl.avg_pool(jnp.asarray(x), 2))


def test_encoder_matches_flax():
    x = _x(9, (2, 32, 48, 3))
    jm = JEncoder(feature_dim=16)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 10)
    want = jm.apply(v, jnp.asarray(x), False)
    tm = BaseEncoder(16).eval()
    load_jax_params(tm, v)
    with torch.inference_mode():
        got = tm(_nchw(x))
    for g, w in zip(got, want):
        _close(_nhwc(g), w, tol=1e-4)


def test_decoder_matches_flax():
    d, h, w = 16, 6, 8
    rs = np.random.RandomState(11)
    dpv = np.exp(rs.randn(2, h, w, d)).astype(np.float32)
    feats = [rs.randn(2, h, w, 16).astype(np.float32),
             rs.randn(2, 2 * h, 2 * w, 8).astype(np.float32),
             rs.rand(2, 4 * h, 4 * w, 3).astype(np.float32)]
    jm = JDecoder(d)
    jf = [jnp.asarray(f) for f in feats]
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(dpv), jf), 12)
    want = jm.apply(v, jnp.asarray(dpv), jf)
    tm = BaseDecoder(d, 16, 8).eval()
    load_jax_params(tm, v)
    with torch.inference_mode():
        got = tm(_nchw(dpv), [_nchw(f) for f in feats])
    _close(_nhwc(got), want, tol=1e-4)


@pytest.mark.parametrize("nmode,bn_avg", [("exp7_lc", False),
                                          ("exp7", True)])
def test_bridge_consumes_every_leaf_once(nmode, bn_avg):
    """Round trip over the whole model tree: every JAX leaf becomes exactly
    one state_dict entry, every entry of the port's model is filled, and
    each tensor reads back as its leaf (up to the layout permutation)."""
    from depthestimation_tpu.data import synthetic
    mi, _ = synthetic.make_batch(batch=1, t_win=1, h=32, w=48, d_min=3.0,
                                 d_max=30.0, ndepth=16)
    mi = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
          for k, a in mi.items()}
    jm = JModel(feature_dim=16, d=16, nmode=nmode, bn_avg=bn_avg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1)},
        mi, train=False))
    rs = np.random.RandomState(13)
    v = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    leaves = jax.tree_util.tree_leaves(v)
    sd = from_jax_params(v)
    assert len(sd) == len(leaves)
    tm = BaseModelNet(16, 16, nmode, bn_avg=bn_avg)
    load_jax_params(tm, v)                       # strict, shapes checked
    assert len(tm.state_dict()) == len(leaves)
    got = sorted(np.sort(t.numpy().ravel()).tobytes()
                 for t in tm.state_dict().values())
    want = sorted(np.sort(a.ravel()).tobytes() for a in leaves)
    assert got == want
    assert any(k.endswith("running_var") for k in sd) == bn_avg
