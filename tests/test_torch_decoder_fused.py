"""The port's BaseDecoder with its fused refine tail (the three
full-resolution 3x3 convs through ops/convbn2d_kernel.py, each bias and
leaky ReLU riding the next layer's load) against the JAX package's
``BaseDecoder(convbn2d="interpret")``, at tests/test_encoder_fused.py's
decoder geometry, with the flax weights carried over by
``weights.from_jax_params``.

The output and every parameter gradient (and the input's) are held to the
f32 eager oracle by tests/TOLERANCES.md rule 4: the port's distance is
within max(3 x the JAX fused distance, 4e-3 x |oracle|). The JAX sides run
under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from depthestimation_tpu.models.decoder import BaseDecoder as JDecoder
from depthestimation_tpu_torch.models.decoder import BaseDecoder
from depthestimation_tpu_torch.ops import convbn2d_kernel as c2
from depthestimation_tpu_torch.weights import (from_jax_params,
                                               load_jax_params)

D = 16


def _inputs():
    rs = np.random.RandomState(7)
    logits = rs.randn(2, 8, 12, D)
    dpv = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    feats = [rs.randn(2, 8, 12, 8) * 0.3, rs.randn(2, 16, 24, 4) * 0.3,
             rs.randn(2, 32, 48, 3) * 0.3]
    return dpv.astype(np.float32), [f.astype(np.float32) for f in feats]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _dist(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b)


def test_fused_tail_rule4():
    dpv, feats = _inputs()
    jfeats = [jnp.asarray(f) for f in feats]
    jo = JDecoder(D, dtype=jnp.float32, convbn2d=False)
    jf = JDecoder(D, dtype=jnp.bfloat16, convbn2d="interpret")
    params = jax.tree_util.tree_map(
        np.asarray, jo.init(jax.random.PRNGKey(0), jnp.asarray(dpv),
                            jfeats))

    def run(m):
        def f(p, v):
            out = m.apply(p, v, jfeats)
            return jnp.sum(out ** 2) / v.size, out
        (_, out), (gp, gv) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(dpv))
        grads = {k: t.numpy().astype(np.float64) for k, t in
                 from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                        gp)).items()}
        grads["dpv"] = np.asarray(gv, np.float64)
        return np.asarray(out, np.float64), grads

    (o_o, g_o), (o_j, g_j) = run(jo), run(jf)

    tm = BaseDecoder(D, 8, 4, 3, dtype=torch.bfloat16, convbn2d="interpret")
    assert tm.use_fused()
    load_jax_params(tm, params)
    v = _nchw(dpv).requires_grad_()
    out = tm(v, [_nchw(f) for f in feats])
    ((out ** 2).sum() / v.numel()).backward()
    assert c2.convbn2d_block.launches == c2.convbn2d_block.bwd_launches == 0
    o_p = np.moveaxis(out.detach().double().numpy(), 1, -1)
    g_p = {k: p.grad.double().numpy() for k, p in tm.named_parameters()}
    g_p["dpv"] = np.moveaxis(v.grad.double().numpy(), 1, -1)

    assert _dist(o_p, o_o) <= max(3.0 * _dist(o_j, o_o),
                                  4e-3 * np.linalg.norm(o_o))
    assert set(g_p) == set(g_o)
    for k, go in g_o.items():
        bound = max(3.0 * _dist(g_j[k], go), 4e-3 * np.linalg.norm(go))
        assert _dist(g_p[k], go) <= bound, (k, _dist(g_p[k], go),
                                            _dist(g_j[k], go))


def test_tail_routing():
    """True takes the tail for a bf16 decoder only; "interpret" at any
    dtype; False never."""
    def mk(dtype, cc):
        return BaseDecoder(D, 8, 4, 3, dtype=dtype, convbn2d=cc)

    assert mk(torch.bfloat16, True).use_fused()
    assert not mk(None, True).use_fused()
    assert mk(None, "interpret").use_fused()
    assert not mk(torch.bfloat16, False).use_fused()
