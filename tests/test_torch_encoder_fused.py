"""The port's BaseEncoder in its fused convbn2d route against the JAX
package's ``BaseEncoder(convbn2d="interpret")`` (the Pallas strip kernel
in interpret mode), at tests/test_encoder_fused.py's geometry, with the
flax weights carried over by ``weights.from_jax_params``.

- the fused route has the eager route's parameter names: JAX's fused
  parameter tree loads strictly into the port's fused encoder;
- the forward outputs and every parameter gradient are held to the f32
  eager oracle by tests/TOLERANCES.md rule 4: the port's distance is
  within max(3 x the JAX fused distance, 4e-3 x |oracle|). For a gradient
  the reference distance is the larger of JAX's two bf16 routes (fused
  and eager): the SPP branches pool the 8x12 map to a pixel or four and
  normalize over 2 to 8 values, so their bf16 conv gradients are noise
  (1x to 25x their own norm away from the oracle across JAX's routes);
  every other gradient sits at 0.01 to 1.1 on all routes;
- the running statistics of that train forward (``bn_avg=True``) against
  JAX's fused ones, at test_encoder_fused.py's tolerances (tight where the
  kernels' sums feed them, loose downstream of the chain).
The JAX sides run under ``jax.jit``; the weights are drawn with numpy into
the flax tree (``eval_shape``), as flax's init draws them. The decoder's
fused tail is in tests/test_torch_decoder_fused.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.models.encoder import BaseEncoder as JEncoder
from depthestimation_tpu_torch.models.encoder import BaseEncoder
from depthestimation_tpu_torch.ops import convbn2d_kernel as c2
from depthestimation_tpu_torch.weights import (from_jax_params,
                                               load_jax_params)

B, H, W = 2, 32, 48
FDIM = 32


def _x(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, W, 3) * 0.5).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1).astype(np.float64)


def _loss_terms(o1, feat):
    return (o1 ** 2).sum() * 0.1 + (feat ** 2).sum()


def _dist(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b)


def _variables(model, x):
    """The flax tree of ``model`` (``eval_shape``: nothing runs) with
    flax's init drawn by numpy: He normal by fan-out for kernels, unit BN
    scales, zero biases and running means, unit running variances."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), True))
    rs = np.random.RandomState(0)

    def init(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_out = np.prod(s.shape[:-2]) * s.shape[-1]
            return (rs.randn(*s.shape) * np.sqrt(2.0 / fan_out)).astype(
                np.float32)
        return np.full(s.shape, name in ("scale", "var"), np.float32)

    return jax.tree_util.tree_map_with_path(init, shapes)


def _grads_np(grads):
    return {k: v.numpy().astype(np.float64) for k, v in
            from_jax_params({"params": jax.tree_util.tree_map(
                np.asarray, grads)}).items()}


@pytest.fixture(scope="module")
def runs():
    """Outputs and gradients of the same loss on the same input, and the
    running statistics of that train forward: JAX f32 eager (the oracle),
    JAX bf16 fused (interpret) and the port's bf16 fused route."""
    x = _x(2)
    jo = JEncoder(FDIM, True, dtype=jnp.float32, convbn2d=False)
    jf = JEncoder(FDIM, True, dtype=jnp.bfloat16, convbn2d="interpret")
    variables = _variables(jf, x)

    def vg(m):
        def f(p, v):
            (o1, raw, feat), upd = m.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, v,
                True, mutable=["batch_stats"])
            loss = _loss_terms(o1.astype(jnp.float32),
                               feat.astype(jnp.float32))
            return loss, ((o1, raw, feat), upd)
        (_, (outs, upd)), grads = jax.jit(
            jax.value_and_grad(f, has_aux=True))(variables["params"],
                                                 jnp.asarray(x))
        return [np.asarray(o, np.float64) for o in outs], _grads_np(grads), \
            upd

    jx = JEncoder(FDIM, True, dtype=jnp.bfloat16, convbn2d=False)
    out = {"variables": variables, "oracle": vg(jo), "jax": vg(jf),
           "jax_eager": vg(jx)}
    tm = BaseEncoder(FDIM, True, dtype=torch.bfloat16, convbn2d="interpret")
    load_jax_params(tm, variables)
    tm.train()
    o1, raw, feat = tm(_nchw(x))
    _loss_terms(o1.float(), feat.float()).backward()
    out["port"] = ([_nhwc(o) for o in (o1, raw, feat)],
                   {k: p.grad.double().numpy()
                    for k, p in tm.named_parameters()}, tm.state_dict())
    return out


def test_fused_route_keeps_the_parameter_names(runs):
    """JAX's fused tree is the eager one, and it loads strictly (names and
    shapes) into the port's fused encoder: the weight bridge is unchanged."""
    v = runs["variables"]
    x = jnp.asarray(_x(0))
    eager = jax.eval_shape(
        lambda: JEncoder(FDIM, True, dtype=jnp.bfloat16, convbn2d=False)
        .init(jax.random.PRNGKey(0), x, True))
    assert (jax.tree_util.tree_structure(eager)
            == jax.tree_util.tree_structure(v))
    tm = BaseEncoder(FDIM, True, dtype=torch.bfloat16, convbn2d="interpret")
    load_jax_params(tm, v)                       # strict, shapes checked
    assert set(from_jax_params(v)) == set(tm.state_dict())


def test_forward_rule4(runs):
    outs_o, outs_j, outs_p = runs["oracle"][0], runs["jax"][0], \
        runs["port"][0]
    for name, oo, oj, op in zip(("out1", "raw", "feat"), outs_o, outs_j,
                                outs_p):
        bound = max(3.0 * _dist(oj, oo), 4e-3 * np.linalg.norm(oo))
        assert _dist(op, oo) <= bound, (name, _dist(op, oo), _dist(oj, oo))
    assert c2.convbn2d_block.launches == 0


def test_grads_rule4(runs):
    g_o, g_j, g_p = runs["oracle"][1], runs["jax"][1], runs["port"][1]
    g_x = runs["jax_eager"][1]
    assert set(g_o) == set(g_j) == set(g_p)
    for k, go in g_o.items():
        ref = max(_dist(g_j[k], go), _dist(g_x[k], go))
        bound = max(3.0 * ref, 4e-3 * np.linalg.norm(go))
        assert _dist(g_p[k], go) <= bound, (k, _dist(g_p[k], go), ref)
    assert c2.convbn2d_block.bwd_launches == 0


def test_running_stats(runs):
    """The train forward's running statistics: the port's fused route
    against JAX's fused one."""
    want = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {"params": runs["variables"]["params"],
                     **runs["jax"][2]}))
    got = runs["port"][2]
    fused = ("ConvBN_0.", "ConvBN_1.", "ConvBN_2.", "_Stage_0.", "_Stage_1.")
    n = 0
    for k, w in want.items():
        if not k.endswith(("running_mean", "running_var")):
            continue
        tight = k.startswith(fused)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=3e-2 if tight else 1e-1,
                                   atol=5e-3 if tight else 5e-2, err_msg=k)
        n += 1
    assert n > 40
