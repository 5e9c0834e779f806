"""The flat Conv3d's depth-tap combine (``ops/combine_kernel.py``) and the
routing of ``tpu.convcomb_pallas`` / ``tpu.combine_pallas``, against the
JAX package.

- ``tap_combine_plain`` (what the wrapper runs on CPU tensors, and what the
  CUDA kernel equals bit for bit) and its backward against JAX's
  ``tap_combine(..., interpret=True)`` and ``tap_combine_xla`` at the
  shapes of tests/test_combine_pallas.py. f32: rtol/atol 1e-5, as there.
  bf16: equal to the interpret-mode Pallas kernel bit for bit: both sum the
  three taps in f32 and round once (the XLA roll+mask form sums in bf16,
  two roundings, and is not the yardstick).
- A ``BaseModelNet`` with ``convcomb_pallas: false, combine_pallas:
  "interpret"`` against the JAX model with the same keys and weights. f32:
  the limits of tests/test_torch_model.py (probabilities 1e-4, depth 1e-3
  m), at B=12 so that JAX's ``n >= 192`` gate lets its kernel run. bf16:
  tests/TOLERANCES.md rule 4 against the f32 oracle.
- Routing: which of the fused block, the combine wrapper, its plain version
  and the eager combine each setting reaches; the default route is the one
  it was (outputs bit-identical to the explicitly forced route)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.data import synthetic as jsyn
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu.ops.combine_pallas import (tap_combine as j_combine,
                                                    tap_combine_xla)
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.ops import combine_kernel as tc
from depthestimation_tpu_torch.ops.dpv import dpv_to_depthmap
from depthestimation_tpu_torch.weights import load_jax_params

SHAPES = [(2, 4, 3, 8, 8), (1, 6, 2, 16, 4), (3, 2, 1, 8, 8)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    """JAX [N, H, W, C] -> the port's [N, C, H, W] tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("b,d,h,w,f", SHAPES + [(2, 3, 2, 5, 1)])
def test_plain_forward_matches_jax_f32(b, d, h, w, f):
    x = _rand((b * d, h, w, 3 * f))
    got = _nhwc(tc.tap_combine(_nchw(x), d))
    for want in (j_combine(jnp.asarray(x), d, f, True),
                 tap_combine_xla(jnp.asarray(x), d, f)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert tc.tap_combine.launches == 0          # CPU: the plain version


@pytest.mark.parametrize("b,d,h,w,f", SHAPES)
def test_plain_bf16_equals_the_interpret_kernel_bit_for_bit(b, d, h, w, f):
    x = jnp.asarray(_rand((b * d, h, w, 3 * f), 3)).astype(jnp.bfloat16)
    want = np.asarray(j_combine(x, d, f, True).astype(jnp.float32))
    t = _nchw(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    y = tc.tap_combine(t, d)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(y), want)
    g = jnp.asarray(_rand((b * d, h, w, f), 4)).astype(jnp.bfloat16)
    _, pull = jax.vjp(lambda v: j_combine(v, d, f, True), x)
    dt = tc.tap_combine_bwd_plain(
        _nchw(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16), d)
    np.testing.assert_array_equal(
        _nhwc(dt), np.asarray(pull(g)[0].astype(jnp.float32)))


def test_depth_edges_zeroed():
    """Row 0 of an item takes no tap 0 from the item before, its last row
    no tap 2 from the item after; inside an item both flow."""
    b, d, h, w, f = 2, 3, 2, 8, 8
    x = torch.zeros(b * d, 3 * f, h, w)
    x[d - 1, :f] = 7.0
    x[d, 2 * f:] = 5.0
    assert torch.all(tc.tap_combine_plain(x, d) == 0.0)
    x2 = torch.zeros(b * d, 3 * f, h, w)
    x2[0, :f] = 7.0                              # t0[0] -> y[1]
    y2 = tc.tap_combine_plain(x2, d)
    assert torch.all(y2[1] == 7.0) and torch.all(y2[[0, 2, 3, 4, 5]] == 0.0)


@pytest.mark.parametrize("b,d,h,w,f", SHAPES[:2])
def test_vjp_matches_jax_f32(b, d, h, w, f):
    x, g = _rand((b * d, h, w, 3 * f), 1), _rand((b * d, h, w, f), 2)
    _, pull = jax.vjp(lambda t: j_combine(t, d, f, True), jnp.asarray(x))
    want = np.asarray(pull(jnp.asarray(g))[0])
    t = _nchw(x).requires_grad_()
    tc.tap_combine(t, d).backward(_nchw(g))      # the Function's backward
    np.testing.assert_allclose(_nhwc(t.grad), want, rtol=1e-5, atol=1e-5)
    tp = _nchw(x).requires_grad_()               # autograd of the plain ops
    tc.tap_combine_plain(tp, d).backward(_nchw(g))
    assert torch.equal(tp.grad, t.grad)
    assert tc.tap_combine.bwd_launches == 0


# ---- the model on the flat route ----------------------------------------

FD = D = 16
H, W = 32, 48


def _jnp(mi):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in mi.items()}


@pytest.fixture(scope="module")
def flat_models():
    """One JAX weight tree; the f32 oracle and the bf16 JAX output on the
    flat route with the combine kernel in interpret mode, at B=12 (192
    flattened rows: JAX's gate for the stacked-tap conv and its kernel)."""
    mi, _ = jsyn.make_batch(batch=12, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=1)
    keys = dict(convcomb_pallas=False, combine_pallas="interpret")
    j32 = JModel(feature_dim=FD, d=D, nmode="exp7_lc", **keys)
    jbf = JModel(feature_dim=FD, d=D, nmode="exp7_lc", dtype=jnp.bfloat16,
                 sweep_pallas="interpret", convbn2d=False, **keys)
    assert j32.conv3d_path(12, D, H // 4, W // 4) == "xla-flat"
    v = jax.jit(lambda r, m: j32.init(r, m, train=False))(
        {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1)},
        _jnp(mi))
    out32 = jax.jit(lambda p, m: j32.apply(p, m, train=False))(v, _jnp(mi))
    outbf = jax.jit(lambda p, m: jbf.apply(p, m, train=False))(v, _jnp(mi))
    return mi, jax.tree_util.tree_map(np.asarray, v), out32, outbf


def _port(mi, variables, dtype):
    tm = BaseModelNet(FD, D, "exp7_lc", dtype=dtype, convbn2d=False,
                      convcomb_pallas=False, combine_pallas="interpret")
    assert tm.conv3d_path() == "flat+tap_combine"
    load_jax_params(tm.eval(), variables)        # one tree, either route
    with torch.inference_mode():
        return tm(tsyn.to_device(mi, "cpu"))


def test_flat_route_f32_matches_jax(flat_models):
    mi, variables, out_j, _ = flat_models
    out_t = _port(mi, variables, None)
    ref_j = np.asarray(out_j["output_refined"][0])
    ref_t = out_t["output_refined"][0].numpy()
    np.testing.assert_allclose(np.exp(ref_t), np.exp(ref_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(np.exp(out_t["output"][1].numpy()),
                               np.exp(np.asarray(out_j["output"][1])),
                               rtol=0, atol=1e-4)
    d_candi = np.asarray(mi["d_candi"], np.float32)
    depth_t = dpv_to_depthmap(torch.from_numpy(ref_t), d_candi,
                              log=True).numpy()
    depth_j = (np.exp(ref_j) * d_candi[:, None, None]).sum(1)
    assert np.abs(depth_t - depth_j).max() <= 1e-3
    # in f32 the kernel's form and the eager roll+mask form are the same
    # sums in the same order: the two flat routes agree bit for bit
    eager = BaseModelNet(FD, D, "exp7_lc", convcomb_pallas=False).eval()
    load_jax_params(eager, variables)
    with torch.inference_mode():
        ref_e = eager(tsyn.to_device(mi, "cpu"))["output_refined"][0]
    assert torch.equal(ref_e, out_t["output_refined"][0])


def test_flat_route_bf16_rule4(flat_models):
    mi, variables, out32, outbf = flat_models
    oracle = np.asarray(out32["output_refined"][0])
    jax_bf = np.asarray(outbf["output_refined"][0])
    port_bf = _port(mi, variables, torch.bfloat16)["output_refined"][0]
    port_bf = port_bf.numpy()
    assert np.all(np.isfinite(port_bf))
    d_candi = np.asarray(mi["d_candi"], np.float32)[:, None, None]

    def dists(x):
        p, po = np.exp(x), np.exp(oracle)
        dep, depo = (p * d_candi).sum(1), (po * d_candi).sum(1)
        return (np.linalg.norm(dep - depo) / np.linalg.norm(depo),
                np.linalg.norm(p - po) / np.linalg.norm(po))

    floor = 4e-3
    for what, dj, dp in zip(("depth", "refined DPV"), dists(jax_bf),
                            dists(port_bf)):
        assert dp <= 3 * dj + floor, (what, dp, dj)


# ---- routing ---------------------------------------------------------------

def _cfg(dtype, **tpu):
    return tcfg.config_from_dict({
        "data": {"exp_name": "t", "model_name": "base"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0,
                "d_max": 30.0, "feature_dim": FD, "ndepth": D,
                "qpower": 1.0, "img_size": [W, H], "nmode": "exp7_lc",
                "bn_avg": False},
        "tpu": dict(dtype=dtype, **tpu)})


@pytest.fixture
def calls(monkeypatch):
    """Count what the layers reach: the fused block's wrapper and plain
    version, the combine's wrapper and plain version, the eager combine."""
    from depthestimation_tpu_torch.models import layers
    n = {}

    def spy(name):
        fn = getattr(layers, name)
        n[name] = 0

        def wrapped(*a, **k):
            n[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(layers, name, wrapped)

    for name in ("convbn_block", "convbn_block_plain", "tap_combine",
                 "tap_combine_plain", "depth_combine"):
        spy(name)
    return n


@pytest.mark.parametrize("dtype,tpu,path,reached", [
    ("bfloat16", {}, "convcomb", "convbn_block"),
    ("bfloat16", {"convcomb_pallas": True}, "convcomb", "convbn_block"),
    ("bfloat16", {"convcomb_pallas": False}, "flat", "depth_combine"),
    ("bfloat16", {"convcomb_pallas": False, "combine_pallas": True},
     "flat+tap_combine", "tap_combine"),
    ("bfloat16", {"convcomb_pallas": False, "combine_pallas": "interpret"},
     "flat+tap_combine", "tap_combine_plain"),
    ("bfloat16", {"combine_pallas": True}, "convcomb", "convbn_block"),
    ("float32", {}, "flat", "depth_combine"),
    ("float32", {"combine_pallas": True}, "flat+tap_combine", "tap_combine"),
    ("float32", {"convcomb_pallas": "interpret"}, "convcomb",
     "convbn_block_plain"),
])
def test_routing(calls, dtype, tpu, path, reached):
    """Each setting reaches its implementation 8 times a forward (7 ConvBN3d
    layers and the 1-channel classifier: no N or F gate) and no other."""
    model = get_model(_cfg(dtype, **tpu), "cpu", seed=0)
    assert model.conv3d_path(1, D, H // 4, W // 4) == path
    mi, _ = tsyn.make_batch(batch=1, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D)
    with torch.inference_mode():
        out = model(tsyn.to_device(mi, "cpu"))
    assert torch.isfinite(out["output_refined"][0]).all()
    assert calls == {k: 8 * (k == reached) for k in calls}
    assert tc.tap_combine.launches == 0


def _refined(dtype, **tpu):
    model = get_model(_cfg(dtype, **tpu), "cpu", seed=3)
    mi, _ = tsyn.make_batch(batch=1, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D)
    with torch.inference_mode():
        return model(tsyn.to_device(mi, "cpu"))["output_refined"][0]


@pytest.mark.parametrize("dtype,forced", [
    ("bfloat16", {"convcomb_pallas": True, "combine_pallas": False}),
    ("float32", {"convcomb_pallas": False, "combine_pallas": False})])
def test_default_route_did_not_move(dtype, forced):
    """With neither key the model runs the route it ran before the keys
    were honoured (bf16: the fused stack; f32: the flat stack with the
    eager combine): bit-identical to that route forced."""
    assert torch.equal(_refined(dtype), _refined(dtype, **forced))


def test_flat_routes_differ_from_the_fused_one_and_agree_with_each_other():
    fused = _refined("bfloat16")
    flat = _refined("bfloat16", convcomb_pallas=False)
    kernel = _refined("bfloat16", convcomb_pallas=False, combine_pallas=True)
    interp = _refined("bfloat16", convcomb_pallas=False,
                      combine_pallas="interpret")
    assert not torch.equal(fused, flat)          # the key is honoured
    assert torch.equal(kernel, interp)           # one route, one arithmetic
    # the eager combine rounds twice in bf16, the kernel's form once
    assert not torch.equal(flat, kernel)


def test_one_weight_tree_serves_both_routes():
    a = get_model(_cfg("bfloat16"), "cpu", seed=5).state_dict()
    b = get_model(_cfg("bfloat16", convcomb_pallas=False,
                       combine_pallas=True), "cpu", seed=5).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
