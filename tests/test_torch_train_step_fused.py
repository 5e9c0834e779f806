"""The slice as a whole: the port's bf16 train step through the fused 2D
ConvBN layers against the JAX bf16 step through its Pallas strip kernel,
and the routing of ``tpu.convbn2d``.

- Rule 4 (tests/TOLERANCES.md): both steps with ``convbn2d="interpret"``
  (the encoder's fused chain and the decoder's fused tail; the port runs
  its kernels' plain versions on CPU tensors, JAX its three Pallas kernels
  in interpret mode) start from the same weights on the same batch; each
  is measured against the port's f32 eager step, as in
  tests/test_torch_train_step_bf16.py: the loss and the gradient of each
  of the encoder, BV head, Base3D and decoder, within 3x the JAX distance
  plus 0.4%.
- Routing: ``get_model`` reads ``tpu.convbn2d`` (default "auto"); a bf16
  model with "auto" takes the fused encoder in ``.train()`` and the eager
  one in ``.eval()``, an f32 model stays eager, True adds the decoder's
  tail in both modes; the wrappers are reached where the route says, and
  their launch counters stay at 0 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.ops import convbn2d_kernel as c2
from test_torch_train_step import (_CFG, D, FD, H, W, cfgs,
                                   jax_value_and_grad, jax_variables,
                                   jnp_dict, make_batch, port_grads,
                                   port_step)
from test_torch_train_step_bf16 import GROUPS, _group_rel


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fused_bf16_step_rule4_against_jax():
    batch = make_batch()
    variables = jax_variables(batch[0])
    jc, _ = cfgs()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jbf = JModel(feature_dim=FD, d=D, nmode="exp7_lc", dtype=jnp.bfloat16,
                 sweep_pallas="interpret", convcomb_pallas="interpret",
                 convbn2d="interpret")
    lbf, gbf = jax_value_and_grad(jbf, jc)(
        params, jnp_dict(batch[0]), jnp_dict(batch[1]))
    grads_j = port_grads(gbf)
    (l32,), oracle, _, _ = port_step(batch, variables, None)

    losses, grads, _, _ = port_step(batch, variables, torch.bfloat16,
                                    convbn2d="interpret")
    assert np.isfinite(losses[0])
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert c2.convbn2d_block.launches == c2.convbn2d_block.bwd_launches == 0
    floor = 4e-3
    d_port = abs(losses[0] - l32) / abs(l32)
    d_jax = abs(float(lbf) - l32) / abs(l32)
    assert d_port <= 3 * d_jax + floor, (d_port, d_jax)
    for prefix in GROUPS:
        dp = _group_rel(grads, oracle, prefix)
        dj = _group_rel(grads_j, oracle, prefix)
        assert dp <= 3 * dj + floor, (prefix, dp, dj)


def _cfg(dtype, convbn2d=None):
    tpu = {"dtype": dtype}
    if convbn2d is not None:
        tpu["convbn2d"] = convbn2d
    return tcfg.config_from_dict(dict(_CFG, tpu=tpu))


@pytest.fixture
def calls(monkeypatch):
    """Count the fused layer's wrapper where the layers reach it."""
    from depthestimation_tpu_torch.models import layers
    n = {"convbn2d": 0}

    def spy(*a, **k):
        n["convbn2d"] += 1
        return c2.convbn2d_block(*a, **k)

    monkeypatch.setattr(layers, "convbn2d_block", spy)
    return n


# fused layers per forward at feature_dim 16: the stem's two stride-1
# convs, stage 0's three blocks and stage 1's three tail blocks (2 convs
# each) = 14; the decoder's tail adds 3
@pytest.mark.parametrize("dtype,cc,train,path,want", [
    ("bfloat16", None, True, "convbn2d", 14),
    ("bfloat16", None, False, "eager", 0),
    ("float32", None, True, "eager", 0),
    ("bfloat16", False, True, "eager", 0),
    ("bfloat16", True, True, "convbn2d", 17),
    ("bfloat16", True, False, "eager", 3),
    ("float32", "interpret", False, "convbn2d", 17)])
def test_routing(calls, dtype, cc, train, path, want):
    model = get_model(_cfg(dtype, cc), "cpu", seed=0)
    assert model.convbn2d == ("auto" if cc is None else cc)
    model.train(train)
    assert model.encoder_path(H, W) == path
    mi, _ = tsyn.make_batch(batch=1, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D)
    with torch.no_grad():
        out = model(tsyn.to_device(mi, "cpu"),
                    generator=torch.Generator().manual_seed(0))
    assert calls["convbn2d"] == want
    assert c2.convbn2d_block.launches == 0
    assert torch.isfinite(out["output_refined"][0]).all()


def test_fused_route_needs_sizes_divisible_by_4():
    model = get_model(_cfg("bfloat16"), "cpu", seed=0).train()
    assert model.encoder_path(H, W) == "convbn2d"
    assert model.encoder_path(H + 2, W) == "eager"


def test_default_device_is_the_card():
    """Without a device the entry points build on CUDA: on a machine
    without a card that is an error, not a silent CPU run."""
    import inspect

    from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime
    for fn in (get_model, NetRuntime):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert next(get_model(_cfg("float32")).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            get_model(_cfg("float32"))
