"""The port's train step (parallel/train_step.py) against the JAX package.

- the weight-decay groups against ``_decay_mask``, and one Adam / AdamW
  update on a fed-in gradient against optax at 1e-6;
- the f32 step from the same weights (weight bridge) on the same batch:
  the loss of 3 Adam steps at rtol 1e-5, and every parameter's gradient
  (mapped through ``weights.from_jax_params``) within 3x plus 1e-3 of the
  largest rel-L2 by which the port's own gradient moves when the input
  images move by one part in 10^6 (three draws). The step is that
  sensitive at this point: such a change moves some encoder and Base3D
  gradients by 1-2% (the decoder's by 2e-5), as far as the port is from
  JAX. (The bf16 step is held by rule 4 in
  tests/test_torch_train_step_bf16.py.)
- the train-mode ``prev_lc`` drop at ``use_lc_prob`` 1.0 and 0.0 against
  JAX's ``_drop_prev_lc`` (both branches deterministic), and its draws;
- kernel dispatch of a step: bf16 reaches the sweep wrapper twice and the
  Base3D block wrapper 16 times (two camera sides), forward and backward;
  f32 reaches neither."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg_from
from depthestimation_tpu.losses.base_loss import BaseLoss as JBaseLoss
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu.parallel import train_step as jts
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.parallel import train_step as ts
from depthestimation_tpu_torch.weights import from_jax_params, load_jax_params

FD = D = 16
H, W = 32, 48
B = 2
_CFG = {
    "data": {"exp_name": "t", "model_name": "base", "loss_name": "base"},
    "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0, "d_max": 30.0,
            "feature_dim": FD, "ndepth": D, "qpower": 1.0,
            "img_size": [W, H], "nmode": "exp7_lc", "bn_avg": False},
    "loss": {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0,
             "smooth_mul": 0.5, "dc_mul": 0.25, "rsc_low_mul": 0.0},
    "train": {"batch_size": B, "lr": 1e-5, "optim": "adam", "beta": 0.999,
              "momentum": 0.9, "weight_decay": 1e-6, "bias_decay": 0.0},
}


def cfgs(**train):
    d = dict(_CFG, train=dict(_CFG["train"], **train))
    return jcfg_from(d), tcfg.config_from_dict(d)


def jnp_dict(d):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def make_batch():
    mi, gt = tsyn.make_batch(batch=B, t_win=1, h=H, w=W, d_min=3.0,
                             d_max=30.0, ndepth=D, seed=4)
    # 1 cm off a rectified rig: keeps the warp grid's first and last rows
    # off the validity edge |y| = 1 (see tests/test_torch_loss.py)
    gt["T_left2right"] = gt["T_left2right"].copy()
    gt["T_left2right"][1, 3] = 0.01
    return mi, gt


def jax_variables(mi: dict) -> dict:
    """A JAX parameter tree for the exp7_lc model, drawn with numpy (He
    normal by fan-out for kernels, unit BN scales, zero biases); only its
    structure comes from flax (``eval_shape``: nothing is compiled)."""
    shapes = jax.eval_shape(
        lambda r, m: JModel(feature_dim=FD, d=D, nmode="exp7_lc").init(
            r, m, train=False),
        {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1)},
        jnp_dict(mi))
    rs = np.random.RandomState(0)

    def init(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_out = np.prod(s.shape[:-2]) * s.shape[-1]
            return (rs.randn(*s.shape) * np.sqrt(2.0 / fan_out)).astype(
                np.float32)
        return np.full(s.shape, name == "scale", np.float32)

    return {"params": jax.tree_util.tree_map_with_path(init,
                                                       shapes["params"])}


def jax_value_and_grad(model, cfg):
    """The JAX step's loss and gradient for two camera sides that see the
    same batch: one forward serves both sides (no running statistics, no
    draws: the two forwards would be the same), which halves the trace."""
    loss = JBaseLoss(cfg)

    def f(params, mi, gt):
        out = model.apply({"params": params}, mi, train=True,
                          rngs={"lc_drop": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])[0]
        return loss([out, out], [gt, gt])

    return jax.jit(jax.value_and_grad(f))


def port_grads(tree) -> dict:
    return from_jax_params({"params": jax.tree_util.tree_map(np.asarray,
                                                             tree)})


def port_step(batch, variables, dtype, steps=1, convbn2d=False):
    """(losses, step-0 gradients, last aux, state) of the port's step;
    ``convbn2d`` routes the fused 2D ConvBN layers (eager by default, as
    the JAX steps these tests compare with)."""
    _, tc = cfgs()
    model = BaseModelNet(FD, D, "exp7_lc", dtype=dtype, convbn2d=convbn2d)
    load_jax_params(model, variables)
    state = ts.init_state(model, tc)
    step = ts.make_train_step(get_loss(tc))
    mi = tsyn.to_device(batch[0], "cpu")
    gt = tsyn.to_device(batch[1], "cpu")
    losses, grads = [], None
    for _ in range(steps):
        state, loss, aux = step(state, mi, mi, gt, gt)
        losses.append(loss.item())
        if grads is None:
            grads = {k: p.grad.clone() for k, p in
                     model.named_parameters()}
    return losses, grads, aux, state


def rel(a, b):
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def variables(batch):
    return jax_variables(batch[0])


def test_f32_step_matches_jax(batch, variables):
    jc, _ = cfgs()
    vg = jax_value_and_grad(JModel(feature_dim=FD, d=D, nmode="exp7_lc"),
                            jc)
    mi, gt = jnp_dict(batch[0]), jnp_dict(batch[1])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jts.make_optimizer(jc, params)
    opt = tx.init(params)
    losses_j, grads_j = [], None
    for _ in range(3):
        loss, g = vg(params, mi, gt)
        grads_j = grads_j or port_grads(g)
        losses_j.append(float(loss))
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)

    losses, grads, aux, state = port_step(batch, variables, None, steps=3)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert state.step == 3
    assert set(grads) == set(grads_j)
    mi_np, gt_np = batch
    moved = []
    for seed in range(3):
        rgb = mi_np["rgb"] * (1 + 1e-6 * np.random.RandomState(seed).randn(
            *mi_np["rgb"].shape))
        moved.append(port_step((dict(mi_np, rgb=rgb.astype(np.float32)),
                                gt_np), variables, None)[1])
    for k in grads:
        sens = max(rel(g[k], grads[k]) for g in moved)
        assert rel(grads[k], grads_j[k]) <= 3 * sens + 1e-3, k
    assert aux["prev_output_left"].shape == (B, D, H // 4, W // 4)
    assert not aux["refined_left"].requires_grad


@pytest.mark.parametrize("p", [1.0, 0.0])
def test_drop_prev_lc_matches_jax(p):
    prev = np.random.RandomState(5).randn(B, D, H // 4, W // 4).astype(
        np.float32)
    jm = JModel(feature_dim=FD, d=D, nmode="exp7_lc", use_lc_prob=p)
    want = jm.apply({}, jnp.asarray(prev), prev.shape, True,
                    method=JModel._drop_prev_lc,
                    rngs={"lc_drop": jax.random.PRNGKey(3)})
    tm = BaseModelNet(FD, D, "exp7_lc", use_lc_prob=p).train()
    got = tm._drop_prev_lc(torch.from_numpy(prev), torch.zeros(prev.shape),
                           torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_prev_lc_draws():
    """One draw per train-mode call with prev_lc; none without it or in
    eval; a train-mode call with prev_lc needs a generator."""
    tm = BaseModelNet(FD, D, "exp7_lc", use_lc_prob=0.7)
    like = torch.zeros(1, D, 2, 3)
    prev = torch.randn(1, D, 2, 3)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    tm.train()
    assert torch.equal(tm._drop_prev_lc(None, like, gen),
                       torch.full_like(like, float(np.log(1.0 / D))))
    tm.eval()
    assert tm._drop_prev_lc(prev, like, gen) is prev
    assert torch.equal(gen.get_state(), state)
    tm.train()
    picks = [tm._drop_prev_lc(prev, like, gen) is prev for _ in range(200)]
    assert 0.55 < np.mean(picks) < 0.85
    with pytest.raises(ValueError, match="Generator"):
        tm._drop_prev_lc(prev, like, None)


def test_train_forward_draws_the_drop(batch, variables):
    """At use_lc_prob 0 a train-mode forward with prev_lc is the forward
    without it; in eval prev_lc is used."""
    tm = BaseModelNet(FD, D, "exp7_lc", use_lc_prob=0.0)
    load_jax_params(tm, variables)
    mi = tsyn.to_device(batch[0], "cpu")
    prev = torch.log_softmax(torch.randn(B, D, H // 4, W // 4), dim=1)
    with torch.no_grad():
        tm.train()
        dropped = tm(dict(mi, prev_lc=prev),
                     generator=torch.Generator())["output_refined"][0]
        none = tm(mi)["output_refined"][0]
        tm.eval()
        kept = tm(dict(mi, prev_lc=prev))["output_refined"][0]
    torch.testing.assert_close(dropped, none)
    assert not torch.allclose(kept, none)


def test_decay_groups_match_jax(variables):
    mask_j = jts._decay_mask(variables["params"])
    want = port_grads(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), mask_j,
        variables["params"]))
    got = ts._decay_mask(BaseModelNet(FD, D, "exp7_lc"))
    assert set(got) == set(want)
    assert all(got[k] == bool(want[k].flatten()[0]) for k in got)
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("optim", ["adam", "adamw"])
def test_one_update_matches_optax(variables, optim):
    jc, tc = cfgs(optim=optim, lr=1e-2, weight_decay=1e-2, bias_decay=1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rs = np.random.RandomState(6)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32)), params)
    tx = jts.make_optimizer(jc, params)
    upd, _ = tx.update(grads, tx.init(params), params)
    want = port_grads(optax.apply_updates(params, upd))

    tm = BaseModelNet(FD, D, "exp7_lc")
    load_jax_params(tm, variables)
    opt = ts.make_optimizer(tc, tm)
    g_t = port_grads(grads)
    for k, p in tm.named_parameters():
        p.grad = g_t[k].clone()
    opt.step()
    for k, p in tm.named_parameters():
        torch.testing.assert_close(p.detach(), want[k], rtol=0, atol=1e-6)
    ts.set_learning_rate(opt, 5e-3)
    assert all(g["lr"] == 5e-3 for g in opt.param_groups)


def test_eval_step_is_the_eval_forward(batch, variables):
    tm = BaseModelNet(FD, D, "exp7_lc")
    load_jax_params(tm, variables)
    mi = tsyn.to_device(batch[0], "cpu")
    tm.train()
    out = ts.make_eval_step(tm)(mi)
    assert not tm.training
    with torch.inference_mode():
        want = tm(mi)
    torch.testing.assert_close(out["output_refined"][0],
                               want["output_refined"][0])


@pytest.fixture
def spies(monkeypatch):
    """Count the kernel wrappers where the model reaches them and the
    plain backwards their CPU Functions reach."""
    from depthestimation_tpu_torch.models import layers
    from depthestimation_tpu_torch.ops import convcomb_kernel as ck
    from depthestimation_tpu_torch.ops import plane_sweep
    from depthestimation_tpu_torch.ops import sweep_kernel as sk
    calls = {"sweep": 0, "convcomb": 0, "sweep_bwd": 0, "convcomb_bwd": 0}

    def wrap(name, fn):
        def spy(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(plane_sweep, "sweep_stage2",
                        wrap("sweep", plane_sweep.sweep_stage2))
    monkeypatch.setattr(layers, "convbn_block",
                        wrap("convcomb", layers.convbn_block))
    monkeypatch.setattr(sk, "sweep_stage2_bwd_plain",
                        wrap("sweep_bwd", sk.sweep_stage2_bwd_plain))
    monkeypatch.setattr(ck, "convbn_block_bwd_plain",
                        wrap("convcomb_bwd", ck.convbn_block_bwd_plain))
    return calls


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, (2, 16, 2, 16)),
                                        (None, (0, 0, 0, 0))])
def test_step_kernel_dispatch(spies, batch, variables, dtype, want):
    losses, _, _, _ = port_step(batch, variables, dtype)
    assert np.isfinite(losses[0])
    assert (spies["sweep"], spies["convcomb"], spies["sweep_bwd"],
            spies["convcomb_bwd"]) == want
