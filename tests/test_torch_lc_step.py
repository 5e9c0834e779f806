"""The slice as a whole: the port's train step with the light-curtain loop
inside (``make_train_step(loss_fn, lc_fn=fused_lc_fn(...))``) against the
JAX package's ``make_train_step(..., lc_fn=...)`` at a small size (exp7_lc,
feature_dim 16, D 16, 48x32, B 2, 2 LC iterations, default planner), f32,
on the flat Base3D route with the combine kernel's plain version
(``convcomb_pallas: false, combine_pallas: "interpret"`` on both sides).

Both start from one numpy-drawn weight tree on one synthetic batch, the hit
noise off on both sides' devices. The JAX step runs once under ``jax.jit``
and yields everything compared:

- the loss of step 1: rtol 1e-5 (as tests/test_torch_train_step.py);
- the gradient of each of the encoder, BV head, Base3D and decoder, read
  from JAX's first Adam moment (``mu = (1 - b1) g`` after one step, no
  weight decay): rel-L2 <= 3e-2. The f32 step is that sensitive at this
  point: a change of one part in 10^6 in the images moves some encoder and
  Base3D gradients by 1-2% (tests/test_torch_train_step.py);
- ``prev_output`` feedback: probabilities within 1e-4;
- ``prev_lc_left`` / ``prev_lc_right``: log DPVs that normalize, differ
  from log-uniform, and agree with JAX's as tests/test_torch_lc.py states
  for the loop: at most 10% of the 1/4-res columns may differ, the others
  within 2e-3 in probability;
- step 2 with ``prev_output`` and ``prev_lc`` fed back (the port is fed
  JAX's feedback, so that one differing ray does not fork the two runs;
  ``use_lc_prob`` 1.0: no random drop): the loss at rtol 5e-4. Adam's
  first update is lr times the gradient's sign, so a parameter whose
  gradient is zero to rounding moves either way: a change of one part in
  10^6 in the images moves the port's own second loss by up to 1.2e-4
  (three draws), as far as the port is from JAX here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg_from
from depthestimation_tpu.lc.curtain import LightCurtain as JLightCurtain
from depthestimation_tpu.lc.process import lc_process as j_lc_process
from depthestimation_tpu.losses.base_loss import BaseLoss as JBaseLoss
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu.ops import ufield as juf
from depthestimation_tpu.parallel import train_step as jts
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.ops import ufield as tuf
from depthestimation_tpu_torch.parallel import train_step as ts
from depthestimation_tpu_torch.trainer.default import fused_lc_fn
from depthestimation_tpu_torch.weights import from_jax_params, load_jax_params
from test_torch_train_step import (_CFG, B, D, FD, H, W, jax_variables,
                                   jnp_dict, make_batch, rel)

GROUPS = ("base_encoder.", "conv0", "based_3d.", "base_decoder.")
KEYS = {"convcomb_pallas": False, "combine_pallas": "interpret"}
CFG = dict(_CFG,
           data=dict(_CFG["data"], dataset_path="kitti"),
           train=dict(_CFG["train"], weight_decay=0.0),
           lc={"enabled": True, "iterations": 2, "planner": "default",
               "use_lc_prob": 1.0,
               "params": {"step": [0.5], "spread_iter": 2, "spread_n": 5}},
           tpu=dict(dtype="float32", **KEYS))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curtain(cls, cfg, mi, **kw):
    lc = cls(**kw)
    params = lc.gen_params_from_model_input(mi)
    # a freer galvo than the default: at 48 columns the default would pin
    # every path to one curve (tests/test_torch_lc.py)
    params["max_omega"] = 1.0e5
    lc.init(lc.expand_params(params, cfg, D, 2 * D))
    for dev in (lc.lightcurtain_large, lc.lightcurtain_small):
        dev.hit_noise = 0.0
    return lc


def _jax_lc_fn(cfg, lc):
    """``trainer/default.py:_fused_lc_fn`` of the JAX package, as
    ``bench_train.py:_make_lc_fn`` rebuilds it."""
    ufp = juf.UFieldParams.for_dataset(cfg.data.dataset_path)

    def lc_fn(refined_l, refined_r, mi_l, mi_r, key):
        refined = jnp.concatenate([refined_l, refined_r], axis=0)
        dmaps = jnp.concatenate([mi_l["dmaps"], mi_r["dmaps"]], axis=0)
        dmaps_up = jnp.repeat(jnp.repeat(dmaps, 4, axis=-2), 4, axis=-1)
        intr = jnp.concatenate([mi_l["intrinsics_up"],
                                mi_r["intrinsics_up"]], axis=0)
        out = j_lc_process(refined, dmaps_up, intr, lc, ufp,
                           iterations=int(cfg.lc.iterations),
                           planner=cfg.lc.planner,
                           params=dict(cfg.lc.params),
                           key=key)[:, :, ::4, ::4]
        return out[:B], out[B:]

    return lc_fn


@pytest.fixture(scope="module")
def runs():
    jc, tc = jcfg_from(CFG), tcfg.config_from_dict(CFG)
    mi_np, gt_np = make_batch()
    variables = jax_variables(mi_np)

    # -- JAX: two steps of the jitted LC-on step
    jm = JModel(feature_dim=FD, d=D, nmode="exp7_lc", use_lc_prob=1.0,
                **KEYS)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jts.make_optimizer(jc, params)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats={}, opt_state=tx.init(params))
    jstep = jts.make_train_step(
        jm, JBaseLoss(jc), tx, donate=False,
        lc_fn=_jax_lc_fn(jc, _curtain(JLightCurtain, jc, mi_np)))
    mi, gt = jnp_dict(mi_np), jnp_dict(gt_np)
    key = jax.random.PRNGKey(0)
    state1, loss1, aux1 = jstep(state, mi, mi, gt, gt, key)
    adam = [s for s in jax.tree_util.tree_leaves(
        state1.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    grads_j = from_jax_params({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - 0.9), adam[0].mu)})
    aux1 = {k: np.array(v) for k, v in aux1.items()}     # writable copies

    def fed(side):
        return dict(mi, prev_output=jnp.asarray(aux1[f"prev_output_{side}"]),
                    prev_lc=jnp.asarray(aux1[f"prev_lc_{side}"]))

    _, loss2, _ = jstep(state1, fed("left"), fed("right"), gt, gt, key)
    jax_out = {"loss1": float(loss1), "loss2": float(loss2), "aux": aux1,
               "grads": grads_j}

    # -- the port: the same two steps
    model = get_model(tc, "cpu")
    assert model.conv3d_path() == "flat+tap_combine"
    assert model.use_lc_prob == 1.0
    load_jax_params(model, variables)
    lc = _curtain(LightCurtain, tc, mi_np, device="cpu")
    step = ts.make_train_step(get_loss(tc), lc_fn=fused_lc_fn(
        tc, lc, tuf.UFieldParams.for_dataset(tc.data.dataset_path)))
    tstate = ts.init_state(model, tc)
    mi_t, gt_t = tsyn.to_device(mi_np, "cpu"), tsyn.to_device(gt_np, "cpu")
    gen = torch.Generator().manual_seed(0)
    tstate, tl1, taux1 = step(tstate, mi_t, mi_t, gt_t, gt_t, gen)
    grads_t = {k: p.grad.clone() for k, p in model.named_parameters()}

    def fed_t(side):
        return dict(mi_t,
                    prev_output=torch.from_numpy(aux1[f"prev_output_{side}"]),
                    prev_lc=torch.from_numpy(aux1[f"prev_lc_{side}"]))

    tstate, tl2, taux2 = step(tstate, fed_t("left"), fed_t("right"), gt_t,
                              gt_t, gen)
    port_out = {"loss1": tl1.item(), "loss2": tl2.item(), "aux": taux1,
                "aux2": taux2, "grads": grads_t, "state": tstate}
    return jax_out, port_out


def test_losses_match_jax(runs):
    j, t = runs
    assert np.isfinite(t["loss1"]) and np.isfinite(t["loss2"])
    np.testing.assert_allclose(t["loss1"], j["loss1"], rtol=1e-5)
    np.testing.assert_allclose(t["loss2"], j["loss2"], rtol=5e-4)
    assert t["loss1"] != t["loss2"]              # the feedback is an input
    assert t["state"].step == 2


@pytest.mark.parametrize("prefix", GROUPS)
def test_gradients_by_group_match_jax(runs, prefix):
    j, t = runs
    keys = [k for k in t["grads"] if k.startswith(prefix)]
    assert keys and set(t["grads"]) == set(j["grads"])
    got = torch.cat([t["grads"][k].flatten() for k in keys])
    want = torch.cat([j["grads"][k].flatten() for k in keys])
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 3e-2, (prefix, rel(got, want))


@pytest.mark.parametrize("side", ["left", "right"])
def test_prev_lc_feedback_matches_jax(runs, side):
    j, t = runs
    shape = (B, D, H // 4, W // 4)
    for aux in (t["aux"], t["aux2"]):
        pl = aux[f"prev_lc_{side}"]
        assert pl.shape == shape and not pl.requires_grad
        p = torch.exp(pl)
        assert torch.isfinite(pl).all()
        torch.testing.assert_close(p.sum(1), torch.ones_like(p.sum(1)),
                                   rtol=0, atol=1e-3)
        # the curtains sensed something: not the log-uniform prior
        assert (pl - np.log(1.0 / D)).abs().max() > 0.5
    p = torch.exp(t["aux"][f"prev_lc_{side}"]).numpy()
    q = np.exp(j["aux"][f"prev_lc_{side}"])
    off = (np.abs(p - q) > 2e-3).any(axis=(1, 2))               # [B, W/4]
    assert off.mean() <= 0.10, off.mean()
    keep = np.broadcast_to(~off[:, None, None, :], p.shape)
    assert np.abs(p - q)[keep].max() <= 2e-3
    po = torch.exp(t["aux"][f"prev_output_{side}"]).numpy()
    np.testing.assert_allclose(po, np.exp(j["aux"][f"prev_output_{side}"]),
                               rtol=0, atol=1e-4)


def test_lc_off_step_is_unchanged():
    """Without ``lc_fn`` the step returns no ``prev_lc`` and draws nothing
    more than before; with it, the LC loop draws after the two drops."""
    tc = tcfg.config_from_dict(CFG)
    mi_np, gt_np = make_batch()
    mi, gt = tsyn.to_device(mi_np, "cpu"), tsyn.to_device(gt_np, "cpu")
    model = get_model(tc, "cpu", seed=0)
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    _, loss, aux = ts.make_train_step(get_loss(tc))(
        ts.init_state(model, tc), mi, mi, gt, gt, gen)
    assert "prev_lc_left" not in aux and "prev_output_left" in aux
    assert torch.equal(gen.get_state(), before)  # prev_lc None: no draw
    assert np.isfinite(loss.item())
