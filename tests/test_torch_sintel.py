"""The flow trainers (``trainer/sintel.py``), the checkpoint module and the
factories against the JAX package on the same numpy inputs and weights.

- One ``SintelTrainer`` step (PWCLite at output level 2, 64x64, B=2,
  ``UnFlowLoss``, Adam): the loss and its terms within 1e-4 relative (the
  smoothness term is linear in the flows, which agree to 1e-4),
  each parameter's gradient within 1e-4 of its max|JAX| (f32 sums of
  another order through the whole net), and the Adam-updated parameters
  within 1e-2 lr of JAX's wherever |g| > 1e-2 max|g| of its parameter,
  and within 2 lr elsewhere (a first Adam step moves each weight by lr
  g / (|g| + eps), about lr sign(g), so a gradient near 0 may take the
  other sign), all against one jitted JAX step.
- ``evaluate_flow_epe``, ``affine_resample`` and ``transform_flow``: 1e-5.
- The AR step's ``l_atst``, ``l_ot`` and total against JAX's helpers
  composed as ``SintelARTrainer._loss_terms`` composes them, with the same
  theta, rectangles and noise injected: 1e-4 relative.
- ``synthetic_flow_batches`` equal to JAX's; a checkpoint round trip;
  ``stage1`` and ``halflr`` at their epochs; ``train()`` keeps the best
  checkpoint; the factories' wiring.
The weights are the JAX tree's shapes (``jax.eval_shape``) filled from a
seed, with zero biases as flax initializes them; both JAX references run
in one ``jax.jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthestimation_tpu import config as jcfg
from depthestimation_tpu.losses import flow_loss as jf
from depthestimation_tpu.models import pwclite as jp
from depthestimation_tpu.trainer import sintel as js
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.losses.flow_loss import UnFlowLoss
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.models import pwclite as tp
from depthestimation_tpu_torch.trainer import checkpoint as ck
from depthestimation_tpu_torch.trainer import sintel as ts
from depthestimation_tpu_torch.trainer.factory import get_trainer
from depthestimation_tpu_torch.utils.logger import init_logger
from depthestimation_tpu_torch.weights import from_jax_params, load_jax_params

HW, B, LEVEL = 64, 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(trainer="sintel", **train):
    d = {"data": {"exp_name": "t_sintel", "model_name": "pwclite",
                  "loss_name": "unflow", "trainer_name": trainer,
                  "dataset_path": "synthetic",
                  "dataset_split": "synthetic"},
         "loss": {"w_ssim": 0.85, "w_smooth": 75.0, "w_ternary": 0.0},
         "train": {"batch_size": B, "n_epoch": 1, "epoch_size": 4,
                   "valid_size": 2, "print_freq": 100, "lr": 2e-4,
                   "momentum": 0.9, "beta": 0.999, "halflr": [],
                   "w_ar": 0.1},
         "seed": 0}
    d["train"].update(train)
    return d


def _batch(seed=1):
    data = ts.synthetic_flow_batches(1, batch=B, h=HW, w=HW, seed=seed)[0]
    return data, np.concatenate([data["img1"], data["img2"]],
                                1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params():
    model = jp.PWCLite(output_level=LEVEL)
    shapes = jax.eval_shape(
        lambda k, v: model.init(k, v, with_bk=True)["params"],
        jax.random.PRNGKey(0), jnp.zeros((B, 6, HW, HW)))
    rs = np.random.RandomState(0)

    def fill(s):
        if len(s.shape) == 4:
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _jax_trainer(trainer="sintel"):
    cfg = jcfg.config_from_dict(_cfg_dict(trainer))
    cls = js.SintelARTrainer if trainer == "sintel_ar" else js.SintelTrainer
    return cls(0, jp.PWCLite(output_level=LEVEL), jf.UnFlowLoss(cfg),
               None, "", cfg)


def _torch_trainer(tmp_path, trainer="sintel", **train):
    cfg = tcfg.config_from_dict(_cfg_dict(trainer, **train))
    model = tp.PWCLite(output_level=LEVEL)
    load_jax_params(model, {"params": _params()})
    return get_trainer(cfg)(0, model, UnFlowLoss(cfg),
                            init_logger("test_torch_sintel"), str(tmp_path),
                            cfg)


def test_one_step_matches_a_jitted_jax_step(tmp_path):
    loss_w, terms_w, grads_w, new_w = _jax_run()[0]
    tr = _torch_trainer(tmp_path)
    _, pair = _batch()
    loss, terms = tr._step(torch.from_numpy(pair))
    assert abs(loss.item() - loss_w) <= 1e-4 * abs(loss_w)
    for k, v in terms_w.items():
        assert abs(terms[k].item() - v) <= 1e-4 * abs(v), k
    grads = from_jax_params({"params": grads_w})
    new = from_jax_params({"params": new_w})
    named = dict(tr.model.named_parameters())
    assert set(named) == set(grads)
    lr = tr.lr
    for k, p in named.items():
        g, w = p.grad.numpy(), grads[k].numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k
        d = np.abs(p.detach().numpy() - new[k].numpy())
        assert d.max() <= 2.0 * lr, k
        clear = np.abs(w) > 1e-2 * np.abs(w).max()
        assert d[clear].max() <= 1e-2 * lr, k


def test_flow_helpers_match_jax():
    rs = np.random.RandomState(3)
    gt = rs.randn(2, 2, 32, 48).astype(np.float32)
    pred = rs.randn(2, 2, 8, 12).astype(np.float32)
    assert ts.evaluate_flow_epe(gt, torch.from_numpy(pred)) == pytest.approx(
        js.evaluate_flow_epe(gt, pred), rel=1e-5)
    assert ts.evaluate_flow_epe(gt, torch.from_numpy(gt)) == 0.0
    x = rs.uniform(0, 1, (2, 3, 16, 24)).astype(np.float32)
    flow = (rs.randn(2, 2, 16, 24) * 2).astype(np.float32)
    theta = np.stack([np.array([[0.95, -0.1, 0.02], [0.12, 1.05, -0.03]]),
                      np.array([[1.1, 0.05, -0.04], [-0.08, 0.9, 0.01]])]
                     ).astype(np.float32)
    for fn_t, fn_j, a in ((ts.affine_resample, js.affine_resample, x),
                          (ts.transform_flow, js.transform_flow, flow)):
        got = fn_t(torch.from_numpy(a), torch.from_numpy(theta)).numpy()
        want = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(theta)))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    eye = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]]).expand(2, 2, 3)
    torch.testing.assert_close(ts.affine_resample(torch.from_numpy(x), eye),
                               torch.from_numpy(x))


def _draws():
    rs = np.random.RandomState(4)
    theta = np.stack([np.array([[0.97, -0.15, 0.03], [0.15, 0.97, -0.02]]),
                      np.array([[1.05, 0.1, -0.01], [-0.1, 1.05, 0.02]])]
                     ).astype(np.float32)
    return {"theta": theta, "oy": np.array([3, 40]),
            "ox": np.array([47, 0]),
            "noise": rs.uniform(0, 1, (B, 3, HW, HW)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """One jitted JAX call (one trace, one compile) of both references on
    ``_batch()``: the ``SintelTrainer`` step (loss, terms, gradients,
    Adam-updated parameters) and the AR terms, JAX's helpers composed as
    ``SintelARTrainer._loss_terms`` composes them with ``_draws()``
    injected (total, l_atst, l_ot). The AR terms take the teacher, the
    mask and the photometric total from the step's own forward, and run
    the two student passes as one batch (PWCLite has no batch coupling),
    so the model is traced three times, not five."""
    tr, ar = _jax_trainer(), _jax_trainer("sintel_ar")
    model = ar.model
    ph = pw = int(HW * ar.ot_frac)

    def robust(diff, mask):
        l = (jnp.abs(diff) + ar.ar_eps) ** ar.ar_q
        return jnp.mean(l * mask) / (jnp.mean(mask) + 1e-7)

    def run(params, opt_state, img_pair, theta, oy, ox, noise):
        (loss, (terms, out)), grads = jax.value_and_grad(
            tr._loss_terms, has_aux=True)(params, img_pair,
                                          jax.random.PRNGKey(0))
        updates, _ = tr.tx.update(grads, opt_state, params)
        teacher = jax.lax.stop_gradient(out["flows_fw"][0])
        noc = jax.lax.stop_gradient(terms.pop("noc_mask"))
        step = (loss, terms, grads, optax.apply_updates(params, updates))

        img_t = js.affine_resample(img_pair, theta)
        flow_t = js.transform_flow(teacher, theta)
        gy = jnp.arange(HW)[None, :, None]
        gx = jnp.arange(HW)[None, None, :]
        rect = ((gy >= oy[:, None, None]) & (gy < (oy + ph)[:, None, None])
                & (gx >= ox[:, None, None]) & (gx < (ox + pw)[:, None, None]))
        rect = rect[:, None].astype(img_pair.dtype)
        img2_oc = img_pair[:, 3:] * (1 - rect) + noise * rect
        img_oc = jnp.concatenate([img_pair[:, :3], img2_oc], axis=1)
        students = model.apply({"params": params}, jnp.concatenate(
            [img_t, img_oc]))["flows_fw"][0]
        l_atst = robust(students[:B] - flow_t,
                        js.affine_resample(noc, theta))
        l_ot = robust(students[B:] - teacher, noc)
        return step, (loss + ar.w_ar * l_atst + ar.w_ar * l_ot, l_atst, l_ot)

    params = jax.tree_util.tree_map(jnp.asarray, _params())
    dr = _draws()
    out = jax.jit(run)(params, tr.tx.init(params), jnp.asarray(_batch()[1]),
                       *(jnp.asarray(dr[k]) for k in ("theta", "oy", "ox",
                                                      "noise")))
    return jax.tree_util.tree_map(np.asarray, out)


def test_ar_terms_match_jax_with_injected_draws(tmp_path):
    total_w, atst_w, ot_w = (float(v) for v in _jax_run()[1])
    tr = _torch_trainer(tmp_path, "sintel_ar")
    assert isinstance(tr, ts.SintelARTrainer)
    _, pair = _batch()
    draws = {k: torch.from_numpy(v) for k, v in _draws().items()}
    total, terms, _ = tr._loss_terms(torch.from_numpy(pair), draws)
    for got, want in ((total, total_w), (terms["l_atst"], atst_w),
                      (terms["l_ot"], ot_w)):
        assert np.isfinite(want) and want > 0
        assert abs(got.item() - want) <= 1e-4 * abs(want)
    # the trainer's own draws: shapes and ranges of the injected ones
    own = tr.draw(B, HW, HW)
    assert own["theta"].shape == (B, 2, 3)
    assert own["noise"].shape == (B, 3, HW, HW)
    assert int(own["oy"].max()) <= HW - 16 and int(own["ox"].min()) >= 0
    loss, t = tr._step(torch.from_numpy(pair), draws)
    assert np.isfinite(loss.item()) and set(t) >= {"l_atst", "l_ot"}


def test_synthetic_flow_batches_equal_jax():
    a = ts.synthetic_flow_batches(2, batch=2, h=16, w=24, seed=3)
    b = js.synthetic_flow_batches(2, batch=2, h=16, w=24, seed=3)
    for x, y in zip(a, b):
        for k in ("img1", "img2"):
            np.testing.assert_array_equal(x[k], y[k])
        np.testing.assert_array_equal(x["target"]["flow"],
                                      y["target"]["flow"])


def test_checkpoint_round_trip(tmp_path):
    model = tp.PWCLite(output_level=1)
    tp.init_weights(model, torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = {"model": model.state_dict(), "optimizer": opt.state_dict()}
    assert not ck.checkpoint_exists(str(tmp_path), "exp")
    ck.save_checkpoint(str(tmp_path), "exp", state, 3, is_best=True)
    assert ck.checkpoint_exists(str(tmp_path), "exp")
    assert ck.checkpoint_exists(str(tmp_path), "exp", best=True)
    loaded, epoch = ck.load_checkpoint(str(tmp_path), "exp", state,
                                       best=True)
    assert epoch == 3
    for k, v in state["model"].items():
        torch.testing.assert_close(loaded["model"][k], v)
    with pytest.raises(ValueError):
        ck.load_checkpoint(str(tmp_path), "exp", {"model": None})
    # partial restore: keys and shapes that match are taken, others kept
    other = tp.PWCLite(output_level=2).state_dict()
    merged = ck.restore_params_partial(other, loaded["model"])
    assert set(merged) == set(other)
    torch.testing.assert_close(merged["conv1x1_0.weight"],
                               loaded["model"]["conv1x1_0.weight"])
    assert merged["conv1x1_2.weight"] is other["conv1x1_2.weight"]


def test_stage1_and_halflr_apply_at_their_epochs(tmp_path):
    tr = _torch_trainer(tmp_path, halflr=[1])
    tr.cfg["stage1"] = tcfg.Config({"epoch": 2, "loss": {"w_ternary": 1.0,
                                                          "w_ssim": 0.0}})
    tr.train_loader = []
    lrs, weights = [], []
    for _ in range(3):
        tr._run_one_epoch()
        lrs.append(tr.lr)
        weights.append((tr.loss_func.w_ssim, tr.loss_func.w_ternary))
    assert lrs == [2e-4, 1e-4, 1e-4]
    assert weights == [(0.85, 0.0), (0.85, 0.0), (0.0, 1.0)]


def test_train_keeps_the_best_checkpoint(tmp_path):
    tr = _torch_trainer(tmp_path, epoch_size=1, valid_size=1)
    tr.train_loader = ts.synthetic_flow_batches(1, batch=B, h=HW, w=HW)
    tr.val_loader = ts.synthetic_flow_batches(1, batch=B, h=HW, w=HW,
                                              seed=2)
    best = tr.train()
    assert np.isfinite(best) and tr.i_iter == 1 and tr.i_epoch == 1
    state, epoch = ck.load_checkpoint(str(tmp_path), "t_sintel", best=True)
    assert epoch == 1 and set(state) == {"model", "optimizer"}
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(state["model"][k], v)


def test_factories_wire_the_flow_slice():
    cfg = tcfg.load_config("configs/sintel_flow.json")
    assert get_trainer(cfg) is ts.SintelTrainer
    cfg.data.trainer_name = "sintel_ar"
    assert get_trainer(cfg) is ts.SintelARTrainer
    cfg.data.trainer_name = "default"
    from depthestimation_tpu_torch.trainer.default import DefaultTrainer
    assert get_trainer(cfg) is DefaultTrainer
    cfg.data.trainer_name = "sweep"
    from depthestimation_tpu_torch.trainer.sweep import SweepTrainer
    assert get_trainer(cfg) is SweepTrainer
    assert isinstance(get_loss(cfg), UnFlowLoss)
    model = get_model(cfg, "cpu", seed=0)
    assert isinstance(model, tp.PWCLite) and model.output_level == 4
    assert model.search_range == 4 and model.use_kernels
    assert next(model.parameters()).dtype == torch.float32
