"""The sweep model family (``models/sweep.py``, ``losses/sweep_loss.py``,
``trainer/sweep.py``) against the JAX package on the same numpy inputs,
f32 on the CPU (64x48 for the model and the loss; the trainer at 96x64,
the smallest size the synthetic video renders, 16 sweep planes).

Tolerances:
- the forward through ``weights.load_jax_params`` (the whole tree, one to
  one), train and eval mode (BatchNorm takes batch statistics in both):
  the two outputs within 1e-4 (sigmoids: absolute);
- ``SweepLoss``: the value at rtol 1e-5 and its gradient with respect to
  both outputs within 1e-5 of the largest (f32 sums in another order);
  an item whose mask is empty adds 0;
- one ``SweepTrainer`` epoch (2 Adam steps) from JAX's initial weights,
  ``weight_decay`` 0: the first loss at rtol 1e-5, the second at 5e-4
  (Adam's first update moves a parameter whose gradient is zero to
  rounding either way, ``tests/test_torch_lc_step.py``), the validation's
  ``peak_int_err`` at rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg
from depthestimation_tpu.data.scheduler import BatchScheduler as JSched
from depthestimation_tpu.data.video_synthetic import (
    SyntheticSweepVideoDataset as JSweepDS)
from depthestimation_tpu.data.video_synthetic import (
    assemble_inputs as jassemble)
from depthestimation_tpu.losses import get_loss as jget_loss
from depthestimation_tpu.models import get_model as jget_model
from depthestimation_tpu.trainer import get_trainer as jget_trainer
from depthestimation_tpu.utils.logger import init_logger as jlogger
from depthestimation_tpu_torch.config import config_from_dict as tcfg
from depthestimation_tpu_torch.data.scheduler import BatchScheduler
from depthestimation_tpu_torch.data.video_synthetic import (
    SyntheticSweepVideoDataset)
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.losses.sweep_loss import SweepLoss
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.models.sweep import (SweepModel,
                                                    constrain_output)
from depthestimation_tpu_torch.trainer.factory import get_trainer
from depthestimation_tpu_torch.trainer.sweep import SweepTrainer
from depthestimation_tpu_torch.utils.logger import init_logger
from depthestimation_tpu_torch.weights import load_jax_params

W, H, P = 64, 48, 16
TW, TH = 96, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return {
        "data": {"exp_name": "sweep_t", "model_name": "sweep",
                 "loss_name": "sweep", "trainer_name": "sweep",
                 "dataset_path": "sweep", "dataset_split": "sweep"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0,
                "d_max": 30.0, "feature_dim": 32, "ndepth": 16,
                "softce": 0.3, "qpower": 1.0, "img_size": [TW, TH],
                "crop_w": TW, "nmode": "exp7", "bn_avg": False,
                "pnoise": 0.0},
        "loss": {"img_mult": 1.0},
        "train": {"batch_size": 2, "lr": 1e-4, "epoch_num": 1, "n_gpu": 1,
                  "optim": "adam", "print_freq": 1, "weight_decay": 0.0,
                  "self_recurse": 1},
    }


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's weights and its train- and eval-mode outputs, one program."""
    rgb = np.random.RandomState(0).rand(2, 2, 3, H, W).astype(np.float32)
    jm = jget_model(jcfg(_cfg()))

    def run(key, x):
        v = jm.init(key, {"rgb": x})
        return v, {t: jm.apply(v, {"rgb": x}, train=t) for t in (True,
                                                                  False)}

    v, outs = jax.jit(run)(jax.random.PRNGKey(0), jnp.asarray(rgb))
    return rgb, v, outs


@pytest.mark.parametrize("train", [True, False])
def test_sweep_model_forward_matches_jax(jax_forward, train):
    rgb, v, outs = jax_forward
    want = outs[train]
    model = get_model(tcfg(_cfg()), "cpu")
    assert isinstance(model, SweepModel)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, v))
    model.train(train)
    with torch.no_grad():
        got = model({"rgb": torch.from_numpy(rgb)})
    assert got["output"][0].shape == (2, 2, H // 4, W // 4)
    assert got["output_refined"][0].shape == (2, 2, H, W)
    for k in ("output", "output_refined"):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k][0]),
                                   rtol=0, atol=1e-4, err_msg=k)
    ps = got["output_refined"][0][:, 1]
    assert ps.min() >= 0.1 and ps.max() <= 4.1
    x = torch.tensor([[[[0.0]], [[0.0]]]])
    assert torch.allclose(constrain_output(x).flatten(),
                          torch.tensor([0.5, 2.1]))


def _loss_inputs(rs, empty_item: bool):
    def side():
        out = {"output_refined": [rs.rand(2, 2, H, W).astype(np.float32)],
               "output": [rs.rand(2, 2, H // 4, W // 4).astype(np.float32)]}
        fi = (rs.rand(2, P, H, W) * 255).astype(np.float32)
        fi[:, :, :5] = 0.0                        # no return: log(EPS)
        mask = (rs.rand(2, 1, H, W) > 0.3).astype(np.float32)
        if empty_item:
            mask[1] = 0.0
        return out, {"feat_int_tensor": fi, "mask_tensor": mask}
    return [side(), side()]


@pytest.mark.parametrize("empty_item", [False, True])
def test_sweep_loss_value_and_gradient_match_jax(empty_item):
    sides = _loss_inputs(np.random.RandomState(1), empty_item)
    cfg = _cfg()
    jl, tl = jget_loss(jcfg(cfg)), get_loss(tcfg(cfg))
    assert isinstance(tl, SweepLoss)
    gts = [g for _, g in sides]
    outs = [o for o, _ in sides]

    def jloss(o):
        return jl(o, [{k: jnp.asarray(v) for k, v in g.items()}
                      for g in gts])

    jo = jax.tree_util.tree_map(jnp.asarray, outs)
    want, gj = jax.value_and_grad(jloss)(jo)
    to = [{k: [torch.from_numpy(v[0]).requires_grad_()] for k, v in o.items()}
          for o in outs]
    got = tl(to, [{k: torch.from_numpy(v) for k, v in g.items()}
                  for g in gts])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if empty_item:
        # item 1 adds 0 (its sqrt(0) has no gradient, in JAX as here):
        # the loss is item 0's over the batch of 2
        half = tl([{k: [v[0][:1].detach()] for k, v in o.items()}
                   for o in to],
                  [{k: torch.from_numpy(v[:1]) for k, v in g.items()}
                   for g in gts])
        np.testing.assert_allclose(got.item(), half.item() / 2, rtol=1e-6)
        return
    got.backward()
    for s in range(2):
        for k in ("output", "output_refined"):
            g = to[s][k][0].grad.numpy()
            w = np.asarray(gj[s][k][0])
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def _loader(sched_cls):
    ds_cls = JSweepDS if sched_cls is JSched else SyntheticSweepVideoDataset
    ds = ds_cls(n_traj=2, traj_len=2, h=TH, w=TW, ndepth=16, d_min=3.0,
                d_max=30.0, planes=P)
    return sched_cls(ds, 2, shuffle=False, prefetch=False)


def test_sweep_trainer_epoch_matches_jax(tmp_path):
    cfg = jcfg(_cfg())
    loader = _loader(JSched)
    jtr = jget_trainer(cfg)(0, jget_model(cfg), jget_loss(cfg),
                            jlogger("t_sweep_jax", str(tmp_path / "j")),
                            str(tmp_path / "j"), cfg, loader, loader)
    batch = next(iter(loader.enumerate()))
    mi0, _ = jassemble(batch, "left", False)
    jtr.ensure_state({**mi0, "prev_output": None, "prev_lc": None})
    var0 = jax.tree_util.tree_map(np.array, {"params": jtr.state.params})
    jtr._run_one_epoch()
    jerr, jkeys = jtr._validate_with_gt()

    tc = tcfg(_cfg())
    assert get_trainer(tc) is SweepTrainer
    model = get_model(tc, "cpu")
    load_jax_params(model, var0)
    tloader = _loader(BatchScheduler)
    tr = get_trainer(tc)(0, model, get_loss(tc),
                         init_logger("t_sweep", str(tmp_path / "t")),
                         str(tmp_path / "t"), tc, tloader, tloader)
    tr.ensure_state()
    tr._run_one_epoch()
    losses = tr._last_epoch_losses
    assert len(losses) == len(jtr._last_epoch_losses) == 2
    np.testing.assert_allclose(losses[0], jtr._last_epoch_losses[0],
                               rtol=1e-5)
    np.testing.assert_allclose(losses[1], jtr._last_epoch_losses[1],
                               rtol=5e-4)
    err, keys = tr._validate_with_gt()
    assert keys == jkeys == ["peak_int_err"]
    np.testing.assert_allclose(err[0], jerr[0], rtol=1e-3)
    assert tr.foutput["peak_int_err"] == [err[0]]
    assert (tmp_path / "t" / "sweep_t.json").is_file()
