"""The config keys that route a ``BaseModelNet`` as in JAX
(``tpu.sweep_dtype``, ``tpu.conv3d_flat``, ``var.diffhomo``), and the
port's TF32 contract.

- Routing: which sweep (the kernel wrapper or the f32 plain version, or
  none), which Base3D stack and which BV-head width ``get_model`` builds
  for each value, and ``ValueError`` for a value the key does not take.
- ``diffhomo: false`` (no sweep: the cost is the reference frame's
  features, the diagonal warp the gather form on every view) against the
  JAX model with the same weights and inputs, f32: the limits of
  tests/test_torch_model.py (probabilities 1e-4, depth 1e-3 m).
- TF32: the f32 entry points (``BaseModelNet``'s forward, the train step's
  backward, ``SintelTrainer._step`` and its validation) read both TF32
  switches off inside their convs, whatever the caller left them at, and
  restore them after. The switches are read on the CPU too, so a patched
  conv sees what cuDNN would."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depthestimation_tpu.data import synthetic as jsyn
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.models import layers
from depthestimation_tpu_torch.ops import plane_sweep
from depthestimation_tpu_torch.ops.dpv import dpv_to_depthmap
from depthestimation_tpu_torch.parallel.train_step import (init_state,
                                                           make_train_step)
from depthestimation_tpu_torch.weights import load_jax_params

FD = D = 16
H, W = 48, 72


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype="bfloat16", var=None, **tpu):
    v = {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0, "d_max": 30.0,
         "feature_dim": FD, "ndepth": D, "qpower": 1.0,
         "img_size": [W, H], "nmode": "exp7_lc", "bn_avg": False}
    v.update(var or {})
    return tcfg.config_from_dict({
        "data": {"exp_name": "t", "model_name": "base"}, "var": v,
        "train": {"batch_size": 1, "lr": 1e-5, "optim": "adam"},
        "tpu": dict(dtype=dtype, **tpu)})


def _batch(batch=1, seed=0):
    mi, _ = tsyn.make_batch(batch=batch, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=seed)
    return mi


@pytest.fixture
def calls(monkeypatch):
    """Count what a forward reaches: the sweep kernel's wrapper and its
    plain version (with the dtype it ran in), the gather warp, the fused
    Base3D block and the flat stack's eager combine."""
    n = {"sweep_stage2": [], "sweep_stage2_plain": []}

    def spy_sweep(name):
        fn = getattr(plane_sweep, name)

        def wrapped(*a, **k):
            n[name].append(a[0].dtype)
            return fn(*a, **k)
        monkeypatch.setattr(plane_sweep, name, wrapped)

    def spy(mod, name):
        fn = getattr(mod, name)
        n[name] = 0

        def wrapped(*a, **k):
            n[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy_sweep("sweep_stage2")
    spy_sweep("sweep_stage2_plain")
    from depthestimation_tpu_torch.models import base_model
    spy(base_model, "warp_feature_volume_batched")
    spy(layers, "convbn_block")
    spy(layers, "depth_combine")
    return n


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,keys,sweep,plain,warp,path,conv0_in", [
    ("bfloat16", {}, [BF], [], 0, "convcomb", D),
    ("bfloat16", {"sweep_dtype": "auto"}, [BF], [], 0, "convcomb", D),
    ("bfloat16", {"sweep_dtype": "bfloat16"}, [BF], [], 0, "convcomb", D),
    ("bfloat16", {"sweep_dtype": "float32"}, [], [F32], 0, "convcomb", D),
    ("float32", {}, [], [F32], 0, "flat", D),
    ("float32", {"sweep_dtype": "bfloat16"}, [BF], [], 0, "flat", D),
    ("bfloat16", {"conv3d_flat": True}, [BF], [], 0, "convcomb", D),
    ("bfloat16", {"conv3d_flat": False}, [BF], [], 0, "flat", D),
    ("bfloat16", {"conv3d_flat": False, "convcomb_pallas": True,
                  "combine_pallas": True}, [BF], [], 0, "flat", D),
    ("bfloat16", {"diffhomo": True}, [BF], [], 0, "convcomb", D),
    ("bfloat16", {"diffhomo": False}, [], [], 1, "convcomb", FD),
    ("float32", {"diffhomo": False}, [], [], 1, "flat", FD),
])
def test_routing(calls, dtype, keys, sweep, plain, warp, path, conv0_in):
    keys = dict(keys)
    var = {"diffhomo": keys.pop("diffhomo")} if "diffhomo" in keys else {}
    model = get_model(_cfg(dtype, var, **keys), "cpu", seed=0)
    assert model.conv3d_path() == path
    assert model.conv0.Conv_0.in_channels == conv0_in
    with torch.inference_mode():
        out = model(tsyn.to_device(_batch(), "cpu"))
    assert torch.isfinite(out["output_refined"][0]).all()
    assert calls["sweep_stage2"] == sweep
    assert calls["sweep_stage2_plain"] == plain
    assert calls["warp_feature_volume_batched"] == warp
    fused = path == "convcomb"
    assert (calls["convbn_block"], calls["depth_combine"]) == (
        (8, 0) if fused else (0, 8))


@pytest.mark.parametrize("var,tpu", [
    ({}, {"sweep_dtype": "float16"}),
    ({}, {"sweep_dtype": None}),
    ({}, {"conv3d_flat": "false"}),
    ({"diffhomo": "no"}, {}),
    ({"diffhomo": 0}, {}),
])
def test_bad_values_raise(var, tpu):
    with pytest.raises(ValueError):
        get_model(_cfg("bfloat16", var, **tpu), "cpu", seed=0)


def test_diffhomo_false_matches_jax_f32():
    mi, _ = jsyn.make_batch(batch=2, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=4)
    mij = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in mi.items()}
    jm = JModel(feature_dim=FD, d=D, nmode="exp7", diffhomo=False)

    @jax.jit
    def init_apply(rng, m):
        v = jm.init(rng, m, train=False)
        return v, jm.apply(v, m, train=False)

    variables, out_j = init_apply({"params": jax.random.PRNGKey(0),
                                   "lc_drop": jax.random.PRNGKey(1)}, mij)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = get_model(_cfg("float32", {"diffhomo": False, "nmode": "exp7"}),
                   "cpu")
    load_jax_params(tm, variables)
    with torch.inference_mode():
        out_t = tm(tsyn.to_device(mi, "cpu"))
    ref_j = np.asarray(out_j["output_refined"][0])
    ref_t = out_t["output_refined"][0].numpy()
    np.testing.assert_allclose(np.exp(ref_t), np.exp(ref_j), rtol=0,
                               atol=1e-4)
    for i in range(2):                       # bv, bv_upd
        np.testing.assert_allclose(np.exp(out_t["output"][i].numpy()),
                                   np.exp(np.asarray(out_j["output"][i])),
                                   rtol=0, atol=1e-4)
    depth_t = dpv_to_depthmap(torch.from_numpy(ref_t), mi["d_candi"],
                              log=True).numpy()
    depth_j = (np.exp(ref_j) * np.asarray(mi["d_candi"], np.float32)[
        :, None, None]).sum(1)
    assert np.abs(depth_t - depth_j).max() <= 1e-3


# ---- TF32 ------------------------------------------------------------------

def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 switches on, as a caller may leave them; every conv2d
    records the switches in its forward and, through a hook on its
    output, in its backward."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = {"forward": set(), "backward": set()}
    conv = F.conv2d

    def spy(*a, **k):
        seen["forward"].add(_flags())
        y = conv(*a, **k)
        if y.requires_grad:
            y.register_hook(lambda g: seen["backward"].add(_flags()))
        return y
    monkeypatch.setattr(F, "conv2d", spy)
    yield seen
    assert _flags() == (True, True)          # restored after the entry
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def test_depth_entry_points_run_without_tf32(tf32_on):
    model = get_model(_cfg("float32"), "cpu", seed=0)
    mi = tsyn.to_device(_batch(), "cpu")
    with torch.inference_mode():
        model(mi)
    assert tf32_on["forward"] == {(False, False)}

    def loss_fn(outs, gts):
        return sum(o["output_refined"][0].exp().mean() for o in outs)

    state = init_state(model, _cfg("float32"))
    _, loss, _ = make_train_step(loss_fn)(state, mi, mi, None, None)
    assert torch.isfinite(loss)
    assert tf32_on["forward"] == {(False, False)}
    assert tf32_on["backward"] == {(False, False)}


def test_flow_entry_points_run_without_tf32(tf32_on, tmp_path):
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.trainer import sintel as ts
    from depthestimation_tpu_torch.trainer.factory import get_trainer
    from depthestimation_tpu_torch.utils.logger import init_logger
    cfg = tcfg.config_from_dict({
        "data": {"exp_name": "t_tf32", "model_name": "pwclite",
                 "loss_name": "unflow", "trainer_name": "sintel",
                 "dataset_path": "synthetic",
                 "dataset_split": "synthetic"},
        "loss": {"w_ssim": 0.85, "w_smooth": 75.0, "w_ternary": 0.0},
        "train": {"batch_size": 1, "n_epoch": 1, "epoch_size": 1,
                  "valid_size": 1, "print_freq": 100, "lr": 2e-4}})
    data = ts.synthetic_flow_batches(1, batch=1, h=64, w=64, seed=0)
    model = get_model(cfg, "cpu", seed=0)
    tr = get_trainer(cfg)(0, model, get_loss(cfg), init_logger("t_tf32"),
                          str(tmp_path), cfg, data, data)
    loss, _ = tr._step(tr._img_pair(data[0]))
    assert torch.isfinite(loss)
    assert np.isfinite(tr._validate_with_gt())
    assert tf32_on["forward"] == {(False, False)}
    assert tf32_on["backward"] == {(False, False)}
