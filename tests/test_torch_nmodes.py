"""The rest of the model family against the JAX package, f32, at the
widths of tests/test_nmodes.py (B 2, D 32, feature_dim 32, 64x96).

- ``BaseModelNet`` in nmodes default, exp2 (``tofuse_dpv`` from the batch's
  depth through ``gen_dpv_withmask``, as tests/test_nmodes.py builds it),
  exp3 and lc with the sweep (``var.diffhomo`` true: the cost volume
  alone), and the gather sweep (``sweep_impl: "gather"``) of exp7 and of
  default: eval and train forward from the same weights
  (``weights.load_jax_params``) on the same numpy batch. Every DPV of
  ``output`` and ``output_refined`` is compared as probabilities at atol
  1e-4, as tests/test_torch_model.py does, or at three times the most
  that DPV of the port moves when the input images move by one part in
  10^6, where that is larger: the cost volume's squared distances make
  the BV head that sensitive (lc with the sweep: the port's own ``bv_upd``
  moves by 1.0e-4 to 1.3e-4 under such a change, and sits 1.1e-4 from
  JAX's; the cost volume alone is 8e-8 rel-L2 from JAX's). JAX's eval
  and train forwards
  are one function here (``bn_avg`` false: batch statistics in both; no
  ``prev_lc``, so no draw), so one jitted JAX forward serves both modes.
- exp3's loss through ``BaseLoss`` and its gradient: the loss at rtol 1e-5
  and all the gradients as one vector at rel-L2 1e-3 plus three times the
  most the port's own gradient moves when the input images move by one
  part in 10^6 (two draws), the rule of tests/test_torch_train_step.py:
  such a change moves it by 3e-3 to 7e-3, and it sits 3.8e-3 from JAX's.
- exp3 in bf16 (the port's plain versions, JAX's XLA routes): rule 4 of
  tests/TOLERANCES.md, both measured against the f32 oracle.
- exp8 raises ``ValueError`` on both sides; exp2 without ``tofuse_dpv``
  raises ``KeyError`` naming it.
- ``DefaultModel`` and ``PackNetModel`` (eval) against JAX at the same
  atol. JAX's dropout draws cannot be reproduced, so PackNet's train mode
  is checked for shapes, finite values and the keep rate of its masks.
- ``get_model(cfg, "cpu", seed=0)`` builds every config in ``configs/``
  and both new model names.

The JAX weights are drawn with numpy on the tree's shapes
(``jax.eval_shape``), and each JAX model is compiled once; the torch side
runs on one thread (module fixture)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg_from
from depthestimation_tpu.data import synthetic as jsyn
from depthestimation_tpu.losses.base_loss import BaseLoss as JBaseLoss
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu.models.base_model import DefaultModel as JDefault
from depthestimation_tpu.models.packnet import PackNetModel as JPackNet
from depthestimation_tpu.ops import dpv as jdpv
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models import get_model, packnet
from depthestimation_tpu_torch.models.base_model import (BaseModelNet,
                                                         DefaultModel)
from depthestimation_tpu_torch.weights import from_jax_params, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FD = D = 32
H, W = 64, 96
B = 2
_CFG = {
    "data": {"exp_name": "t", "model_name": "base", "loss_name": "base"},
    "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 5.0, "d_max": 40.0,
            "feature_dim": FD, "ndepth": D, "qpower": 1.0,
            "img_size": [W, H], "nmode": "exp3", "bn_avg": False},
    "loss": {"ce_mul": 1.0, "dsc_mul": 1.0, "rsc_mul": 1.0,
             "smooth_mul": 0.5, "dc_mul": 0.25, "rsc_low_mul": 0.0},
    "train": {"batch_size": B, "lr": 1e-5, "optim": "adam"},
}
#: case -> BaseModelNet keywords (both packages take these names)
CASES = {
    "default": dict(nmode="default"),
    "exp2": dict(nmode="exp2"),
    "exp3": dict(nmode="exp3"),
    "lc_sweep": dict(nmode="lc"),
    "exp7_gather": dict(nmode="exp7", sweep_impl="gather"),
    "default_gather": dict(nmode="default", sweep_impl="gather"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jnp_dict(d):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


@pytest.fixture(scope="module")
def batch():
    mi, gt = jsyn.make_batch(batch=B, t_win=1, h=H, w=W, d_min=5.0,
                             d_max=40.0, ndepth=D, seed=0)
    mi["tofuse_dpv"] = np.asarray(jdpv.gen_dpv_withmask(
        mi["dmaps"], mi["masks"], mi["d_candi"], 0.3), np.float32)
    # 1 cm off a rectified rig: keeps the loss's warp grid off the
    # validity edge (tests/test_torch_loss.py)
    gt["T_left2right"] = gt["T_left2right"].copy()
    gt["T_left2right"][1, 3] = 0.01
    return mi, gt


def numpy_variables(init_fn, seed: int = 0) -> dict:
    """A parameter tree of ``init_fn``'s shapes (``jax.eval_shape``:
    nothing is compiled), drawn with numpy: He normal by fan-out for
    kernels, unit scales, zero biases."""
    shapes = jax.eval_shape(init_fn)
    rs = np.random.RandomState(seed)

    def init(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_out = np.prod(s.shape[:-2]) * s.shape[-1]
            return (rs.randn(*s.shape) * np.sqrt(2.0 / fan_out)).astype(
                np.float32)
        return np.full(s.shape, name == "scale", np.float32)

    return {"params": jax.tree_util.tree_map_with_path(init,
                                                       shapes["params"])}


_RNGS = {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}
_JAX = {}


def jax_case(name: str, mi: dict):
    """(variables, JAX train-mode outputs as numpy) of ``CASES[name]``,
    one compile per case, cached for the module."""
    if name not in _JAX:
        jm = JModel(feature_dim=FD, d=D, **CASES[name])
        mij = jnp_dict(mi)
        v = numpy_variables(lambda: jm.init(_RNGS, mij, train=False))
        out = jax.jit(lambda p, m: jm.apply(
            p, m, train=True, rngs={"lc_drop": jax.random.PRNGKey(3)},
            mutable=["batch_stats"])[0])(v, mij)
        _JAX[name] = v, jax.tree_util.tree_map(np.asarray, out)
    return _JAX[name]


def assert_dpvs_match(out_t: dict, out_j: dict, moved: dict | None = None):
    """Every DPV as probabilities within 1e-4 of JAX's, or within three
    times ``moved``'s distance from ``out_t`` (the port's output on input
    images moved by one part in 10^6) where that is larger."""
    for key in ("output", "output_refined"):
        assert len(out_t[key]) == len(out_j[key]), key
        for i, (a, b) in enumerate(zip(out_t[key], out_j[key])):
            a = a.detach().numpy()
            assert a.shape == b.shape, key
            atol = 1e-4
            if moved is not None:
                sens = np.abs(np.exp(moved[key][i].numpy()) - np.exp(a))
                atol = max(atol, 3 * float(sens.max()))
            np.testing.assert_allclose(np.exp(a), np.exp(b), rtol=0,
                                       atol=atol, err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(batch, case, mode):
    mi = batch[0]
    variables, out_j = jax_case(case, mi)
    tm = BaseModelNet(FD, D, **CASES[case])
    load_jax_params(tm, variables)
    tm.train(mode == "train")
    rgb = mi["rgb"] * (1 + 1e-6 * np.random.RandomState(0).randn(
        *mi["rgb"].shape))
    with torch.no_grad():
        out_t = tm(tsyn.to_device(mi, "cpu"))
        moved = tm(tsyn.to_device(dict(mi, rgb=rgb.astype(np.float32)),
                                  "cpu"))
    assert_dpvs_match(out_t, out_j, moved)
    n_out = 1 if CASES[case]["nmode"] == "default" else 2
    assert len(out_t["output"]) == n_out
    assert out_t["output_refined"][0].shape == (B, D, H, W)


def test_single_output_nmodes_take_the_train_step(batch):
    """default's ``output`` has one entry and PackNet's refined DPV is 64
    wide: the loss reads ``output[-1]`` and iterates ``output``, so the
    step needs no nmode-specific code (port only)."""
    from depthestimation_tpu_torch.models.layers import init_weights
    from depthestimation_tpu_torch.parallel.train_step import (
        init_state, make_train_step)
    mi, gt = (tsyn.to_device(x, "cpu") for x in batch)
    cfg = tcfg.config_from_dict(_CFG)
    for model in (BaseModelNet(FD, D, "default"), DefaultModel(D)):
        init_weights(model, torch.Generator().manual_seed(0))
        step = make_train_step(get_loss(cfg))
        state, loss, _ = step(init_state(model, cfg), mi, mi, gt, gt)
        assert np.isfinite(loss.item()) and state.step == 1


def test_based_3d_only_where_jax_builds_it():
    """default and exp2 carry no Base3D (their JAX trees have none, so the
    weights map one to one); exp3's takes 1 + T planes."""
    for nmode, has in (("default", False), ("exp2", False), ("exp3", True),
                       ("exp7", True), ("lc", True), ("exp8", False)):
        assert hasattr(BaseModelNet(FD, D, nmode), "based_3d") == has
    first = BaseModelNet(FD, D, "exp3").based_3d.ConvBN3d_0.Conv3d_0
    assert first.weight.shape[1] == 3


def test_exp3_loss_and_gradients_match_jax(batch):
    mi, gt = batch
    jc = jcfg_from(_CFG)
    jm = JModel(feature_dim=FD, d=D, nmode="exp3")
    variables, _ = jax_case("exp3", mi)
    loss_j = JBaseLoss(jc)

    def f(params, m, g):
        out = jm.apply({"params": params}, m, train=True,
                       rngs={"lc_drop": jax.random.PRNGKey(3)},
                       mutable=["batch_stats"])[0]
        return loss_j([out, out], [g, g])

    lj, gj = jax.jit(jax.value_and_grad(f))(
        variables["params"], jnp_dict(mi), jnp_dict(gt))
    grads_j = from_jax_params({"params": jax.tree_util.tree_map(np.asarray,
                                                                gj)})

    loss_t = get_loss(tcfg.config_from_dict(_CFG))
    gtt = tsyn.to_device(gt, "cpu")

    def port(m):
        """(loss, all the gradients as one vector, their names)."""
        tm = BaseModelNet(FD, D, "exp3").train()
        load_jax_params(tm, variables)
        out = tm(tsyn.to_device(m, "cpu"))
        loss = loss_t([out, out], [gtt, gtt])
        loss.backward()
        grads = dict(tm.named_parameters())
        keys = sorted(grads)
        return (loss.item(), torch.cat([grads[k].grad.flatten()
                                        for k in keys]), keys)

    def rel(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b)).item()

    loss, got, keys = port(mi)
    np.testing.assert_allclose(loss, float(lj), rtol=1e-5)
    assert keys == sorted(grads_j)
    want = torch.cat([grads_j[k].flatten() for k in keys])
    sens = 0.0
    for seed in range(2):
        rgb = mi["rgb"] * (1 + 1e-6 * np.random.RandomState(seed).randn(
            *mi["rgb"].shape))
        sens = max(sens, rel(port(dict(mi, rgb=rgb.astype(np.float32)))[1],
                             got))
    assert rel(got, want) <= 3 * sens + 1e-3, (rel(got, want), sens)


def test_exp3_bf16_rule4_against_f32_oracle(batch):
    mi = batch[0]
    variables, out32 = jax_case("exp3", mi)
    oracle = out32["output_refined"][0]
    jbf = JModel(feature_dim=FD, d=D, nmode="exp3", dtype=jnp.bfloat16)
    jax_bf = np.asarray(jax.jit(lambda p, m: jbf.apply(p, m, train=False))(
        variables, jnp_dict(mi))["output_refined"][0])
    tm = BaseModelNet(FD, D, "exp3", dtype=torch.bfloat16).eval()
    load_jax_params(tm, variables)
    with torch.no_grad():
        port_bf = tm(tsyn.to_device(mi, "cpu"))["output_refined"][0].numpy()
    assert np.all(np.isfinite(port_bf))
    d_candi = np.asarray(mi["d_candi"], np.float32)[:, None, None]

    def dists(x):
        p, po = np.exp(x), np.exp(oracle)
        dep, depo = (p * d_candi).sum(1), (po * d_candi).sum(1)
        return (np.linalg.norm(dep - depo) / np.linalg.norm(depo),
                np.linalg.norm(p - po) / np.linalg.norm(po))

    for what, dj, dp in zip(("depth", "refined DPV"), dists(jax_bf),
                            dists(port_bf)):
        assert dp <= 3 * dj + 4e-3, (what, dp, dj)


def test_exp8_and_exp2_without_its_input_raise(batch):
    mi = batch[0]
    jm = JModel(feature_dim=FD, d=D, nmode="exp8")
    with pytest.raises(ValueError, match="exp8"):
        jax.eval_shape(lambda: jm.init(_RNGS, jnp_dict(mi), train=False))
    tm = BaseModelNet(FD, D, "exp8")
    assert hasattr(tm, "base_decoder2")
    with pytest.raises(ValueError, match="exp8"):
        tm(tsyn.to_device(mi, "cpu"))
    no_dpv = {k: v for k, v in mi.items() if k != "tofuse_dpv"}
    with pytest.raises(KeyError, match="tofuse_dpv"):
        BaseModelNet(FD, D, "exp2")(tsyn.to_device(no_dpv, "cpu"))
    with pytest.raises(ValueError, match="nmode"):
        BaseModelNet(FD, D, "exp5")
    with pytest.raises(ValueError, match="sweep_impl"):
        BaseModelNet(FD, D, "exp7", sweep_impl="direct")


def test_default_model_matches_jax(batch):
    mi = batch[0]
    jm = JDefault(d=D)
    mij = jnp_dict(mi)
    v = numpy_variables(lambda: jm.init(_RNGS, mij), seed=1)
    out_j = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, m: jm.apply(p, m))(v, mij))
    tm = DefaultModel(D).eval()
    load_jax_params(tm, v)
    with torch.no_grad():
        out_t = tm(tsyn.to_device(mi, "cpu"))
    assert_dpvs_match(out_t, out_j)
    assert out_t["output_refined"][0].shape == (B, D, H, W)


@pytest.fixture(scope="module")
def packnet_jax(batch):
    mi = batch[0]
    jm = JPackNet(d=D)
    mij = jnp_dict(mi)
    v = numpy_variables(lambda: jm.init(_RNGS, mij, train=False), seed=2)
    out = jax.jit(lambda p, m: jm.apply(p, m, train=False))(v, mij)
    return v, jax.tree_util.tree_map(np.asarray, out)


def test_packnet_eval_matches_jax(batch, packnet_jax):
    v, out_j = packnet_jax
    tm = packnet.PackNetModel(d=D).eval()
    load_jax_params(tm, v)
    with torch.no_grad():
        out_t = tm(tsyn.to_device(batch[0], "cpu"))
    assert_dpvs_match(out_t, out_j)
    # the refine head is 64 wide whatever D is, as in JAX
    assert out_t["output_refined"][0].shape == (B, 64, H, W)


def test_packnet_train_mode(batch, packnet_jax):
    tm = packnet.PackNetModel(d=D).train()
    load_jax_params(tm, packnet_jax[0])
    gen = torch.Generator().manual_seed(0)
    out = tm(tsyn.to_device(batch[0], "cpu"), generator=gen)
    assert out["output"][0].shape == (B, D, H // 4, W // 4)
    assert out["output_refined"][0].shape == (B, 64, H, W)
    assert all(torch.isfinite(o).all() for o in out["output"]
               + out["output_refined"])
    x = torch.ones(200_000)
    y = packnet.dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs((y > 0).float().mean().item() - 0.5) < 0.01
    with pytest.raises(ValueError, match="Generator"):
        tm(tsyn.to_device(batch[0], "cpu"))


def test_space_to_depth_channel_order():
    from depthestimation_tpu.models import packnet as jp
    x = np.random.RandomState(3).randn(2, 8, 12, 5).astype(np.float32)
    want = np.asarray(jp.space_to_depth(jnp.asarray(x)))
    got = packnet.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    back = packnet.depth_to_space(got)
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), x)


def test_every_config_builds():
    files = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
    assert len(files) >= 30
    for f in files:
        cfg = tcfg.load_config(f)
        model = get_model(cfg, "cpu", seed=0)
        if cfg.data.model_name == "base":
            assert model.nmode == cfg.var.nmode, f
    cfg = tcfg.load_config(os.path.join(ROOT, "configs", "test_tiny.json"))
    for name, cls in (("default", DefaultModel),
                      ("packnet", packnet.PackNetModel)):
        cfg.data.model_name = name
        a = get_model(cfg, "cpu", seed=4)
        assert isinstance(a, cls)
        b = get_model(cfg, "cpu", seed=4).state_dict()
        assert all(torch.equal(t, b[k]) for k, t in a.state_dict().items())
    cfg.data.model_name = "base"
    cfg.var.sweep_impl = "gather"
    assert get_model(cfg, "cpu", seed=0).sweep_impl == "gather"
