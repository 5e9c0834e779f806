"""The whole serving slice in f32: the port's BaseModelNet (exp7, exp7_lc)
against the JAX BaseModelNet with the same weights (weight bridge) and the
same numpy inputs. Bounds: expected depth max-abs <= 1e-3 m, refined and
low-res DPVs compared as probabilities max-abs <= 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.data import synthetic as jsyn
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.ops.dpv import dpv_to_depthmap
from depthestimation_tpu_torch.weights import load_jax_params

FD = D = 16
H, W = 48, 72          # make_batch wants h % 4 == 0 and w % 6 == 0


@pytest.fixture(scope="module")
def batch():
    mi, _ = jsyn.make_batch(batch=2, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=1)
    return mi


@pytest.fixture(scope="module")
def variables(batch):
    mi = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items()}
    jm = JModel(feature_dim=FD, d=D, nmode="exp7_lc")
    v = jax.jit(lambda r, m: jm.init(r, m, train=False))(
        {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1)},
        mi)
    return jax.tree_util.tree_map(np.asarray, v)


def test_make_batch_is_the_jax_make_batch(batch):
    mi, gt = tsyn.make_batch(batch=2, t_win=1, h=H, w=W, d_min=3.0,
                             d_max=30.0, ndepth=D, seed=1)
    _, gt_j = jsyn.make_batch(batch=2, t_win=1, h=H, w=W, d_min=3.0,
                              d_max=30.0, ndepth=D, seed=1)
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(mi[k], v, err_msg=k)
        else:
            assert mi[k] is None and v is None
    np.testing.assert_allclose(gt["soft_labels"], gt_j["soft_labels"],
                               rtol=1e-5, atol=1e-6)


def _prev(seed, b):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, D, H // 4, W // 4).astype(np.float32)
    return x - np.log(np.exp(x).sum(1, keepdims=True))


@pytest.mark.parametrize("nmode,with_prev", [("exp7", False),
                                             ("exp7_lc", False),
                                             ("exp7_lc", True)])
def test_slice_f32_matches_jax(batch, variables, nmode, with_prev):
    mi = dict(batch)
    if with_prev:
        mi["prev_output"] = _prev(2, 2)
        mi["prev_lc"] = _prev(3, 2)
    params = variables
    if nmode == "exp7":       # Base3D takes one plane fewer (no prev_lc)
        params = jax.tree_util.tree_map(lambda a: a, variables)
        k = params["params"]["based_3d"]["ConvBN3d_0"]["Conv3d_0"]
        k["kernel"] = k["kernel"][:, :, :, 1:]
    jm = JModel(feature_dim=FD, d=D, nmode=nmode)
    out_j = jm.apply(params, {k: (jnp.asarray(v) if isinstance(
        v, np.ndarray) else v) for k, v in mi.items()}, train=False)
    tm = BaseModelNet(FD, D, nmode).eval()
    load_jax_params(tm, params)
    with torch.inference_mode():
        out_t = tm(tsyn.to_device(mi, "cpu"))

    ref_j = np.asarray(out_j["output_refined"][0])
    ref_t = out_t["output_refined"][0].numpy()
    assert ref_t.shape == (2, D, H, W)
    np.testing.assert_allclose(np.exp(ref_t), np.exp(ref_j), rtol=0,
                               atol=1e-4)
    for i in range(2):                       # bv, bv_upd
        np.testing.assert_allclose(np.exp(out_t["output"][i].numpy()),
                                   np.exp(np.asarray(out_j["output"][i])),
                                   rtol=0, atol=1e-4)
    d_candi = batch["d_candi"]
    depth_t = dpv_to_depthmap(torch.from_numpy(ref_t), d_candi,
                              log=True).numpy()
    depth_j = (np.exp(ref_j) * np.asarray(d_candi, np.float32)[:, None,
                                                               None]).sum(1)
    assert np.abs(depth_t - depth_j).max() <= 1e-3


def test_other_nmodes_raise():
    """Every nmode of the JAX package builds (tests/test_torch_nmodes.py
    holds their forwards to JAX's); exp8 has no forward, as in JAX, and a
    name JAX does not know raises at construction."""
    for nmode in ("default", "exp2", "exp3", "exp8"):
        assert BaseModelNet(FD, D, nmode).nmode == nmode
    assert BaseModelNet(FD, D, "lc").diffhomo
    assert BaseModelNet(FD, D, "lc", diffhomo=False).nmode == "lc"
    with pytest.raises(ValueError, match="exp8"):
        BaseModelNet(FD, D, "exp8")(tsyn.to_device(
            tsyn.make_batch(batch=1, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=1)[0], "cpu"))
    with pytest.raises(ValueError, match="unknown nmode"):
        BaseModelNet(FD, D, "exp4")
