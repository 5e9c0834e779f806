"""The whole serving slice in bf16, and the port's kernel dispatch.

bf16 (tests/TOLERANCES.md rule 4): the port's bf16 BaseModelNet (kernel
wrappers on CPU tensors, so their plain versions) and the JAX bf16 model
with both Pallas kernels in interpret mode are each measured against the
f32 oracle; the port must stay within 3x the JAX distance plus a floor.

Dispatch is by configuration: a bf16 model calls the sweep wrapper once
and the Base3D block wrapper 8 times per forward; an f32 model calls
neither."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.data import synthetic as jsyn
from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.weights import load_jax_params

FD = D = 16
H, W = 48, 72


def _cfg(dtype="float32", **tpu):
    return tcfg.config_from_dict({
        "data": {"exp_name": "t", "model_name": "base"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0,
                "d_max": 30.0, "feature_dim": FD, "ndepth": D,
                "qpower": 1.0, "img_size": [W, H], "nmode": "exp7_lc",
                "bn_avg": False},
        "tpu": dict(dtype=dtype, **tpu),
    })


def test_slice_bf16_rule4_against_f32_oracle():
    mi, _ = jsyn.make_batch(batch=2, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=2)
    mij = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in mi.items()}
    j32 = JModel(feature_dim=FD, d=D, nmode="exp7_lc")
    jbf = JModel(feature_dim=FD, d=D, nmode="exp7_lc", dtype=jnp.bfloat16,
                 sweep_pallas="interpret", convcomb_pallas="interpret")
    v = jax.jit(lambda r, m: j32.init(r, m, train=False))(
        {"params": jax.random.PRNGKey(3), "lc_drop": jax.random.PRNGKey(4)},
        mij)
    oracle = np.asarray(jax.jit(lambda p, m: j32.apply(p, m, train=False))(
        v, mij)["output_refined"][0])
    jax_bf = np.asarray(jax.jit(lambda p, m: jbf.apply(p, m, train=False))(
        v, mij)["output_refined"][0])
    tm = BaseModelNet(FD, D, "exp7_lc", dtype=torch.bfloat16).eval()
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, v))
    with torch.inference_mode():
        port_bf = tm(tsyn.to_device(mi, "cpu"))["output_refined"][0].numpy()
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


@pytest.fixture
def spies(monkeypatch):
    """Count calls of the two kernel wrappers where the model reaches
    them (their plain versions still run: the tensors are on the CPU)."""
    from depthestimation_tpu_torch.models import layers
    from depthestimation_tpu_torch.ops import plane_sweep
    calls = {"sweep": 0, "convcomb": 0}

    def wrap(name, fn):
        def spy(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(plane_sweep, "sweep_stage2",
                        wrap("sweep", plane_sweep.sweep_stage2))
    monkeypatch.setattr(layers, "convbn_block",
                        wrap("convcomb", layers.convbn_block))
    return calls


@pytest.mark.parametrize("dtype,want", [("bfloat16", (1, 8)),
                                        ("float32", (0, 0))])
def test_kernel_dispatch_by_dtype(spies, dtype, want):
    mi, _ = tsyn.make_batch(batch=1, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D)
    model = get_model(_cfg(dtype), "cpu", seed=0)
    with torch.inference_mode():
        out = model(tsyn.to_device(mi, "cpu"))
    assert (spies["sweep"], spies["convcomb"]) == want
    assert torch.isfinite(out["output_refined"][0]).all()


def test_get_model_seeded_and_tpu_knobs_ignored():
    """The same seed gives the same weights; the TPU-only knobs are
    accepted and change nothing. ``convcomb_pallas`` and ``combine_pallas``
    are not among them: they route Base3D
    (tests/test_torch_combine.py)."""
    assert tcfg.IGNORED_TPU_KEYS == ("remat", "sweep_pallas", "mesh",
                                     "scan_train", "scan_eval", "scan_chunk")
    knobs = {k: True for k in tcfg.IGNORED_TPU_KEYS}
    a = get_model(_cfg("bfloat16"), "cpu", seed=5).state_dict()
    m = get_model(_cfg("bfloat16", **knobs), "cpu", seed=5)
    assert m.conv3d_path() == "convcomb"
    b = m.state_dict()
    c = get_model(_cfg("bfloat16"), "cpu", seed=6).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert get_model(_cfg("bfloat16"), "cpu").dtype == torch.bfloat16
    assert get_model(_cfg("float32"), "cpu").dtype is None


def test_config_loads_repo_configs():
    import os
    from depthestimation_tpu.config import load_config as jload
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("default_exp7_lc.json", "synthetic_tpu.json"):
        path = os.path.join(root, "configs", name)
        assert tcfg.load_config(path) == jload(path)
