"""The recorded-sweep fusion path: ``lc/process_real.py``, nmode ``lc`` and
the trainer's ``lc.real_lc_config`` route, against the JAX package on the
same numpy inputs, f32 on the CPU (64x48, feature_dim = D = 16, 16 sweep
planes, the curtains' 32 range bins; the trainer at 96x64, the smallest
size the synthetic video renders, its curtains at 128 bins as JAX's).

Tolerances:
- ``sample_sweep_intensity``: EQUAL (a gather; ties take the first plane
  on both sides);
- ``lc_process_real`` against JAX's under ``jax.jit``: the whole-loop rule
  of ``tests/test_torch_lc.py`` (at most 10% of the rays end on another
  fused column; elsewhere probabilities within 2e-3 and the expected depth
  within 0.05 m);
- the nmode ``lc`` forward through ``weights.from_jax_params``: the DPVs
  as probabilities within 5e-4 (measured up to 3.4e-4 after Base3D, 3e-5
  before it: the encoder's features, within 1e-5 relative of JAX's, enter
  Base3D directly as its fourth plane, where exp7's pass through the
  sweep's averaging first; ``tests/test_torch_model.py`` holds exp7 to
  1e-4);
- the trainer (one JAX ``DefaultTrainer`` epoch of 2 steps on
  ``SyntheticSweepVideoDataset``, ``use_lc_prob`` 1.0, ``pnoise`` 0,
  weight decay 0, shared by the file): step 1's loss at rtol 1e-5 and its
  gradient of each of the encoder, BV head, Base3D and decoder (read from
  JAX's first Adam moment) at rel-L2 3e-2, as
  ``tests/test_torch_lc_step.py``; step 2, fed the recorded-sweep fusion's
  ``prev_lc``, at rtol 1e-3 (Adam's first update moves a parameter whose
  gradient is zero to rounding either way, 5e-4 in that file; the fused
  feedback adds the loop's differing rays); the ``prev_lc`` feedback by
  the whole-loop rule on the 1/4-res columns.

The seam of JAX's ``_lc_jitted(real=True)``: its closure names its
arguments ``(refined, sweep_int, sweep_z, ...)`` but passes them on to
``lc_process_real(bv, sweep_z, sweep_int, ...)`` positionally, and its
caller passes channel 0 (z) first; the two swaps cancel. The port names
them as they are, and ``test_trainer_passes_z_as_sweep_z`` pins it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg
from depthestimation_tpu.data.scheduler import BatchScheduler as JSched
from depthestimation_tpu.data.video_synthetic import (
    SyntheticSweepVideoDataset as JSweepDS)
from depthestimation_tpu.data.video_synthetic import (
    assemble_inputs as jassemble)
from depthestimation_tpu.lc.curtain import LightCurtain as JLightCurtain
from depthestimation_tpu.lc import process_real as jpr
from depthestimation_tpu.losses import get_loss as jget_loss
from depthestimation_tpu.models import get_model as jget_model
from depthestimation_tpu.ops import ufield as juf
from depthestimation_tpu.runtime.planner_runtime import (
    process_lc_json as j_process_lc_json)
from depthestimation_tpu.trainer import get_trainer as jget_trainer
from depthestimation_tpu.utils.logger import init_logger as jlogger
from depthestimation_tpu_torch.config import config_from_dict as tcfg
from depthestimation_tpu_torch.data.scheduler import BatchScheduler
from depthestimation_tpu_torch.data.video_synthetic import (
    SyntheticSweepVideoDataset, synthesize_sweep, to_device)
from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.lc.process_real import (lc_process_real,
                                                       sample_sweep_intensity)
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.ops import ufield as tuf
from depthestimation_tpu_torch.runtime.planner_runtime import process_lc_json
from depthestimation_tpu_torch.trainer.factory import get_trainer
from depthestimation_tpu_torch.utils.logger import init_logger
from depthestimation_tpu_torch.weights import from_jax_params

W, H, D, N, P = 64, 48, 16, 32, 16
#: the trainer's size: the synthetic video renders 96x64, not 64x48
TW, TH = 96, 64
GROUPS = ("base_encoder.", "conv0", "based_3d.", "base_decoder.")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sensor(n=N, shifted=False, w=W, h=H):
    f = 0.8 * w
    intr = [[f, 0, w / 2 + 1.5], [0, f, h / 2 - 1.0], [0, 0, 1]]
    rtc = np.eye(4)
    if shifted:
        rtc[0, 3], rtc[2, 3] = 0.1, 0.05
    return {
        "name": "toy_fusion", "N": n, "q_power": 1.0,
        "s_range": 3.0, "e_range": 18.0,
        "intr_rgb": intr, "intr_lc": intr,
        "dist_rgb": [0] * 5, "dist_lc": [0] * 5,
        "size_rgb": [w, h], "size_lc": [w, h], "rTc": rtc.tolist(),
        "lTc": [[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        "laser_fov": 80.0, "laser_timestep": 1.5e-4,
        "expand_A": n, "expand_B": n,
        "unc_shift": 1.0, "unc_span": 0.3, "unc_ang": 0,
    }


def _curtains(shifted):
    """(JAX, port) LightCurtain pairs on one sensor bundle; a freer galvo
    than the default, so that at 64 columns the planner's choices count
    (``tests/test_torch_lc.py``)."""
    out = []
    for cls, proc, kw in ((JLightCurtain, j_process_lc_json, {}),
                          (LightCurtain, process_lc_json,
                           {"device": "cpu"})):
        lc = cls(**kw)
        params = proc(_sensor(shifted=shifted))
        params["max_omega"] = 1.0e5
        lc.init(params)
        out.append(lc)
    return out


def _scene():
    depth = np.full((2, H, W), 12.0, np.float32)
    depth[0, :, :24] = 7.0
    depth[1, 20:, 30:] = 15.0
    depth[1, :4] = 0.0                           # no return
    return depth


def _sweep(depth):
    z, i = zip(*(synthesize_sweep(d, 3.0, 18.0, planes=P) for d in depth))
    z, i = np.stack(z), np.stack(i)
    z[:, 5] = np.nan                             # planes not recorded
    z[1, 9, :, :10] = np.nan
    return z, i


def _log_dpv(rs, b):
    x = rs.randn(b, D, H, W).astype(np.float32)
    return x - np.log(np.exp(x).sum(1, keepdims=True))


def _same_field(p, q, d_candi):
    off = (np.abs(p - q) > 2e-3).any(axis=(1, 2))              # [B, W]
    assert off.mean() <= 0.10, off.mean()
    keep = np.broadcast_to(~off[:, None, None, :], p.shape)
    assert np.abs(p - q)[keep].max() <= 2e-3
    d = np.asarray(d_candi, np.float32)[:, None, None]
    dd = np.abs((p * d).sum(1) - (q * d).sum(1))
    assert dd[keep[:, 0]].max() <= 0.05


def test_sample_sweep_intensity_equals_jax():
    rs = np.random.RandomState(0)
    z, inten = _sweep(_scene())
    z = np.where(np.isnan(z), 1000.0, z).astype(np.float32)
    cz = rs.uniform(2.0, 20.0, (2, H, W)).astype(np.float32)
    cz[0, 3, :8] = z[0, 2, 3, :8]                 # on a plane
    # halfway between two planes: a tie, the first plane wins
    cz[1, 5, :8] = 0.5 * (z[1, 3, 5, :8] + z[1, 4, 5, :8])
    fn = jax.jit(jax.vmap(jpr.sample_sweep_intensity))
    want = np.asarray(fn(cz, z, inten))
    got = sample_sweep_intensity(_t(cz), _t(z), _t(inten))
    assert got.shape == (2, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    # leading axes broadcast: paths [B, 3] against each item's sweep
    got3 = sample_sweep_intensity(_t(np.stack([cz] * 3, 1)), _t(z)[:, None],
                                  _t(inten)[:, None])
    assert got3.shape == (2, 3, H, W)
    assert torch.equal(got3[:, 1], got)


PARAMS = {"step": [0.5], "spread_iter": 2, "spread_n": 3}


def _jax_real(jl, bv, z, inten, intr, ufp, planner="default",
              params=PARAMS, iterations=2):
    fn = jax.jit(lambda b, zz, ii, k: jpr.lc_process_real(
        b, zz, ii, k, jl, jl, ufp, iterations=iterations, planner=planner,
        params=params))
    return np.asarray(fn(jnp.asarray(bv), jnp.asarray(z), jnp.asarray(inten),
                         jnp.asarray(intr)))


@pytest.mark.parametrize("shifted,planner,params", [
    (True, "default", PARAMS),
    (False, "sweep", {"start": 4.0, "end": 17.0, "step": 4.0,
                      "spread_iter": 1, "spread_n": 3})])
def test_lc_process_real_matches_jax(shifted, planner, params):
    """Two iterations on 2 items with NaN planes; ``shifted``: the real
    device's LC camera is moved, so its returns splat into the RGB frame
    through ``transform_points`` (the co-located default planner runs in
    the trainer's test, call by call)."""
    jl, tl = _curtains(shifted)
    assert tl.transform_needed == shifted
    rs = np.random.RandomState(1)
    bv = _log_dpv(rs, 2)
    z, inten = _sweep(_scene())
    intr = np.tile(np.asarray(_sensor()["intr_rgb"], np.float32), (2, 1, 1))
    ufp_j = juf.UFieldParams(pshift=0, zstart=-1e6, zend=1e6, maxd=1e6,
                             mind=0.0, quash=False)
    ufp_t = tuf.UFieldParams(**ufp_j.__dict__)
    got = lc_process_real(_t(bv).requires_grad_(), _t(z), _t(inten),
                          _t(intr), tl, tl, ufp_t, iterations=2,
                          planner=planner, params=params)
    assert got.shape == bv.shape and not got.requires_grad
    p = np.exp(got.numpy())
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-4)
    assert np.abs(p - np.exp(bv)).max() > 0.05   # the curtains sensed
    want = _jax_real(jl, bv, z, inten, intr, ufp_j, planner, params)
    _same_field(p, np.exp(want), np.linspace(3.0, 18.0, D))


def test_swapping_z_and_intensity_changes_the_result():
    _, tl = _curtains(False)
    bv = _log_dpv(np.random.RandomState(2), 2)
    z, inten = _sweep(_scene())
    intr = np.tile(np.asarray(_sensor()["intr_rgb"], np.float32), (2, 1, 1))
    ufp = tuf.UFieldParams(pshift=0, zstart=-1e6, zend=1e6, maxd=1e6,
                           mind=0.0, quash=False)
    args = (_t(intr), tl, tl, ufp)
    right = lc_process_real(_t(bv), _t(z), _t(inten), *args, iterations=1,
                            params=PARAMS)
    swapped = lc_process_real(_t(bv), _t(inten), _t(z), *args, iterations=1,
                              params=PARAMS)
    assert (torch.exp(right) - torch.exp(swapped)).abs().max() > 0.05


# ---- nmode lc and the trainer's real-LC route ----------------------------

def _cfg(tmp_path):
    sensor = tmp_path / "toy_fusion.json"
    sensor.write_text(json.dumps(_sensor(n=D, w=TW, h=TH)))
    return {
        "data": {"exp_name": "lc_fusion", "model_name": "base",
                 "loss_name": "base", "trainer_name": "default",
                 "dataset_path": "sweep", "dataset_split": "sweep"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0,
                "d_max": 18.0, "feature_dim": D, "ndepth": D,
                "softce": 0.3, "qpower": 1.0, "img_size": [TW, TH],
                "crop_w": TW, "nmode": "lc", "bn_avg": False,
                "diffhomo": False, "pnoise": 0.0},
        "lc": {"enabled": True, "iterations": 1, "planner": "default",
               "params": {"step": [0.5], "spread_iter": 1, "spread_n": 3},
               "use_lc_prob": 1.0, "algo_lc_config": str(sensor),
               "real_lc_config": str(sensor)},
        "loss": {"ce_mul": 1.0, "dsc_mul": 0.0, "rsc_mul": 0.0,
                 "smooth_mul": 0.5, "dc_mul": 0.0, "rsc_low_mul": 0.0},
        "train": {"batch_size": 2, "lr": 1e-5, "epoch_num": 1, "n_gpu": 1,
                  "optim": "adam", "print_freq": 1, "weight_decay": 0.0,
                  "self_recurse": 1},
        "tpu": {"dtype": "float32"},
    }


def _loader(sched_cls):
    ds_cls = JSweepDS if sched_cls is JSched else SyntheticSweepVideoDataset
    ds = ds_cls(n_traj=2, traj_len=2, h=TH, w=TW, ndepth=D, d_min=3.0,
                d_max=18.0, planes=P)
    return sched_cls(ds, 2, shuffle=False, prefetch=False)


def _silent(rt_lc):
    for dev in (rt_lc.lightcurtain_large, rt_lc.lightcurtain_small):
        dev.hit_noise = 0.0


@pytest.fixture(scope="module")
def jax_epoch(tmp_path_factory):
    """One JAX epoch (2 steps) with the real device; step 1's gradients
    from the first Adam moment; every ``_run_lc`` call and its output."""
    root = tmp_path_factory.mktemp("lc_real_jax")
    raw = _cfg(root)
    cfg = jcfg(raw)
    loader = _loader(JSched)
    tr = jget_trainer(cfg)(0, jget_model(cfg), jget_loss(cfg),
                           jlogger("t_lc_real_jax", str(root)), str(root),
                           cfg, loader, loader)
    batch = next(iter(loader.enumerate()))
    mi0, _ = jassemble(batch, "left", False)
    tr.ensure_state({**mi0, "prev_output": None, "prev_lc": None})
    tr._ensure_lc(mi0)
    assert tr.real_lc is not None and tr._fused_lc_fn() is None
    var0 = jax.tree_util.tree_map(np.array, {"params": tr.state.params})
    states, calls = [], []
    step, run_lc = tr._train_step, tr._run_lc

    def spy_step(*a):
        out = step(*a)
        adam = [s for s in jax.tree_util.tree_leaves(
            out[0].opt_state,
            is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        states.append(np.array(float(out[1])))
        if len(states) == 1:
            calls.append(("mu", jax.tree_util.tree_map(
                lambda m: np.array(m) / (1.0 - 0.9), adam[0].mu)))
        return out

    def spy_lc(refined, mi, key):
        out = run_lc(refined, mi, key)
        calls.append(("lc", "sweep_arr_tensor" in mi, np.array(out)))
        return out

    tr._train_step, tr._run_lc = spy_step, spy_lc
    for lc in (tr.lc, tr.real_lc):
        _silent(lc)
    tr._run_one_epoch()
    return {"raw": raw, "var0": var0, "losses": tr._last_epoch_losses,
            "grads": from_jax_params({"params": calls[0][1]}),
            "lc": [c[1:] for c in calls[1:]]}


def _port_trainer(raw, root, variables):
    cfg = tcfg(raw)
    model = get_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(variables))
    loader = _loader(BatchScheduler)
    tr = get_trainer(cfg)(0, model, get_loss(cfg),
                          init_logger("t_lc_real", str(root)), str(root),
                          cfg, loader, loader)
    return tr, loader


def test_nmode_lc_forward_matches_jax(jax_epoch, tmp_path):
    """The eval forward of the initial weights on the first batch (f32,
    ``diffhomo: false``), with a ``prev_lc`` and the default
    ``prev_output``."""
    cfg = jcfg(jax_epoch["raw"])
    batch = next(iter(_loader(JSched).enumerate()))
    mi, _ = jassemble(batch, "left", False)
    rs = np.random.RandomState(3)
    x = rs.randn(2, D, TH // 4, TW // 4).astype(np.float32)
    mi = {**mi, "prev_output": None,
          "prev_lc": x - np.log(np.exp(x).sum(1, keepdims=True))}
    model = jget_model(cfg)
    want = jax.jit(lambda v, m: model.apply(v, m, train=False))(
        jax.tree_util.tree_map(jnp.asarray, jax_epoch["var0"]),
        {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in mi.items()})
    tr, _ = _port_trainer(jax_epoch["raw"], tmp_path, jax_epoch["var0"])
    assert tr.model.based_3d.ConvBN3d_0.Conv3d_0.weight.shape[1] == 4
    with torch.no_grad():
        got = tr.model({**to_device({k: v for k, v in mi.items()
                                     if k != "prev_output"}, "cpu"),
                        "prev_output": None})
    for k in ("output", "output_refined"):
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(np.exp(g.numpy()),
                                       np.exp(np.asarray(w)), rtol=0,
                                       atol=5e-4, err_msg=k)


def test_trainer_epoch_with_real_lc_matches_jax(jax_epoch, tmp_path):
    tr, _ = _port_trainer(jax_epoch["raw"], tmp_path, jax_epoch["var0"])
    calls, grads = [], {}
    run_lc = tr._run_lc

    def spy_lc(refined, mi):
        out = run_lc(refined, mi)
        calls.append(("sweep_arr_tensor" in mi, out))
        return out

    tr._run_lc = spy_lc
    tr.ensure_state()
    real_make = tr._train_step

    def spy_step(*a):
        out = real_make(*a)
        if not grads:
            grads.update({k: p.grad.clone()
                          for k, p in tr.model.named_parameters()})
        return out

    orig_ensure = tr._ensure_lc

    def ensure(mi):
        orig_ensure(mi)
        for lc in (tr.lc, tr.real_lc):
            _silent(lc)
        tr._train_step = spy_step

    tr._ensure_lc = ensure
    tr._run_one_epoch()
    assert tr.real_lc is not None and tr.real_lc.initialized
    assert tr._fused_lc_fn() is None
    # every LC call saw the recorded sweep: 2 steps x 2 sides
    assert [c[0] for c in calls] == [True] * 4
    assert [c[0] for c in jax_epoch["lc"]] == [True] * 4
    losses = tr._last_epoch_losses
    np.testing.assert_allclose(losses[0], jax_epoch["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1], jax_epoch["losses"][1], rtol=1e-3)
    for pre in GROUPS:
        keys = [k for k in grads if k.startswith(pre)]
        g = torch.cat([grads[k].flatten() for k in keys])
        w = torch.cat([jax_epoch["grads"][k].flatten() for k in keys])
        assert float((g - w).norm() / w.norm()) <= 3e-2, pre
    # the feedback of each call, by the loop's rule on 1/4-res columns
    d_candi = np.linspace(3.0, 18.0, D)
    for (_, got), (_, want) in zip(calls, jax_epoch["lc"]):
        assert got.shape == (2, D, TH // 4, TW // 4)
        _same_field(np.exp(got.numpy()), np.exp(want), d_candi)
    pl = tr.prev_lc["left"]
    assert pl is not None and torch.isfinite(pl).all()


def test_trainer_passes_z_as_sweep_z(tmp_path, monkeypatch):
    """``_run_lc`` gives ``lc_process_real`` channel 0 of
    ``sweep_arr_tensor`` (z) as ``sweep_z``, and a batch without a sweep
    goes to the simulator."""
    from depthestimation_tpu_torch.trainer import default as tdefault
    cfg = tcfg(_cfg(tmp_path))
    tr = get_trainer(cfg)(0, get_model(cfg, "cpu", seed=0), get_loss(cfg),
                          init_logger("t_lc_real_z", str(tmp_path)),
                          str(tmp_path), cfg)
    seen = {}

    def fake_real(bv, sweep_z, sweep_int, *a, **k):
        seen["real"] = (sweep_z, sweep_int)
        return bv

    def fake_sim(bv, dmaps_up, *a, **k):
        seen["sim"] = dmaps_up
        return bv

    monkeypatch.setattr(tdefault, "lc_process_real", fake_real)
    monkeypatch.setattr(tdefault, "lc_process", fake_sim)
    tr.real_lc = object()
    z = torch.full((2, P, H, W), 5.0)
    inten = torch.full((2, P, H, W), 200.0)
    mi = {"sweep_arr_tensor": torch.stack([z, inten], -1),
          "intrinsics_up": torch.eye(3).repeat(2, 1, 1),
          "dmaps": torch.ones(2, H // 4, W // 4)}
    out = tr._run_lc(torch.zeros(2, D, H, W), mi)
    assert out.shape == (2, D, H // 4, W // 4)
    assert torch.equal(seen["real"][0], z) and torch.equal(seen["real"][1],
                                                           inten)
    del mi["sweep_arr_tensor"]
    tr._run_lc(torch.zeros(2, D, H, W), mi)
    assert seen["sim"].shape == (2, H, W)
