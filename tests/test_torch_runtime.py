"""The server: the port's NetRuntime against the JAX NetRuntime over three
frames with prev_output feedback, same weights (weight bridge), same numpy
frames, f32 on the CPU. Bounds: depth max-abs <= 1e-3 m; refined and
low-res DPVs and the fed-back prev_output as probabilities max-abs <= 1e-4;
the uncertainty field to f32 round-off."""

import jax
import numpy as np
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg
from depthestimation_tpu.models import get_model as jget_model
from depthestimation_tpu.runtime.net_runtime import NetRuntime as JRuntime
from depthestimation_tpu_torch.config import config_from_dict as tcfg
from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime
from depthestimation_tpu_torch.weights import from_jax_params

W, H = 64, 48
D = 16


def _cfg_dict():
    return {
        "data": {"exp_name": "nrt", "model_name": "base",
                 "loss_name": "base", "trainer_name": "default",
                 "dataset_path": "synthetic", "dataset_split": "k2"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0,
                "d_max": 30.0, "feature_dim": 16, "ndepth": D,
                "softce": 0.3, "qpower": 1.0, "img_size": [W, H],
                "crop_w": W, "nmode": "exp7_lc", "bn_avg": False},
    }


def _sensor_json():
    """tests/test_net_runtime.py's sensor, with an off-centre principal
    point and a UF band that keeps most rows."""
    intr = [[0.8 * W, 0, W / 2 + 1.5], [0, 0.8 * W, H / 2 - 1.0], [0, 0, 1]]
    return {
        "intr_rgb": intr, "intr_lc": intr,
        "dist_rgb": [0] * 5, "dist_lc": [0] * 5,
        "size_rgb": [W, H], "size_lc": [W, H],
        "rTc": np.eye(4).tolist(),
        "lTc": [[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        "left_2_right": np.eye(4).tolist(),
        "N": D, "s_range": 3.0, "e_range": 30.0, "q_power": 1.0,
        "laser_fov": 80.0, "laser_timestep": 2e-4,
        "unc_shift": -1e6, "unc_span": 2e6, "unc_ang": 0,
        "expand_A": D, "expand_B": D,
    }


@pytest.fixture(scope="module")
def runtimes():
    cfg = jcfg(_cfg_dict())
    tmp = JRuntime(cfg, _sensor_json(), mode="mono_lc",
                   variables={"params": {}})
    mi = tmp._model_input([np.zeros((3, H, W), np.float32)] * 2,
                          np.eye(4, dtype=np.float32))
    model = jget_model(cfg)
    v = jax.jit(lambda r, m: model.init(r, m, train=False))(
        {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1)},
        mi)
    v = jax.tree_util.tree_map(np.asarray, v)
    jrt = JRuntime(jcfg(_cfg_dict()), _sensor_json(), mode="mono_lc",
                   variables=v)
    trt = NetRuntime(tcfg(_cfg_dict()), _sensor_json(), mode="mono_lc",
                     state_dict=from_jax_params(v))
    return jrt, trt


def test_runtime_three_frames_match_jax(runtimes):
    jrt, trt = runtimes
    rng = np.random.default_rng(0)
    step = np.eye(4, dtype=np.float32)
    step[0, 3] = -0.2
    d_candi = np.asarray(trt.d_candi, np.float32)
    np.testing.assert_array_equal(trt.d_candi, jrt.d_candi)
    np.testing.assert_array_equal(trt.unit_ray, jrt.unit_ray)
    for i in range(3):
        frame = rng.random((3, H, W), dtype=np.float32)
        out_j = jrt.process_frame(frame, rel_pose=step)
        out_t = trt.process_frame(frame, rel_pose=step)
        depth_j = np.asarray(out_j["depth"])
        depth_t = out_t["depth"].numpy()
        assert depth_t.shape == (H, W) and np.all(np.isfinite(depth_t))
        assert np.abs(depth_t - depth_j).max() <= 1e-3, i
        assert depth_t.min() >= d_candi[0] - 1e-3
        assert depth_t.max() <= d_candi[-1] + 1e-3
        for k in ("dpv_refined", "dpv_low"):
            np.testing.assert_allclose(np.exp(out_t[k].numpy()),
                                       np.exp(np.asarray(out_j[k])),
                                       rtol=0, atol=1e-4, err_msg=f"{k} {i}")
        np.testing.assert_allclose(np.exp(trt.prev_output.numpy()),
                                   np.exp(np.asarray(jrt.prev_output)),
                                   rtol=0, atol=1e-4)
        uf_j = np.asarray(out_j["uf"])
        np.testing.assert_allclose(out_t["uf"].numpy(), uf_j, rtol=1e-4,
                                   atol=1e-5, equal_nan=True)
    trt.reset()
    assert trt.prev_output is None and len(trt._frames) == 0


def test_runtime_seeded_init():
    rt = NetRuntime(tcfg(_cfg_dict()), _sensor_json(), mode="mono", seed=3)
    out = rt.process_frame(np.random.default_rng(1).random(
        (3, H, W), dtype=np.float32))
    assert out["dpv_refined"].shape == (D, H, W)
    s = torch.exp(out["dpv_refined"]).sum(0)
    torch.testing.assert_close(s, torch.ones_like(s), atol=1e-4, rtol=0)
