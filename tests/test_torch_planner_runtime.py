"""The port's light-curtain serving runtime (``runtime/planner_runtime.py``,
``runtime/sensor_sampling.py``, the planners' ``yield_mode`` and
``NetRuntime(planner=...)``) against the JAX package on the same numpy
inputs, f32 on the CPU, 64x48, 32 range bins (16 in the server's sensor).

Tolerances:
- host-side parameter setup (``update_for_algo``): equal;
- streamed paths (``yield_mode``) against the batched pass: IDENTICAL
  design points (the same solves one field at a time);
- whole loops (``PlannerRuntime`` rounds, ``ReplayDriver``, the sampling
  harness, the server's planner), noise off on both sides: the rule of
  ``tests/test_torch_lc.py``: at most 10% of the rays (image columns) end
  on another fused column; on the rest the fused probabilities are within
  2e-3 and the expected depth within 0.05 m. UF scores (mean absolute
  errors in metres) within 0.05 m;
- the pipelined real loop: the same send / receive / convert order as
  JAX's, and measurement DPVs within 1e-5 (probabilities).

JAX's PRNG draws cannot be reproduced: ``plan_m1`` takes JAX's own samples
through its ``sampled=`` seam, and the simulator's hit noise is off on
both sides (set on the objects after ``init``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.config import config_from_dict as jcfg
from depthestimation_tpu.lc import curtain as jcur
from depthestimation_tpu.models import get_model as jget_model
from depthestimation_tpu.ops.ufield import gen_ufield as j_gen_ufield
from depthestimation_tpu.runtime import planner_runtime as jpr
from depthestimation_tpu.runtime.net_runtime import NetRuntime as JNet
from depthestimation_tpu.runtime.sensor_sampling import (
    SensorSamplingHarness as JHarness)
from depthestimation_tpu_torch.config import config_from_dict as tcfg
from depthestimation_tpu_torch.ops.ufield import gen_ufield
from depthestimation_tpu_torch.runtime import planner_runtime as tpr
from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime
from depthestimation_tpu_torch.runtime.sensor_sampling import (
    SensorSamplingHarness, synthesize_sweep)
from depthestimation_tpu_torch.weights import from_jax_params

W, H, N = 64, 48, 32
DEFAULT = ("default", {"step": [0.5], "std_div": 5.0})
SWEEP = ("sweep", {"start": 4.0, "end": 28.0, "step": 6.0, "phases": 2})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The planner's DP is a loop of small ops: more threads only cost, and
    the suite's other workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sensor(n=N, shifted=False):
    intr = [[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]
    rtc = np.eye(4)
    if shifted:
        rtc[0, 3], rtc[2, 3] = 0.1, 0.05
    return {
        "intr_rgb": intr, "intr_lc": intr,
        "dist_rgb": [0] * 5, "dist_lc": [0] * 5,
        "size_rgb": [W, H], "size_lc": [W, H], "rTc": rtc.tolist(),
        "lTc": [[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        "left_2_right": np.eye(4).tolist(),
        "N": n, "s_range": 3.0, "e_range": 30.0, "q_power": 1.0,
        "laser_fov": 80.0, "laser_timestep": 2e-4,
        "unc_shift": -1e6, "unc_span": 2e6, "unc_ang": 0,
        "expand_A": n, "expand_B": n,
    }


def _quiet(rt):
    for lc in (rt.real_lc, rt.algo_lc):
        for dev in (lc.lightcurtain_large, lc.lightcurtain_small):
            dev.hit_noise = 0.0
    return rt


def _pair(planner, params, **kw):
    return (_quiet(jpr.PlannerRuntime(_sensor(**kw), planner=planner,
                                      params=params)),
            _quiet(tpr.PlannerRuntime(_sensor(**kw), planner=planner,
                                      params=params, device="cpu")))


def _scene():
    depth = np.full((H, W), 15.0, np.float32)
    depth[:, :20] = 9.0
    depth[30:, 40:] = 21.0
    return depth


def _same_field(final_t, final_j, d_candi):
    """The whole-loop rule on log fields [1, D, H, W]."""
    p = np.exp(final_t.numpy())
    q = np.exp(np.asarray(final_j))
    off = (np.abs(p - q) > 2e-3).any(axis=(1, 2))              # [1, W]
    assert off.mean() <= 0.10, off.mean()
    keep = np.broadcast_to(~off[:, None, None, :], p.shape)
    assert np.abs(p - q)[keep].max() <= 2e-3
    d = np.asarray(d_candi, np.float32)[:, None, None]
    dd = np.abs((p * d).sum(1) - (q * d).sum(1))
    assert dd[keep[:, 0]].max() <= 0.05
    return keep[0, 0]


def test_process_lc_json_and_update_for_algo_match_jax():
    raw = _sensor()
    raw["size_rgb"], raw["size_lc"] = [320, 256], [512, 640]
    raw["intr_lc"] = [[400.0, 0, 256.0], [0, 400.0, 320.0], [0, 0, 1]]
    pj, pt = jpr.process_lc_json(raw), tpr.process_lc_json(raw)
    aj, at = jpr.update_for_algo(pj), tpr.update_for_algo(pt)
    for want, got in ((pj, pt), (aj, at)):
        assert set(want) == set(got)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
    assert at["size_lc"] == [320, 400 - 144]
    assert abs(at["intr_lc"][0][0] - 250.0) < 1e-3


@pytest.fixture(scope="module")
def sim_runs():
    """Three sim rounds of the default and the phased sweep planner from
    the 4 m prior, scored before each round, on both sides."""
    depth = _scene()
    out = {}
    for planner, params in (DEFAULT, SWEEP):
        jrt, trt = _pair(planner, params)
        scores = []
        for _ in range(3):
            scores.append((jrt.score(depth), trt.score(depth)))
            dj, mj = jrt.run(None, depth)
            dt, mt = trt.run(None, depth)
        out[planner] = (jrt, trt, scores, (dj, mj), (dt, mt))
    return out


@pytest.mark.parametrize("planner", ["default", "sweep"])
def test_sim_rounds_match_jax(sim_runs, planner):
    jrt, trt, scores, (dj, mj), (dt, mt) = sim_runs[planner]
    assert trt.counter == jrt.counter == 3
    if planner == "sweep":
        assert trt._sweep_offset() == jrt._sweep_offset() == 0.0
    keep = _same_field(trt.final, jrt.final, jrt.algo_lc.d_candi)
    for a, b in scores:
        assert abs(a - b) <= 0.05, scores
    assert scores[-1][1] < scores[0][1]          # the rounds sensed
    # extract_depth on the rays that agree; its mask where both agree
    mask_t, mask_j = mt.numpy(), np.asarray(mj)
    cols = np.broadcast_to(keep, mask_t.shape)
    assert (mask_t[cols] == mask_j[cols]).mean() >= 0.99
    both = cols & (mask_t > 0) & (mask_j > 0)
    # the sparse sweep is not yet confident anywhere after 3 rounds
    assert both.any() == (planner == "default")
    if both.any():
        assert np.abs(dt.numpy()[both] - np.asarray(dj)[both]).max() <= 0.05
    et = trt.extract_depth(var_thresh=1e9)[0].numpy()
    ej = np.asarray(jrt.extract_depth(var_thresh=1e9)[0])
    assert np.abs(et - ej)[cols].max() <= 0.05


@pytest.mark.parametrize("planner,params", [
    DEFAULT, ("m1", {"step": 2, "interval": 5}),
    ("sweep", {"start": 4.0, "end": 28.0, "step": 6.0})])
def test_yield_mode_paths_equal_the_batched_pass(planner, params):
    _, trt = _pair(planner, params)
    trt.run(None, _scene())
    lc = trt.algo_lc
    uf, _ = gen_ufield(trt.final[0], trt._d_candi, trt._intr, trt.uf_params,
                       log=True)
    args = (uf, lc.planner_large, lc.fw_large, "high", params)
    fn = getattr(lc, f"plan_{planner}")
    if planner == "m1":
        batch = fn(*args, torch.Generator().manual_seed(3))
        stream = fn(*args, torch.Generator().manual_seed(3), yield_mode=True)
    else:
        batch, stream = fn(*args), fn(*args, yield_mode=True)
    assert not isinstance(stream, torch.Tensor)
    stream = list(stream)
    assert len(stream) == batch.shape[0] >= 3
    for i, p in enumerate(stream):
        assert torch.equal(p, batch[i]), i


def test_m1_on_fixed_samples_matches_jax():
    """The runtime's m1 round on JAX's own draws: the planning camera's
    design points equal but for the rays whose DP scores tie to the last
    bits (at most 2%, as ``test_torch_lc.py``)."""
    params = {"step": 2, "interval": 5}
    jrt, trt = _pair("m1", params)
    uf_j, _ = j_gen_ufield(jrt.final[0],
                           jnp.asarray(jrt.algo_lc.d_candi, jnp.float32),
                           jnp.asarray(jrt.real_param["intr_rgb"]),
                           jrt.uf_params, log=True)
    lj, lt = jrt.algo_lc, trt.algo_lc
    key = jax.random.PRNGKey(5)
    want = np.asarray(lj.plan_m1(uf_j, lj.planner_large, lj.fw_large, "high",
                                 params, key))
    _, fr = lj._prepare_field(uf_j, lj.fw_large, "high", normalize=False)
    base = jnp.nan_to_num(jcur._fix_sides(fr), nan=1e-5)
    logits = jnp.log(jnp.clip(base.T, 1e-12, None))
    sampled, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        sampled.append(np.asarray(jax.random.categorical(sub, logits)))
    uf_t = torch.from_numpy(np.asarray(uf_j))
    got = lt.plan_m1(uf_t, lt.planner_large, lt.fw_large, "high", params,
                     sampled=torch.from_numpy(np.stack(sampled))).numpy()
    assert got.shape == want.shape == (3, 512, 2)
    differ = (got != want).any(-1).mean()
    assert differ <= 0.02, differ
    # the runtime's own round draws from its generator, seeded
    a = tpr.PlannerRuntime(_sensor(), planner="m1", params=params,
                           device="cpu", seed=4)
    b = tpr.PlannerRuntime(_sensor(), planner="m1", params=params,
                           device="cpu", seed=4)
    assert torch.equal(a._plan(), b._plan())


class _SerialDevice:
    """A serial curtain device that logs the calls it sees: ``send`` starts
    an exposure of the true depth, ``receive`` returns it; noise off."""

    def __init__(self, lcdev, depth, log, to_host):
        self.lcdev, self.depth, self.log = lcdev, depth, log
        self.to_host = to_host
        self.pending = None

    def send(self, path):
        self.log.append("send")
        self.pending = np.asarray(path)

    def receive(self):
        self.log.append("recv")
        out, thick = self.lcdev.get_return(self.depth, self.pending, True)
        return self.to_host(out), self.to_host(thick)

    def sense(self, path):
        self.log.append("sense")
        self.pending = np.asarray(path)
        return self.receive()


def _real_pair(pipelined):
    depth = _scene()
    logs = {"jax": [], "torch": []}
    rts = {}
    for side, mod in (("jax", jpr), ("torch", tpr)):
        kw = {} if side == "jax" else {"device": "cpu"}
        probe = _quiet(mod.PlannerRuntime(_sensor(), mode="real",
                                          planner="default",
                                          params=dict(DEFAULT[1]), **kw))
        host = ((lambda x: np.asarray(x)) if side == "jax"
                else (lambda x: x.numpy()))
        dev = _SerialDevice(probe.real_lc.lightcurtain_large,
                            depth if side == "jax" else torch.from_numpy(
                                depth), logs[side], host)
        fns = (dict(send_fn=dev.send, recv_fn=dev.receive) if pipelined
               else dict(sense_fn=dev.sense))
        rt = _quiet(mod.PlannerRuntime(_sensor(), mode="real",
                                       planner="default",
                                       params=dict(DEFAULT[1]), **fns, **kw))
        real = rt._measurement_dpv

        def convert(*a, _real=real, _log=logs[side]):
            _log.append("convert")
            return _real(*a)

        rt._measurement_dpv = convert
        rts[side] = rt
    return rts, logs


@pytest.mark.parametrize("pipelined", [True, False])
def test_real_loop_order_and_measurements_match_jax(pipelined):
    rts, logs = _real_pair(pipelined)
    jrt, trt = rts["jax"], rts["torch"]
    # the same streamed paths into both loops
    uf, _ = j_gen_ufield(jrt.final[0],
                         jnp.asarray(jrt.algo_lc.d_candi, jnp.float32),
                         jnp.asarray(jrt.real_param["intr_rgb"]),
                         jrt.uf_params, log=True)
    paths = np.asarray(jrt.algo_lc.plan_default(
        uf, jrt.algo_lc.planner_large, jrt.algo_lc.fw_large, "high",
        {"step": [0.5]}))
    want = jrt._sense_real_pipelined(jnp.asarray(p) for p in paths)
    got = trt._sense_real_pipelined(torch.from_numpy(p) for p in paths)
    if pipelined:
        order = ["send", "recv", "send", "convert", "recv", "send",
                 "convert", "recv", "convert"]
    else:
        order = ["sense", "recv", "sense", "recv", "convert", "sense",
                 "recv", "convert", "convert"]
    assert logs["jax"] == order and logs["torch"] == order
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (1, N, H, W)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    # a whole real round: three curtains sent, the field moved
    before = trt.final.clone()
    trt.run(None)
    assert logs["torch"].count("recv") == 6
    assert not torch.equal(trt.final, before)
    with pytest.raises(ValueError, match="sense_fn"):
        tpr.PlannerRuntime(_sensor(), mode="real", device="cpu").run(None)


def test_score_cache_keys_on_content_not_id():
    """A new frame in the same array object (the same ``id()``) gets a
    fresh truth field."""
    rt = tpr.PlannerRuntime(_sensor(shifted=True), device="cpu")
    assert rt.real_lc.transform_needed
    arr = _scene()
    first = rt.score(arr)
    arr[:] = 11.0
    second = rt.score(arr)
    fresh = tpr.PlannerRuntime(_sensor(shifted=True), device="cpu")
    assert second == fresh.score(np.full((H, W), 11.0, np.float32))
    assert second != first
    jrt = jpr.PlannerRuntime(_sensor(shifted=True))
    assert abs(jrt.score(np.full((H, W), 11.0, np.float32)) - second) <= 0.05


def test_replay_driver_matches_jax(sim_runs):
    """``ReplayDriver`` over 3 frames, on the runtimes of the sim test
    reset to their prior (JAX's compiled rounds are reused)."""
    jrt, trt = sim_runs["default"][:2]
    frames = [{"depth": _scene()} for _ in range(3)]
    for rt in (jrt, trt):
        rt.init_unc_field()
        rt.unc_scores = []
    sj = jpr.ReplayDriver(jrt).play(frames)
    st = tpr.ReplayDriver(trt).play(frames)
    assert len(st) == 3 and st[-1] < st[0]
    np.testing.assert_allclose(st, sj, rtol=0, atol=0.05)
    assert trt.unc_scores == st
    _same_field(trt.final, jrt.final, jrt.algo_lc.d_candi)


def test_sensor_sampling_harness_curve_matches_jax():
    depth = np.full((H, W), 12.0, np.float32)
    depth[:, 40:] = 20.0
    sz, si = synthesize_sweep(depth, 3.0, 30.0, planes=16)
    sz = sz.copy()
    sz[3] = np.nan                               # a plane not recorded
    jrt, trt = _pair(*DEFAULT)
    sj = JHarness(jrt, sz, si, depth).iterate(3)
    st = SensorSamplingHarness(trt, sz, si, depth).iterate(3)
    assert trt.counter == 3 and st[-1] < st[0]
    np.testing.assert_allclose(st, sj, rtol=0, atol=0.05)
    _same_field(trt.final, jrt.final, jrt.algo_lc.d_candi)


# ---- the server with its planner -----------------------------------------

D = 16


def _net_cfg():
    return {
        "data": {"exp_name": "nrt", "model_name": "base",
                 "loss_name": "base", "trainer_name": "default",
                 "dataset_path": "synthetic", "dataset_split": "k2"},
        "var": {"sigma_soft_max": 10.0, "t_win": 1, "d_min": 3.0,
                "d_max": 30.0, "feature_dim": 16, "ndepth": D,
                "softce": 0.3, "qpower": 1.0, "img_size": [W, H],
                "crop_w": W, "nmode": "exp7_lc", "bn_avg": False},
    }


def test_net_runtime_planner_matches_jax():
    """``NetRuntime(planner="default")`` over 3 frames with ``depth_sense``
    against JAX's: depth (1e-3 m) and the refined DPV (1e-4) as in
    ``test_torch_runtime.py``, each frame fed JAX's ``prev_lc``;
    ``lc_depth`` on the rays that agree (0.05 m), ``prev_lc`` as
    probabilities within 2e-3 where it reads only rays that agree;
    ``reset`` re-seeds the planner's prior and drops the carry."""
    sensor = _sensor(n=D)
    cfg = jcfg(_net_cfg())
    tmp = JNet(cfg, sensor, mode="mono_lc", variables={"params": {}})
    mi = tmp._model_input([np.zeros((3, H, W), np.float32)] * 2,
                          np.eye(4, dtype=np.float32))
    v = jax.jit(lambda r, m: jget_model(cfg).init(r, m, train=False))(
        {"params": jax.random.PRNGKey(0), "lc_drop": jax.random.PRNGKey(1)},
        mi)
    v = jax.tree_util.tree_map(np.asarray, v)
    jrt = JNet(jcfg(_net_cfg()), sensor, mode="mono_lc", variables=v,
               planner="default")
    trt = NetRuntime(tcfg(_net_cfg()), sensor, mode="mono_lc",
                     state_dict=from_jax_params(v), device="cpu",
                     planner="default")
    for rt in (jrt.planner_rt, trt.planner_rt):
        _quiet(rt)
    assert trt.planner_rt.params == {"step": [0.5], "std_div": 5.0}
    rng = np.random.default_rng(0)
    depth = _scene()
    for i in range(3):
        frame = rng.random((3, H, W), dtype=np.float32)
        oj = jrt.process_frame(frame, depth_sense=depth)
        ot = trt.process_frame(frame, depth_sense=depth)
        assert np.abs(ot["depth"].numpy() - np.asarray(oj["depth"])).max() \
            <= 1e-3, i
        np.testing.assert_allclose(np.exp(ot["dpv_refined"].numpy()),
                                   np.exp(np.asarray(oj["dpv_refined"])),
                                   rtol=0, atol=1e-4)
        keep = _same_field(trt.planner_rt.final, jrt.planner_rt.final,
                           trt.planner_rt.algo_lc.d_candi)
        cols = np.broadcast_to(keep, (H, W))
        both = cols & (ot["lc_mask"].numpy() > 0) & (
            np.asarray(oj["lc_mask"]) > 0)
        assert np.abs(ot["lc_depth"].numpy() - np.asarray(oj["lc_depth"]))[
            both].max() <= 0.05
        assert tuple(trt.prev_lc.shape) == (1, D, H // 4, W // 4)
        # prev_lc on the low-res columns whose linear x4 downsample reads
        # only rays that agree (full-res columns 4j - 3 .. 4j + 6)
        kept = keep.all(0)
        low = [j for j in range(W // 4) if kept[max(0, 4 * j - 3):
                                                4 * j + 7].all()]
        assert len(low) >= W // 8
        np.testing.assert_allclose(np.exp(trt.prev_lc.numpy())[..., low],
                                   np.exp(np.asarray(jrt.prev_lc))[..., low],
                                   rtol=0, atol=2e-3)
        s = torch.exp(trt.prev_lc).sum(1)
        torch.testing.assert_close(s, torch.ones_like(s), atol=1e-4, rtol=0)
        # the next frame's network sees JAX's feedback: a ray that ended
        # on another fused column would otherwise move every depth
        # through Base3D's receptive field
        trt.prev_lc = torch.from_numpy(np.array(jrt.prev_lc))
    trt.reset()
    fresh = tpr.PlannerRuntime(sensor, device="cpu")
    assert trt.prev_lc is None and trt.prev_output is None
    assert trt.planner_rt.counter == 0
    assert torch.equal(trt.planner_rt.final, fresh.final)
    # no depth_sense: the planner does not run
    out = trt.process_frame(rng.random((3, H, W), dtype=np.float32))
    assert "lc_depth" not in out and trt.prev_lc is None
