"""The port's light-curtain stack (``depthestimation_tpu_torch/lc`` and the
LC parts of ``ops``) against the JAX package on the same numpy inputs.

Everything is float32 on the CPU on both sides, so the tolerances are those
of reordered f32 arithmetic:

- setup that both sides compute in numpy float64 (``digitize_soft``, the
  FieldWarp grids, ``camera_angles``, the planner's ``phi``): equal to 1e-6
  (they are the same numpy expressions);
- the planner: IDENTICAL design points on the same cost field, for the
  velocity-only and the ``max_alpha`` solver, ties included (both sides
  take the first maximum of exactly equal f32 scores);
- elementwise stages (device returns, thickness, observation models,
  warps, prepared fields): rtol 1e-4 with an absolute floor that scales
  with the quantity (stated at each test);
- whole planners on a random field: the fields the DP sees differ in the
  last bits, so a ray whose two best ranges score within those bits may
  pick the other one. The tests state the share of rays allowed to differ
  (2%) and observe 0 on the fields used here;
- ``lc_process`` (noise off on both sides' devices, set on the test-local
  objects after ``init``) against JAX's loop under ``jax.jit``: at most
  10% of the rays (image columns) may end with another fused column; on
  every other ray the fused probabilities are within 2e-3 and the fused
  expected depth within 0.05 m of JAX's. Observed over three seeds and 1-3
  iterations: up to 6.3% of rays for the default planner in ``high`` (0
  for ``low`` and ``sweep``), 1e-4 and 5e-3 m on the rest. The rays that
  differ come from XLA's fused arithmetic under ``jit``: it moves DP scores
  that are tied to the last bits; against JAX run eagerly the port agrees
  on every ray (the stage-by-stage test).

Random draws cannot match JAX's: ``plan_m1`` is fed JAX's own sampled
indices through its ``sampled=`` seam, and the hit noise is off.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.data import synthetic as jsyn
from depthestimation_tpu.lc import curtain as jcur
from depthestimation_tpu.lc.curtain import LightCurtain as JLightCurtain
from depthestimation_tpu.lc.device import LCDevice as JLCDevice
from depthestimation_tpu.lc.fieldwarp import FieldWarp as JFieldWarp
from depthestimation_tpu.lc.fieldwarp import digitize_soft as j_digitize
from depthestimation_tpu.lc.planner import PlannerRT as JPlannerRT
from depthestimation_tpu.lc.process import lc_process as j_lc_process
from depthestimation_tpu.lc.transform import transform_points as j_transform
from depthestimation_tpu.ops import dpv as jdpv
from depthestimation_tpu.ops import geometry as jgeo
from depthestimation_tpu.ops import ufield as juf
from depthestimation_tpu_torch.config import config_from_dict
from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.lc.device import LCDevice, camera_angles
from depthestimation_tpu_torch.lc.fieldwarp import FieldWarp, digitize_soft
from depthestimation_tpu_torch.lc.planner import PlannerRT
from depthestimation_tpu_torch.lc.process import lc_process
from depthestimation_tpu_torch.lc.transform import transform_points
from depthestimation_tpu_torch.ops import cuda_lib
from depthestimation_tpu_torch.ops import dpv as tdpv
from depthestimation_tpu_torch.ops import planner_dp_kernel as pdk
from depthestimation_tpu_torch.ops import geometry as tgeo
from depthestimation_tpu_torch.ops import ufield as tuf
from depthestimation_tpu_torch.ops.resample import interp

W, H, D = 72, 32, 16


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


def _close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---- ops -------------------------------------------------------------------

@pytest.mark.parametrize("left,right", [(None, None), (np.nan, np.nan),
                                        (-1.0, 2.0)])
def test_interp_matches_jnp(left, right):
    rs = np.random.RandomState(0)
    xp = np.sort(rs.randn(3, 9).astype(np.float32), axis=-1)
    xp[1, 4] = xp[1, 3]                          # a zero-width segment
    fp = rs.randn(3, 9).astype(np.float32)
    x = np.concatenate([rs.randn(20) * 1.5, xp[0, [0, -1, 3]]]).astype(
        np.float32)
    want = np.stack([np.asarray(jnp.interp(x, xp[i], fp[i], left=left,
                                           right=right)) for i in range(3)])
    got = interp(_t(x), _t(xp), _t(fp), left=left, right=right).numpy()
    assert got.shape == (3, 23)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("n,iters", [(5, 1), (5, 2), (3, 3)])
def test_spread_dpv_matches_jax(n, iters):
    p = np.random.RandomState(1).rand(2, D, 4, 6).astype(np.float32)
    _close(tdpv.spread_dpv(_t(p), n, iters),
           jdpv.spread_dpv(jnp.asarray(p), n, iters), rtol=1e-5)


def test_observation_models_match_jax():
    rs = np.random.RandomState(2)
    d_candi = jdpv.powerf(3.0, 30.0, D, 1.0)
    z = rs.uniform(0.0, 35.0, (2, 5, 7)).astype(np.float32)
    z[0, 0, :3] = 0.0                            # nothing sensed
    unc = rs.uniform(1e-4, 0.5, z.shape).astype(np.float32)
    unc[0, 1, :2] = 0.0                          # zero variance: 0/0
    x = rs.rand(*z.shape).astype(np.float32)
    a_j = jdpv.intensity_to_confidence(jnp.asarray(x))
    a_t = tdpv.intensity_to_confidence(_t(x))
    _close(a_t, a_j, rtol=1e-6)
    want = jax.vmap(lambda zz, uu, aa: jdpv.mixed_model(
        d_candi, zz, uu, aa, 1.0 - aa))(jnp.asarray(z), jnp.asarray(unc), a_j)
    got = tdpv.mixed_model(d_candi, _t(z), _t(unc), a_t, 1.0 - a_t)
    assert got.shape == (2, D, 5, 7)
    _close(got, want, atol=1e-6)
    _close(tdpv.invert_curve(_t(x), 0.3),
           jdpv.invert_curve(jnp.asarray(x), 0.3), rtol=1e-5)
    assert np.array_equal(tdpv.gen_uniform(d_candi, _t(z)).numpy(),
                          np.asarray(jdpv.gen_uniform(d_candi, z)))
    masks = (rs.rand(2, 1, 5, 7) > 0.3).astype(np.float32)
    _close(tdpv.gen_dpv_withmask(_t(z), _t(masks), d_candi),
           jdpv.gen_dpv_withmask(jnp.asarray(z), jnp.asarray(masks),
                                 d_candi), atol=1e-6)
    inten = rs.rand(5, 7, 1).astype(np.float32)
    mj, lj = jdpv.lc_intensities_to_dist(d_candi, jnp.asarray(z[0])[..., None],
                                         jnp.asarray(inten), 0.4, 0.1, 0.2)
    mt, lt = tdpv.lc_intensities_to_dist(d_candi, _t(z[0])[..., None],
                                         _t(inten), 0.4, 0.1, 0.2)
    _close(mt, mj, atol=1e-7)
    _close(lt, lj, atol=1e-6)
    assert tdpv.EPS == jdpv.EPS


def test_ufield_batch_and_params_match_jax():
    assert tuf.UFieldParams.for_dataset("data/kitti") == tuf.UFieldParams()
    for name in ("kitti", "x/ilim/y", "sweep_set"):
        pj, pt = (m.UFieldParams.for_dataset(name) for m in (juf, tuf))
        assert pj.__dict__ == pt.__dict__
    rs = np.random.RandomState(3)
    d_candi = jdpv.powerf(3.0, 30.0, D, 1.0).astype(np.float32)
    dpv = rs.rand(3, D, 24, 10).astype(np.float32)
    dpv /= dpv.sum(1, keepdims=True)
    intr = np.tile(np.array([[8.0, 0, 5], [0, 8.0, 2], [0, 0, 1]],
                            np.float32), (3, 1, 1))
    intr[1, 1, 2] = 4.0                          # per-item intrinsics
    for p_j, p_t in ((juf.UFieldParams(pshift=2, zstart=0.3, zend=6.0),
                      tuf.UFieldParams(pshift=2, zstart=0.3, zend=6.0)),
                     (juf.UFieldParams.for_dataset("ilim"),
                      tuf.UFieldParams.for_dataset("ilim"))):
        want = [juf.gen_ufield(jnp.asarray(dpv[i]), jnp.asarray(d_candi),
                               jnp.asarray(intr[i]), p_j, log=False)
                for i in range(3)]
        uf, dm = tuf.gen_ufield(_t(dpv), d_candi, _t(intr), p_t, log=False)
        assert uf.shape == (3, D, 10) and dm.shape == (3, 24, 10)
        for i in range(3):
            np.testing.assert_allclose(uf[i].numpy(), np.asarray(want[i][0]),
                                       rtol=1e-5, atol=1e-7, equal_nan=True)
            _close(dm[i], want[i][1], rtol=1e-5)


def test_intr_scale_matches_jax():
    intr = np.array([[400.0, 0, 190], [0, 410.0, 120], [0, 0, 1]])
    np.testing.assert_array_equal(tgeo.intr_scale(intr, (384, 256), (96, 64)),
                                  jgeo.intr_scale(intr, (384, 256), (96, 64)))


# ---- device ----------------------------------------------------------------

def _device_params(w=W, h=H, max_alpha=None):
    intr = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]],
                    np.float32)
    cam = {"width": w, "height": h, "matrix": intr,
           "distortion": [0.0] * 5, "hit_mode": 1, "hit_noise": 0.0}
    ltc = np.eye(4, dtype=np.float32)
    ltc[0, 3] = 0.2
    laser = {"lTc": ltc, "fov": 80.0, "laser_timestep": 2e-4}
    if max_alpha is not None:
        laser["max_alpha"] = max_alpha
    return cam, laser


def _curtains(rs, n=3, pts=50):
    """Wavy curtains whose angular support leaves some columns uncovered
    (NaN) on one of them."""
    xs = np.linspace(-9, 9, pts).astype(np.float32)
    zs = np.stack([8.0 + 2.0 * np.sin(xs * (0.3 + 0.2 * i)) + rs.rand(pts)
                   for i in range(n)]).astype(np.float32)
    out = np.stack([np.broadcast_to(xs, zs.shape), zs], -1).copy()
    out[0, :, 0] *= 0.3                          # narrow: NaN columns
    return out


def test_device_setup_and_thickness_match_jax():
    cam, laser = _device_params()
    dj, dt = JLCDevice(cam, laser), LCDevice(cam, laser, "cpu")
    np.testing.assert_array_equal(dt.thetas, dj.thetas)
    np.testing.assert_array_equal(camera_angles(dj.intr, W), dj.thetas)
    pts = _curtains(np.random.RandomState(4))
    want = np.stack([np.asarray(dj.curtain_thickness(jnp.asarray(p)))
                     for p in pts])
    got = dt.curtain_thickness(_t(pts)).numpy()
    assert np.isnan(want[0]).any() and not np.isnan(want[1]).any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7,
                               equal_nan=True)
    zc = dt.curtain_profile(_t(pts)).numpy()
    wantz = np.stack([np.asarray(dj.curtain_profile(jnp.asarray(p)))
                      for p in pts])
    np.testing.assert_allclose(zc, wantz, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


def test_get_return_without_noise_matches_jax():
    """Intensity is 255 exp(-(err/sigma)^2): rtol 1e-4 in the exponent's
    inputs; absolute floor 2e-2 of 255 where the exponent is large."""
    cam, laser = _device_params()
    dj, dt = JLCDevice(cam, laser), LCDevice(cam, laser, "cpu")
    rs = np.random.RandomState(5)
    depth = rs.uniform(6.0, 12.0, (2, H, W)).astype(np.float32)
    depth[0, :4] = 0.0                           # invalid pixels
    pts = _curtains(rs)
    out, thick = dt.get_return(_t(depth)[:, None], _t(pts), True)
    assert out.shape == (2, 3, H, W, 4) and thick.shape == (2, 3, H, W)
    for b in range(2):
        for p in range(3):
            oj, tj = dj.get_return(jnp.asarray(depth[b]), jnp.asarray(pts[p]))
            np.testing.assert_allclose(out[b, p, ..., :3].numpy(),
                                       np.asarray(oj)[..., :3], rtol=1e-5,
                                       atol=1e-5, equal_nan=True)
            np.testing.assert_allclose(out[b, p, ..., 3].numpy(),
                                       np.asarray(oj)[..., 3], rtol=1e-3,
                                       atol=2e-2, equal_nan=True)
            np.testing.assert_allclose(thick[b, p].numpy(), np.asarray(tj),
                                       rtol=1e-4, equal_nan=True)
    # a generator with hit_noise 0 draws nothing; with noise it changes
    # the intensity only, within its clip
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    out0, _ = dt.get_return(_t(depth)[:, None], _t(pts), True, generator=gen)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(torch.nan_to_num(out0), torch.nan_to_num(out))
    dt.hit_noise = 0.05
    outn, _ = dt.get_return(_t(depth)[:, None], _t(pts), True, generator=gen)
    assert torch.equal(torch.nan_to_num(outn[..., :3]),
                       torch.nan_to_num(out[..., :3]))
    i0, i1 = torch.nan_to_num(out[..., 3]), torch.nan_to_num(outn[..., 3])
    assert not torch.equal(i0, i1)
    assert i1.min() >= 0 and i1.max() <= 255
    assert (i1 - i0).abs().max() <= 0.05 * 6 * 255


# ---- transform -------------------------------------------------------------

def test_transform_points_shifted_camera_matches_jax():
    """The z-buffered scatter: many points per pixel, a camera shifted and
    turned, points behind it and outside the image, NaN thickness."""
    rs = np.random.RandomState(6)
    w, h, n = 24, 16, 4000
    intr = np.array([[20.0, 0, 12], [0, 20.0, 8], [0, 0, 1]], np.float32)
    ang = 0.1
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                 [-np.sin(ang), 0, np.cos(ang)]]
    T[:3, 3] = [0.3, -0.1, 0.5]
    pts = np.stack([rs.uniform(-6, 6, (2, n)), rs.uniform(-4, 4, (2, n)),
                    rs.uniform(-2, 12, (2, n)), rs.uniform(0, 255, (2, n))],
                   -1).astype(np.float32)
    thick = rs.rand(2, n).astype(np.float32)
    thick[0, :50] = np.nan
    got = transform_points(_t(pts), _t(thick), intr, T, w, h)
    for i in range(2):
        want = j_transform(jnp.asarray(pts[i]), jnp.asarray(thick[i]),
                           jnp.asarray(intr), jnp.asarray(T), w, h)
        for g, wv in zip(got, want):
            assert g.shape == (2, h, w)
            _close(g[i], wv, rtol=1e-5, atol=1e-5)
    assert (got[0] > 0).float().mean() > 0.5     # the image is covered


# ---- field warps -----------------------------------------------------------

def _warps(rtc):
    intr_in = np.array([[60.0, 0, 36], [0, 60.0, 16], [0, 0, 1]])
    intr_out = np.array([[50.0, 0, 30], [0, 50.0, 14], [0, 0, 1]])
    dist = np.zeros((1, 5), np.float32)
    args = (intr_in, dist, (72, 32), intr_out, dist, (60, 28), rtc)
    return JFieldWarp(*args), FieldWarp(*args, device="cpu")


def test_digitize_soft_and_grids_match_jax():
    rs = np.random.RandomState(7)
    arr = jdpv.powerf(3.0, 30.0, 24, 1.3)
    vals = np.concatenate([rs.uniform(0, 35, 100), arr[[0, -1]],
                           [arr[0] - 1e-3, arr[-1] + 1e-3]])
    np.testing.assert_array_equal(digitize_soft(vals, arr),
                                  j_digitize(vals, arr))
    rtc = np.eye(4)
    rtc[0, 3], rtc[2, 3] = 0.3, -0.2
    fj, ft = _warps(rtc)
    d_up = jdpv.powerf(3.0, 30.0, 2 * D, 1.0)
    fj.warm(d_up, d_up)
    ft.warm(d_up, d_up)
    assert set(ft._grids) == {"z2r_in", "z2r_out", "transform"}
    for name in ft._grids:
        np.testing.assert_allclose(ft._grids[name].numpy(), fj._grids[name],
                                   rtol=0, atol=1e-6)


def test_field_warps_match_jax():
    rtc = np.eye(4)
    rtc[0, 3], rtc[2, 3] = 0.3, -0.2
    fj, ft = _warps(rtc)
    d = jdpv.powerf(3.0, 30.0, D, 1.0)
    d_up = jdpv.powerf(3.0, 30.0, 2 * D, 1.0)
    field = np.random.RandomState(8).rand(2, D, 72).astype(np.float32)
    pre = ft.preprocess(_t(field), d, d_up)
    assert pre.shape == (2, 2 * D, 60)
    for i in range(2):
        pj = fj.preprocess(jnp.asarray(field[i]), d, d_up)
        _close(pre[i], pj, rtol=1e-5)
    up = pre.numpy()
    for name in ("ztheta2zrange_input", "ztheta2zrange_output",
                 "transformZTheta"):
        got = getattr(ft, name)(_t(up), d_up, d_up)
        for i in range(2):
            want = getattr(fj, name)(jnp.asarray(up[i]), d_up, d_up)
            _close(got[i], want, rtol=1e-5)
        assert float(got.abs().sum()) > 0


# ---- planner ---------------------------------------------------------------

def _fields(rs, r, w):
    f = rs.rand(4, r, w).astype(np.float32)
    f[1] = np.round(f[1] * 4) / 4                # many exact ties
    f[2, :, ::3] = 0.0                           # flat columns
    f[3, rs.randint(0, r, 20), rs.randint(0, w, 20)] = np.nan
    return f


@pytest.mark.parametrize("max_alpha,r", [(None, 32), (4.0e7, 16)])
def test_planner_design_points_identical_to_jax(max_alpha, r):
    cam, laser = _device_params(max_alpha=max_alpha)
    ranges = jdpv.powerf(3.0, 30.0, r, 1.0)
    pj = JPlannerRT(JLCDevice(cam, laser), ranges, W)
    pt = PlannerRT(LCDevice(cam, laser, "cpu"), ranges, W)
    np.testing.assert_array_equal(pt.phi, pj.phi)
    assert pt.dphi_max == pj.dphi_max and pt.ddphi_max == pj.ddphi_max
    fields = _fields(np.random.RandomState(9), r, W)
    got = pt.get_design_points(_t(fields)).numpy()
    assert got.shape == (4, W, 2)
    for i, f in enumerate(fields):
        want = np.asarray(pj.get_design_points(f))
        np.testing.assert_array_equal(got[i], want)
    # the galvo limit holds along every path
    phi = np.degrees(np.arctan2(got[..., 0] + 0.2, got[..., 1]))
    assert np.abs(np.diff(phi, axis=-1)).max() <= pt.dphi_max + 1e-3
    # a batch of one, and leading axes
    one = pt.get_design_points(_t(fields[0])).numpy()
    np.testing.assert_array_equal(one, got[0])
    two = pt.get_design_points(_t(fields).reshape(2, 2, r, W)).numpy()
    np.testing.assert_array_equal(two.reshape(4, W, 2), got)


@pytest.mark.parametrize("max_alpha", [None, 4.0e7])
def test_planner_cpu_solves_take_the_plain_path(max_alpha):
    """A CPU field runs ``_dp_solve`` (or the ``max_alpha`` loop), never
    the kernel: ``planner_dp.launches`` stays 0 and the span
    ``lc.plan.dp`` notes the plain route."""
    from depthestimation_tpu_torch.utils import profiling
    cam, laser = _device_params(max_alpha=max_alpha)
    pt = PlannerRT(LCDevice(cam, laser, "cpu"), jdpv.powerf(3.0, 30.0, 16,
                                                            1.0), W)
    before = pdk.planner_dp.launches
    with profiling.recording() as rec:
        pts = pt.get_design_points(_t(_fields(np.random.RandomState(3), 16,
                                              W)))
    assert pts.shape == (4, W, 2) and bool(torch.isfinite(pts).all())
    assert pdk.planner_dp.launches == before
    assert [s["attrs"] for s in rec.read()] == [{"route": "plain"}]
    assert isinstance(pt._penalty, torch.Tensor) == (max_alpha is None)
    assert pt._bits is None


def test_planner_dp_kernel_is_in_the_library():
    assert cuda_lib._SIGNATURES["planner_dp_fwd"] == (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    assert cuda_lib.CSRC / "planner_dp.cu" in cuda_lib._sources()


@pytest.mark.parametrize("r", [1, 3, 24, 33, 128, 200, 257, 1024])
def test_planner_feasibility_bits_in_the_kernels_scan_order(r):
    """``pack_feasible``'s bits, read as the kernel reads them (lane q of
    node r, word j // 32, bit j % 32 for predecessor rp = q + j * S),
    give back the penalty; S lanes keep a block within 512 threads (1024
    at one lane a node)."""
    s = pdk.split(r)
    assert s in (1, 2, 4, 8, 16, 32)
    assert -(-r * s // 32) * 32 <= (pdk.THREADS if s > 1 else 1024)
    assert s == 32 or -(-r * 2 * s // 32) * 32 > pdk.THREADS
    rs = np.random.RandomState(r)
    k = 3 if r < 500 else 1
    pen = torch.from_numpy(np.where(rs.rand(k, r, r) < 0.5, 0.0,
                                    -1e30).astype(np.float32))
    bits = pdk.pack_feasible(pen, s)
    assert bits.dtype == torch.int32 and bits.is_contiguous()
    assert bits.shape == (k, pdk.words(r, s), r, s)
    word = bits.to(torch.int64) & 0xFFFFFFFF
    got = torch.zeros(k, r, r, dtype=torch.bool)
    for q in range(min(s, r)):
        for j in range(-(-(r - q) // s)):
            bit = (word[:, j // 32, :, q] >> (j % 32)) & 1
            got[:, q + j * s, :] = bit.bool()
    assert torch.equal(got, pen == 0)


@pytest.mark.parametrize("r,w", [(128, 200), (40, 64)])
def test_planner_feasibility_bits_built_in_chunks(r, w):
    """``feasible_bits`` packs the planner's penalty a chunk of hops at a
    time (4 chunks at 128 ranges on 200 rays, one at 40 on 64) into the
    same bits as ``pack_feasible`` of the whole penalty."""
    cam, laser = _device_params(w=w)
    laser["laser_timestep"] = 3.5e-5          # a galvo that cannot keep up
    pt = PlannerRT(LCDevice(cam, laser, "cpu"), jdpv.powerf(3.0, 30.0, r,
                                                            1.0), w)
    whole = pt._penalty_of(0, w - 1)
    assert whole.shape == (w - 1, r, r)
    assert bool((whole == 0).any()) and bool((whole != 0).any())
    calls = []

    def penalty_of(a, b):
        calls.append((a, b))
        return pt._penalty_of(a, b)

    bits = pdk.feasible_bits(penalty_of, w - 1, r)
    assert torch.equal(bits, pdk.pack_feasible(whole, pdk.split(r)))
    k = max(1, (1 << 20) // (r * r))
    assert calls == [(a, min(a + k, w - 1)) for a in range(0, w - 1, k)]


class _Recorder:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("r,c,scratch", [(128, 768, False),
                                         (1024, 120, True)])
def test_planner_dp_cuda_branch_on_meta_tensors(r, c, scratch, monkeypatch):
    """The CUDA branch on ``meta`` tensors (no data, so it runs here): it
    allocates the points and the indices (and the back-pointers' scratch
    only where they outgrow shared memory), hands the C entry point as
    many arguments as its signature has, counts one launch, and refuses
    what the kernel does not take."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "library", lambda: rec)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(pdk.planner_dp, "launches", 0)
    meta = torch.device("meta")
    s = pdk.split(r)
    field = torch.empty(48, r, c, device=meta)
    bits = torch.empty(c - 1, pdk.words(r, s), r, s, dtype=torch.int32,
                       device=meta)
    xz = torch.empty(c, r, 2, device=meta)
    pts, idx = pdk.planner_dp(field, bits, xz)
    assert pts.shape == (48, c, 2) and pts.dtype == torch.float32
    assert idx.shape == (48, c) and idx.dtype == torch.int64
    assert pdk.planner_dp.launches == 1
    (name, args), = rec.calls
    assert name == "planner_dp_fwd"
    assert len(args) == len(cuda_lib._SIGNATURES[name])
    assert args[6:10] == (48, r, c, s)
    assert (args[5] is not None) == scratch
    for bad in (field.double(), field.transpose(1, 2),
                torch.empty(48, r, 1, device=meta)):
        with pytest.raises(ValueError):
            pdk.planner_dp(bad, bits, xz)
    for bad_bits in (bits[1:], bits.to(torch.int64), torch.empty(
            bits.shape, dtype=torch.int32)):
        with pytest.raises(ValueError):
            pdk.planner_dp(field, bad_bits, xz)
    with pytest.raises(ValueError):
        pdk.planner_dp(field, bits, xz[1:])
    with pytest.raises(ValueError):
        pdk.planner_dp(torch.empty(1, 1025, c, device=meta), bits, xz)
    with pytest.raises(ValueError):
        pdk.planner_dp(torch.empty(48, r, c), torch.empty(
            bits.shape, dtype=torch.int32), torch.empty(c, r, 2))
    assert pdk.planner_dp.launches == 1


# ---- LightCurtain ----------------------------------------------------------

CFG = config_from_dict({"data": {"exp_name": "t"},
                        "var": {"d_min": 3.0, "d_max": 30.0, "qpower": 1.0,
                                "ndepth": D}})


def _build(cls, mi, rtc=None, **kw):
    lc = cls(**kw)
    params = lc.gen_params_from_model_input(mi)
    # at 72 columns a ray spans a degree: the default galvo (0.875 deg per
    # ray) would pin every path to one curve and the planners' choices
    # would go untested
    params["max_omega"] = 1.0e5
    if rtc is not None:
        params["rTc"] = rtc
    lc.init(lc.expand_params(params, CFG, D, 2 * D))
    for dev in (lc.lightcurtain_large, lc.lightcurtain_small):
        dev.hit_noise = 0.0                      # draws cannot match JAX's
    return lc


@pytest.fixture(scope="module")
def scene():
    mi, _ = jsyn.make_batch(batch=2, t_win=1, h=H, w=W, d_min=3.0,
                            d_max=30.0, ndepth=D, seed=1)
    return mi


@pytest.fixture(scope="module")
def curtains(scene):
    return _build(JLightCurtain, scene), _build(LightCurtain, scene,
                                                device="cpu")


def _same_paths(got, want, share=0.02):
    """Design points equal but for at most ``share`` of the rays."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    differ = (got != want).any(-1).mean()
    assert differ <= share, differ
    return differ


def _uf(rs, w=W):
    uf = rs.rand(2, D, w).astype(np.float32) ** 3
    uf[0, :, 5] = 0.25                           # a flat column: 0/0
    uf[1, 3, 7] = np.nan                         # a NaN column -> the back
    return uf


def test_init_matches_jax(curtains):
    jl, tl = curtains
    assert tl.initialized and not tl.transform_needed
    assert tl.lightcurtain_large.hit_noise == 0.0
    assert LightCurtain("cpu").initialized is False
    for k in ("intr_rgb_small", "intr_lc_small", "cTr"):
        np.testing.assert_array_equal(tl.PARAMS[k], jl.PARAMS[k])
    assert tl.PARAMS["size_lc_small"] == jl.PARAMS["size_lc_small"]
    for name in ("planner_large", "planner_small"):
        np.testing.assert_array_equal(getattr(tl, name).phi,
                                      getattr(jl, name).phi)
    for name in ("fw_large", "fw_small"):
        for g in ("z2r_in", "z2r_out"):
            np.testing.assert_allclose(getattr(tl, name)._grids[g].numpy(),
                                       getattr(jl, name)._grids[g],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["high", "low"])
def test_prepare_field_and_plan_empty_match_jax(curtains, mode):
    jl, tl = curtains
    w = W if mode == "high" else W // 4
    uf = _uf(np.random.RandomState(10), w)
    fw = "fw_large" if mode == "high" else "fw_small"
    for normalize in (True, False):
        got = tl._prepare_field(_t(uf), getattr(tl, fw), mode,
                                normalize=normalize)
        for i in range(2):
            want = jl._prepare_field(jnp.asarray(uf[i]), getattr(jl, fw),
                                     mode, normalize=normalize)
            for g, wv in zip(got, want):
                _close(g[i], wv, rtol=1e-4, atol=1e-6)
    got = getattr(tl, f"plan_empty_{mode}")(_t(uf), {})
    for i in range(2):
        _close(got[i], getattr(jl, f"plan_empty_{mode}")(
            jnp.asarray(uf[i]), {}), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["high", "low"])
def test_plan_default_matches_jax(curtains, mode):
    jl, tl = curtains
    uf = _uf(np.random.RandomState(11), W if mode == "high" else W // 4)
    cfg = {"step": [0.5, 0.25]}
    got = getattr(tl, f"plan_default_{mode}")(_t(uf), cfg)
    assert got.shape == (2, 5, uf.shape[-1], 2)
    jfn = jax.jit(lambda f: getattr(jl, f"plan_default_{mode}")(f, cfg))
    for i in range(2):
        _same_paths(got[i], jfn(jnp.asarray(uf[i])))


def test_plan_m1_matches_jax_on_the_same_samples(curtains):
    jl, tl = curtains
    uf = _uf(np.random.RandomState(12))[0]
    cfg = {"step": 2, "interval": 3}
    key = jax.random.PRNGKey(7)
    want = jl.plan_m1_high(jnp.asarray(uf), cfg, key)
    # JAX's own draws, remade from its key chain on its own field
    _, fr = jl._prepare_field(jnp.asarray(uf), jl.fw_large, "high",
                              normalize=False)
    base = jnp.nan_to_num(jcur._fix_sides(fr), nan=1e-5)
    logits = jnp.log(jnp.clip(base.T, 1e-12, None))
    sampled, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        sampled.append(np.asarray(jax.random.categorical(sub, logits)))
    got = tl.plan_m1_high(_t(uf), cfg, sampled=_t(np.stack(sampled)))
    assert got.shape == (3, W, 2)
    _same_paths(got, want)
    # its own draws: seeded, in range, moving with the seed
    g = torch.Generator().manual_seed(1)
    a = tl.plan_m1_high(_t(uf), cfg, generator=g)
    b = tl.plan_m1_high(_t(uf), cfg,
                        generator=torch.Generator().manual_seed(1))
    c = tl.plan_m1_high(_t(uf), cfg, generator=g)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[0], got[0])             # path 0 draws nothing
    assert (a[1] != a[0]).any(-1).float().mean() > 0.5   # the draws steer
    assert torch.equal(tl.plan_m1_low(_t(uf[:, ::4]), cfg),
                       tl.plan_m1_low(_t(uf[:, ::4]), cfg))


def test_plan_sweep_matches_jax(curtains):
    jl, tl = curtains
    cfg = {"start": 4.0, "end": 20.0, "step": 4.0, "offset": 0.5}
    got = tl.plan_sweep_high(None, cfg)
    want = np.asarray(jl.plan_sweep_high(None, cfg))
    assert got.shape == (4, 2000, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["high", "low"])
def test_sense_matches_jax(curtains, scene, mode):
    """Measurement DPVs are probabilities: atol 1e-5, rtol 1e-3."""
    jl, tl = curtains
    rs = np.random.RandomState(13)
    depth = scene["dmaps_up"] if mode == "high" else scene["dmaps"]
    depth = depth.copy()
    depth[1, :3] = 0.0
    pts = _curtains(rs)
    pts[..., 1] += 4.0
    got = getattr(tl, f"sense_{mode}")(_t(depth)[:, None], _t(pts))
    assert got.shape == (2, 3, D) + depth.shape[1:]
    jfn = jax.jit(lambda dm, p: getattr(jl, f"sense_{mode}")(dm, p))
    for b in range(2):
        for p in range(3):
            want = jfn(jnp.asarray(depth[b]), jnp.asarray(pts[p]))
            _close(got[b, p], want, rtol=1e-3, atol=1e-5)
    _close(got.sum(2), np.ones_like(got.sum(2)), atol=1e-5)


def test_shifted_camera_sense_and_measurement_paths_match_jax(scene):
    """``transform_needed``: the depth map goes into the LC camera's frame
    and the returns come back through ``transform_points``."""
    rtc = np.eye(4, dtype=np.float32)
    rtc[0, 3], rtc[2, 3] = 0.1, 0.05
    jl = _build(JLightCurtain, scene, rtc)
    tl = _build(LightCurtain, scene, rtc, device="cpu")
    assert tl.transform_needed and "transform" in tl.fw_large._grids
    depth = scene["dmaps_up"]
    pts = _curtains(np.random.RandomState(14), n=2)
    pts[..., 1] += 4.0
    got = tl.sense_high(_t(depth)[:, None], _t(pts))
    for b in range(2):
        for p in range(2):
            want = jl.sense_high(jnp.asarray(depth[b]), jnp.asarray(pts[p]))
            # a point on a pixel's edge may round into the neighbour: the
            # share of pixels off by more than the tolerance stays tiny
            off = np.abs(got[b, p].numpy() - np.asarray(want)) > 1e-4
            assert off.any(0).mean() <= 0.01
    uf = _uf(np.random.RandomState(15))
    fz, fr = tl._prepare_field(_t(uf), tl.fw_large, "high")
    for i in range(2):
        wz, wr = jl._prepare_field(jnp.asarray(uf[i]), jl.fw_large, "high")
        _close(fz[i], wz, atol=1e-5)
        _close(fr[i], wr, atol=1e-5)
    # the recorded-measurement paths
    out, thick = tl.lightcurtain_large.get_return(_t(depth[0]), _t(pts[1]))
    out, thick = torch.nan_to_num(out), torch.nan_to_num(thick)
    sa = tl.transform_measurement(out, thick)
    sa_j = jl.transform_measurement(jnp.asarray(out.numpy()),
                                    jnp.asarray(thick.numpy()))
    assert sa.shape == (3, H, W)
    _close(sa, sa_j, rtol=1e-5, atol=1e-5)
    sa_j = jnp.asarray(sa.numpy())
    _close(tl.gen_lc_dpv_approx(sa, 10.0), jl.gen_lc_dpv_approx(sa_j, 10.0),
           rtol=1e-3, atol=1e-5)
    _close(tl.gen_lc_dpv_true(sa, 10.0), jl.gen_lc_dpv_true(sa_j, 10.0),
           rtol=1e-3, atol=1e-5)


# ---- the Bayes loop --------------------------------------------------------

def _log_dpv(rs, b, h, w):
    x = rs.randn(b, D, h, w).astype(np.float32)
    return x - np.log(np.exp(x).sum(1, keepdims=True))


@pytest.mark.parametrize("planner,mode,params", [
    ("default", "high", {"step": [0.5], "spread_iter": 2, "spread_n": 5}),
    ("sweep", "high", {"start": 5.0, "end": 25.0, "step": 5.0,
                       "spread_iter": 0}),
    ("default", "low", {"step": [0.5], "spread_iter": 1, "spread_n": 3}),
    ("m1", "high", {"step": 1, "spread_iter": 1, "spread_n": 3}),
])
def test_lc_process_matches_jax(curtains, scene, planner, mode, params):
    jl, tl = curtains
    rs = np.random.RandomState(16)
    high = mode == "high"
    h, w = (H, W) if high else (H // 4, W // 4)
    bv = _log_dpv(rs, 2, h, w)
    dm = scene["dmaps_up"] if high else scene["dmaps"]
    intr = scene["intrinsics_up"] if high else scene["intrinsics"]
    ufp_j, ufp_t = juf.UFieldParams(), tuf.UFieldParams()
    got = lc_process(_t(bv), _t(dm), _t(intr), tl, ufp_t, iterations=2,
                     planner=planner, params=params, mode=mode,
                     generator=torch.Generator().manual_seed(0))
    assert got.shape == bv.shape and not got.requires_grad
    p = np.exp(got.numpy())
    assert np.isfinite(got.numpy()).all()
    _close(p.sum(1), np.ones_like(p.sum(1)), atol=1e-4)
    assert np.abs(p - np.exp(bv)).max() > 0.05   # the curtains sensed
    if planner == "m1":
        return                                   # its draws are its own
    want = np.asarray(jax.jit(lambda b, d, i: j_lc_process(
        b, d, i, jl, ufp_j, iterations=2, planner=planner, params=params,
        mode=mode))(jnp.asarray(bv), jnp.asarray(dm), jnp.asarray(intr)))
    q = np.exp(want)
    # a ray = an image column; one whose design point differs senses
    # another curtain and ends with another fused column
    off = (np.abs(p - q) > 2e-3).any(axis=(1, 2))               # [B, W]
    assert off.mean() <= 0.10, off.mean()
    keep = np.broadcast_to(~off[:, None, None, :], p.shape)
    assert np.abs(p - q)[keep].max() <= 2e-3
    d_candi = np.asarray(scene["d_candi"], np.float32)[:, None, None]
    ddepth = np.abs((p * d_candi).sum(1) - (q * d_candi).sum(1))
    assert ddepth[keep[:, 0]].max() <= 0.05


def test_lc_process_stage_by_stage_first_iteration(curtains, scene):
    """One iteration taken apart: field, paths, measurements, fusion."""
    jl, tl = curtains
    rs = np.random.RandomState(17)
    bv = _log_dpv(rs, 2, H, W)
    d_candi = np.asarray(scene["d_candi"], np.float32)
    curr = np.clip(np.exp(bv), tdpv.EPS, 1.0).astype(np.float32)
    intr, dm = scene["intrinsics_up"], scene["dmaps_up"]
    cfg = {"step": [0.5]}
    uf_t, _ = tuf.gen_ufield(_t(curr), d_candi, _t(intr), tuf.UFieldParams(),
                             log=False)
    paths_t = tl.plan_default_high(uf_t, cfg)
    dpvs_t = tl.sense_high(_t(dm)[:, None], paths_t)
    differ = 0.0
    for i in range(2):
        uf_j, _ = juf.gen_ufield(jnp.asarray(curr[i]), jnp.asarray(d_candi),
                                 jnp.asarray(intr[i]), juf.UFieldParams(),
                                 log=False)
        np.testing.assert_allclose(uf_t[i].numpy(), np.asarray(uf_j),
                                   rtol=1e-5, atol=1e-7, equal_nan=True)
        paths_j = jl.plan_default_high(uf_j, cfg)
        differ = max(differ, _same_paths(paths_t[i], paths_j))
        for p in range(3):
            want = jl.sense_high(jnp.asarray(dm[i]), paths_j[p])
            # planned curtains graze the surfaces, where the intensity's
            # exponent is steepest: probabilities to 5e-4
            if np.array_equal(paths_t[i, p].numpy(), np.asarray(paths_j[p])):
                _close(dpvs_t[i, p], want, rtol=1e-3, atol=5e-4)
    assert differ == 0.0                         # observed on these fields


@pytest.mark.parametrize("planner,mode", [("sweep", "low"), ("nope", "high")])
def test_lc_process_refuses_like_jax(curtains, scene, planner, mode):
    """``sweep`` + ``low`` has no planner in the reference (it calls None:
    a TypeError); the port says so. An unknown planner raises on both."""
    jl, tl = curtains
    bv = _log_dpv(np.random.RandomState(18), 2, H // 4, W // 4)
    params = {"start": 5.0, "end": 25.0, "step": 5.0}
    args = (bv, scene["dmaps"], scene["intrinsics"])
    with pytest.raises(ValueError):
        lc_process(*map(_t, args), tl, tuf.UFieldParams(), iterations=1,
                   planner=planner, params=params, mode=mode)
    with pytest.raises((TypeError, ValueError)):
        j_lc_process(*map(jnp.asarray, args), jl, juf.UFieldParams(),
                     iterations=1, planner=planner, params=params, mode=mode)


def test_lc_process_default_generator_is_seed_0(curtains, scene):
    """With the hit noise on, ``generator=None`` is one seeded with 0."""
    _, tl = curtains
    tl.lightcurtain_large.hit_noise = 0.01
    try:
        bv = _log_dpv(np.random.RandomState(19), 2, H, W)
        args = (_t(bv), _t(scene["dmaps_up"]), _t(scene["intrinsics_up"]),
                tl, tuf.UFieldParams())
        a = lc_process(*args, iterations=1)
        b = lc_process(*args, iterations=1,
                       generator=torch.Generator().manual_seed(0))
        c = lc_process(*args, iterations=1,
                       generator=torch.Generator().manual_seed(1))
    finally:
        tl.lightcurtain_large.hit_noise = 0.0
    assert torch.equal(a, b) and not torch.equal(a, c)
