"""The port's ops (depthestimation_tpu_torch/ops: dpv, geometry, resample,
ufield, plane-sweep stage 1 and band matrices) against the JAX package on
the same numpy inputs. Both sides are f32 on the CPU; the tolerances are
f32 round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops import dpv as jdpv
from depthestimation_tpu.ops import geometry as jgeo
from depthestimation_tpu.ops import plane_sweep as jps
from depthestimation_tpu.ops import resample as jrs
from depthestimation_tpu.ops import ufield as juf
from depthestimation_tpu_torch.ops import dpv as tdpv
from depthestimation_tpu_torch.ops import geometry as tgeo
from depthestimation_tpu_torch.ops import plane_sweep as tps
from depthestimation_tpu_torch.ops import resample as trs
from depthestimation_tpu_torch.ops import ufield as tuf

D, H, W = 16, 12, 16


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _log_dpv(seed, shape=(2, D, H, W)):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    return x - np.log(np.exp(x).sum(-3, keepdims=True))


def test_powerf_matches():
    for q in (1.0, 2.0):
        np.testing.assert_array_equal(tdpv.powerf(3.0, 30.0, D, q),
                                      jdpv.powerf(3.0, 30.0, D, q))


@pytest.mark.parametrize("log", [False, True])
def test_dpv_to_depthmap(log):
    x = _log_dpv(0)
    if not log:
        x = np.exp(x)
    d = jdpv.powerf(3.0, 30.0, D, 1.0)
    want = np.asarray(jdpv.dpv_to_depthmap(jnp.asarray(x), d, log=log))
    got = tdpv.dpv_to_depthmap(_t(x), d, log=log).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n", [8, 32])
def test_upsample_dpv(n):
    x = _log_dpv(1)
    want = np.asarray(jdpv.upsample_dpv(jnp.asarray(x), n, log=True))
    got = tdpv.upsample_dpv(_t(x), n, log=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gen_soft_label():
    rs = np.random.RandomState(2)
    dm = rs.uniform(3.0, 30.0, (H, W)).astype(np.float32)
    dm[0, 0] = 0.0
    d = jdpv.powerf(3.0, 30.0, D, 1.0)
    want = np.asarray(jdpv.gen_soft_label(d, dm, 0.3, zero_invalid=True))
    got = tdpv.gen_soft_label(d, dm, 0.3, zero_invalid=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(3, 4), (1, 1), (12, 16)])
def test_resize_linear_is_jax_antialiased_resize(out_hw):
    """net_runtime's prev_output downsample: jax.image.resize "linear"
    antialiases when shrinking; torch's bilinear needs antialias=True."""
    x = np.exp(_log_dpv(3, (1, D, H, W)))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, D) + out_hw,
                                       method="linear"))
    got = tdpv.resize_linear(_t(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if out_hw == (3, 4):
        plain = torch.nn.functional.interpolate(
            _t(x), size=out_hw, mode="bilinear", align_corners=False)
        assert np.abs(plain.numpy() - want).max() > 1e-3   # antialias matters


def test_geometry_setup_helpers():
    intr = np.array([[184.3, 0, 166.2], [0, 184.3, 132.1], [0, 0, 1]],
                    np.float32)
    np.testing.assert_array_equal(tgeo.intr_scale_unit(intr, 0.25),
                                  jgeo.intr_scale_unit(intr, 0.25))
    fov = tgeo.fov_from_intrinsics(intr, 80, 64)
    assert fov == jgeo.fov_from_intrinsics(intr, 80, 64)
    np.testing.assert_array_equal(tgeo.unit_ray_array_2d(20, 16, *fov),
                                  jgeo.unit_ray_array_2d(20, 16, *fov))


def test_depth_to_pts():
    rs = np.random.RandomState(4)
    dm = rs.uniform(3.0, 30.0, (H, W)).astype(np.float32)
    intr = np.array([[20.0, 0, 8.3], [0, 21.0, 6.1], [0, 0, 1]], np.float32)
    want = np.asarray(jgeo.depth_to_pts(jnp.asarray(dm), jnp.asarray(intr)))
    got = tgeo.depth_to_pts(_t(dm), _t(intr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(12, 16), (1, 1), (5, 7)])
@pytest.mark.parametrize("in_hw", [(3, 4), (1, 1)])
def test_resize_bilinear_align_corners(in_hw, out_hw):
    x = np.random.RandomState(5).randn(2, 3, *in_hw).astype(np.float32)
    want = np.asarray(jrs.resize_bilinear_align_corners(jnp.asarray(x),
                                                        out_hw))
    got = trs.resize_bilinear_align_corners(_t(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shift", [-3, 0, 2])
def test_shift_rows(shift):
    x = np.random.RandomState(6).randn(D, H, W).astype(np.float32)
    want = np.asarray(jrs.shift_rows(jnp.asarray(x), shift))
    np.testing.assert_array_equal(trs.shift_rows(_t(x), shift).numpy(), want)


def test_bilinear_sample_many():
    """The 4-tap gather (fast_take) with zero padding, out-of-image and
    exactly-on-grid samples included."""
    rs = np.random.RandomState(7)
    img = rs.randn(2, 5, H, W).astype(np.float32)
    pix = rs.uniform(-2.5, W + 1.5, (2, 40, 2)).astype(np.float32)
    pix[:, :5] = np.floor(pix[:, :5])
    want = np.stack([np.asarray(jps.bilinear_sample_many(
        jnp.asarray(img[i]), jnp.asarray(pix[i]))) for i in range(2)])
    got = tps.bilinear_sample_many(_t(img), _t(pix)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _poses(seed, n):
    rs = np.random.RandomState(seed)
    rots, tras = [], []
    for _ in range(n):
        a = rs.randn(3) * 0.02
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        r = np.eye(3) + k + k @ k / 2.0                 # near-rotation
        rots.append(np.linalg.qr(r)[0] * np.sign(np.diag(np.linalg.qr(r)[1])))
        tras.append(np.array([-0.3, 0.02, 0.05]) * rs.uniform(0.5, 1.5))
    return np.asarray(rots, np.float32), np.asarray(tras, np.float32)


def test_homography_resample_and_band_mats():
    """Stage 1 (K R K^-1 resample, closed-form K^-1) and the per-depth
    band matrices, including a plane behind the camera (the 1e12
    sentinel), against the JAX functions view by view."""
    rs = np.random.RandomState(8)
    n = 3
    feat = rs.randn(n, 6, H, W).astype(np.float32)
    rots, tras = _poses(9, n)
    tras[2] = [0.0, 0.0, -6.0]                    # m2 = -d at d = 6
    intr = np.tile(np.array([[11.0, 0, 8.4], [0, 11.5, 5.7], [0, 0, 1]],
                            np.float32), (n, 1, 1))
    d_candi = np.linspace(3.0, 30.0, D).astype(np.float32)
    d_candi[3] = 6.0
    got = tps.homography_resample(_t(feat), _t(rots), _t(intr)).numpy()
    rx_t, ry_t = tps.sweep_mats(_t(d_candi), _t(rots), _t(tras), _t(intr),
                                H, W)
    for i in range(n):
        want = np.asarray(jps._homography_resample(
            jnp.asarray(feat[i]), jnp.asarray(rots[i]), jnp.asarray(intr[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        rx, ry = jps._sweep_mats(jnp.asarray(d_candi), jnp.asarray(rots[i]),
                                 jnp.asarray(tras[i]), jnp.asarray(intr[i]),
                                 H, W)
        np.testing.assert_allclose(rx_t[i].numpy(), np.asarray(rx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ry_t[i].numpy(), np.asarray(ry),
                                   rtol=1e-5, atol=1e-5)


def test_identity_rotation_stage1_is_exact():
    """CLAUDE.md's contract: at R = I stage 1 reproduces the input."""
    feat = np.random.RandomState(10).randn(2, 4, H, W).astype(np.float32)
    intr = np.tile(np.array([[11.0, 0, 8.0], [0, 11.0, 6.0], [0, 0, 1]],
                            np.float32), (2, 1, 1))
    rot = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    got = tps.homography_resample(_t(feat), _t(rot), _t(intr)).numpy()
    np.testing.assert_allclose(got, feat, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pshift,quash", [(0, True), (3, False)])
def test_gen_ufield(pshift, quash):
    x = _log_dpv(11, (D, H, W))
    d = np.asarray(jdpv.powerf(3.0, 30.0, D, 1.0), np.float32)
    intr = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]], np.float32)
    p_j = juf.UFieldParams(pshift=pshift, zstart=-1.0, zend=2.0, maxd=100.0,
                           mind=3.0, quash=quash)
    p_t = tuf.UFieldParams(**vars(p_j))
    uf_j, dm_j = juf.gen_ufield(jnp.asarray(x), jnp.asarray(d),
                                jnp.asarray(intr), p_j, log=True)
    uf_t, dm_t = tuf.gen_ufield(_t(x), _t(d), _t(intr), p_t, log=True)
    np.testing.assert_allclose(uf_t.numpy(), np.asarray(uf_j), rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(dm_t.numpy(), np.asarray(dm_j), rtol=1e-5,
                               atol=1e-5)


def test_ufield_params_from_sensor():
    assert vars(tuf.UFieldParams.from_sensor(0.8, 0.3, 2)) == vars(
        juf.UFieldParams.from_sensor(0.8, 0.3, 2))
