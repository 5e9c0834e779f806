"""The port's fused Base3D block (ops/convcomb_kernel.py) and Base3D stack
(models/base3d.py) against the JAX package.

- ``convbn_block`` on a CPU tensor (its plain version) vs the Pallas kernel
  in interpret mode, at tests/test_convcomb_pallas.py's sizes and bounds
  (one block call: tests/TOLERANCES.md rule 3);
- the f32 plain flat stack vs JAX's flat XLA stack, same parameters
  through the weight bridge (f32 round-off);
- the bf16 fused stack vs JAX's fused interpret stack, both measured
  against the f32 oracle (rule 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.models.base3d import Base3D as JBase3D
from depthestimation_tpu.ops.convcomb_pallas import (convbn_block as jblock,
                                                     pack_wm as jpack,
                                                     to_transposed)
from depthestimation_tpu_torch.models.base3d import Base3D
from depthestimation_tpu_torch.ops import convcomb_kernel as ck
from depthestimation_tpu_torch.weights import load_jax_params

B, D, H, W = 2, 8, 8, 16
N, HW = B * D, H * W


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _block_data(seed, c, f):
    rs = np.random.RandomState(seed)
    x4 = rs.randn(N, H, W, c).astype(np.float32)
    k3 = (rs.randn(3, 3, 3, c, f) * 0.2).astype(np.float32)
    a = (rs.rand(c) * 0.5 + 0.75).astype(np.float32)
    b = (rs.randn(c) * 0.1).astype(np.float32)
    # bf16-representable inputs, so both sides start from the same values
    x4 = np.asarray(jnp.asarray(x4, jnp.bfloat16), np.float32)
    k3 = np.asarray(jnp.asarray(k3, jnp.bfloat16), np.float32)
    return x4, k3, a, b


def _jax_block(x4, k3, a, b, relu):
    """JAX convbn_block, channels zero-padded to 8 as layers.Conv3d._fused
    does around the kernel."""
    c, f = k3.shape[-2:]
    cp, fp = (-c) % 8, (-f) % 8
    x4p = np.pad(x4, ((0, 0),) * 3 + ((0, cp),))
    k3p = np.pad(k3, ((0, 0),) * 3 + ((0, cp), (0, fp)))
    ap = np.concatenate([a, np.ones(cp, np.float32)])
    bp = np.concatenate([b, np.zeros(cp, np.float32)])
    y, st = jblock(to_transposed(jnp.asarray(x4p, jnp.bfloat16)),
                   jpack(jnp.asarray(k3p)).astype(jnp.bfloat16),
                   jnp.asarray(ap), jnp.asarray(bp), D, H, W, relu, True)
    return np.asarray(y[:, :f], np.float32), np.asarray(st[:f])


@pytest.mark.parametrize("c,f", [(8, 8), (5, 32), (32, 1)])
@pytest.mark.parametrize("relu", [False, True])
def test_convbn_block_matches_pallas_interpret(c, f, relu):
    x4, k3, a, b = _block_data(c + f, c, f)
    y_j, st_j = _jax_block(x4, k3, a, b, relu)
    x = _t(x4).permute(0, 3, 1, 2).reshape(N, c, HW).to(torch.bfloat16)
    wm = ck.pack_wm(_t(k3).permute(4, 3, 0, 1, 2)).to(torch.bfloat16)
    before = ck.convbn_block.launches
    y, st = ck.convbn_block(x, wm, _t(a), _t(b), D, H, W, relu)
    assert ck.convbn_block.launches == before        # CPU: plain version
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    scale = np.abs(y_j).max() + 1e-6
    np.testing.assert_allclose(y.float().numpy(), y_j, atol=0.03 * scale)
    np.testing.assert_allclose(st.numpy(), st_j, rtol=3e-2,
                               atol=1e-2 * N * HW)


def test_segment_rows_fill_the_card():
    """The forward's depth segments (``forward_segment``): long ones (fewer
    halo rebuilds, one weight build per block) while the waves of resident
    blocks stay full. At 384x256 (96 tiles) B=8 takes 64 rows where 2
    blocks fit an SM (C32->F32), 32 at 4 (C5->F32); B=1 takes 16 at 4 and
    8 at 2; a short item is one segment. These measured fastest, or within
    7% of it, on an H100."""
    tiles = ck.pixel_tiles(64, 96)
    assert tiles == 96
    assert ck.forward_segment(8, 64, tiles, 2 * 132) == 64
    assert ck.forward_segment(8, 64, tiles, 4 * 132) == 32
    assert ck.forward_segment(1, 64, tiles, 4 * 132) == 16
    assert ck.forward_segment(1, 64, tiles, 2 * 132) == 8
    assert ck.forward_segment(2, 3, 5, 4 * 132) >= 3


def test_depth_combine_edges():
    """A row's taps never cross an item's depth edge: rows D-1 and D of
    the flat volume belong to different items."""
    t = torch.zeros(N, 3, 1, 1)
    t[D - 1, 2] = 1.0          # item 0's last row, tap 2 (feeds row D-2)
    t[D, 0] = 5.0              # item 1's first row, tap 0 (feeds row D+1)
    y = ck.depth_combine(t, D)[:, 0, 0, 0]
    want = torch.zeros(N)
    want[D - 2] = 1.0
    want[D + 1] = 5.0
    torch.testing.assert_close(y, want)


def _jax_base3d(dtype, fused, bn_avg=False):
    return JBase3D(feature_dim=16, dres_count=2, bn_avg=bn_avg, dtype=dtype,
                   flat=True, convcomb_pallas="interpret" if fused else False)


def _port_base3d(variables, dtype, bn_avg=False):
    m = Base3D(5, D, feature_dim=16, dres_count=2, bn_avg=bn_avg,
               dtype=dtype).eval()
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, variables))
    return m


def _vol(seed):
    return np.random.RandomState(seed).randn(B, D, H, W, 5).astype(np.float32)


def _port_vol(vol):
    return _t(vol).permute(0, 4, 1, 2, 3)           # [B, C, D, H, W]


def test_base3d_f32_plain_stack_matches_jax():
    vol = _vol(3)
    jm = _jax_base3d(None, False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(vol), False, False)
    want = np.asarray(jm.apply(variables, jnp.asarray(vol), False, False))
    with torch.inference_mode():
        got = _port_base3d(variables, None)(_port_vol(vol)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("edge", [False, True])
def test_base3d_bf16_fused_rule4(edge):
    """bf16 fused stack (kernel plain versions) vs JAX's fused interpret
    stack, both against the f32 oracle: dist(port) <= 3 dist(jax) + floor.
    ``edge``: nonzero only in item 0's last depth slice, which must not
    leak into item 1 through the flat rows."""
    vol = _vol(4)
    if edge:
        vol = np.zeros_like(vol)
        vol[0, -1] = 1.0
    jo, jf = _jax_base3d(None, False), _jax_base3d(jnp.bfloat16, True)
    variables = jo.init(jax.random.PRNGKey(1), jnp.asarray(vol), False, False)
    oracle = np.asarray(jo.apply(variables, jnp.asarray(vol), False, False))
    y_jax = np.asarray(jf.apply(variables, jnp.asarray(vol), False, False))
    with torch.inference_mode():
        y_port = _port_base3d(variables, torch.bfloat16)(
            _port_vol(vol)).numpy()
    dist_j = np.linalg.norm(y_jax - oracle)
    dist_p = np.linalg.norm(y_port - oracle)
    floor = 4e-3 * np.linalg.norm(oracle)
    assert dist_p <= 3 * dist_j + floor, (dist_p, dist_j, floor)
    scale = np.abs(oracle).max()
    np.testing.assert_allclose(y_port, oracle, atol=0.05 * scale)


def test_base3d_running_stats_eval():
    """bn_avg=True: eval normalizes with the running statistics carried in
    the JAX ``batch_stats`` tree (bridged to running_mean / running_var)."""
    vol = _vol(5)
    jm = _jax_base3d(None, False, bn_avg=True)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(vol), False, False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rs = np.random.RandomState(6)
    stats = jax.tree_util.tree_map(
        lambda s: (rs.rand(*s.shape) * 0.5 + 0.5).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    want = np.asarray(jm.apply(variables, jnp.asarray(vol), False, False))
    for dtype, tol in ((None, 1e-5), (torch.bfloat16, 0.05)):
        with torch.inference_mode():
            got = _port_base3d(variables, dtype, bn_avg=True)(
                _port_vol(vol)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)
