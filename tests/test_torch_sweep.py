"""Plane sweep + diagonal warp of the port (ops/plane_sweep.py and the
stage-2 module ops/sweep_kernel.py) against the JAX package.

f32: the port's batched sweep (stage 2 on its plain version) against
``plane_sweep_and_warp_decomposed_batched(use_pallas=False)``, the JAX
plain reference, at rtol 1e-5 / atol 1e-4.
bf16: the stage-2 module on a CPU tensor (its plain version, with the
kernel's rounding points) against the Pallas kernel in interpret mode, one
kernel call each, so tests/TOLERANCES.md rule 3 applies: atol = 2% of
max|want|. The CUDA kernel itself is pinned to the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops.plane_sweep import \
    plane_sweep_and_warp_decomposed_batched
from depthestimation_tpu.ops.sweep_pallas import sweep_stage2 as jax_stage2
from depthestimation_tpu_torch.ops import sweep_kernel
from depthestimation_tpu_torch.ops.plane_sweep import \
    plane_sweep_and_warp_batched

B, C1, D, H, W = 2, 6, 8, 8, 12


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(seed, t, rotate):
    rs = np.random.RandomState(seed)
    fa = rs.randn(B, t, C1, H, W).astype(np.float32)
    fr = rs.randn(B, t, D, H, W).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, t, 1, 1))
    for b in range(B):
        for v in range(t - 1):
            poses[b, v, :3, 3] = [-0.2 * (t - 1 - v), 0.01 * b, 0.03]
            if rotate:
                a = 0.01 * (v + 1)
                poses[b, v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                       [-np.sin(a), 0, np.cos(a)]]
    intr = np.tile(np.array([[0.58 * W, 0, 0.5 * W + 0.3],
                             [0, 0.58 * W, 0.5 * H - 0.2], [0, 0, 1]],
                            np.float32), (B, 1, 1))
    d_candi = np.linspace(3.0, 30.0, D).astype(np.float32)
    return fa, fr, d_candi, poses, intr


@pytest.mark.parametrize("t,rotate", [(2, False), (2, True), (3, True)])
def test_sweep_f32_matches_jax_plain_reference(t, rotate):
    fa, fr, d_candi, poses, intr = _inputs(t + 10 * rotate, t, rotate)
    cost_j, warped_j = plane_sweep_and_warp_decomposed_batched(
        jnp.asarray(fa), jnp.asarray(fr), jnp.asarray(d_candi),
        jnp.asarray(poses), jnp.asarray(intr), 10.0, dtype=jnp.float32,
        use_pallas=False)
    cost_t, warped_t = plane_sweep_and_warp_batched(
        _t(fa), _t(fr), _t(d_candi), _t(poses), _t(intr), 10.0,
        dtype=torch.float32)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(warped_t.numpy(), np.asarray(warped_j),
                               rtol=1e-5, atol=1e-4)


def _stage2_inputs(seed, n, v):
    rs = np.random.RandomState(seed)
    fa = rs.randn(n, C1, H, W).astype(np.float32)
    ref = rs.randn(n // v, C1, H, W).astype(np.float32)
    fr = rs.randn(n, D, H, W).astype(np.float32)
    # band-like matrices: at most two nonzeros per row, rows sum <= 1
    def band(size):
        m = np.zeros((n, D, size, size), np.float32)
        for i in range(size):
            j = rs.randint(0, size - 1, (n, D))
            f = rs.rand(n, D).astype(np.float32)
            np.put_along_axis(m[:, :, i], j[..., None], (1 - f)[..., None], -1)
            np.put_along_axis(m[:, :, i], j[..., None] + 1, f[..., None], -1)
        return m
    return fa, ref, fr, band(W).transpose(0, 1, 3, 2).copy(), band(H)


@pytest.mark.parametrize("v", [1, 2])
def test_stage2_bf16_plain_matches_pallas_interpret(v):
    n = 2 * v
    args = _stage2_inputs(v, n, v)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args]
    cost_j, diag_j = jax_stage2(*bf, v, True)
    tb = [_t(a).to(torch.bfloat16) for a in args]
    before = sweep_kernel.sweep_stage2.launches
    cost_t, diag_t = sweep_kernel.sweep_stage2(*tb, v)      # CPU: plain
    assert sweep_kernel.sweep_stage2.launches == before
    for got, want in ((cost_t, cost_j), (diag_t, diag_j)):
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=0.02 * np.abs(want).max())


def test_stage2_plain_f32_is_the_einsum_form():
    """In f32 the plain version rounds nowhere: it equals the direct
    per-view einsum of plane_sweep_and_warp_decomposed."""
    args = [_t(a) for a in _stage2_inputs(3, 2, 1)]
    fa, ref, fr, rxt, ry = args
    cost, diag = sweep_kernel.sweep_stage2_plain(fa, ref, fr, rxt, ry, 1)
    warped = torch.einsum("ndyh,nchw,ndwx->ndcyx", ry, fa, rxt)
    want = ((warped - ref[:, None]) ** 2).sum(2)
    torch.testing.assert_close(cost, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(
        diag, torch.einsum("ndyh,ndhw,ndwx->ndyx", ry, fr, rxt),
        rtol=1e-5, atol=1e-5)
