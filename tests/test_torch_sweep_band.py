"""The stage-2 kernels' decomposition (ops/sweep_band.py: band taps, row
strips with their hulls, depth and channel groups, sums in the kernels'
order) against the plain versions (ops/sweep_kernel.py) and against the
JAX package's Pallas ``sweep_stage2`` in interpret mode, forward and
through ``jax.vjp``.

Inputs come from numpy with a seed: the band matrices of the port's
``sweep_mats`` for a sideways camera step, a forward step (tz != 0, so Ry
has two taps a row and Ry^T up to three) and a step that moves planes out
of the image (all-zero rows and columns); the random two-tap bands of
tests/test_torch_sweep.py; dense matrices (the separable path); a
one-tap Ry that is no identity (rows shifted by one: the sideways path's
taps, whose rows of dw lie outside the strip).

Tolerances: one kernel call each, so tests/TOLERANCES.md rule 3 (cost and
diag 1% of max|plain|, the gradients 3%) where the short sums may round
in another order than the dense products; on the sideways step every sum
of the taps is one exact product or one rounding, so the model matches
the plain version to f32 reassociation of the channel sum (rtol 1e-5).
The random two-tap rows have wide columns, so their backward takes the
separable path, as the kernel's does, and their rows jump, so some
forward blocks' hulls outgrow the ring and take it too. A taller shape
mixes the paths in one call: one item's small step on the band path, the
other's large vertical step past the buffers on the separable one.

At the flagship's 64x96, D=64 (5 m to 40 m) ``block_paths`` places each
camera step's blocks without computing them: forward steps of -2 m to
2.5 m, a vertical step of 1 m and a turn stay on the band path, larger
steps send some blocks to the separable one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops.sweep_pallas import sweep_stage2 as jax_stage2
from depthestimation_tpu_torch.ops import sweep_band as sb
from depthestimation_tpu_torch.ops.plane_sweep import sweep_mats
from depthestimation_tpu_torch.ops.sweep_kernel import (
    sweep_stage2_bwd_plain, sweep_stage2_plain)

C1, D, H, W = 6, 8, 13, 16
BF = torch.bfloat16
STEPS = {"sideways": (-0.2, 0.0, 0.0), "forward": (-0.1, 0.02, 0.3),
         "outside": (-3.0, 0.0, 0.0)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers and JAX's own share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mats(kind, n, rs):
    """(rxt [n, D, W, W], ry [n, D, H, H]) as float32 numpy."""
    if kind in STEPS:
        tra = torch.tensor([STEPS[kind]] * n, dtype=torch.float32)
        tra[:, 0] *= torch.from_numpy(1.0 + 0.1 * rs.rand(n).astype(
            np.float32))
        intr = torch.tensor([[0.58 * W, 0, 0.5 * W + 0.3],
                             [0, 0.58 * W, 0.5 * H - 0.2], [0, 0, 1]]
                            ).repeat(n, 1, 1)
        rot = torch.eye(3).repeat(n, 1, 1)
        d_candi = torch.linspace(3.0, 30.0, D)
        rx, ry = sweep_mats(d_candi, rot, tra, intr, H, W)
        return rx.transpose(-1, -2).numpy(), ry.numpy()
    if kind == "dense":
        return ((rs.rand(n, D, W, W) * 0.2).astype(np.float32),
                (rs.rand(n, D, H, H) * 0.2).astype(np.float32))
    if kind == "shifted":   # a sideways step's Rx^T, Ry one row down
        rxt, _ = _mats("sideways", n, rs)
        ry = np.broadcast_to(np.eye(H, k=-1, dtype=np.float32),
                             (n, D, H, H)).copy()
        return rxt, ry

    def band(size):     # two-tap rows (tests/test_torch_sweep.py)
        m = np.zeros((n, D, size, size), np.float32)
        for i in range(size):
            j = rs.randint(0, size - 1, (n, D))
            f = rs.rand(n, D).astype(np.float32)
            np.put_along_axis(m[:, :, i], j[..., None], (1 - f)[..., None], -1)
            np.put_along_axis(m[:, :, i], j[..., None] + 1, f[..., None], -1)
        return m
    return band(W).transpose(0, 1, 3, 2).copy(), band(H)


def _inputs(kind, v, seed):
    """bf16 (fa, ref, fr, rxt, ry) and f32 (gcost, gdiag), B = 2."""
    rs = np.random.RandomState(seed)
    n = 2 * v
    rxt, ry = _mats(kind, n, rs)
    arrs = (rs.randn(n, C1, H, W), rs.randn(n // v, C1, H, W),
            rs.randn(n, D, H, W), rxt, ry)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(BF) for a in arrs]
    cts = [torch.from_numpy(rs.randn(n, D, H, W).astype(np.float32))
           for _ in range(2)]
    return args, cts


CASES = [("sideways", 1), ("forward", 2), ("band2", 3), ("outside", 1),
         ("dense", 2), ("shifted", 2)]


@pytest.mark.parametrize("kind", ["sideways", "forward", "band2", "outside",
                                  "dense", "shifted"])
def test_band_taps_rebuild_the_matrices(kind):
    """Where an extent holds at most TAPS entries its taps rebuild the
    matrix exactly, and every nonzero lies inside its extent."""
    args, _ = _inputs(kind, 1, 7)
    rxt, ry = args[3].float(), args[4].float()
    taps = sb.band_taps(args[3], args[4])
    for name, m in (("colx", rxt.transpose(-1, -2)), ("roww", rxt),
                    ("rowy", ry), ("colh", ry.transpose(-1, -2))):
        lo, n, w = taps[name]
        idx = torch.arange(m.shape[-1])
        inside = (idx >= lo[..., None]) & (idx < (lo + n)[..., None])
        assert not (m != 0)[~inside].any(), name
        short = n <= sb.TAPS
        rebuilt = torch.zeros_like(m)
        for k in range(sb.TAPS):
            at = (idx == (lo + k)[..., None]) & (k < n)[..., None]
            rebuilt = rebuilt + torch.where(at, w[..., k, None],
                                            torch.zeros_like(m))
        assert torch.equal(rebuilt[short], m[short]), name
    if kind == "forward":
        # Ry has two taps a row and Ry^T up to three: the case the
        # sideways step (Ry = I) does not reach
        assert int(taps["rowy"][1].max()) == 2
        assert 2 <= int(taps["colh"][1].max()) <= 3
    if kind == "outside":
        assert int((taps["colx"][1] == 0).sum()) > 0
    # random two-tap rows scatter the columns: their transposes are wider
    # than a bilinear band's
    assert bool(sb.bilinear_fwd(taps).all()) == (kind != "dense")
    assert (bool(sb.bilinear_bwd(taps).all())
            == (kind not in ("dense", "band2")))


@pytest.mark.parametrize("kind,v", CASES)
@pytest.mark.parametrize("group", [4, 3])
def test_forward_model_matches_plain(kind, v, group):
    args, _ = _inputs(kind, v, 11 + v)
    cost, diag, paths = sb.stage2_fwd(*args, v, group=group)
    cost_p, diag_p = sweep_stage2_plain(*args, v)
    if kind == "dense":
        assert paths["band"] == 0
    elif kind in STEPS:     # camera steps: every block on the band path
        assert paths["separable"] == 0, paths
    if kind == "sideways":
        torch.testing.assert_close(cost, cost_p, rtol=1e-5,
                                   atol=1e-5 * cost_p.abs().max().item())
        torch.testing.assert_close(diag, diag_p, rtol=1e-6, atol=1e-6)
    for got, want in ((cost, cost_p), (diag, diag_p)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-2 * want.abs().max().item())


@pytest.mark.parametrize("kind,v", CASES)
@pytest.mark.parametrize("cgroup", [2, 4])
def test_backward_model_matches_plain(kind, v, cgroup):
    args, cts = _inputs(kind, v, 21 + v)
    *got, paths = sb.stage2_bwd(*args, *cts, v, cgroup=cgroup)
    want = sweep_stage2_bwd_plain(*args, *cts, v)
    if kind in ("dense", "band2"):      # wide Ry^T or Rx rows
        assert paths["band"] == 0
    else:
        assert paths["separable"] == 0, paths
    for g, p, name in zip(got, want, ("dfa", "dref", "dfr")):
        assert g.shape == p.shape, name
        tight = 1e-5 if kind == "sideways" else 3e-2
        torch.testing.assert_close(g, p, rtol=0,
                                   atol=tight * p.abs().max().item(),
                                   msg=name)


def _jax(args, cts, v):
    """JAX's interpret-mode forward and its custom VJP on the same bf16
    inputs: (cost, diag), (dfa, dref, dfr) as f32 numpy."""
    xs = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args]
    out, vjp = jax.vjp(lambda fa, ref, fr: jax_stage2(fa, ref, fr, xs[3],
                                                      xs[4], v, True),
                       *xs[:3])
    grads = vjp(tuple(jnp.asarray(c.numpy()) for c in cts))
    return ([np.asarray(o, np.float32) for o in out],
            [np.asarray(g, np.float32) for g in grads])


@pytest.mark.parametrize("kind,v", [("forward", 2), ("outside", 1),
                                    ("band2", 3)])
def test_model_matches_pallas_interpret(kind, v):
    args, cts = _inputs(kind, v, 31 + v)
    fwd_j, bwd_j = _jax(args, cts, v)
    cost, diag, _ = sb.stage2_fwd(*args, v)
    *grads, _ = sb.stage2_bwd(*args, *cts, v)
    for got, want in zip((cost, diag), fwd_j):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
    # JAX returns the gradients in the inputs' dtype (bf16): compare at
    # rule 3's 3% of max, which covers that rounding
    for got, want, name in zip(grads, bwd_j, ("dfa", "dref", "dfr")):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=3e-2 * np.abs(want).max(),
                                   err_msg=name)


def _step_mats(n, h, w, d, tra, yaw=0.0, near=5.0, far=40.0):
    """sweep_mats' bf16 (rxt, ry) for one camera step (tra [3], a turn of
    ``yaw`` radians) of every view, planes from ``near`` to ``far``."""
    c, s_ = np.cos(yaw), np.sin(yaw)
    rot = torch.tensor([[c, 0, s_], [0, 1, 0], [-s_, 0, c]],
                       dtype=torch.float32).repeat(n, 1, 1)
    intr = torch.tensor([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                         [0, 0, 1]]).repeat(n, 1, 1)
    rx, ry = sweep_mats(torch.linspace(near, far, d), rot,
                        torch.tensor([tra] * n, dtype=torch.float32), intr,
                        h, w)
    return rx.transpose(-1, -2).contiguous().to(BF), ry.contiguous().to(BF)


# (sideways, vertical, forward) metres, turn in degrees; the backward's
# separable blocks expected (> 0 or == 0) at 64x96, D=64
FLAGSHIP_STEPS = [((-0.2, 0.0, 1.0), 0.0, False), ((0.0, 0.0, 1.5), 0.0, False),
                  ((0.0, 0.0, 2.0), 0.0, False), ((0.0, 0.0, -2.0), 0.0, False),
                  ((0.0, 0.0, 2.5), 0.0, False), ((0.1, 0.0, 1.5), 5.0, False),
                  ((0.0, 1.0, 0.0), 0.0, False), ((0.0, 0.0, -2.5), 0.0, True),
                  ((0.0, 2.0, 0.0), 0.0, True)]


@pytest.mark.parametrize("tra,yaw,past", FLAGSHIP_STEPS)
def test_flagship_steps_take_the_band_path(tra, yaw, past):
    """Which path the kernels' blocks take on the flagship's matrices: the
    forward steps of driving stay on the band path in both directions;
    the buffers' limit lies where the kernel's header says."""
    rxt, ry = _step_mats(1, 64, 96, 64, tra, np.deg2rad(yaw))
    paths = sb.block_paths(rxt, ry, 1)
    assert paths["fwd"]["band"] + paths["fwd"]["separable"] == 16 * 16
    assert paths["bwd"]["band"] + paths["bwd"]["separable"] == 16
    assert (paths["bwd"]["separable"] > 0) == past, paths
    if not past:
        assert paths["fwd"]["separable"] == 0, paths


@pytest.mark.parametrize("v", [1, 2])
def test_models_mix_paths_in_one_call(v):
    """One call whose blocks take both paths (32 rows, so the backward's
    hulls can outgrow its buffers): an item's sideways step on the band
    path, another's step 2 m up and 1 m back (rows leave the image:
    all-zero rows of Ry) partly on the separable one; both directions
    within rule 3 of the plain versions."""
    h, w, d, c1 = 32, 24, 6, 3
    rs = np.random.RandomState(41 + v)
    n = 2 * v
    mats = [_step_mats(v, h, w, d, tra, near=3.0, far=30.0)
            for tra in ((-0.2, 0.0, 0.0), (0.0, 2.0, -1.0))]
    rxt = torch.cat([m[0] for m in mats])
    ry = torch.cat([m[1] for m in mats])
    assert bool((ry.float().abs().sum(-1) == 0).any())
    arrs = (rs.randn(n, c1, h, w), rs.randn(n // v, c1, h, w),
            rs.randn(n, d, h, w))
    args = [torch.from_numpy(a.astype(np.float32)).to(BF) for a in arrs]
    args += [rxt, ry]
    cts = [torch.from_numpy(rs.randn(n, d, h, w).astype(np.float32))
           for _ in range(2)]
    cost, diag, fpaths = sb.stage2_fwd(*args, v)
    *grads, bpaths = sb.stage2_bwd(*args, *cts, v, cgroup=2)
    assert bpaths["band"] > 0 and bpaths["separable"] > 0, bpaths
    assert fpaths["band"] > 0 and fpaths["separable"] > 0, fpaths
    for got, want in zip((cost, diag), sweep_stage2_plain(*args, v)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-2 * want.abs().max().item())
    for got, want, name in zip(grads, sweep_stage2_bwd_plain(*args, *cts, v),
                               ("dfa", "dref", "dfr")):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=3e-2 * want.abs().max().item(),
                                   msg=name)
