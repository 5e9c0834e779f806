"""The decompositions that the flat conv3d op's and the correlation's
Hopper kernels compute, against the plain versions, and the two wrappers'
CUDA branch on ``meta`` tensors. No JAX.

- conv3d (``ops/conv_gemm.py``): the ring kernel's conv3d mode (B read
  from the op's weight by index, flipped for the data gradient; K in chunks
  of 16 or 32 input channels, output groups of 32; taps rounded to x's
  dtype, the f32 ring) against ``conv3d_flat_plain``: bf16 within one ulp
  of max|y| (the same bf16 products summed in f32 in another order), f32
  1e-5 of max|y|; the weight gradient as the three-tap GEMM over dy in
  groups of (32 output, 64 input) channels against ``conv3d_flat_dw_plain``,
  1e-5 of max|dW| (f32 sums in another order).
- correlation (``ops/correlation_kernel.py``): the forward's channel
  groups added in order, and the backward's gather of dx2 from the
  cotangent planes shifted by their displacements, against
  ``correlation_batched`` and ``correlation_bwd_plain``, 1e-5 of max|plain|.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from depthestimation_tpu_torch.ops import conv3d_kernel as c3
from depthestimation_tpu_torch.ops import conv_gemm as cg
from depthestimation_tpu_torch.ops import correlation as cr
from depthestimation_tpu_torch.ops import correlation_kernel as crk
from depthestimation_tpu_torch.ops import cuda_lib

BF = torch.bfloat16
# (N, depth, C, F, H, W): C = 5 (one chunk of 16), 20 and 40 (chunks of 32,
# the last cut), 64 (two whole chunks); F = 3, 8, 36 and 40 (two output
# groups); depth 1 (both edges on every row); odd widths
_C3 = [(6, 3, 5, 40, 7, 9), (4, 4, 20, 3, 5, 7), (2, 1, 8, 8, 5, 6),
       (4, 2, 40, 36, 4, 9), (4, 4, 64, 33, 3, 5)]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _ulp(t):
    top = t.float().abs().max().item()
    return 2.0 ** (torch.tensor(top).log2().floor().item() - 7)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n,depth,c,f,h,w", _C3)
def test_conv3d_ring_matches_plain(n, depth, c, f, h, w, flip, dtype):
    g = torch.Generator().manual_seed(n + c + f + h)
    wt = torch.randn(f, c, 3, 3, 3, generator=g) * 0.1
    x = torch.randn(n, f if flip else c, h, w, generator=g).to(dtype)
    got = cg.conv3d_fwd_gemm(x, wt, depth, flip)
    want = c3.conv3d_flat_plain(x, c3.flip_weight(wt) if flip else wt,
                                depth)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    bound = _ulp(want) if dtype == BF else 1e-5 * want.abs().max().item()
    assert err <= bound, (err, bound)


def test_conv3d_b_reads_the_ops_own_weight():
    """B[s*Cp + k][t*S + o] = W5[o0 + o, k0 + k, t, s]; flipped,
    W5[k0 + k, o0 + o, 2 - t, 8 - s]; zero past the channels."""
    wt = torch.arange(5 * 7 * 27, dtype=torch.float32).reshape(5, 7, 3, 3,
                                                               3) + 1
    b = cg.conv3d_fwd_weights(wt, 0, 16, 0, 8)
    assert b.shape == (144, 24)
    for t in range(3):
        for s in range(9):
            for o, k in ((0, 0), (4, 6), (2, 3)):
                assert b[s * 16 + k, t * 8 + o] == wt[o, k, t, s // 3, s % 3]
    assert b.count_nonzero() == wt.count_nonzero()
    bf = cg.conv3d_fwd_weights(wt, 0, 16, 0, 8, flip=True)
    for t in range(3):
        for s in range(9):
            for k, o in ((0, 0), (4, 6), (2, 3)):    # input k of 5, output o
                assert bf[s * 16 + k, t * 8 + o] == wt[k, o, 2 - t,
                                                        (8 - s) // 3,
                                                        (8 - s) % 3]
    assert [cg.conv3d_chunk(c) for c in (1, 16, 17, 64)] == [16, 16, 32, 32]


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("n,depth,c,f,h,w", _C3 + [(2, 2, 70, 5, 3, 4)])
def test_conv3d_dw_gemm_matches_plain(n, depth, c, f, h, w, dtype):
    g = torch.Generator().manual_seed(n * 7 + c + f)
    x = torch.randn(n, c, h, w, generator=g).to(dtype)
    dy = (torch.randn(n, f, h, w, generator=g) * 0.1).to(dtype)
    got = cg.conv3d_dw_gemm(x, dy, depth)
    want = c3.conv3d_flat_dw_plain(x, dy, depth)
    assert got.shape == want.shape == (f, c, 3, 3, 3)
    assert _rel(got, want) <= 1e-5


# PWCLite's five levels of a 384x832 pair at B=8, and odd ones
_LEVELS = [(8, 192, 6, 13), (8, 128, 12, 26), (8, 96, 24, 52),
           (8, 64, 48, 104), (8, 32, 96, 208)]


def test_channel_groups_fill_the_card_at_every_level():
    """At B=8 on 132 SMs: the forward splits C where the tiles give fewer
    blocks than SMs, in multiples of 8; the backward takes 32 channels a
    block where that gives two waves of blocks, else 8."""
    fwd = [crk.fwd_channels(*lv, 132) for lv in _LEVELS]
    bwd = [crk.bwd_channels(*lv, 132) for lv in _LEVELS]
    assert fwd == [16, 16, 32, 64, 32] and bwd == [8, 8, 8, 32, 32]
    for (b, c, h, w), cf, cb in zip(_LEVELS, fwd, bwd):
        tiles = b * -(-h // 8) * -(-w // 32)
        assert cf % 8 == 0
        assert tiles * -(-c // cb) >= 132
    assert crk.fwd_channels(1, 5, 3, 5, 132) == 8
    assert crk.bwd_channels(8, 32, 96, 208, 132, md=1) == 8


@pytest.mark.parametrize("b,c,h,w,md,group", [
    (2, 20, 7, 11, 4, 8), (1, 8, 5, 6, 2, 8), (2, 17, 9, 13, 1, 16),
    (1, 192, 6, 13, 4, 8), (2, 40, 5, 9, 3, 32)])
def test_correlation_groups_add_in_order(b, c, h, w, md, group):
    g = torch.Generator().manual_seed(b + c + md)
    x1 = torch.randn(b, c, h, w, generator=g)
    x2 = torch.randn(b, c, h, w, generator=g)
    assert _rel(crk.correlation_groups(x1, x2, md, group),
                cr.correlation_batched(x1, x2, md)) <= 1e-5


@pytest.mark.parametrize("b,c,h,w,md", [
    (2, 20, 7, 11, 4), (1, 8, 5, 6, 2), (2, 17, 9, 13, 1), (1, 5, 3, 5, 3),
    (1, 16, 12, 40, 4)])
def test_correlation_bwd_gather_matches_plain(b, c, h, w, md):
    g = torch.Generator().manual_seed(b * 3 + c + md)
    x1 = torch.randn(b, c, h, w, generator=g)
    x2 = torch.randn(b, c, h, w, generator=g)
    gg = torch.randn(b, (2 * md + 1) ** 2, h, w, generator=g)
    for got, want in zip(crk.correlation_bwd_gather(x1, x2, gg, md),
                         cr.correlation_bwd_plain(x1, x2, gg, md)):
        assert _rel(got, want) <= 1e-5


class _Ops(TorchDispatchMode):
    """The PyTorch operators a call runs."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


class _Recorder:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


# allocations and views: no operator that computes
_NO_KERNEL = {"aten.empty", "aten.empty_like", "aten.view", "aten.permute",
              "aten.transpose"}


@pytest.fixture
def meta_lib(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "library", lambda: rec)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda device: 132)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    for fn, attr in ((c3.conv3d_flat, "launches"),
                     (c3.conv3d_flat, "dw_launches"),
                     (crk.correlate, "launches"),
                     (crk.correlate, "bwd_launches")):
        monkeypatch.setattr(fn, attr, 0)        # restored after the test
    return rec


def _signature_ok(rec, name):
    launches = [args for got, args in rec.calls if got == name]
    assert len(launches) == 1, rec.calls
    assert len(launches[0]) == len(cuda_lib._SIGNATURES[name])
    return launches[0]


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("flip", [False, True])
def test_conv3d_wrappers_pass_the_ops_own_weight(meta_lib, flip, dtype):
    """The forward (and, flipped, the data gradient) hands the kernel the
    weight as it is, no repack, cast or flipped copy: y is the call's one
    allocation. The weight gradient allocates dw and its scratch and
    returns a view."""
    meta = torch.device("meta")
    wt = torch.empty(40, 36, 3, 3, 3, device=meta, dtype=dtype)
    x = torch.empty(16, 40 if flip else 36, 12, 20, device=meta, dtype=dtype)
    with _Ops() as ops:
        y = c3.conv3d_flat_fwd(x, wt, 8, flip=flip)
    assert y.shape == (16, 36 if flip else 40, 12, 20) and y.dtype == dtype
    assert set(ops.names) <= _NO_KERNEL and ops.names.count("aten.empty") == 1
    args = _signature_ok(meta_lib, "conv3d_flat_fwd")
    assert args[-2] == int(flip) and args[-3] == int(dtype == torch.float32)
    assert c3.conv3d_flat.launches == 1
    dy = torch.empty(16, 40, 12, 20, device=meta, dtype=dtype)
    x = torch.empty(16, 36, 12, 20, device=meta, dtype=dtype)
    with _Ops() as ops:
        dw = c3.conv3d_flat_dw(x, dy, 8)
    assert dw.shape == (40, 36, 3, 3, 3) and dw.dtype == torch.float32
    assert set(ops.names) <= _NO_KERNEL, ops.names
    need = c3.dw_scratch(16, 36, 40, 12, 20, dtype, 132)
    assert ops.names.count("aten.empty") == (3 if need["u"] else 2)
    _signature_ok(meta_lib, "conv3d_flat_dw")
    assert c3.conv3d_flat.dw_launches == 1


def test_conv3d_f32_forward_casts_only_a_bf16_weight(meta_lib):
    """The f32 kernel reads an f32 weight: a bf16 weight is the one case
    that costs a cast."""
    meta = torch.device("meta")
    x = torch.empty(8, 4, 5, 6, device=meta)
    with _Ops() as ops:
        c3.conv3d_flat_fwd(x, torch.empty(3, 4, 3, 3, 3, device=meta,
                                          dtype=BF), 4)
    assert "aten._to_copy" in ops.names


@pytest.mark.parametrize("level", [0, 4])
def test_correlation_wrappers_allocate_and_launch_only(meta_lib, level):
    """The forward allocates the output (and its partial sums where the
    channels split: the coarse level), the backward dx1 and dx2, and each
    launches its kernel once with the channels a block takes."""
    b, c, h, w = _LEVELS[level]
    meta = torch.device("meta")
    x1 = torch.empty(b, c, h, w, device=meta)
    with _Ops() as ops:
        out = crk.correlate_fwd(x1, x1, 4)
    assert out.shape == (b, 81, h, w)
    assert set(ops.names) <= _NO_KERNEL
    cf = crk.fwd_channels(b, c, h, w, 132)
    assert ops.names.count("aten.empty") == (1 if cf >= c else 2)
    args = _signature_ok(meta_lib, "correlation_fwd")
    assert args[-2] == cf and (args[3] is None) == (cf >= c)
    g = torch.empty(b, 81, h, w, device=meta)
    with _Ops() as ops:
        dx1, dx2 = crk.correlate_bwd(x1, x1, g, 4)
    assert dx1.shape == dx2.shape == x1.shape
    assert set(ops.names) <= _NO_KERNEL
    args = _signature_ok(meta_lib, "correlation_bwd")
    assert args[-2] == crk.bwd_channels(b, c, h, w, 132)
    assert (crk.correlate.launches, crk.correlate.bwd_launches) == (1, 1)
