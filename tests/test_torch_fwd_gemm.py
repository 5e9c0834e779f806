"""The GEMM that the forward kernels of the fused conv blocks compute
(``ops/conv_gemm.py``: M = pixels, K = ``s*Cp + c``, B read from the
module's weight layout, padded as the kernels pad; Base3D's taps stacked
on N with their depth ring and its rounding points) against the plain
forward versions, at small shapes with C = 5, F = 1, ragged and odd
widths, depth 1 and 2 and every activation; and the forward wrappers'
CUDA branch, which must pass the module's own weight tensor to the kernel
and run no PyTorch kernel of its own. No JAX.

Bounds: y within one bf16 ulp of max|y| (the two sum the same bf16
products in f32 in another order, so a value may round the other way);
the stats, f32 sums of y, rtol 1e-5 plus the sum of the y differences."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from depthestimation_tpu_torch.ops import conv_gemm as cg
from depthestimation_tpu_torch.ops import convbn2d_kernel as c2
from depthestimation_tpu_torch.ops import convcomb_kernel as ck
from depthestimation_tpu_torch.ops import cuda_lib

BF = torch.bfloat16


def _close(got, want, what):
    (y, st), (y_p, st_p) = got, want
    assert y.dtype == y_p.dtype == BF and y.shape == y_p.shape, what
    top = y_p.float().abs().max().item()
    ulp = 2.0 ** (torch.tensor(top).log2().floor().item() - 7)
    d = (y.float() - y_p.float()).abs()
    assert d.max().item() <= ulp, (what, d.max().item(), ulp)
    yf = y_p.float().reshape(y.shape[0], y.shape[1], -1)
    dd = d.reshape(yf.shape)
    slack = torch.stack([dd.sum(dim=(0, 2)),
                         (dd * (2 * yf.abs() + dd)).sum(dim=(0, 2))], -1)
    assert torch.all((st - st_p).abs() <= 1e-5 * st_p.abs() + slack
                     + 1e-6), (what, st, st_p)


def _inputs(seed, shape_x, shape_w):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape_x, generator=g).to(BF)
    w = (torch.randn(shape_w, generator=g) * 0.3).to(BF)
    c = shape_x[1]
    a = torch.rand(c, generator=g) * 0.5 + 0.75
    b = torch.randn(c, generator=g) * 0.1
    return x, w, a, b


@pytest.mark.parametrize("act", c2.ACTS)
@pytest.mark.parametrize("n,c,f,h,w", [
    (2, 5, 7, 6, 19), (1, 16, 1, 5, 16), (2, 3, 17, 4, 9),
    (1, 20, 33, 3, 21), (1, 67, 64, 4, 11)])
def test_convbn2d_fwd_gemm_matches_plain(n, c, f, h, w, act):
    x, wt, a, b = _inputs(n * 100 + c + f, (n, c, h, w), (f, c, 3, 3))
    _close(cg.convbn2d_fwd_gemm(x, wt, a, b, act),
           c2.convbn2d_block_plain(x, wt, a, b, act), (n, c, f, h, w, act))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("items,depth,c,f,h,w", [
    (2, 3, 5, 4, 5, 17), (1, 4, 16, 1, 4, 9), (2, 2, 6, 11, 3, 20),
    (3, 1, 5, 1, 2, 7), (1, 2, 32, 32, 3, 16), (2, 2, 32, 20, 2, 13)])
def test_convcomb_fwd_gemm_matches_plain(items, depth, c, f, h, w, relu):
    n = items * depth
    x, wm, a, b = _inputs(n + c + f, (n, c, h * w), (3 * f, c, 3, 3))
    _close(cg.convcomb_fwd_gemm(x, wm, a, b, depth, h, w, relu),
           ck.convbn_block_plain(x, wm, a, b, depth, h, w, relu),
           (items, depth, c, f, h, w, relu))


def test_forward_layouts_read_the_modules_own():
    """B[s*Cp + c, f] = W[f, c, s] with zero padding; Base3D's taps at
    column t*S + f with S = 8, 16 or 32."""
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3) + 1
    bm = cg.fwd_weights(w, 16, 16)
    assert bm.shape == (144, 16)
    for s in range(9):
        for c in range(3):
            assert torch.equal(bm[s * 16 + c, :2], w[:, c, s // 3, s % 3])
    assert bm.count_nonzero() == w.count_nonzero()
    assert [cg.tap_stride(f) for f in (1, 8, 9, 16, 17, 32)] == [
        8, 8, 16, 16, 32, 32]
    wm = torch.randn(3 * 5, 4, 3, 3)
    st = cg.convcomb_fwd_weights(wm, 16)
    assert st.shape == (144, 24)
    for t in range(3):
        for f in range(5):
            for c, s in ((0, 0), (3, 8), (2, 4)):
                assert st[s * 16 + c, t * 8 + f] == wm[t * 5 + f, c,
                                                       s // 3, s % 3]
    assert st.count_nonzero() == wm.count_nonzero()


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


@pytest.mark.parametrize("layer", ["convbn2d", "convcomb"])
def test_forward_wrappers_pass_the_modules_own_weight(layer, monkeypatch):
    """The CUDA branch of each forward wrapper, on tensors of the ``meta``
    device (no data, so the branch runs here): it allocates y, the stats
    and the partial sums and nothing else (no packed weight: no zeros, no
    copy, no indexing), hands the C entry point as many arguments as its
    ctypes signature has, and counts one launch."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "library", lambda: rec)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda device: 132)
    ck._fwd_slots.cache_clear()
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    meta = torch.device("meta")
    if layer == "convbn2d":
        x = torch.empty(2, 32, 16, 24, device=meta, dtype=BF)
        w = torch.empty(32, 32, 3, 3, device=meta, dtype=BF)
        ab = torch.empty(32, device=meta)
        fn, name, counter = (lambda: c2.convbn2d_block(x, w, ab, ab, "relu"),
                             "convbn2d_fwd", c2.convbn2d_block)
        want_shape = (2, 32, 16, 24)
    else:
        x = torch.empty(16, 32, 12 * 16, device=meta, dtype=BF)
        w = torch.empty(96, 32, 3, 3, device=meta, dtype=BF)
        ab = torch.empty(32, device=meta)
        fn, name, counter = (lambda: ck.convbn_block(x, w, ab, ab, 8, 12, 16,
                                                     True),
                             "convcomb_fwd", ck.convbn_block)
        want_shape = (16, 32, 12 * 16)
    monkeypatch.setattr(counter, "launches", 0)   # restored after the test
    with _Ops() as ops:
        y, st = fn()
    assert y.shape == want_shape and st.shape == (32, 2)
    assert counter.launches == 1
    assert sorted(ops.names) == ["aten.empty"] * 3, ops.names
    launches = [(got, args) for got, args in rec.calls if got == name]
    assert len(launches) == 1, rec.calls
    assert all(len(args) == len(cuda_lib._SIGNATURES[got])
               for got, args in rec.calls)
