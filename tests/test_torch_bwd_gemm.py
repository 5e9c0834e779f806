"""The GEMMs that the backward kernels of the fused conv blocks compute
(``ops/conv_gemm.py``: the data gradient on the flipped [9 Fp, Cp] or
stacked [27 Fp, Cp] weights read from the module's layout, the weight
gradient with M = 9 Cp and N = F or 3F, the depth taps with their edge
masks, the second pass's write into the weight's layout) against the
plain backward versions, in f32, at small shapes with C = 5, F = 1 and a
ragged width. No JAX. Bound: 1e-5 of max|plain| per output (f32 sums in
another order)."""

import numpy as np
import pytest
import torch

from depthestimation_tpu_torch.ops import conv_gemm as cg
from depthestimation_tpu_torch.ops.convbn2d_kernel import \
    convbn2d_block_bwd_plain
from depthestimation_tpu_torch.ops.convcomb_kernel import \
    convbn_block_bwd_plain


def _close(got, want, what):
    for g, p, nm in zip(got, want, ("dx", "dW", "da", "db")):
        g, p = g.float(), p.float()
        assert g.shape == p.shape, (what, nm, g.shape, p.shape)
        bnd = 1e-5 * max(p.abs().max().item(), 1e-6)
        err = (g - p).abs().max().item()
        assert err <= bnd, (what, nm, err, bnd)


def _inputs(seed, shape_x, shape_w, f, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape_x, generator=g).to(dtype)
    w = (torch.randn(shape_w, generator=g) * 0.2).to(dtype)
    c = shape_x[1]
    a = torch.rand(c, generator=g) * 0.5 + 0.75
    b = torch.randn(c, generator=g) * 0.1
    return g, x, w, a, b


@pytest.mark.parametrize("n,c,f,h,w,act", [
    (2, 5, 7, 6, 19, "relu"), (1, 16, 1, 5, 16, "none"),
    (2, 3, 17, 4, 9, "leaky"), (1, 20, 33, 3, 21, "relu")])
def test_convbn2d_gemm_matches_plain(n, c, f, h, w, act):
    g, x, wt, a, b = _inputs(n * 100 + c, (n, c, h, w), (f, c, 3, 3), f)
    y = torch.randn(n, f, h, w, generator=g)
    gy = torch.randn(n, f, h, w, generator=g) * 0.1
    gs = torch.randn(f, 2, generator=g) * 1e-2
    args = (x, wt, a, b, y, gy, gs, act)
    _close(cg.convbn2d_bwd_gemm(*args), convbn2d_block_bwd_plain(*args),
           (n, c, f, h, w, act))


@pytest.mark.parametrize("items,depth,c,f,h,w,relu", [
    (2, 3, 5, 4, 5, 17, False), (1, 4, 16, 1, 4, 9, True),
    (2, 2, 6, 11, 3, 20, True), (1, 1, 5, 1, 2, 7, False)])
def test_convcomb_gemm_matches_plain(items, depth, c, f, h, w, relu):
    n = items * depth
    g, x, wm, a, b = _inputs(n + c + f, (n, c, h * w), (3 * f, c, 3, 3), f)
    y = torch.randn(n, f, h * w, generator=g)
    gy = torch.randn(n, f, h * w, generator=g) * 0.1
    gs = torch.randn(f, 2, generator=g) * 1e-2
    args = (x, wm, a, b, y, gy, gs, depth, h, w, relu)
    _close(cg.convcomb_bwd_gemm(*args), convbn_block_bwd_plain(*args),
           (items, depth, c, f, h, w, relu))


def test_layouts_read_and_write_the_modules_own():
    """B[s*Fp + f, c] = W[f, c, 8 - s] with zero padding; the stacked taps
    in reverse order; dW[f, c, s] = P[s*Cp + c, f]."""
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    bm = cg.dx_weights(w, 16, 16)
    assert bm.shape == (144, 16)
    for s in range(9):
        for f in range(2):
            assert torch.equal(bm[s * 16 + f, :3], w[f, :, (8 - s) // 3,
                                                      (8 - s) % 3])
    assert bm.count_nonzero() == w.count_nonzero()
    wm = torch.randn(9, 3, 3, 3)
    st = cg.convcomb_dx_weights(wm, 16, 16)
    for q in range(3):
        assert torch.equal(st[q], cg.dx_weights(wm[(2 - q) * 3:(3 - q) * 3],
                                                16, 16))
    p = torch.randn(9 * 16, 16)
    dw = cg.weight_from_gemm(p, 5, 3, 16)
    for f, c, s in ((0, 0, 0), (4, 2, 8), (3, 1, 5)):
        assert dw[f, c, s // 3, s % 3] == p[s * 16 + c, f]


def test_depth_taps_mask_the_edges():
    ge = torch.arange(6, dtype=torch.float32).reshape(6, 1) + 1
    t = cg.depth_taps(ge, 3)                  # rows 0-2 item 0, 3-5 item 1
    np.testing.assert_array_equal(t[:, 0].numpy(), [2, 3, 0, 5, 6, 0])
    np.testing.assert_array_equal(t[:, 1].numpy(), [1, 2, 3, 4, 5, 6])
    np.testing.assert_array_equal(t[:, 2].numpy(), [0, 1, 2, 0, 4, 5])


@pytest.mark.parametrize("m_rows,want", [(144, (1, 3)), (288, (2, 3)),
                                         (576, (3, 3)), (720, (4, 3)),
                                         (64, (1, 1)), (1152, (6, 3))])
def test_dw_split_covers_m(m_rows, want):
    nsplit, wgs = cg.dw_split(m_rows)
    assert (nsplit, wgs) == want
    tiles = -(-m_rows // 64)
    assert nsplit * wgs >= tiles and wgs <= 3
    assert nsplit * wgs - tiles < nsplit          # under a warpgroup idle
                                                  # per split


def test_backward_segments_take_whole_items_where_the_card_stays_full():
    """The backward ring kernel reads all three taps' weights per block,
    so it takes the longest depth segment that still gives 4 blocks per
    SM: a whole item's 64 rows at the B=8 step (96 tiles x 8 items), 8
    rows at B=1; ``segment_rows``'s defaults are the backward's (the
    forward has its own, ``forward_segment``)."""
    from depthestimation_tpu_torch.ops.convcomb_kernel import segment_rows
    bwd = ((64, 32, 16, 8), 4)
    assert segment_rows(8, 64, 96, 132, *bwd) == 64
    assert segment_rows(1, 64, 96, 132, *bwd) == 8
    assert segment_rows(8, 64, 96, 132) == 64
