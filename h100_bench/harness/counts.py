"""Operations and bytes: the yardstick of the roofline and mfu metrics.

The per-call counts copy ``chip_smoke.py``'s arithmetic (``bound``,
``sweep_flops`` and the conv counts beside them): a conv's operations are
2 x pixels x F x taps x C, a backward's twice the forward's (dx and dW),
and the bytes are every input read once and every output written once.
``step_flops`` counts a whole train step from the configuration's shapes
alone, so it does not depend on which implementation runs;
``flow_step_flops`` does the same for PWCLite's ARFlow step, which runs
in f32 (its peak is ``F32_FLOPS``, TF32 being off).
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, bf16 tensor FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
#: the same data sheet: float32 FLOP/s outside the tensor cores
F32_FLOPS = 67e12


def least_seconds(n_bytes: float, flops: float,
                  peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the peak of their type."""
    return max(n_bytes / HBM_BPS, flops / peak)


def conv2d_flops(n, h, w, c, f, taps=9) -> float:
    return 2.0 * n * h * w * f * taps * c


def convbn2d_call(n, c, h, w, f):
    """(forward bytes, forward ops, backward bytes, backward ops) of one
    fused 2D ConvBN call on bf16 x [n, c, h, w], weight [f, c, 3, 3]."""
    x, wt, y = 2 * n * c * h * w, 2 * f * c * 9, 2 * n * f * h * w
    ab, st = 8 * c, 8 * f
    fl = conv2d_flops(n, h, w, c, f)
    return (x + wt + ab + y + st, fl,
            2 * (x + wt + ab) + 2 * y + st + x + wt + ab, 2 * fl)


def convcomb_call(n, c, hw, f):
    """The same for one Base3D block on the flat volume x [n, c, hw] with
    the tap-stacked weight [3f, c, 3, 3]."""
    x, wm, y = 2 * n * c * hw, 2 * 3 * f * c * 9, 2 * n * f * hw
    ab, st = 8 * c, 8 * f
    fl = 2.0 * n * hw * 3 * f * 9 * c
    return (x + wm + ab + y + st, fl,
            2 * (x + wm + ab) + 2 * y + st + x + wm + ab, 2 * fl)


def sweep_call(n, d, c1, h, w, nx: float, ny: float, elt: int = 2):
    """One stage-2 sweep call: fa [n, c1, h, w], ref [n/v, c1, h, w]
    (counted as n), fr [n, d, h, w], rxt [n, d, w, w], ry [n, d, h, h],
    cost and diag [n, d, h, w] f32. ``nx``, ``ny``: the nonzeros of rxt
    and ry summed over views and depths (the products are sparse by data:
    ``F . Rx^T`` takes h MACs per nonzero of Rx^T, ``Ry . s`` w MACs per
    nonzero of Ry, for c1 features and the diagonal warp; the cost adds 3
    operations per channel and output pixel)."""
    ins = elt * (2 * n * c1 * h * w + n * d * h * w + n * d * (w * w + h * h))
    outs = 4 * 2 * n * d * h * w
    fl = 2.0 * (c1 + 1) * (h * nx + ny * w) + 3.0 * n * d * c1 * h * w
    return ins + outs, fl, ins + outs + elt * (2 * n * c1 * h * w
                                               + n * d * h * w), 2 * fl


def step_flops(cfg: dict, batch: int) -> float:
    """Operations of one train step of exp7 / exp7_lc at the configured
    sizes: every convolution of the encoder (on the T frames), the BV
    head, Base3D and the decoder, the sweep's stage-2 products at two taps
    an output, forward and backward (2x: dx and dW; the stem's input takes
    no dx), both camera sides. Elementwise work (BatchNorm, the loss, the
    light-curtain loop) is not counted."""
    v = cfg["var"]
    wd, ht = v["img_size"]
    fd, d = v["feature_dim"], v["ndepth"]
    t = int(v.get("t_win", 1)) + 1
    m = fd / 64.0
    s0, s1, s2, s3 = int(16 * m), int(32 * m), int(64 * m), int(128 * m)
    n = batch * t
    h2, w2, h4, w4 = ht // 2, wd // 2, ht // 4, wd // 4
    stem = conv2d_flops(n, h2, w2, 3, s1)
    enc = 2 * conv2d_flops(n, h2, w2, s1, s1)
    enc += 3 * 2 * conv2d_flops(n, h2, w2, s1, s1)                  # stage 0
    enc += (conv2d_flops(n, h4, w4, s1, s2) + conv2d_flops(n, h4, w4, s2, s2)
            + conv2d_flops(n, h4, w4, s1, s2, 1))
    enc += (s0 - 1) * 2 * conv2d_flops(n, h4, w4, s2, s2)            # stage 1
    enc += (conv2d_flops(n, h4, w4, s2, s3) + conv2d_flops(n, h4, w4, s3, s3)
            + conv2d_flops(n, h4, w4, s2, s3, 1))
    enc += 2 * 2 * conv2d_flops(n, h4, w4, s3, s3)                   # stage 2
    enc += 3 * 2 * conv2d_flops(n, h4, w4, s3, s3)                   # stage 3
    for win in (64, 32, 16, 8):
        k = min(win, h4, w4)
        enc += conv2d_flops(n, h4 // k, w4 // k, s3, s1, 1)
    enc += conv2d_flops(n, h4, w4, s2 + s3 + 4 * s1, s3)
    enc += conv2d_flops(n, h4, w4, s3, fd, 1)
    b = batch
    c1 = fd + 3
    sweep = 2.0 * b * (t - 1) * d * (c1 + 1) * (h4 * w4 * 2 + h4 * w4 * 2)
    head = 3 * conv2d_flops(b, h4, w4, d, d)
    cin = (3 if v["nmode"] == "exp7_lc" else 2) + t
    b3d = (conv2d_flops(b * d, h4, w4, cin, 32, 27)
           + 6 * conv2d_flops(b * d, h4, w4, 32, 32, 27)
           + conv2d_flops(b * d, h4, w4, 32, 1, 27))
    c0, cq = d + fd, d + int(32 * m)
    dec = 2 * conv2d_flops(b, h4, w4, c0, c0)
    dec += conv2d_flops(b, h4, w4, c0, d, 16)                  # 4x4 stride 2
    dec += 2 * conv2d_flops(b, h2, w2, cq, cq)
    dec += conv2d_flops(b, h2, w2, cq, d, 16)
    dec += (conv2d_flops(b, ht, wd, d + 3, d + 3)
            + conv2d_flops(b, ht, wd, d + 3, d)
            + conv2d_flops(b, ht, wd, d, d))
    fwd = stem + enc + sweep + head + b3d + dec
    side = 3.0 * fwd - stem          # forward, dx, dW; no dx into the image
    return 2.0 * side


def correlation_call(n, c, h, w, md):
    """One cost-volume correlation call on f32 x1, x2 [n, c, h, w] at
    search range ``md``: (forward bytes, forward ops, backward bytes,
    backward ops). The forward takes a multiply-add per channel and
    displacement of each output pixel; the backward twice that (dx1 and
    dx2). Bytes: x1 and x2 read and the [n, (2md+1)^2, h, w] output
    written; the backward reads x1, x2 and the output's cotangent and
    writes dx1 and dx2."""
    k = (2 * md + 1) ** 2
    x, y = 4 * n * c * h * w, 4 * n * k * h * w
    fl = 2.0 * n * k * c * h * w
    return 2 * x + y, fl, 2 * x + y + 2 * x, 2 * fl


def _pwc_levels(h, w):
    """PWCLite's pyramid (``ref.pwclite.PYRAMID``, the published widths):
    (height, width, channels), finest first, stride-2 convs with padding 1
    from the image."""
    from ref.pwclite import PYRAMID
    out = []
    for c in PYRAMID[1:]:
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out.append((h, w, c))
    return out


def flow_step_flops(model: dict, batch: int, h: int, w: int) -> float:
    """Operations of one ARFlow train step of PWCLite on B image pairs of
    h x w (``model``: the configuration's model group): six pyramid
    extractions (the teacher's two frames and each student's two) and
    four two-frame passes (the teacher forward and backward, the two
    students), each pass's levels up to ``output_level``: the 1x1 conv,
    the correlation, the reduced estimator and the context network.
    Forward, dx and dW for every conv (the stem takes no dx: its input is
    an image) and forward plus twice it for the correlation, except the
    teacher's backward pass: its flows reach the loss only through the
    occlusion mask, a comparison, so autograd runs no backward of it.
    Elementwise work (warps, resizes, the loss) is not counted."""
    from ref.pwclite import CONTEXT, ESTIMATOR, PYRAMID
    md, top = model["search_range"], model["output_level"]
    levels = _pwc_levels(h, w)
    stem = 0.0
    ext = 0.0
    cin = PYRAMID[0]
    for i, (lh, lw, c) in enumerate(levels):
        first = conv2d_flops(batch, lh, lw, cin, c)
        if i == 0:
            stem = first
        ext += first + conv2d_flops(batch, lh, lw, c, c)
        cin = c
    k = (2 * md + 1) ** 2
    pas = 0.0
    corr = 0.0
    for lh, lw, c in levels[::-1][:top + 1]:
        corr += 2.0 * batch * k * c * lh * lw
        pas += conv2d_flops(batch, lh, lw, c, 32, 1)
        ein = k + 32 + 2
        for ci, co in ESTIMATOR:
            pas += conv2d_flops(batch, lh, lw, ci or ein, co)
        cc = 32 + 2
        for co, _ in CONTEXT:
            pas += conv2d_flops(batch, lh, lw, cc, co)
            cc = co
    return 6 * (3.0 * ext - stem) + 3 * 3.0 * (pas + corr) + (pas + corr)
