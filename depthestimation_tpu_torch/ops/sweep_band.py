"""The decomposition of the stage-2 sweep kernels (``csrc/sweep_stage2.cu``)
in plain torch, so that the CPU tests can hold it against the plain
versions and the JAX package. It runs on no path.

Both kernels compute on the band matrices' nonzero extents:

- ``band_taps`` is the first launch of either direction: for every column
  of Rx^T (colx), row of Rx^T (roww), row of Ry (rowy) and column of Ry
  (colh) of each (n, d), the first nonzero ``lo``, the extent's length
  ``n`` (first to last nonzero, 0 when all zero) and, where ``n <= TAPS``,
  its entries; ``longest`` holds each kind's longest extent per (n, d).
  Both kernels take their band path on bilinear bands only: rows of Ry and
  columns of Rx^T of at most two taps (``bilinear_fwd``), and for the
  backward their transposes of at most three (``bilinear_bwd``).
- ``stage2_fwd``: a block owns (view n, a group of ``group`` depths, a
  strip of ``ROWS`` output rows). The feature rows it needs are the hull
  of its Ry extents; where its depths are bilinear and the hull fits
  ``fwd_cap(h)`` rows, each output is ``sum_k ty_k bf16(sum_j F[h_k, w_j]
  tx_j)`` over the taps and the cost adds channel by channel in order;
  the diagonal planes follow the C1 channels. Otherwise the block takes
  the separable path (s1 on the hull rows, then warped).
- ``stage2_bwd``: a block owns a strip of ``ROWS`` rows of one item's dfa
  and dref for a group of ``cgroup`` channels and walks the item's views,
  then depths. At depth d it needs dw on the strip and its strip's Ry^T
  extents (rows ``[ya, yb)`` of d) and F on their Ry extents; over every
  view and depth these make the Y hull and the F hull, which fit
  ``bwd_caps(h)`` on the band path. Per depth it computes dw (and -dw of
  its own rows into dref), ds1 on its strip and adds ds1 . Rx into dfa,
  which it writes at the end of each view. On a sideways step the
  kernel computes dw on the whole Y hull at every depth; rows past d's
  reach no output, so the model computes d's rows only. ``dfr`` comes
  from one more block per (n, d).
- ``fwd_blocks`` and ``bwd_blocks`` make each block's decision and hulls;
  ``block_paths`` counts the blocks on each path for given matrices.

The sums run in the kernels' order (taps in index order; channels, views
and depths in order), in f32 with the rounding points of
``sweep_stage2_plain``. The separable path is modelled by dense products
over the same rows, whose zero terms change no sum.
"""

from __future__ import annotations

import torch

TAPS = 3
ROWS = 4


def fwd_cap(h: int) -> int:
    """Feature rows a forward ring stage holds."""
    return min(h, ROWS + 6)


def bwd_caps(h: int) -> tuple[int, int]:
    """(rows of dw, rows of F) a backward block holds on the band path."""
    return min(h, ROWS + 12), min(h, ROWS + 14)


def _rnd(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _extents(m: torch.Tensor):
    """(lo, n, w [.., TAPS]) of every row of ``m`` [..., L, K] over K."""
    k = m.shape[-1]
    nz = m != 0
    idx = torch.arange(k)
    any_ = nz.any(-1)
    lo = torch.where(nz, idx, k).amin(-1)
    hi = torch.where(nz, idx, -1).amax(-1)
    lo = torch.where(any_, lo, torch.zeros_like(lo))
    n = torch.where(any_, hi - lo + 1, torch.zeros_like(lo))
    ks = torch.arange(TAPS)
    pos = (lo[..., None] + ks).clamp(max=k - 1)
    w = torch.gather(m.to(torch.float32), -1, pos)
    keep = (ks < n[..., None]) & (n[..., None] <= TAPS)
    return lo, n, torch.where(keep, w, torch.zeros_like(w))


def band_taps(rxt: torch.Tensor, ry: torch.Tensor) -> dict:
    """The taps of ``band_taps_kernel``: rxt [N, D, W, X], ry [N, D, Y, H]
    -> {"colx", "roww", "rowy", "colh": (lo, n, w) each, "longest":
    {kind: [N, D]}}."""
    t = {"colx": _extents(rxt.transpose(-1, -2)), "roww": _extents(rxt),
         "rowy": _extents(ry), "colh": _extents(ry.transpose(-1, -2))}
    t["longest"] = {k: t[k][1].amax(-1) for k in ("colx", "roww", "rowy",
                                                  "colh")}
    return t


def bilinear_fwd(taps: dict) -> torch.Tensor:
    """[N, D]: where the forward's band path holds (n, d): Ry rows and
    Rx^T columns of at most two taps."""
    lg = taps["longest"]
    return (lg["rowy"] <= 2) & (lg["colx"] <= 2)


def bilinear_bwd(taps: dict) -> torch.Tensor:
    """[N, D]: the backward's, also their transposes of at most three."""
    lg = taps["longest"]
    return bilinear_fwd(taps) & (lg["colh"] <= TAPS) & (lg["roww"] <= TAPS)


def _pick(tap, nd, idx):
    lo, n, w = tap
    return lo[nd][idx], n[nd][idx], w[nd][idx]


def _warped_taps(f, ty, tx):
    """sum_k ty_k bf16(sum_j f[:, h_k, w_j] tx_j) for rows ``ty`` [R] and
    columns ``tx`` [X]: f [C, H, W] f32 -> [C, R, X]."""
    ylo, yn, yw = ty
    xlo, xn, xw = tx
    c, h, w = f.shape
    acc = torch.zeros(c, ylo.numel(), xlo.numel())
    for k in range(TAPS):
        rows = f[:, (ylo + k).clamp(max=h - 1)]                # [C, R, W]
        s = torch.zeros_like(acc)
        for j in range(TAPS):
            col = (xlo + j).clamp(max=w - 1)
            p = rows[:, :, col] * xw[:, j]
            s = s + torch.where(j < xn, p, torch.zeros_like(p))
        term = yw[:, k, None] * _rnd(s)
        acc = acc + torch.where((k < yn)[:, None], term, torch.zeros_like(term))
    return acc


def _strip_extents(tap, h: int):
    """(lo, hi) [..., S] of the union of the extents ``tap`` (lo, n, _)
    [..., H] over each strip of ROWS rows; lo >= hi where all are empty."""
    lo, n, _ = tap
    s = -(-h // ROWS)
    pad = s * ROWS - h
    big = torch.iinfo(torch.int64).max // 4
    lo_ = torch.where(n > 0, lo, torch.full_like(lo, big))
    hi_ = torch.where(n > 0, lo + n, torch.full_like(lo, -1))
    lo_ = torch.nn.functional.pad(lo_, (0, pad), value=big)
    hi_ = torch.nn.functional.pad(hi_, (0, pad), value=-1)
    shape = lo.shape[:-1] + (s, ROWS)
    return lo_.reshape(shape).amin(-1), hi_.reshape(shape).amax(-1)


def _rows(lo, hi):
    """(first, rows) of a hull: (0, 1) where it is empty (one row staged,
    all weights 0)."""
    empty = hi <= lo
    return (torch.where(empty, torch.zeros_like(lo), lo),
            torch.where(empty, torch.ones_like(lo), hi - lo))


def fwd_blocks(taps: dict, h: int, group: int = 4) -> dict:
    """The forward's blocks (view n, depth group, strip): "f0", "frows"
    (the hull of the strip's Ry extents over the group's depths) and
    "band" (its path), each [N, groups, strips]."""
    lo, hi = _strip_extents(taps["rowy"], h)                # [N, D, S]
    nn, dd, ss = lo.shape
    g = -(-dd // group)
    pad = g * group - dd
    big = torch.iinfo(torch.int64).max // 4
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=big)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-1)
    lo = lo.reshape(nn, g, group, ss).amin(2)
    hi = hi.reshape(nn, g, group, ss).amax(2)
    bil = torch.nn.functional.pad(bilinear_fwd(taps), (0, pad), value=True)
    bil = bil.reshape(nn, g, group).all(-1)[..., None]
    f0, frows = _rows(lo, hi)
    return {"f0": f0, "frows": frows, "band": bil & (frows <= fwd_cap(h))}


def bwd_blocks(taps: dict, h: int, v: int) -> dict:
    """The backward's blocks (item, strip; each channel group alike):
    "ya", "yb" [N, D, S], the rows of dw depth d needs (the strip and its
    Ry^T extents at d), and "band" [B, S], its path: whether the Y hull
    (those rows over the item's views and depths) and the F hull (at each
    depth the Ry extents of d's rows) fit ``bwd_caps(h)``."""
    lo, hi = _strip_extents(taps["colh"], h)                # [N, D, S]
    nn, dd, ss = lo.shape
    r0 = torch.arange(ss) * ROWS
    r1 = (r0 + ROWS).clamp(max=h)
    ya, yb = torch.minimum(lo, r0), torch.maximum(hi, r1)
    b = nn // v
    y0 = ya.reshape(b, v * dd, ss).amin(1)
    yrows = yb.reshape(b, v * dd, ss).amax(1) - y0
    rlo, rn, _ = taps["rowy"]                               # [N, D, H]
    ys = torch.arange(h)
    inside = ((ys >= ya[..., None]) & (ys < yb[..., None])
              & (rn > 0)[:, :, None, :])                    # [N, D, S, H]
    big = torch.iinfo(torch.int64).max // 4
    flo = torch.where(inside, rlo[:, :, None, :], big).amin(-1)
    fhi = torch.where(inside, (rlo + rn)[:, :, None, :], -1).amax(-1)
    flo = flo.reshape(b, v * dd, ss).amin(1)
    fhi = fhi.reshape(b, v * dd, ss).amax(1)
    frows = _rows(flo, fhi)[1]
    bil = bilinear_bwd(taps).reshape(b, v * dd).all(-1)[:, None]
    cap_y, cap_f = bwd_caps(h)
    band = bil & (yrows <= cap_y) & (frows <= cap_f)
    return {"ya": ya, "yb": yb, "band": band}


def block_paths(rxt: torch.Tensor, ry: torch.Tensor, v: int,
                group: int = 4) -> dict:
    """Blocks on each path: {"fwd": {"band": k, "separable": k}, "bwd":
    ...}; the forward's counted per (view, depth group, strip), the
    backward's per (item, strip) (each of its channel groups alike)."""
    taps = band_taps(rxt.cpu(), ry.cpu())
    h = ry.shape[-1]
    out = {}
    for key, band in (("fwd", fwd_blocks(taps, h, group)["band"]),
                      ("bwd", bwd_blocks(taps, h, v)["band"])):
        k = int(band.sum())
        out[key] = {"band": k, "separable": band.numel() - k}
    return out


def stage2_fwd(fa, ref, fr, rxt, ry, v: int, group: int = 4):
    """``sweep_stage2_plain`` (bf16 inputs) in the forward kernel's
    decomposition. Returns (cost, diag, paths): paths counts the blocks
    that took the band and the separable path."""
    f32 = torch.float32
    n_, c1, h, w = fa.shape
    d_ = fr.shape[1]
    taps = band_taps(rxt, ry)
    blocks = fwd_blocks(taps, h, group)
    cost = torch.empty(n_, d_, h, w)
    diag = torch.empty(n_, d_, h, w)
    paths = {"band": 0, "separable": 0}
    fa32, ref32, fr32 = fa.to(f32), ref.to(f32), fr.to(f32)
    xs = torch.arange(w)
    for n in range(n_):
        b = n // v
        for gi, d0 in enumerate(range(0, d_, group)):
            ds = range(d0, min(d0 + group, d_))
            for si, y0 in enumerate(range(0, h, ROWS)):
                ys = torch.arange(y0, min(y0 + ROWS, h))
                band = bool(blocks["band"][n, gi, si])
                f0 = int(blocks["f0"][n, gi, si])
                frows = int(blocks["frows"][n, gi, si])
                paths["band" if band else "separable"] += 1
                for d in ds:
                    nd = (n, d)
                    if band:
                        ty = _pick(taps["rowy"], nd, ys)
                        tx = _pick(taps["colx"], nd, xs)
                        acc = torch.zeros(len(ys), w)
                        for c in range(c1):       # channels in order
                            wv = _warped_taps(fa32[n, c:c + 1], ty, tx)[0]
                            dv = wv - ref32[b, c, ys]
                            acc = acc + dv * dv
                        dg = _warped_taps(fr32[n, d:d + 1], ty, tx)[0]
                    else:
                        rows = slice(f0, f0 + frows)
                        ryd = ry[n, d].to(f32)[ys][:, rows]
                        s1 = _rnd(fa32[n, :, rows] @ rxt[n, d].to(f32))
                        wv = ryd @ s1                          # [C, R, X]
                        acc = torch.zeros(len(ys), w)
                        for c in range(c1):
                            dv = wv[c] - ref32[b, c, ys]
                            acc = acc + dv * dv
                        dg = ryd @ _rnd(fr32[n, d, rows] @ rxt[n, d].to(f32))
                    cost[n, d, ys] = acc
                    diag[n, d, ys] = dg
    return cost, diag, paths


def stage2_bwd(fa, ref, fr, rxt, ry, gcost, gdiag, v: int, cgroup: int = 2):
    """``sweep_stage2_bwd_plain`` (bf16 inputs) in the backward kernel's
    decomposition. Returns (dfa, dref, dfr, paths)."""
    f32 = torch.float32
    n_, c1, h, w = fa.shape
    d_ = fr.shape[1]
    bsz = n_ // v
    taps = band_taps(rxt, ry)
    blocks = bwd_blocks(taps, h, v)
    fa32, ref32 = fa.to(f32), ref.to(f32)
    rxt32, ry32 = rxt.to(f32), ry.to(f32)
    dfa = torch.empty(n_, c1, h, w)
    dref = torch.empty(bsz, c1, h, w)
    paths = {"band": 0, "separable": 0}
    xs = torch.arange(w)
    for b in range(bsz):
        for c0 in range(0, c1, cgroup):
            cs = slice(c0, min(c0 + cgroup, c1))
            for si, r0 in enumerate(range(0, h, ROWS)):
                rs = torch.arange(r0, min(r0 + ROWS, h))
                band = bool(blocks["band"][b, si])
                paths["band" if band else "separable"] += 1
                acc_ref = torch.zeros(cs.stop - c0, len(rs), w)
                for vv in range(v):
                    n = b * v + vv
                    acc_fa = torch.zeros(cs.stop - c0, len(rs), w)
                    for d in range(d_):
                        nd = (n, d)
                        g = gcost[n, d].to(f32)
                        # the rows of dw this depth needs, the strip's own
                        # among them
                        ya = int(blocks["ya"][n, d, si])
                        yb = int(blocks["yb"][n, d, si])
                        ys = torch.arange(ya, yb)
                        own = (ys >= r0) & (ys < r0 + len(rs))
                        if band:
                            wv = _warped_taps(
                                fa32[n, cs], _pick(taps["rowy"], nd, ys),
                                _pick(taps["colx"], nd, xs))
                            dw = 2.0 * (wv - ref32[b, cs][:, ys]) * g[ys]
                            dwb = _rnd(dw)
                            lo, nn, wt = _pick(taps["colh"], nd, rs)
                            s = torch.zeros(cs.stop - c0, len(rs), w)
                            for k in range(TAPS):
                                # padded entries read a row of d's (weight 0)
                                row = (lo + k - ya).clamp(0, len(ys) - 1)
                                term = wt[:, k, None] * dwb[:, row]
                                s = s + torch.where((k < nn)[:, None], term,
                                                    torch.zeros_like(term))
                            ds1 = _rnd(s)
                            lo, nn, wt = _pick(taps["roww"], nd, xs)
                            s = torch.zeros_like(acc_fa)
                            for k in range(TAPS):
                                col = (lo + k).clamp(max=w - 1)
                                term = ds1[:, :, col] * wt[:, k]
                                s = s + torch.where(k < nn, term,
                                                    torch.zeros_like(term))
                            acc_fa = acc_fa + s
                        else:       # s1 and dw on the rows d needs
                            s1 = _rnd(fa32[n, cs] @ rxt32[n, d])
                            dw = 2.0 * (ry32[n, d][ys] @ s1
                                        - ref32[b, cs][:, ys]) * g[ys]
                            ds1 = _rnd(ry32[n, d][ys][:, rs].T @ _rnd(dw))
                            acc_fa = acc_fa + ds1 @ rxt32[n, d].T
                        acc_ref = acc_ref - dw[:, own]
                    dfa[n, cs, r0:r0 + len(rs)] = acc_fa
                dref[b, cs, r0:r0 + len(rs)] = acc_ref
    dfr = torch.empty(n_, d_, h, w)
    for n in range(n_):
        for d in range(d_):
            ds2 = _rnd(ry32[n, d].T @ _rnd(gdiag[n, d].to(f32)))
            dfr[n, d] = ds2 @ rxt32[n, d].T
    return dfa, dref, dfr, paths
