"""Plane sweep + diagonal feature warp, batched over B*V views.

Port of ``depthestimation_tpu/ops/plane_sweep.py``. The decomposed path
(``_homography_resample``, ``_affine_band_mats``, ``_sweep_mats`` and the
body of ``_pallas_sweep_local``): for fronto-parallel planes the depth-d
homography factors into one depth-independent homography resample by
``A = K R K^-1`` (stage 1, a 4-tap bilinear gather) and, per depth, a
separable bilinear resample ``Ry_d . src . Rx_d^T`` (stage 2: banded
matmuls, ``ops/sweep_kernel.py``). Stage 1 and the band matrices are f32,
as in JAX at HIGHEST precision. The cost volume alone
(``plane_sweep_volume_decomposed``) is the einsum form of stage 2 in the
sweep's dtype, as JAX computes it in XLA, outside its kernel.

The gather path (``sweep_impl: "gather"``, JAX ``plane_sweep_volume`` and
``plane_sweep_and_warp``): every depth plane's homography pixels
(``homography_pixels``) sampled by four bilinear taps, f32.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops.resample import fast_take
from depthestimation_tpu_torch.ops.sweep_kernel import (sweep_stage2,
                                                        sweep_stage2_plain)


def _pad_flat(img: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> zero-padded [..., C, (H+2)*(W+2)]."""
    h, w = img.shape[-2:]
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))
    return p.reshape(img.shape[:-2] + ((h + 2) * (w + 2),))


def _tap_indices_weights(pix: torch.Tensor, h: int, w: int):
    """Bilinear taps into a 1-px zero-padded flat image. pix [..., 2]
    (x, y) array-index coords -> (idx [4, ...], weight [4, ...]); the
    weights fold in the zero-padding border mask."""
    wp = w + 2
    x, y = pix[..., 0], pix[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0

    def tap(xi, yi, wt):
        valid = (xi >= -1) & (xi <= w) & (yi >= -1) & (yi <= h)
        xc = torch.clamp(xi + 1, 0, wp - 1).long()
        yc = torch.clamp(yi + 1, 0, h + 1).long()
        return yc * wp + xc, torch.where(valid, wt, 0.0)

    taps = [tap(x0, y0, (1 - fx) * (1 - fy)),
            tap(x0 + 1, y0, fx * (1 - fy)),
            tap(x0, y0 + 1, (1 - fx) * fy),
            tap(x0 + 1, y0 + 1, fx * fy)]
    return (torch.stack([i for i, _ in taps]),
            torch.stack([wt for _, wt in taps]).float())


def bilinear_sample_many(img: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Sample img [N, C, H, W] at pix [N, ..., 2] -> [N, C, ...] with zero
    padding (the JAX function vmapped over N)."""
    h, w = img.shape[-2:]
    flat = _pad_flat(img)
    idx, wt = _tap_indices_weights(pix, h, w)
    out = 0.0
    for t in range(4):
        out = out + fast_take(flat, idx[t]) * wt[t][:, None]
    return out


def homography_resample(feat: torch.Tensor, rot: torch.Tensor,
                        intr: torch.Tensor) -> torch.Tensor:
    """Stage 1: resample feat [N, C, H, W] by ``A = K R K^-1`` onto the
    reference grid (rot, intr [N, 3, 3]). Identity rotation reproduces the
    input exactly: K^-1 is the closed form, as in JAX."""
    n, c, h, w = feat.shape
    dev = feat.device
    fx, fy = intr[:, 0, 0], intr[:, 1, 1]
    cx, cy = intr[:, 0, 2], intr[:, 1, 2]
    k_inv = torch.eye(3, dtype=intr.dtype, device=dev).repeat(n, 1, 1)
    k_inv[:, 0, 0] = 1.0 / fx
    k_inv[:, 0, 2] = -cx / fx
    k_inv[:, 1, 1] = 1.0 / fy
    k_inv[:, 1, 2] = -cy / fy
    a_mat = torch.matmul(torch.matmul(intr, rot), k_inv)
    u = (torch.arange(w, dtype=torch.float32, device=dev)[None] + 0.5
         + (cx - 0.5 * w)[:, None])                                # [N, W]
    v = (torch.arange(h, dtype=torch.float32, device=dev)[None] + 0.5
         + (cy - 0.5 * h)[:, None])                                # [N, H]
    grid = torch.stack([u[:, None, :].expand(n, h, w),
                        v[:, :, None].expand(n, h, w),
                        torch.ones((n, h, w), dtype=torch.float32,
                                   device=dev)], dim=1)            # [N,3,H,W]
    q = torch.einsum("nij,njhw->nihw", a_mat, grid)
    q = q / (q[:, 2:3] + 1e-10)
    pix = torch.stack([q[:, 0] - 0.5, q[:, 1] - 0.5],
                      dim=-1).reshape(n, h * w, 2)
    return bilinear_sample_many(feat, pix).reshape(n, c, h, w)


def affine_band_mats(d_candi: torch.Tensor, m: torch.Tensor, h: int, w: int,
                     dxy):
    """Banded bilinear resample matrices of the per-depth global affine,
    batched over views: m [N, 3], dxy = (dx [N], dy [N]).

    Returns (Rx [N, D, W, W], Ry [N, D, H, H]); a row that maps outside the
    image is all-zero (zero padding), and a plane behind the camera
    (1 + m2/d == 0) takes the 1e12 sentinel scale, as in JAX.
    """
    d = d_candi.to(torch.float32)[None]                             # [1, D]
    denom = 1.0 + m[:, 2:3] / d                                     # [N, D]
    inv = torch.where(torch.abs(denom) > 1e-10, 1.0 / denom,
                      torch.full_like(denom, 1e12))

    def band(size: int, off, delta):
        i = torch.arange(size, dtype=torch.float32, device=d.device)
        a = ((i[None, None, :] + 0.5 + delta[:, None, None]
              + off[:, :, None]) * inv[:, :, None]
             - 0.5 - delta[:, None, None])                           # [N,D,n]
        return torch.clamp(1.0 - torch.abs(a[..., None] - i), min=0.0)

    return (band(w, m[:, 0:1] / d, dxy[0]), band(h, m[:, 1:2] / d, dxy[1]))


def sweep_mats(d_candi, rot, tra, intr, h: int, w: int):
    """(Rx, Ry) of each view's depth sweep. rot [N, 3, 3], tra [N, 3],
    intr [N, 3, 3]."""
    m = torch.matmul(intr, torch.matmul(rot.transpose(-1, -2),
                                        tra[..., None]))[..., 0]    # [N, 3]
    dxy = (intr[:, 0, 2] - 0.5 * w, intr[:, 1, 2] - 0.5 * h)
    return affine_band_mats(d_candi, m, h, w, dxy)


def _views(poses: torch.Tensor, intr: torch.Tensor, v: int):
    """The source views' (rot [N, 3, 3], tra [N, 3], intr [N, 3, 3]) of
    poses [B, T, 4, 4] (last view = reference), N = B*v, f32."""
    n = poses.shape[0] * v
    f32 = torch.float32
    return (poses[:, :-1, :3, :3].reshape(n, 3, 3).to(f32),
            poses[:, :-1, :3, 3].reshape(n, 3).to(f32),
            intr.to(f32).repeat_interleave(v, dim=0))


def plane_sweep_and_warp_batched(feat_all: torch.Tensor,
                                 feat_raw: torch.Tensor,
                                 d_candi: torch.Tensor, poses: torch.Tensor,
                                 intr: torch.Tensor, sigma: float,
                                 dtype=torch.float32,
                                 use_kernel: bool = True):
    """Whole-batch decomposed sweep (``_pallas_sweep_local``).

    feat_all [B, T, C1, h, w]; feat_raw [B, T, D, h, w]; poses
    [B, T, 4, 4] (last view = reference); intr [B, 3, 3].
    Returns (cost [B, D, h, w] f32, warped [B, T, D, h, w] f32).

    Stage 2 runs in ``dtype``: bf16 goes through the kernel wrapper
    (``sweep_stage2``), f32 through the plain version, as in JAX where the
    sweep kernel is bf16-only. ``use_kernel=False`` sends bf16 through the
    plain version too (to hold the kernel against it).
    """
    b, t, c1, h, w = feat_all.shape
    v = t - 1
    d = feat_raw.shape[2]
    n = b * v
    rots, tras, intr_n = _views(poses, intr, v)
    f32 = torch.float32
    fa_a = homography_resample(
        feat_all[:, :-1].reshape(n, c1, h, w).to(f32), rots, intr_n)
    fr_a = homography_resample(
        feat_raw[:, :-1].reshape(n, d, h, w).to(f32), rots, intr_n)
    rx, ry = sweep_mats(d_candi, rots, tras, intr_n, h, w)
    rxt = rx.transpose(-1, -2).contiguous()
    ref = feat_all[:, -1].to(dtype).contiguous()
    stage2 = (sweep_stage2 if dtype == torch.bfloat16 and use_kernel
              else sweep_stage2_plain)
    cost_nv, diag_nv = stage2(fa_a.to(dtype), ref, fr_a.to(dtype),
                              rxt.to(dtype), ry.to(dtype).contiguous(), v)
    cost = cost_nv.reshape(b, v, d, h, w).sum(dim=1) / sigma
    warped = torch.cat([diag_nv.reshape(b, v, d, h, w),
                        feat_raw[:, -1:].to(f32)], dim=1)
    return cost, warped


def homography_pixels(d_candi: torch.Tensor, rot: torch.Tensor,
                      tra: torch.Tensor, intr: torch.Tensor,
                      unit_rays: torch.Tensor) -> torch.Tensor:
    """Projected (x, y) array-index coordinates of every depth plane,
    batched over views (``_homography_pixels``): rot [N, 3, 3], tra [N, 3],
    intr [N, 3, 3], unit_rays [N, 3, HW] -> [N, D, HW, 2], f32."""
    term1 = torch.matmul(intr, tra[..., None])                     # [N,3,1]
    term2 = torch.matmul(torch.matmul(intr, rot), unit_rays)       # [N,3,HW]
    d = d_candi.to(term2.dtype)
    p = term1[:, :, None, :] + term2[:, :, None, :] * d[None, None, :, None]
    p = p / (p[:, 2:3] + 1e-10)                                    # [N,3,D,HW]
    return torch.stack([p[:, 0] - 0.5, p[:, 1] - 0.5], dim=-1)


def warp_feature_volume_batched(feat_raw: torch.Tensor,
                                d_candi: torch.Tensor, poses: torch.Tensor,
                                intr: torch.Tensor,
                                unit_rays: torch.Tensor) -> torch.Tensor:
    """The gather form of the diagonal feature warp on every view
    (``warp_feature_volume`` vmapped over the batch, as
    ``BaseModelNet._warped_features`` runs it when ``diffhomo`` is off):
    depth plane d samples feature channel d at the depth-d homography.

    feat_raw [B, T, D, h, w]; poses [B, T, 4, 4]; intr [B, 3, 3];
    unit_rays [B, 3, h*w]. Returns [B, T, D, h, w] f32.
    """
    b, t, d, h, w = feat_raw.shape
    n = b * t
    f32 = torch.float32
    d_candi = torch.as_tensor(d_candi, dtype=f32, device=feat_raw.device)
    if d_candi.numel() != d:
        raise ValueError(f"the diagonal warp needs C == D: {d} feature "
                         f"channels, {d_candi.numel()} depth planes")
    pix = homography_pixels(
        d_candi,
        poses[:, :, :3, :3].reshape(n, 3, 3).to(f32),
        poses[:, :, :3, 3].reshape(n, 3).to(f32),
        intr.to(f32).repeat_interleave(t, dim=0),
        unit_rays.to(f32).repeat_interleave(t, dim=0))          # [N,D,HW,2]
    flat = _pad_flat(feat_raw.reshape(n, d, h, w).to(f32))      # [N,D,HWp]
    idx, wt = _tap_indices_weights(pix, h, w)                   # [4,N,D,HW]
    out = 0.0
    for k in range(4):      # channel d at plane d's taps: the diagonal
        out = out + torch.gather(flat, -1, idx[k]) * wt[k]
    return out.reshape(b, t, d, h, w)


def plane_sweep_volume_decomposed(feat_all: torch.Tensor,
                                  d_candi: torch.Tensor, poses: torch.Tensor,
                                  intr: torch.Tensor, sigma: float,
                                  dtype=torch.float32) -> torch.Tensor:
    """The decomposed cost volume alone (JAX
    ``plane_sweep_volume_decomposed`` vmapped over the batch).

    feat_all [B, T, C, h, w] (last view = reference); poses [B, T, 4, 4];
    intr [B, 3, 3]. Stage 2's two products and the difference run in
    ``dtype``; the squares are summed in f32. Returns [B, D, h, w] f32.
    """
    b, t, c, h, w = feat_all.shape
    v = t - 1
    d = d_candi.numel()
    rots, tras, intr_n = _views(poses, intr, v)
    fa_a = homography_resample(
        feat_all[:, :-1].reshape(b * v, c, h, w).to(torch.float32), rots,
        intr_n)
    rx, ry = sweep_mats(d_candi, rots, tras, intr_n, h, w)
    tmp = torch.einsum("nchw,ndxw->ncdhx", fa_a.to(dtype), rx.to(dtype))
    warped = torch.einsum("ncdhx,ndyh->ncdyx", tmp, ry.to(dtype))
    ref = feat_all[:, -1].to(dtype).repeat_interleave(v, dim=0)
    diff = (warped - ref[:, :, None]).to(torch.float32)
    cost = (diff * diff).sum(dim=1)                          # [N, D, h, w]
    return cost.reshape(b, v, d, h, w).sum(dim=1) / sigma


def _gather_setup(feat_all, d_candi, poses, intr, unit_rays):
    """Shared by the gather forms: (source views' padded flat features
    [N, C, (h+2)(w+2)], tap indices and weights [4, N, D, hw], the
    reference's features [N, C, hw])."""
    b, t, c, h, w = feat_all.shape
    v = t - 1
    f32 = torch.float32
    rots, tras, intr_n = _views(poses, intr, v)
    pix = homography_pixels(
        torch.as_tensor(d_candi, dtype=f32, device=feat_all.device), rots,
        tras, intr_n, unit_rays.to(f32).repeat_interleave(v, dim=0))
    idx, wt = _tap_indices_weights(pix, h, w)
    flat = _pad_flat(feat_all[:, :-1].reshape(b * v, c, h, w).to(f32))
    ref = feat_all[:, -1].reshape(b, c, h * w).to(f32).repeat_interleave(
        v, dim=0)
    return flat, idx, wt, ref


def _gather_cost(flat, idx, wt, ref, b: int, v: int, h: int, w: int,
                 sigma: float):
    acc = 0.0
    for k in range(4):
        acc = acc + fast_take(flat, idx[k]) * wt[k][:, None]  # [N,C,D,hw]
    diff = acc - ref[:, :, None]
    cost = (diff * diff).sum(dim=1)                          # [N, D, hw]
    return cost.reshape(b, v, -1, h, w).sum(dim=1) / sigma


def plane_sweep_volume(feat_all: torch.Tensor, d_candi: torch.Tensor,
                       poses: torch.Tensor, intr: torch.Tensor,
                       unit_rays: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    """The gather cost volume (JAX ``plane_sweep_volume``, L2, vmapped over
    the batch). feat_all [B, T, C, h, w] (last view = reference); poses
    [B, T, 4, 4]; intr [B, 3, 3]; unit_rays [B, 3, h*w]. Returns
    [B, D, h, w] f32."""
    b, t, c, h, w = feat_all.shape
    flat, idx, wt, ref = _gather_setup(feat_all, d_candi, poses, intr,
                                       unit_rays)
    return _gather_cost(flat, idx, wt, ref, b, t - 1, h, w, sigma)


def plane_sweep_and_warp(feat_all: torch.Tensor, feat_raw: torch.Tensor,
                         d_candi: torch.Tensor, poses: torch.Tensor,
                         intr: torch.Tensor, unit_rays: torch.Tensor,
                         sigma: float):
    """The fused gather sweep (JAX ``plane_sweep_and_warp`` vmapped over the
    batch): the source views' cost volume and diagonal warp from one set
    of tap indices; the reference view's warp is ``feat_raw`` itself.

    feat_all [B, T, C1, h, w]; feat_raw [B, T, D, h, w]; poses
    [B, T, 4, 4]; intr [B, 3, 3]; unit_rays [B, 3, h*w]. Returns
    (cost [B, D, h, w] f32, warped [B, T, D, h, w] f32)."""
    b, t, c1, h, w = feat_all.shape
    v = t - 1
    d = feat_raw.shape[2]
    if d != d_candi.numel():
        raise ValueError(f"the diagonal warp needs C == D: {d} feature "
                         f"channels, {d_candi.numel()} depth planes")
    flat, idx, wt, ref = _gather_setup(feat_all, d_candi, poses, intr,
                                       unit_rays)
    cost = _gather_cost(flat, idx, wt, ref, b, v, h, w, sigma)
    flat_r = _pad_flat(feat_raw[:, :-1].reshape(b * v, d, h, w).to(
        torch.float32))
    diag = 0.0
    for k in range(4):      # channel d at plane d's taps: the diagonal
        diag = diag + wt[k] * torch.gather(flat_r, -1, idx[k])
    warped = torch.cat([diag.reshape(b, v, d, h, w),
                        feat_raw[:, -1:].to(torch.float32)], dim=1)
    return cost, warped
