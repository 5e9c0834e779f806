"""Plain f32 reference of the exp7 / exp7_lc depth network, train mode.

Written from the model's equations, not from the port's code paths: every
2D conv is ``F.conv2d``, every BatchNorm takes batch statistics (``E[x]``
and the biased variance, eps 1e-5), Base3D is ``F.conv3d`` on the 5-D
volume ``[B, C, D, h, w]``, and the plane sweep is the two-stage
decomposed form (a homography resample by ``K R K^-1``, then per depth a
separable bilinear resample by banded matrices) as dense f32 einsums.
The module tree and parameter names are those of the port's
``BaseModelNet``, so one state dict made by the benchmark loads into
both. TF32 is off for everything here (``no_tf32``).

In a process group of more than one rank, BatchNorm takes the statistics
of the global batch (the sums all-reduced, differentiably), as the
data-parallel step does.

Memory: a whole side's forward runs under activation checkpointing, and
so does each Base3D layer, so the backward recomputes one side at a time.
The random draws (the ``prev_lc`` drop) happen outside, in
``forward_side``'s caller, so a recompute never draws again.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ref.resample import fast_take


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _world() -> int:
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def batch_norm(x, weight, bias, eps=1e-5):
    """Batch statistics over every axis but 1 (the global batch's in a
    group of more than one rank)."""
    if _world() == 1:
        return F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)
    from torch.distributed.nn.functional import all_reduce
    dims = (0,) + tuple(range(2, x.dim()))
    n = torch.tensor(float(x.numel() // x.shape[1]), device=x.device)
    sums = all_reduce(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                                 n[None]]))
    c = x.shape[1]
    count = sums[-1]
    mean = sums[:c] / count
    var = torch.clamp(sums[c:2 * c] / count - mean * mean, min=0.0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    a = weight * torch.rsqrt(var + eps)
    return x * a.reshape(shape) + (bias - mean * a).reshape(shape)


def leaky(x, slope=0.01):
    return F.leaky_relu(x, slope)


def fp8(x):
    """x rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at the format's 448): the control's operand precision. The
    gradient passes the rounding straight through, so the backward's
    products take the rounded operands the forward saved."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    r = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (r - x.detach())


class LowP(nn.Module):
    """A module whose products may take fp8 operands (``lowp``)."""
    lowp = False

    def q(self, x):
        return fp8(x) if self.lowp else x


class Conv(LowP):
    def __init__(self, cin, cout, k, stride=1, pad=0, dil=1, bias=True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, k, stride, pad, dil, bias=bias)

    def forward(self, x):
        c = self.Conv_0
        return F.conv2d(self.q(x), self.q(c.weight), c.bias, c.stride,
                        c.padding, c.dilation)


class BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride, pad, dil=1):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, stride, dil if dil > 1 else pad,
                           dil, bias=False)
        self.BatchNorm_0 = BN(cout)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride, dil, downsample):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, cout, 3, stride, 1, dil)
        self.ConvBN_1 = ConvBN(cout, cout, 3, 1, 1, dil)
        self.downsample = downsample
        if downsample:
            self.Conv_0 = Conv(cin, cout, 1, stride, 0, bias=False)
            self.BatchNorm_0 = BN(cout)

    def forward(self, x):
        out = self.ConvBN_1(torch.relu(self.ConvBN_0(x)))
        if self.downsample:
            x = self.BatchNorm_0(self.Conv_0(x))
        return out + x


class Stage(nn.Module):
    def __init__(self, cin, cout, blocks, stride, dil):
        super().__init__()
        ds = stride != 1 or cin != cout
        self.n = blocks
        for i in range(blocks):
            self.add_module(f"BasicBlock_{i}", BasicBlock(
                cin if i == 0 else cout, cout, stride if i == 0 else 1, dil,
                ds and i == 0))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return x


def resize_align_corners(x, hw):
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


class Encoder(nn.Module):
    """PSMNet-style: a stride-2 stem, four residual stages (the last
    dilated), four pyramid-pooling branches, a 3x3 ConvBN and a 1x1 head."""

    def __init__(self, fd=64):
        super().__init__()
        m = fd / 64.0
        s0, s1, s2, s3 = int(16 * m), int(32 * m), int(64 * m), int(128 * m)
        for i, stride in enumerate((2, 1, 1)):
            self.add_module(f"ConvBN_{i}",
                            ConvBN(3 if i == 0 else s1, s1, 3, stride, 1))
        self._Stage_0 = Stage(s1, s1, 3, 1, 1)
        self._Stage_1 = Stage(s1, s2, s0, 2, 1)
        self._Stage_2 = Stage(s2, s3, 3, 1, 1)
        self._Stage_3 = Stage(s3, s3, 3, 1, 2)
        for i in range(4):
            self.add_module(f"ConvBN_{3 + i}", ConvBN(s3, s1, 1, 1, 0))
        self.ConvBN_7 = ConvBN(s2 + s3 + 4 * s1, s3, 3, 1, 1)
        self.Conv_0 = Conv(s3, fd, 1, 1, 0, bias=False)

    def forward(self, x):
        for i in range(3):
            x = torch.relu(getattr(self, f"ConvBN_{i}")(x))
        out1 = self._Stage_0(x)
        raw = self._Stage_1(out1)
        skip = self._Stage_3(self._Stage_2(raw))
        h, w = skip.shape[-2:]
        branches = []
        for i, win in enumerate((64, 32, 16, 8)):
            k = min(win, h, w)
            b = torch.relu(getattr(self, f"ConvBN_{3 + i}")(
                F.avg_pool2d(skip, k, k)))
            branches.append(resize_align_corners(b, (h, w)))
        feat = torch.cat([raw, skip] + branches[::-1], dim=1)
        return out1, raw, self.Conv_0(torch.relu(self.ConvBN_7(feat)))


class Conv3dW(LowP):
    """Holds a [F, C, 3, 3, 3] weight under the port's name."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))

    def forward(self, x):
        return F.conv3d(self.q(x), self.q(self.weight), padding=1)


class ConvBN3d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv3d_0 = Conv3dW(cin, cout)
        self.BatchNorm_0 = BN(cout)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv3d_0(x))


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


class Base3D(nn.Module):
    """Seven 3x3x3 ConvBN layers (two residual pairs) and a 3x3x3
    classifier to one channel, on [B, C, D, h, w]."""

    def __init__(self, cin, fd=32, dres=2):
        super().__init__()
        self.dres = dres
        for i in range(2 + 2 * dres + 1):
            self.add_module(f"ConvBN3d_{i}",
                            ConvBN3d(cin if i == 0 else fd, fd))
        self.Conv3d_0 = Conv3dW(fd, 1)

    def _relu_layer(self, i, x):
        return torch.relu(getattr(self, f"ConvBN3d_{i}")(x))

    def forward(self, vol):
        x = _ckpt(self._relu_layer, 0, vol)
        x = _ckpt(self._relu_layer, 1, x)
        i = 2
        for _ in range(self.dres):
            y = _ckpt(self._relu_layer, i, x)
            x = _ckpt(getattr(self, f"ConvBN3d_{i + 1}"), y) + x
            i += 2
        x = _ckpt(self._relu_layer, i, x)
        return _ckpt(self.Conv3d_0, x)[:, 0]


class ConvT(LowP):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias,
                                  2, 1)


class Decoder(nn.Module):
    def __init__(self, d, cq, ch, cf=3):
        super().__init__()
        c0, c1, c2 = d + cq, d + ch, d + cf
        self.Conv_0 = Conv(c0, c0, 3, 1, 1)
        self.Conv_1 = Conv(c0, c0, 3, 1, 1)
        self.ConvTranspose_0 = ConvT(c0, d)
        self.Conv_2 = Conv(c1, c1, 3, 1, 1)
        self.Conv_3 = Conv(c1, c1, 3, 1, 1)
        self.ConvTranspose_1 = ConvT(c1, d)
        self.Conv_4 = Conv(c2, c2, 3, 1, 1)
        self.Conv_5 = Conv(c2, d, 3, 1, 1)
        self.Conv_6 = Conv(d, d, 3, 1, 1)

    def forward(self, dpv, fq, fh, rgb):
        x = torch.cat([dpv, fq], 1)
        x = leaky(self.Conv_1(leaky(self.Conv_0(x))))
        x = torch.cat([leaky(self.ConvTranspose_0(x)), fh], 1)
        x = leaky(self.Conv_3(leaky(self.Conv_2(x))))
        x = torch.cat([leaky(self.ConvTranspose_1(x)), rgb], 1)
        x = self.Conv_6(leaky(self.Conv_5(leaky(self.Conv_4(x)))))
        return torch.log_softmax(x, 1)


# -- the plane sweep: homography resample, then banded matrices ----------

def _bilinear_pad(img, pix):
    """img [N, C, H, W] sampled at pix [N, P, 2] (x, y array coords),
    zero outside -> [N, C, P]."""
    n, c, h, w = img.shape
    wp = w + 2
    flat = F.pad(img, (1, 1, 1, 1)).reshape(n, c, (h + 2) * wp)
    x, y = pix[..., 0], pix[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0.0
    for xi, yi, wt in ((x0, y0, (1 - fx) * (1 - fy)),
                       (x0 + 1, y0, fx * (1 - fy)),
                       (x0, y0 + 1, (1 - fx) * fy),
                       (x0 + 1, y0 + 1, fx * fy)):
        ok = (xi >= -1) & (xi <= w) & (yi >= -1) & (yi <= h)
        idx = (torch.clamp(yi + 1, 0, h + 1).long() * wp
               + torch.clamp(xi + 1, 0, wp - 1).long())
        out = out + fast_take(flat, idx) * torch.where(ok, wt, 0.0)[:, None]
    return out


def homography_resample(feat, rot, intr):
    """Resample feat [N, C, H, W] by A = K R K^-1 onto the reference grid."""
    n, c, h, w = feat.shape
    dev = feat.device
    fx, fy = intr[:, 0, 0], intr[:, 1, 1]
    cx, cy = intr[:, 0, 2], intr[:, 1, 2]
    k_inv = torch.zeros(n, 3, 3, device=dev)
    k_inv[:, 0, 0], k_inv[:, 0, 2] = 1.0 / fx, -cx / fx
    k_inv[:, 1, 1], k_inv[:, 1, 2] = 1.0 / fy, -cy / fy
    k_inv[:, 2, 2] = 1.0
    a = intr @ rot @ k_inv
    u = torch.arange(w, device=dev)[None] + 0.5 + (cx - 0.5 * w)[:, None]
    v = torch.arange(h, device=dev)[None] + 0.5 + (cy - 0.5 * h)[:, None]
    grid = torch.stack([u[:, None, :].expand(n, h, w),
                        v[:, :, None].expand(n, h, w),
                        torch.ones(n, h, w, device=dev)], 1)
    q = torch.einsum("nij,njhw->nihw", a, grid)
    q = q / (q[:, 2:3] + 1e-10)
    pix = torch.stack([q[:, 0] - 0.5, q[:, 1] - 0.5], -1).reshape(n, h * w, 2)
    return _bilinear_pad(feat, pix).reshape(n, c, h, w)


def band_mats(d_candi, rot, tra, intr, h, w):
    """Per-depth bilinear resample matrices of the fronto-parallel plane
    sweep: (Rx [N, D, W, W], Ry [N, D, H, H])."""
    m = (intr @ (rot.transpose(-1, -2) @ tra[..., None]))[..., 0]
    d = d_candi[None]
    denom = 1.0 + m[:, 2:3] / d
    inv = torch.where(denom.abs() > 1e-10, 1.0 / denom,
                      torch.full_like(denom, 1e12))

    def band(size, off, delta):
        i = torch.arange(size, dtype=torch.float32, device=d.device)
        a = ((i[None, None] + 0.5 + delta[:, None, None] + off[:, :, None])
             * inv[:, :, None] - 0.5 - delta[:, None, None])
        return torch.clamp(1.0 - (a[..., None] - i).abs(), min=0.0)

    return (band(w, m[:, 0:1] / d, intr[:, 0, 2] - 0.5 * w),
            band(h, m[:, 1:2] / d, intr[:, 1, 2] - 0.5 * h))


def _stage2(fa, ref, fr, rx, ry, q):
    fa, ref, fr, rx, ry = q(fa), q(ref), q(fr), q(rx), q(ry)
    warped = torch.einsum("ndyh,ndchx->ndcyx", ry,
                          torch.einsum("nchw,ndxw->ndchx", fa, rx))
    diff = warped - ref[:, None]
    cost = (diff * diff).sum(2)
    diag = torch.einsum("ndyh,ndhx->ndyx", ry,
                        torch.einsum("ndhw,ndxw->ndhx", fr, rx))
    return cost, diag


def plane_sweep(feat_all, feat_raw, d_candi, poses, intr, sigma, q):
    """(cost [B, D, h, w], warped [B, T, D, h, w]); the last view is the
    reference."""
    b, t, c1, h, w = feat_all.shape
    v, d = t - 1, feat_raw.shape[2]
    n = b * v
    rot = poses[:, :-1, :3, :3].reshape(n, 3, 3)
    tra = poses[:, :-1, :3, 3].reshape(n, 3)
    intr_n = intr.repeat_interleave(v, 0)
    fa = homography_resample(feat_all[:, :-1].reshape(n, c1, h, w), rot,
                             intr_n)
    fr = homography_resample(feat_raw[:, :-1].reshape(n, d, h, w), rot,
                             intr_n)
    rx, ry = band_mats(d_candi, rot, tra, intr_n, h, w)
    ref = feat_all[:, -1].repeat_interleave(v, 0)
    cost, diag = _ckpt(_stage2, fa, ref, fr, rx, ry, q)
    cost = cost.reshape(b, v, d, h, w).sum(1) / sigma
    return cost, torch.cat([diag.reshape(b, v, d, h, w), feat_raw[:, -1:]], 1)


class RefNet(LowP):
    """exp7 / exp7_lc: encoder -> plane sweep -> BV head -> Base3D over
    [bv, prev_output, (prev_lc), warped views] -> residual + log_softmax ->
    decoder. Returns the port's output dict."""

    def __init__(self, fd=64, d=64, nmode="exp7", n_views=2, sigma=10.0,
                 lowp: bool = False):
        super().__init__()
        if nmode not in ("exp7", "exp7_lc"):
            raise ValueError(f"the reference has nmodes exp7, exp7_lc: "
                             f"{nmode!r}")
        self.nmode, self.d, self.sigma = nmode, d, sigma
        self.base_encoder = Encoder(fd)
        self.base_decoder = Decoder(d, fd, int(32 * fd / 64.0))
        self.conv0 = Conv(d, d, 3, 1, 1)
        self.conv0_1 = Conv(d, d, 3, 1, 1)
        self.conv0_2 = Conv(d, d, 3, 1, 1)
        self.based_3d = Base3D((3 if nmode == "exp7_lc" else 2) + n_views)
        for m in self.modules():
            if isinstance(m, LowP):
                m.lowp = lowp

    def _side(self, rgb, poses, intr, d_candi, prev_output, prev_lc):
        b, t = rgb.shape[:2]
        x = rgb.reshape((b * t,) + rgb.shape[2:])
        feat1, raw, feat = self.base_encoder(x)
        img = F.avg_pool2d(x, x.shape[-2] // feat.shape[-2])
        feat_all = torch.cat([feat, img], 1)
        split = (lambda y: y.reshape((b, t) + y.shape[1:]))
        feat1, raw, feat_all = split(feat1), split(raw), split(feat_all)
        cost, warped = plane_sweep(feat_all, raw, d_candi, poses, intr,
                                   self.sigma, self.q)
        bv = torch.log_softmax(self.conv0_2(leaky(self.conv0_1(leaky(
            self.conv0(cost))))), 1)
        planes = [bv[:, None], prev_output[:, None]]
        if self.nmode == "exp7_lc":
            planes.append(prev_lc[:, None])
        vol = torch.cat(planes + [warped], 1)
        bv_upd = torch.log_softmax(bv + self.based_3d(vol), 1)
        refined = self.base_decoder(torch.exp(bv_upd), feat_all[:, -1, :-3],
                                    feat1[:, -1], rgb[:, -1])
        return bv, bv_upd, refined

    def forward_side(self, mi, prev_output, prev_lc):
        """One camera side; ``prev_output`` / ``prev_lc`` already resolved
        (the uniform defaults and the drop applied by the caller)."""
        d_candi = torch.as_tensor(mi["d_candi"], dtype=torch.float32,
                                  device=mi["rgb"].device)
        if prev_lc is None:
            prev_lc = prev_output
        with no_tf32():
            bv, bv_upd, refined = _ckpt(
                self._side, mi["rgb"], mi["src_cam_poses"], mi["intrinsics"],
                d_candi, prev_output, prev_lc)
        return {"output": [bv, bv_upd], "output_refined": [refined]}

    def uniform(self, like, log: bool):
        v = math.log(1.0 / self.d) if log else 1.0 / self.d
        return torch.full_like(like, v)
