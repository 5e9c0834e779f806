"""sweep_convert: build the training-ready sweep dataset from raw captures
(the port of ``tools/sweep_convert.py``, without OpenCV and without JAX).

For every frame of a raw sweep capture

  <root>/<date>/<drive>/{sweep/*.npy, left_img/*.png, right_img/*.png,
                         nir_img/*.png, lidar/*.bin, calib.json}

it (1) undistorts the 128-plane sweep tensor and the NIR image with the LC
camera's distortion model, (2) projects the velodyne cloud into left /
right / LC depth maps with occlusion filtering and hole filling, (3) warps
the sweep planes into both RGB frames (``data/ilim.lcsweep_to_rgbsweep``)
and (4) writes one ``converted/<index>.npz`` per frame with the keys of
the JAX tool. ``--panel`` renders a UF-debug PNG per frame (matplotlib,
imported only then).

    python -m depthestimation_tpu_torch.sweep_convert --root /data/sweep_data \\
        --drive 2021_03_05_drive_0004_sweep [--frames 0:100] [--out DIR] \\
        [--panel] [--device cuda|cpu]

OpenCV's operations are reproduced bit for bit:

- ``cv2.imread`` + ``cv2.cvtColor(BGR2GRAY)``: ``data/image.read_png``
  (8-bit RGB or gray) and OpenCV's 15-bit fixed-point luma
  (``rgb_to_gray``);
- ``cv2.resize(INTER_AREA)`` by 1/4 and 1/2: box means with OpenCV's
  rounding (``resize_area``);
- ``cv2.undistort(img, K, D)``: ``initUndistortRectifyMap`` with the new K
  equal to K, as ``CV_16SC2`` (every source coordinate quantized to 1/32
  pixel, the bilinear weights taken at the quantized fraction), then
  ``remap`` bilinear with a constant-0 border (``undistort_map``). A
  float map would be off by up to several intensity units. The map's
  taps and weights are built once per (K, D, size, device) and kept
  there (``undistort_taps``); all planes and the NIR image go through
  one batched gather and weighted sum (``remap_torch``) on either
  device. The numpy ``remap_np`` is its oracle in the tests.

The conversion runs on the card unless ``--device cpu`` asks for the CPU;
the depth maps (``data/velodyne``, ``native/kittiops.cpp``) and the
projection run on the host.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

from depthestimation_tpu_torch.data import velodyne
from depthestimation_tpu_torch.data.ilim import lcsweep_to_rgbsweep
from depthestimation_tpu_torch.data.image import read_png

# the LC camera intrinsics / distortion of the capture rig; calib.json can
# override them via "K_lc" / "D_lc"
DEFAULT_K_LC = np.array([[893.074542 / 4, 0, 524.145998 / 4],
                         [0, 893.177518 / 4, 646.766885 / 4],
                         [0, 0, 1]], np.float32)
DEFAULT_D_LC = np.array([-0.033918, 0.027494, -0.001691, -0.001078, 0.0],
                        np.float32)
LC_SIZE = (256, 320)   # (w, h) at the processing scale

#: OpenCV's remap: source coordinates in 1/32 pixel (INTER_BITS = 5)
_INTER_BITS = 5
_TAB = 1 << _INTER_BITS
#: OpenCV's 8-bit BGR2GRAY: 0.299, 0.587, 0.114 in 15-bit fixed point
_GRAY_R, _GRAY_G, _GRAY_B, _GRAY_SHIFT = 9798, 19235, 3735, 15
#: planes a ``remap_np`` pass takes at once (bounds its temporaries)
_NP_CHUNK = 32
#: (K, D, size, device) entries ``undistort_taps`` keeps
_TAPS_KEPT = 8


# -- OpenCV's pieces -------------------------------------------------------

def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2GRAY)`` of the same pixels given as
    RGB (``read_png``'s order): (R 9798 + G 19235 + B 3735 + 2^14) >> 15.
    A gray image is returned as it is (OpenCV reads it as three equal
    channels, whose luma is the value)."""
    if img.ndim == 2:
        return img
    x = img.astype(np.int32)
    y = (x[..., 0] * _GRAY_R + x[..., 1] * _GRAY_G + x[..., 2] * _GRAY_B
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(np.uint8)


def resize_area(img: np.ndarray, factor: int) -> np.ndarray:
    """``cv2.resize(img, None, fx=1/factor, fy=1/factor,
    interpolation=INTER_AREA)`` of a uint8 image ([H, W] or [H, W, C]):
    the output is round(H / factor) x round(W / factor) (half to even); a
    whole block is its sum over factor^2, (sum + 2) >> 2 at factor 2
    (OpenCV's fast path, C = 1, 3, 4), else rounded half to even in f32;
    a block cut by the image's edge is the f32 mean of its pixels."""
    if img.dtype != np.uint8 or factor < 2:
        raise ValueError(f"resize_area takes uint8 images and an integer "
                         f"factor >= 2, got {img.dtype} and {factor}")
    h, w = img.shape[:2]
    dh, dw = round(h / factor), round(w / factor)
    hh, ww = min(h, dh * factor), min(w, dw * factor)
    rest = img.shape[2:]
    buf = np.zeros((dh * factor, dw * factor) + rest, np.int64)
    buf[:hh, :ww] = img[:hh, :ww]
    cnt = np.zeros((dh * factor, dw * factor), np.int64)
    cnt[:hh, :ww] = 1
    sums = buf.reshape((dh, factor, dw, factor) + rest).sum(axis=(1, 3))
    counts = cnt.reshape(dh, factor, dw, factor).sum(axis=(1, 3))
    counts = counts.reshape(counts.shape + (1,) * len(rest))
    area = factor * factor
    if factor == 2 and (not rest or rest[0] in (1, 3, 4)):
        whole = (sums + 2) >> 2
    else:
        whole = np.rint(sums.astype(np.float32) * np.float32(1.0 / area))
    part = np.rint(sums.astype(np.float32)
                   / np.maximum(counts, 1).astype(np.float32))
    out = np.where(counts == area, whole, part)
    return np.clip(out, 0, 255).astype(np.uint8)


def undistort_map(K, D, h: int, w: int) -> tuple:
    """``cv2.initUndistortRectifyMap(K, D, None, K, (w, h), CV_16SC2)``:
    (x0, y0, fx, fy) int64 [h, w] each, the integer source pixel and the
    1/32 fraction of each destination pixel. In double precision as
    OpenCV (K and D taken at their float32 values), the radial, tangential
    and thin-prism terms of up to 12 coefficients."""
    k = np.asarray(K, np.float32).astype(np.float64)
    d = np.zeros(12)
    dist = np.asarray(D, np.float32).astype(np.float64).ravel()
    d[:min(len(dist), 12)] = dist[:12]
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = d
    ir = np.linalg.inv(k)
    j = np.arange(w, dtype=np.float64)[None]
    i = np.arange(h, dtype=np.float64)[:, None]
    x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2 + s3 * r2 + s4 * r2 * r2
    u = k[0, 0] * xd + k[0, 2]
    v = k[1, 1] * yd + k[1, 2]
    iu = np.rint(u * _TAB).astype(np.int64)
    iv = np.rint(v * _TAB).astype(np.int64)
    return iu >> _INTER_BITS, iv >> _INTER_BITS, iu & (_TAB - 1), \
        iv & (_TAB - 1)


def _taps(umap, h: int, w: int):
    """The four bilinear taps of every destination pixel as flat indices
    into the source padded by one zero pixel a side ([4, H'W']; a tap
    outside the padded source reads its zero corner, index 0), and their
    f32 weights ([4, H'W']: OpenCV's 32-entry table, 1 - t and t, their
    products in f32)."""
    x0, y0, fx, fy = (a.reshape(-1) for a in umap)
    idx = []
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
            idx.append(np.where(ok, (yy + 1) * (w + 2) + xx + 1, 0))
    tab = np.arange(_TAB, dtype=np.float32) * np.float32(1.0 / _TAB)
    tx, ty = tab[fx], tab[fy]
    one = np.float32(1)
    wts = [(one - ty) * (one - tx), (one - ty) * tx, ty * (one - tx),
           ty * tx]
    return np.stack(idx), np.stack(wts)


def remap_np(planes: np.ndarray, umap) -> np.ndarray:
    """``cv2.remap(plane, map1, map2, INTER_LINEAR, BORDER_CONSTANT)`` of
    each f32 plane of ``planes`` [N, H, W] with the quantized map of
    ``undistort_map``: ((v00 w00 + v01 w01) + v10 w10) + v11 w11 in f32,
    a tap outside the plane reading 0."""
    planes = np.asarray(planes, np.float32)
    n, h, w = planes.shape
    idx, wts = _taps(umap, h, w)
    out = np.empty((n,) + umap[0].shape, np.float32)
    for s in range(0, n, _NP_CHUNK):
        flat = np.pad(planes[s:s + _NP_CHUNK],
                      ((0, 0), (1, 1), (1, 1))).reshape(-1, (h + 2) * (w + 2))
        v = flat[:, idx]                                   # [n, 4, HW]
        acc = v[:, 0] * wts[0] + v[:, 1] * wts[1]
        acc = acc + v[:, 2] * wts[2]
        acc = acc + v[:, 3] * wts[3]
        out[s:s + _NP_CHUNK] = acc.reshape((-1,) + umap[0].shape)
    return out


@functools.lru_cache(maxsize=_TAPS_KEPT)
def _device_taps(k: bytes, d: bytes, h: int, w: int, device: str):
    k = np.frombuffer(k, np.float32).reshape(3, 3)
    d = np.frombuffer(d, np.float32)
    idx, wts = _taps(undistort_map(k, d, h, w), h, w)
    return (torch.from_numpy(idx.reshape(4, h, w)).to(device),
            torch.from_numpy(wts.reshape(4, h, w)).to(device))


def undistort_taps(K, D, h: int, w: int, device="cuda"):
    """(idx int64, wts f32), [4, h, w] each on ``device``: the taps and
    weights of ``cv2.undistort``'s quantized map at size (h, w), built
    once per (K, D, size, device) and kept."""
    k = np.ascontiguousarray(K, np.float32)
    d = np.ascontiguousarray(D, np.float32).ravel()
    return _device_taps(k.tobytes(), d.tobytes(), int(h), int(w),
                        str(torch.device(device)))


def remap_torch(planes: torch.Tensor, idx: torch.Tensor,
                wts: torch.Tensor) -> torch.Tensor:
    """``remap_np`` of f32 ``planes`` [N, H, W] with the taps of
    ``undistort_taps`` on the planes' device: one gather of the four taps
    of every plane, then the weighted sum in the same order, each product
    and sum its own rounded f32 op (so no fused multiply-add: equal bits
    to ``remap_np``)."""
    if planes.dtype != torch.float32 or planes.dim() != 3:
        raise ValueError(f"remap_torch takes f32 [N, H, W] planes, got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    n = planes.shape[0]
    flat = torch.nn.functional.pad(planes, (1, 1, 1, 1)).reshape(n, -1)
    v = flat[:, idx.reshape(-1)].reshape(n, 4, -1)
    wts = wts.reshape(4, -1)
    acc = v[:, 0] * wts[0] + v[:, 1] * wts[1]
    acc = acc + v[:, 2] * wts[2]
    acc = acc + v[:, 3] * wts[3]
    return acc.reshape((n,) + idx.shape[1:])


def undistort_planes(planes: np.ndarray, K, D, device="cuda") -> np.ndarray:
    """``cv2.undistort`` of every f32 plane of ``planes`` [N, H, W] (one
    quantized map) through ``remap_torch`` on ``device``."""
    idx, wts = undistort_taps(K, D, planes.shape[1], planes.shape[2],
                              device)
    t = torch.from_numpy(np.ascontiguousarray(planes, np.float32))
    return remap_torch(t.to(device), idx, wts).cpu().numpy()


# -- the converter ---------------------------------------------------------

def load_frame(root, drive, idx):
    """One raw frame: the sweep, the scan, the 1/4 RGB images (RGB
    order, where OpenCV gives BGR: only their shapes are used), the NIR
    image in gray at 1/2, and the calibration."""
    date = drive.split("_drive")[0]
    base = os.path.join(root, date, drive)
    s = f"{idx:06d}"
    frame = {}
    frame["sweep_arr"] = np.load(os.path.join(base, "sweep", s + ".npy")) \
        .astype(np.float32)                         # [128, Hlc, Wlc, 2]
    frame["velodata"] = np.fromfile(os.path.join(base, "lidar", s + ".bin"),
                                    dtype=np.float32).reshape(-1, 4)
    frame["left_img"] = resize_area(
        read_png(os.path.join(base, "left_img", s + ".png")), 4)
    frame["right_img"] = resize_area(
        read_png(os.path.join(base, "right_img", s + ".png")), 4)
    nir = rgb_to_gray(read_png(os.path.join(base, "nir_img", s + ".png")))
    frame["nir_img"] = resize_area(nir, 2)

    with open(os.path.join(base, "calib.json")) as f:
        calib = json.load(f)
    intr = np.array(calib["left_P"], np.float32) / 4.0
    intr[2, 2] = 1.0
    frame["large_intr"] = intr[:3, :3]
    frame["M_velo2left"] = np.linalg.inv(
        np.array(calib["left_2_lidar"], np.float32))
    frame["M_left2right"] = np.array(calib["left_2_right"], np.float32)
    frame["M_left2LC"] = np.array(calib["left_2_lc"], np.float32)
    frame["M_right2LC"] = (np.linalg.inv(frame["M_left2right"])
                           @ frame["M_left2LC"])
    frame["M_velo2right"] = frame["M_left2right"] @ frame["M_velo2left"]
    frame["M_velo2LC"] = frame["M_left2LC"] @ frame["M_velo2left"]
    frame["K_lc"] = np.array(calib.get("K_lc", DEFAULT_K_LC), np.float32)
    frame["D_lc"] = np.array(calib.get("D_lc", DEFAULT_D_LC), np.float32)
    return frame


def undistort_frame(frame, device="cuda"):
    """(sweep [128, H, W, 2], NIR [h, w]) undistorted, f32: the 256
    planes, and the NIR image with them when it has their size."""
    K, D = frame["K_lc"], frame["D_lc"]
    sweep = frame["sweep_arr"]
    p, h, w, c = sweep.shape
    planes = np.ascontiguousarray(sweep.transpose(0, 3, 1, 2)).reshape(
        p * c, h, w)
    nir = np.asarray(frame["nir_img"], np.float32)
    if nir.shape == (h, w):
        both = undistort_planes(np.concatenate([planes, nir[None]]), K, D,
                                device)
        planes, nir = both[:-1], both[-1]
    else:
        planes = undistort_planes(planes, K, D, device)
        nir = undistort_planes(nir[None], K, D, device)[0]
    return planes.reshape(p, c, h, w).transpose(0, 2, 3, 1), nir


def depth_maps(frame, lc_size=LC_SIZE):
    """(left, right, LC) depth maps of the scan, occlusion-filtered and
    hole-filled, at the RGB images' and the LC camera's processing size."""
    h, w = frame["left_img"].shape[:2]
    params = {"filtering": 2, "upsample": 0}
    intr34 = np.concatenate([frame["large_intr"],
                             np.zeros((3, 1), np.float32)], 1)
    k_lc34 = np.concatenate([frame["K_lc"], np.zeros((3, 1), np.float32)], 1)
    left = velodyne.generate_depth(frame["velodata"], intr34,
                                   frame["M_velo2left"], w, h, params)
    right = velodyne.generate_depth(frame["velodata"], intr34,
                                    frame["M_velo2right"], w, h, params)
    lc = velodyne.generate_depth(frame["velodata"], k_lc34,
                                 frame["M_velo2LC"], lc_size[0], lc_size[1],
                                 params)
    return tuple(velodyne.upsample_depth(d, 2, 0.5)
                 for d in (left, right, lc))


def project(frame, und, nir, left_depth, right_depth, lc_size=LC_SIZE):
    """The sweep warped into both RGB frames: the npz's per-side keys."""
    h, w = frame["left_img"].shape[:2]
    out = {}
    for side, m in (("left", frame["M_left2LC"]),
                    ("right", frame["M_right2LC"])):
        dmap = left_depth if side == "left" else right_depth
        fi, fz, mask, train_mask, nir_t = lcsweep_to_rgbsweep(
            und, dmap, frame["large_intr"], (w, h), frame["K_lc"], lc_size,
            m, nir_img=nir if side == "left" else None)
        out[f"{side}_feat_int"] = fi.astype(np.float32)
        out[f"{side}_feat_z"] = fz.astype(np.float32)
        out[f"{side}_mask"] = mask.astype(np.float32)
        out[f"{side}_train_mask"] = train_mask.astype(np.float32)
        if side == "left":
            out["nir_warped"] = nir_t.astype(np.float32)
    return out


def convert_frame(frame, lc_size=LC_SIZE, device="cuda"):
    """Raw frame dict -> converted tensors (both camera sides)."""
    # 1. undistort sweep planes + NIR in the LC frame
    und, nir = undistort_frame(frame, device)
    # 2. velodyne -> depth maps with occlusion filtering + hole filling
    left_depth, right_depth, lc_depth = depth_maps(frame, lc_size)
    # 3. project the sweep into both RGB frames
    out = {"left_depth": left_depth, "right_depth": right_depth,
           "lc_depth": lc_depth, "nir_img": nir,
           "sweep_arr": und.astype(np.float32)}
    out.update(project(frame, und, nir, left_depth, right_depth, lc_size))
    return out


def render_panel(out, path):
    """UF debug panel (left depth, LC depth, the sweep's peak intensity in
    the left frame, the warped NIR image)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    axes[0, 0].imshow(out["left_depth"], cmap="turbo")
    axes[0, 0].set_title("left depth")
    axes[0, 1].imshow(out["lc_depth"], cmap="turbo")
    axes[0, 1].set_title("LC depth")
    peak = np.nanmax(out["left_feat_int"], axis=0)
    axes[1, 0].imshow(peak, cmap="gray")
    axes[1, 0].set_title("sweep peak intensity (left frame)")
    axes[1, 1].imshow(out["nir_warped"][0], cmap="gray")
    axes[1, 1].set_title("warped NIR")
    for ax in axes.flat:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)


def main(argv=None, device="cuda"):
    """Convert the drive's frames; returns the indices converted."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--drive", required=True)
    ap.add_argument("--frames", default=None,
                    help="start:end frame range (default: all found)")
    ap.add_argument("--out", default=None,
                    help="output dir (default <drive>/converted)")
    ap.add_argument("--panel", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = args.device or device

    date = args.drive.split("_drive")[0]
    base = os.path.join(args.root, date, args.drive)
    sweep_dir = os.path.join(base, "sweep")
    indices = sorted(int(f.split(".")[0]) for f in os.listdir(sweep_dir)
                     if f.endswith(".npy"))
    if args.frames:
        lo, hi = (int(x) for x in args.frames.split(":"))
        indices = [i for i in indices if lo <= i < hi]

    out_dir = args.out or os.path.join(base, "converted")
    os.makedirs(out_dir, exist_ok=True)
    for idx in indices:
        frame = load_frame(args.root, args.drive, idx)
        out = convert_frame(frame, device=device)
        np.savez_compressed(os.path.join(out_dir, f"{idx:06d}.npz"), **out)
        if args.panel:
            render_panel(out, os.path.join(out_dir, f"{idx:06d}.png"))
        print(f"converted frame {idx} -> {out_dir}/{idx:06d}.npz")
    print(f"done: {len(indices)} frames")
    return indices


if __name__ == "__main__":
    main()
