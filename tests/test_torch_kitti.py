"""The port's real-data path against the JAX package, on fixture trees the
test writes (the shapes of tests/test_data.py ``_write_mini_kitti``): two
KITTI raw drives and an ILIM sweep drive.

- ``data/image.py`` against Pillow: PNGs written by hand with each of the
  five row filters and Pillow's own files, gray and RGB, decoded EQUAL;
  ``resize_bilinear`` EQUAL to ``Image.resize(..., BILINEAR)`` at KITTI's
  ratio (1242x375 -> 768x256 and small multiples), at an upscale and at
  odd sizes; ``rgb_to_l`` EQUAL to ``.convert("L")``; the PNG types it
  does not read (palette, 16-bit, gray+alpha, RGBA, interlaced) and a bad
  filter byte raise ``ValueError`` naming them.
- ``data/velodyne.py``: the native backend against the numpy one, each op
  (the tolerances of tests/test_data.py: equal where the two do the same
  f32 arithmetic, 1e-5 / 1e-4 for the polar densification's trig).
- ``KittiVideoDataset.frame`` and ``IlimVideoDataset.frame`` against
  JAX's, key by key: RGB EQUAL (the resize reproduces Pillow's), depth
  maps and masks EQUAL, poses, intrinsics and rays within 1e-6; a broken
  frame comes back ``{"success": False}`` on both sides; a native library
  that does not build and a PNG type that is not read raise instead, from
  the dataset, its loader and the CLI.
- The scheduler's batches and ``assemble_inputs`` equal to JAX's;
  ``lcsweep_to_rgbsweep`` against JAX's.
- ``train.build_loaders`` picks the dataset JAX's CLI picks, and the CLI
  (``main(..., device="cpu")``) trains two steps on the KITTI tree and on
  the ILIM tree at ``configs/test_tiny.json``'s widths (torch only).
"""

import io
import json
import os
import re
import struct
import zlib

import numpy as np
import PIL.Image as Image
import pytest
import torch

import train as jtrain
from depthestimation_tpu.config import config_from_dict as jcfg_from
from depthestimation_tpu.data import ilim as jilim
from depthestimation_tpu.data import kitti as jkitti
from depthestimation_tpu.data.scheduler import BatchScheduler as JSched
from depthestimation_tpu.data.video_synthetic import (
    assemble_inputs as jassemble)
from depthestimation_tpu_torch import train as ttrain
from depthestimation_tpu_torch.config import config_from_dict, load_config
from depthestimation_tpu_torch.data import ilim, image, kitti, velodyne
from depthestimation_tpu_torch.data.scheduler import BatchScheduler
from depthestimation_tpu_torch.data.video_synthetic import assemble_inputs
from depthestimation_tpu_torch.native import kittiops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_W, RAW_H = 310, 94          # KITTI's 1242x375 over 4
LC_W, LC_H = 20, 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- PNGs


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png(img: np.ndarray, filt, ctype=None, depth=8, interlace=0) -> bytes:
    """A PNG of uint8 ``img`` whose rows all take filter ``filt`` (0..4),
    or row i filter ``filt[i % len(filt)]``."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2}[ch] if ctype is None else ctype
    rows = img.reshape(h, w * ch).astype(np.int32)
    filts = filt if isinstance(filt, (list, tuple)) else [filt]
    raw = bytearray()
    for y in range(h):
        f = filts[y % len(filts)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


def _pillow_png(img) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        buf, "PNG")
    return buf.getvalue()


def _texture(rng, h, w, ch):
    shape = (h, w) if ch == 1 else (h, w, ch)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("ch", [1, 3])
def test_png_decode_matches_pillow(ch):
    rng = np.random.default_rng(ch)
    img = _texture(rng, 23, 37, ch)
    for filt in (0, 1, 2, 3, 4, [4, 3, 2, 1, 0]):
        data = _png(img, filt)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), img)
        np.testing.assert_array_equal(image.decode_png(data), img)
    smooth = np.cumsum(img.astype(np.int32), axis=1).astype(np.uint8)
    for a in (img, smooth):
        np.testing.assert_array_equal(image.decode_png(_pillow_png(a)), a)


def test_png_types_not_read_raise(tmp_path):
    rng = np.random.default_rng(0)
    rgb = _texture(rng, 8, 9, 3)
    cases = {
        "palette": _pillow_png(Image.fromarray(rgb).convert("P")),
        "RGBA": _pillow_png(Image.fromarray(rgb).convert("RGBA")),
        "gray+alpha": _pillow_png(Image.fromarray(rgb).convert("LA")),
        "16-bit": _pillow_png(Image.fromarray(
            rng.integers(0, 65535, (8, 9)).astype(np.uint16))),
        "interlaced": _png(rgb, 0, interlace=1),
    }
    for name, data in cases.items():
        with pytest.raises(ValueError, match=re.escape(name)):
            image.decode_png(data)
    with pytest.raises(ValueError, match="filter type 7"):
        body = bytearray(b"\x00" + rgb[0].tobytes()) * rgb.shape[0]
        body[(rgb.shape[1] * 3 + 1) * 2] = 7
        ihdr = struct.pack(">IIBBBBB", 9, 8, 8, 2, 0, 0, 0)
        image.decode_png(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                         + _chunk(b"IDAT", zlib.compress(bytes(body)))
                         + _chunk(b"IEND", b""))
    path = tmp_path / "x.png"
    path.write_bytes(_pillow_png(rgb))
    assert image.png_size(str(path)) == Image.open(path).size


@pytest.mark.parametrize("src,dst", [
    ((1242, 375), (768, 256)), ((310, 94), (192, 64)), ((621, 187), (384, 128)),
    ((37, 23), (101, 80)), ((31, 20), (7, 5)), ((23, 17), (17, 23)),
    ((10, 10), (10, 20))])
@pytest.mark.parametrize("ch", [1, 3])
def test_resize_matches_pillow(src, dst, ch):
    rng = np.random.default_rng(src[0] + ch)
    img = _texture(rng, src[1], src[0], ch)
    smooth = np.cumsum(img.astype(np.int32), axis=0).astype(np.uint8)
    for a in (img, smooth):
        want = np.asarray(Image.fromarray(a).resize(dst, Image.BILINEAR))
        np.testing.assert_array_equal(image.resize_bilinear(a, dst), want)


def test_rgb_to_l_matches_pillow():
    rgb = _texture(np.random.default_rng(5), 31, 45, 3)
    np.testing.assert_array_equal(
        image.rgb_to_l(rgb), np.asarray(Image.fromarray(rgb).convert("L")))
    gray = rgb[..., 0]
    np.testing.assert_array_equal(image.rgb_to_l(gray), gray)


# ----------------------------------------------------------- velodyne


def _cloud(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.ones((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-10, 10, n)
    pts[:, 1] = rng.uniform(-2, 2, n)
    pts[:, 2] = rng.uniform(2, 40, n)
    return pts


INTR = np.array([[60, 0, 48, 0], [0, 60, 32, 0], [0, 0, 1, 0]], np.float32)


def test_velodyne_native_matches_numpy():
    for params in ({"filtering": 0}, {"filtering": 2, "filterdiff": 1.0}):
        args = (_cloud(), INTR, np.eye(4), 96, 64, params)
        np.testing.assert_array_equal(
            velodyne.generate_depth(*args),
            velodyne.generate_depth(*args, backend="numpy"))
    d = velodyne.generate_depth(_cloud(), INTR, np.eye(4), 96, 64,
                                {"filtering": 0})
    np.testing.assert_allclose(velodyne.upsample_depth(d, 2, 1.0),
                               velodyne.upsample_depth(d, 2, 1.0, "numpy"),
                               rtol=1e-6, atol=1e-6)
    # points near the polar bins' centres, as tests/test_data.py places them
    params = {"upsample": 2.0, "total_vbeams": 32, "total_hbeams": 96,
              "vbeam_fov": 0.4, "hbeam_fov": 0.5, "filtering": 1}
    rng = np.random.default_rng(7)
    n, vb, hb = 4000, 32, 96
    pb, tb = rng.integers(0, vb, n), rng.integers(0, hb, n)
    phi = (pb - vb / 2 + 0.5 + rng.uniform(-0.3, 0.3, n)) * 0.4 + 10.0
    theta = (tb - hb / 2 + 0.5 + rng.uniform(-0.3, 0.3, n)) * 0.5
    r = rng.uniform(2.0, 40.0, n)
    pts = np.ones((n, 4), np.float32)
    pts[:, 1] = r * np.sin(np.radians(phi))
    rc = r * np.cos(np.radians(phi))
    pts[:, 0] = rc * np.sin(np.radians(theta))
    pts[:, 2] = rc * np.cos(np.radians(theta))
    np.testing.assert_allclose(velodyne.upsample_velodyne(pts, params),
                               velodyne.upsample_velodyne_np(pts, params),
                               rtol=1e-5, atol=1e-4)
    up = velodyne.generate_depth(pts, INTR, np.eye(4), 96, 64, params)
    up_np = velodyne.generate_depth(pts, INTR, np.eye(4), 96, 64, params,
                                    backend="numpy")
    assert (up > 0).sum() > 100
    assert np.mean(up == up_np) > 0.99
    # the sweep gather
    planes = 16
    proj = np.zeros((500, 3), np.float32)
    proj[:, 0] = rng.uniform(-2, LC_W + 2, 500)
    proj[:, 1] = rng.uniform(-2, LC_H + 2, 500)
    proj[:, 2] = rng.uniform(0.0, 25.0, 500)
    proj[::17, 2] = 0.0
    s_int = rng.random((planes, LC_H, LC_W)).astype(np.float32)
    s_z = rng.uniform(1, 20, (planes, LC_H, LC_W)).astype(np.float32)
    s_z[0].ravel()[rng.integers(0, LC_H * LC_W, 30)] = np.nan
    nir = rng.random((LC_H, LC_W)).astype(np.float32)
    got = velodyne.lc_generate(proj, s_int, s_z, LC_W, LC_H, nir)
    want = velodyne.lc_generate(proj, s_int, s_z, LC_W, LC_H, nir, "numpy")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[2].sum() > 10
    with pytest.raises(ValueError, match="backend"):
        velodyne.lc_generate(proj, s_int, s_z, LC_W, LC_H, nir, "cv2")


# ------------------------------------------------------------- fixtures


def _smooth_rgb(rng, h, w):
    """A smooth texture (so its PNG stays small) with some noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 6, 3)
    base = np.stack([np.sin(x / 9 + ph[0]) + np.cos(y / 7 + ph[1]),
                     np.sin((x + y) / 13 + ph[2]),
                     np.cos(x / 5 - y / 11)], axis=-1)
    img = 127 + 50 * base + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_kitti(root: str, drives=("0001", "0002"), frames: int = 2):
    date = "2011_09_26"
    os.makedirs(os.path.join(root, date), exist_ok=True)
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n")
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        for cam, bl in (("02", 44.0), ("03", -337.0)):
            f.write(f"S_rect_{cam}: {RAW_W}.0 {RAW_H}.0\n")
            f.write(f"P_rect_{cam}: 180.3 0 151.2 {bl} 0 180.3 43.9 0.2 "
                    "0 0 1 0.003\n")
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: -0.004 -0.076 -0.27\n")
    with open(os.path.join(root, date, "calib_imu_to_velo.txt"), "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: -0.81 0.32 -0.80\n")
    rng = np.random.default_rng(0)
    for k, drive in enumerate(drives):
        dpath = os.path.join(root, date, f"{date}_drive_{drive}_sync")
        for sub in ("image_02/data", "image_03/data",
                    "velodyne_points/data", "oxts/data"):
            os.makedirs(os.path.join(dpath, sub), exist_ok=True)
        for t in range(frames):
            for cam in ("02", "03"):
                Image.fromarray(_smooth_rgb(rng, RAW_H, RAW_W)).save(
                    os.path.join(dpath, f"image_{cam}", "data",
                                 f"{t:010d}.png"))
            # lidar frame: x forward, y left, z up
            n = 6000
            pts = np.ones((n, 4), np.float32)
            pts[:, 0] = rng.uniform(3, 40, n)
            pts[:, 1] = rng.uniform(-12, 12, n)
            pts[:, 2] = rng.uniform(-1.7, 1.5, n)
            pts[:, 3] = rng.uniform(0, 1, n)       # reflectance
            pts.tofile(os.path.join(dpath, "velodyne_points", "data",
                                    f"{t:010d}.bin"))
            oxts = np.zeros(30)
            oxts[0], oxts[1], oxts[2] = 49.01, 8.43 + k * 1e-3 + t * 1e-5, 116
            oxts[5] = 0.3 + 0.01 * t
            np.savetxt(os.path.join(dpath, "oxts", "data", f"{t:010d}.txt"),
                       oxts)
    split = os.path.join(root, "split_k")
    os.makedirs(split, exist_ok=True)
    for name in ("training.txt", "testing.txt"):
        with open(os.path.join(split, name), "w") as f:
            f.write("# drives\n" + "".join(
                f"{date}_drive_{d}_sync\n" for d in drives))
    return split


def write_ilim(root: str, drives=("0003", "0004"), frames: int = 2):
    date = "2021_02_25"
    rng = np.random.default_rng(1)
    for drive in drives:
        dpath = os.path.join(root, date, f"{date}_drive_{drive}_sweep")
        for sub in ("left_img", "right_img", "lidar", "sweep", "nir_img"):
            os.makedirs(os.path.join(dpath, sub), exist_ok=True)
        left_2_lidar = np.eye(4)
        left_2_lidar[:3, 3] = [0.1, -0.05, 0.02]
        left_2_right = np.eye(4)
        left_2_right[0, 3] = -0.2
        p = [[150.0, 0, 80.0, 0], [0, 150.0, 48.0, 0], [0, 0, 1, 0]]
        json.dump({"left_2_lidar": left_2_lidar.tolist(),
                   "left_2_right": left_2_right.tolist(),
                   "left_P": p, "right_P": p},
                  open(os.path.join(dpath, "calib.json"), "w"))
        for t in range(frames):
            for sub in ("left_img", "right_img"):
                Image.fromarray(_smooth_rgb(rng, 96, 160)).save(
                    os.path.join(dpath, sub, f"{t:06d}.png"))
            n = 5000
            pts = np.ones((n, 4), np.float32)    # camera-like lidar frame
            pts[:, 0] = rng.uniform(-8, 8, n)
            pts[:, 1] = rng.uniform(-2, 2, n)
            pts[:, 2] = rng.uniform(3, 30, n)
            pts.tofile(os.path.join(dpath, "lidar", f"{t:06d}.bin"))
            sweep = np.stack([rng.uniform(1, 20, (128, LC_H, LC_W)),
                              rng.random((128, LC_H, LC_W))], -1)
            np.save(os.path.join(dpath, "sweep", f"{t:06d}.npy"),
                    sweep.astype(np.float32))
            Image.fromarray(_smooth_rgb(rng, LC_H, LC_W)).save(
                os.path.join(dpath, "nir_img", f"{t:06d}.png"))
    split = os.path.join(root, "split_sweep")
    os.makedirs(split, exist_ok=True)
    for name in ("training.txt", "testing.txt"):
        with open(os.path.join(split, name), "w") as f:
            f.write("".join(f"{date}_drive_{d}_sweep\n" for d in drives))
    return split


def _cfg_dict(root, split, w, h, crop_w, d=16, lidar=None):
    return {
        "data": {"exp_name": "t_kitti", "model_name": "base",
                 "loss_name": "base", "trainer_name": "default",
                 "dataset_path": root, "dataset_split": split},
        "var": {"img_size": [w, h], "crop_w": crop_w, "t_win": 1,
                "d_min": 3.0, "d_max": 40.0, "ndepth": d, "qpower": 1.0,
                "sigma_soft_max": 10.0, "feature_dim": d, "softce": 0.3,
                "nmode": "exp7", "bn_avg": False},
        "lidar": lidar or {"enabled": False},
        "train": {"batch_size": 2, "lr": 1e-4, "epoch_num": 1, "n_gpu": 1,
                  "optim": "adam"},
    }


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("real_data"))
    return root, write_kitti(root), write_ilim(root)


def assert_frames_equal(got: dict, want: dict):
    assert set(got) == set(want)
    assert got.get("success", True), got
    for k, w in want.items():
        g = got[k]
        if k.startswith(("rgb_", "dmap", "mask", "sweep_arr", "nir_img",
                         "d_candi")):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


def _both(trees, which, **kw):
    root, ksplit, isplit = trees
    if which == "kitti":
        d = _cfg_dict(root, ksplit, 192, 64, 128, **kw)
        return (kitti.KittiVideoDataset(config_from_dict(d)),
                jkitti.KittiVideoDataset(jcfg_from(d)))
    d = _cfg_dict(root, isplit, 128, 64, 96)
    return (ilim.IlimVideoDataset(config_from_dict(d)),
            jilim.IlimVideoDataset(jcfg_from(d)))


@pytest.mark.parametrize("which", ["kitti", "ilim"])
def test_frames_match_jax(trees, which):
    ds, jds = _both(trees, which)
    assert ds.n_trajectories() == jds.n_trajectories() == 2
    for i, t in ((0, 0), (0, 1), (1, 1)):
        got, want = ds.frame(i, t), jds.frame(i, t)
        assert_frames_equal(got, want)
        assert (got["dmap_up_left"] > 0).sum() > 50
    if which == "ilim":
        assert got["sweep_arr"].shape == (128, LC_H, LC_W, 2)
        assert got["nir_img"].shape == (LC_H, LC_W)
    # cached frames are read-only; a corrupt file is a skippable marker
    with pytest.raises(ValueError):
        ds.frame(0, 1)["rgb_left"][0, 0, 0, 0] = 1.0
    drive = ds.drives[1]
    path = drive.img_path("left", 0)
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\xff" * 16)
    fresh, jfresh = _both(trees, which)
    bad, jbad = fresh.frame(1, 0), jfresh.frame(1, 0)
    assert bad["success"] is False and jbad["success"] is False
    Image.fromarray(_smooth_rgb(np.random.default_rng(9), *(
        (RAW_H, RAW_W) if which == "kitti" else (96, 160)))).save(path)


def test_kitti_with_lidar_upsampling_matches_jax(trees):
    lidar = {"enabled": True, "filtering": 1, "upsample": 2.0,
             "total_vbeams": 64, "total_hbeams": 500, "vbeam_fov": 0.4,
             "hbeam_fov": 0.2}
    ds, jds = _both(trees, "kitti", lidar=lidar)
    got, want = ds.frame(0, 1), jds.frame(0, 1)
    for k in ("rgb_left", "rgb_right", "pose_left", "intrinsics"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    # the densification's trig: native and numpy agree to 1e-4 m, so a
    # pixel whose z-buffer winner flips may differ
    for k in ("dmap_up_left", "dmap_left"):
        assert np.mean(np.abs(got[k] - want[k]) < 1e-3) > 0.99, k


@pytest.mark.parametrize("which", ["kitti", "ilim"])
def test_scheduler_batches_match_jax(trees, which):
    ds, jds = _both(trees, which)
    got = list(BatchScheduler(ds, 2, shuffle=False, prefetch=False)
               .enumerate())
    want = list(JSched(jds, 2, shuffle=False, prefetch=False).enumerate())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert g[k] == v, k
        mi, gt = assemble_inputs(g, "left")
        mi_j, gt_j = jassemble(w, "left")
        for a, b in ((mi, mi_j), (gt, gt_j)):
            assert set(a) == set(b)
            for k, v in b.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-6,
                                               err_msg=k)


def test_lcsweep_to_rgbsweep_matches_jax(trees):
    ds, _ = _both(trees, "ilim")
    f = ds.frame(0, 1)
    h, w = f["dmap_up_left"].shape
    rgb_intr = f["intrinsics_up"]
    lc_intr = np.array([[18.0, 0, 10.0], [0, 18.0, 6.0], [0, 0, 1]],
                       np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = 0.05
    nir = f["nir_img"]
    got = ilim.lcsweep_to_rgbsweep(f["sweep_arr"], f["dmap_up_left"],
                                   rgb_intr, (w, h), lc_intr, (LC_W, LC_H),
                                   m, nir)
    want = jilim.lcsweep_to_rgbsweep(f["sweep_arr"], f["dmap_up_left"],
                                     rgb_intr, (w, h), lc_intr,
                                     (LC_W, LC_H), m, nir)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)
    assert got[2].sum() > 20


def test_build_loaders_choose_as_jax(trees, tmp_path):
    root, ksplit, isplit = trees
    for split, dataset_path, want in (
            (ksplit, root, kitti.KittiVideoDataset),
            (isplit, root, ilim.IlimVideoDataset),
            (ksplit, str(tmp_path / "absent"), None)):
        d = _cfg_dict(dataset_path, split, 192, 64, 128)
        tl, vl = ttrain.build_loaders(config_from_dict(d), False)
        jl, jvl = jtrain.build_loaders(jcfg_from(d), False)
        for a, b in ((tl, jl), (vl, jvl)):
            assert type(a.dataset).__name__ == type(b.dataset).__name__
            if want is not None:
                assert isinstance(a.dataset, want)
            else:
                assert type(a.dataset).__name__ == (
                    "SyntheticStereoVideoDataset")
        tl.stop()
        vl.stop()
    d = _cfg_dict(root, ksplit, 192, 64, 128)
    tl, _ = ttrain.build_loaders(config_from_dict(d), True)
    assert type(tl.dataset).__name__ == "SyntheticStereoVideoDataset"


def _cli_config(trees, tmp_path, which) -> str:
    """``configs/test_tiny.json`` pointed at the tree, in ``tmp_path``."""
    root, ksplit, isplit = trees
    raw = json.load(open(os.path.join(ROOT, "configs", "test_tiny.json")))
    raw["data"].update(dataset_path=root, exp_name=f"t_cli_{which}",
                       dataset_split=ksplit if which == "kitti" else isplit)
    path = str(tmp_path / "cfg.json")
    json.dump(raw, open(path, "w"))
    return path


@pytest.mark.parametrize("which", ["kitti", "ilim"])
def test_cli_trains_on_the_tree(trees, tmp_path, monkeypatch, which):
    """An epoch of ``python -m depthestimation_tpu_torch.train`` (from
    Python, on the CPU) on the tree, no ``--synthetic``: two drives at
    batch 2, two frames each, two steps; then ``--eval``."""
    path = _cli_config(trees, tmp_path, which)
    monkeypatch.chdir(tmp_path)
    tr = ttrain.main(["--config", path], device="cpu")
    assert type(tr.train_loader.dataset).__name__ == (
        "KittiVideoDataset" if which == "kitti" else "IlimVideoDataset")
    losses = tr._last_epoch_losses
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    ev = ttrain.main(["--config", path, "--eval"], device="cpu")
    assert ev.cfg.train.batch_size == 1


@pytest.mark.parametrize("which", ["kitti", "ilim"])
@pytest.mark.parametrize("fault", ["no_compiler", "compile_error"])
def test_failed_build_raises_not_skips(trees, tmp_path, monkeypatch, which,
                                       fault):
    """A native library that does not build is no broken sample: making
    the dataset raises, so does a frame read once the library is dropped
    (as a spawned loader process starts), through the loader thread, and
    the CLI stops instead of skipping every batch."""
    ds, _ = _both(trees, which)
    cfg = ds.cfg
    monkeypatch.setattr(kittiops, "_lib", None)
    monkeypatch.setattr(kittiops, "BUILD_DIR", tmp_path / "native")
    if fault == "no_compiler":
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        match = "cannot run g\\+\\+"
    else:
        src = tmp_path / "kittiops.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(kittiops, "SRC", src)
        match = "g\\+\\+ failed on kittiops.cpp"
    with pytest.raises(kittiops.BuildError, match=match):
        ds.frame(0, 0)
    loader = BatchScheduler(ds, 2, shuffle=False, prefetch=True)
    with pytest.raises(kittiops.BuildError, match=match):
        list(loader.enumerate())
    make = (kitti.KittiVideoDataset if which == "kitti"
            else ilim.IlimVideoDataset)
    with pytest.raises(kittiops.BuildError, match=match):
        make(cfg)
    path = _cli_config(trees, tmp_path, which)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(kittiops.BuildError, match=match):
        ttrain.main(["--config", path], device="cpu")


@pytest.mark.parametrize("which", ["kitti", "ilim"])
def test_png_type_not_read_raises_not_skips(trees, which):
    """An RGBA frame is a tree the reader cannot read, not a broken
    sample: ``frame()`` and the loader raise ``UnsupportedPNG``."""
    ds, _ = _both(trees, which)
    path = ds.drives[1].img_path("left", 1)
    good = open(path, "rb").read()
    try:
        Image.open(io.BytesIO(good)).convert("RGBA").save(path)
        with pytest.raises(image.UnsupportedPNG, match="RGBA"):
            ds.frame(1, 1)
        fresh, _ = _both(trees, which)
        with pytest.raises(image.UnsupportedPNG, match="RGBA"):
            list(BatchScheduler(fresh, 2, shuffle=False,
                                prefetch=False).enumerate())
    finally:
        open(path, "wb").write(good)
