"""The port's sweep converter (``depthestimation_tpu_torch/sweep_convert.py``)
against the JAX package's ``tools/sweep_convert.py``, which runs OpenCV.

- ``convert_frame`` on the capture of ``tests/test_sweep_convert.py``
  (128 planes of 320x256, a 20,000-point wall, 384x256 RGB and 640x512
  NIR PNGs), as written (no distortion) and with the rig's LC distortion
  in its ``calib.json``: every npz key equal, bit for bit, and the frame
  ``load_frame`` reads (the RGB images in RGB order, OpenCV's in BGR);
- the pieces alone, bit for bit: the undistort against ``cv2.undistort``
  on random f32 planes (one with NaNs) with the rig's K and D and with
  two stronger models, one whose map leaves the image (the border),
  numpy and the torch
  gather on CPU tensors; ``INTER_AREA`` by 1/4 and 1/2 and ``BGR2GRAY``
  on uint8 images, with sizes the factors do not divide;
- the CLI writes the npz names of the JAX tool, and ``--device``.

The JAX side needs OpenCV: it is imported through ``importorskip`` where
it is used, so the port's own cases run without it.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from depthestimation_tpu_torch import sweep_convert as tsc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG_D = tsc.DEFAULT_D_LC


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    pytest.importorskip("cv2")
    spec = importlib.util.spec_from_file_location(
        "jax_sweep_convert", os.path.join(ROOT, "tools", "sweep_convert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(root, distortion=None):
    pytest.importorskip("cv2")            # the capture's PNGs come from cv2
    from test_sweep_convert import _make_capture
    drive = _make_capture(str(root))
    if distortion is not None:
        path = os.path.join(str(root), "2024_01_01", drive, "calib.json")
        calib = json.load(open(path))
        calib["D_lc"] = [float(x) for x in distortion]
        json.dump(calib, open(path, "w"))
    return drive


@pytest.mark.parametrize("distortion", [None, RIG_D],
                         ids=["as_written", "rig_distortion"])
def test_convert_frame_matches_jax(tmp_path, distortion):
    jsc = _jax_tool()
    drive = _capture(tmp_path, distortion)
    jf = jsc.load_frame(str(tmp_path), drive, 0)
    tf = tsc.load_frame(str(tmp_path), drive, 0)
    assert set(tf) == set(jf)
    for k, v in jf.items():
        v = np.asarray(v)
        if k in ("left_img", "right_img"):
            v = v[..., ::-1]                            # BGR -> RGB
        assert tf[k].shape == v.shape and np.array_equal(tf[k], v), k
    want = jsc.convert_frame(jf)
    got = tsc.convert_frame(tf, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v, equal_nan=True), k
    if distortion is not None:                     # the planes did move
        assert not np.array_equal(got["sweep_arr"], tf["sweep_arr"])


@pytest.mark.parametrize("dist,leaves", [
    (RIG_D, False), ([-0.3, 0.1, 0.01, -0.01, 0.0], False),
    ([0.2, 0.05, 0.0, 0.0, 0.01, 0.02, 0.0, 0.001], True)],
    ids=["rig", "barrel", "rational"])
def test_undistort_matches_cv2(dist, leaves):
    cv2 = pytest.importorskip("cv2")
    k, d = tsc.DEFAULT_K_LC, np.asarray(dist, np.float32)
    rs = np.random.default_rng(3)
    planes = rs.uniform(0, 255, (3, 320, 256)).astype(np.float32)
    planes[2, 100:140, 60:90] = np.nan                  # NaN z planes
    umap = tsc.undistort_map(k, d, 320, 256)
    m1, m2 = cv2.initUndistortRectifyMap(k, d, None, k, (256, 320),
                                         cv2.CV_16SC2)
    assert np.array_equal(umap[0], m1[..., 0])
    assert np.array_equal(umap[1], m1[..., 1])
    assert np.array_equal(umap[3] * 32 + umap[2], m2)
    got = tsc.remap_np(planes, umap)
    got_t = tsc.remap_torch(torch.from_numpy(planes),
                            *tsc.undistort_taps(k, d, 320, 256, "cpu")).numpy()
    for i, plane in enumerate(planes):
        want = cv2.undistort(plane, k, d)
        assert np.array_equal(got[i], want, equal_nan=True), i
        assert np.array_equal(got_t[i], want, equal_nan=True), i
    assert np.array_equal(tsc.undistort_planes(planes, k, d, "cpu"), got,
                          equal_nan=True)
    if leaves:                          # the border: taps read 0
        assert umap[0].min() < 0 and umap[1].min() < 0
        assert (got[0] == 0).any()


@pytest.mark.parametrize("shape", [(256, 384, 3), (66, 98, 3), (63, 97),
                                   (62, 90), (512, 640)])
def test_inter_area_and_gray_match_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    for factor in (2, 4):
        want = cv2.resize(img, None, fx=1 / factor, fy=1 / factor,
                          interpolation=cv2.INTER_AREA)
        got = tsc.resize_area(img, factor)
        assert got.shape == want.shape and np.array_equal(got, want), factor
    if img.ndim == 3:                 # read_png's RGB is cv2.imread's BGR
        want = cv2.cvtColor(img[..., ::-1].copy(), cv2.COLOR_BGR2GRAY)
        assert np.array_equal(tsc.rgb_to_gray(img), want)
    else:
        bgr = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        assert np.array_equal(tsc.rgb_to_gray(img),
                              cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_remap_torch_is_remap_np_without_opencv():
    """The card's gather against the numpy oracle on CPU tensors, bit for
    bit, on the rig's map; the taps are built once per (K, D, size,
    device); wrong inputs raise."""
    umap = tsc.undistort_map(tsc.DEFAULT_K_LC, RIG_D, 64, 48)
    planes = np.random.default_rng(1).normal(0, 50, (5, 64, 48)).astype(
        np.float32)
    taps = tsc.undistort_taps(tsc.DEFAULT_K_LC, RIG_D, 64, 48, "cpu")
    assert [t.shape for t in taps] == [(4, 64, 48)] * 2
    again = tsc.undistort_taps(tsc.DEFAULT_K_LC.copy(), list(RIG_D), 64, 48,
                               torch.device("cpu"))
    assert all(a is b for a, b in zip(taps, again))
    assert tsc.undistort_taps(tsc.DEFAULT_K_LC, RIG_D, 48, 64,
                              "cpu")[0] is not taps[0]
    got = tsc.remap_torch(torch.from_numpy(planes), *taps)
    assert got.dtype == torch.float32 and got.shape == (5, 64, 48)
    assert np.array_equal(got.numpy(), tsc.remap_np(planes, umap))
    assert np.array_equal(tsc.undistort_planes(planes, tsc.DEFAULT_K_LC,
                                               RIG_D, "cpu"),
                          tsc.remap_np(planes, umap))
    with pytest.raises(ValueError):
        tsc.remap_torch(torch.from_numpy(planes).double(), *taps)
    with pytest.raises(ValueError):
        tsc.resize_area(planes[0], 2)


def test_cli_writes_the_jax_tools_names(tmp_path, capsys, monkeypatch):
    jsc = _jax_tool()
    drive = _capture(tmp_path)
    # zlib on 84 MB of planes takes 10 s here; the names are the point
    monkeypatch.setattr(np, "savez_compressed", np.savez)
    out = str(tmp_path / "port")
    assert tsc.main(["--root", str(tmp_path), "--drive", drive, "--frames",
                     "0:1", "--out", out, "--device", "cpu"]) == [0]
    assert "done: 1 frames" in capsys.readouterr().out
    assert os.listdir(out) == ["000000.npz"]
    got = np.load(os.path.join(out, "000000.npz"))
    want = jsc.convert_frame(jsc.load_frame(str(tmp_path), drive, 0))
    assert sorted(got.files) == sorted(want)
    if not torch.cuda.is_available():      # the card, unless asked for CPU
        with pytest.raises((AssertionError, RuntimeError)):
            tsc.main(["--root", str(tmp_path), "--drive", drive, "--frames",
                      "0:1", "--out", str(tmp_path / "card")])
