"""ctypes bindings for ``kittiops.cpp``: the data path's host kernels.

The source is compiled with ``g++ -O3 -march=native -fopenmp -shared
-fPIC`` at first use (``library()``), never at import, into the checkout's
``build/native/`` (listed in ``.gitignore``). The file name carries a hash
of the source and flags, so an edited source is never served from a stale
build. The build runs in a temporary directory and is moved into place
with ``os.replace``: the spawned loader processes of ``data/scheduler.py``
may race to build and all end with the same file. In a data-parallel
group rank 0 builds and the other ranks wait for it. A failed build raises
``BuildError`` with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "kittiops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I64, _I, _F = ctypes.c_int64, ctypes.c_int, ctypes.c_float
#: C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "generate_depth": ([_f32p, _I64, _f32p, _f32p, _I, _I, _I, _F, _f32p],
                       None),
    "upsample_depth": ([_f32p, _I, _I, _I, _F, _f32p], None),
    "upsample_velodyne": ([_f32p, _I64, _I64, _F, _I, _I, _F, _F, _f32p],
                          None),
    "lc_generate": ([_f32p, _I64, _f32p, _f32p, _I, _I, _I, _f32p, _f32p,
                     _f32p, _f32p, _f32p], None),
    "png_unfilter": ([_u8p, _I64, _I64, _I, _u8p], _I),
}

_lock = threading.Lock()
_lib = None


class BuildError(RuntimeError):
    """``kittiops.cpp`` did not build: no ``g++``, or the compiler failed.
    Not a broken sample: the datasets let it through their skip."""


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libkittiops_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        try:
            out = subprocess.run(["g++", *FLAGS, str(SRC), "-o", so],
                                 capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"cannot run g++ on {SRC.name}: {e}") from e
        if out.returncode:
            raise BuildError(f"g++ failed on {SRC.name}:\n{out.stdout}"
                             f"{out.stderr}")
        os.replace(so, target)      # atomic: concurrent builds agree


def _ensure_built() -> Path:
    target = _target()
    if not target.is_file():
        _build(target)
    return target


def library():
    """Build (once per source hash) and load the library; in a
    data-parallel group rank 0 builds first while the other ranks wait
    (``parallel/mesh.rank0_first``)."""
    global _lib
    with _lock:
        if _lib is None:
            from depthestimation_tpu_torch.parallel import mesh
            target = mesh.rank0_first(_ensure_built)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def generate_depth(velodata, intr, m_velo2cam, width, height, filtering,
                   filterdiff):
    velodata = np.ascontiguousarray(velodata, np.float32)
    out = np.zeros((height, width), np.float32)
    library().generate_depth(
        velodata, velodata.shape[0], np.ascontiguousarray(intr, np.float32),
        np.ascontiguousarray(m_velo2cam, np.float32), width, height,
        filtering, filterdiff, out)
    return out


def upsample_depth(depth, filtering, maxdiff):
    depth = np.ascontiguousarray(depth, np.float32)
    out = np.zeros_like(depth)
    library().upsample_depth(depth, depth.shape[0], depth.shape[1],
                             filtering, maxdiff, out)
    return out


def upsample_velodyne(pts_cam, scale, total_vbeams, total_hbeams, vbeam_fov,
                      hbeam_fov):
    pts_cam = np.ascontiguousarray(pts_cam, np.float32)
    vb2, hb2 = int(total_vbeams * scale), int(total_hbeams * scale)
    out = np.empty((vb2 * hb2, 4), np.float32)
    library().upsample_velodyne(
        pts_cam, pts_cam.shape[0], pts_cam.shape[1], float(scale),
        int(total_vbeams), int(total_hbeams), float(vbeam_fov),
        float(hbeam_fov), out)
    return out


def lc_generate(proj_points, sweep_int, sweep_z, lc_width, lc_height,
                nir_img):
    proj_points = np.ascontiguousarray(proj_points, np.float32)
    sweep_int = np.ascontiguousarray(sweep_int, np.float32)
    sweep_z = np.ascontiguousarray(sweep_z, np.float32)
    n = proj_points.shape[0]
    planes = sweep_int.shape[0]
    feat_int = np.empty((planes, n), np.float32)
    feat_z = np.empty((planes, n), np.float32)
    mask = np.empty((1, n), np.float32)
    nir = np.empty((1, n), np.float32)
    library().lc_generate(
        proj_points, n, sweep_int.reshape(planes, -1),
        sweep_z.reshape(planes, -1), planes, int(lc_width), int(lc_height),
        np.ascontiguousarray(nir_img, np.float32).reshape(-1), feat_int,
        feat_z, mask[0], nir[0])
    return feat_int, feat_z, mask, nir


def png_unfilter(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the PNG row filters of ``raw`` (``height`` rows of a filter
    byte and ``stride`` bytes) -> [height, stride] uint8."""
    raw = np.frombuffer(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, "
                         f"{height} rows of {stride + 1} need "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = library().png_unfilter(raw, height, stride, bpp, out)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type "
                         f"{raw[(bad - 1) * (stride + 1)]} (0..4 exist)")
    return out
