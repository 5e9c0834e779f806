"""Velodyne -> depth-map projection (utils_lib equivalent).

Host-side data-path ops replacing the reference's pybind utils_lib
(external/utils_lib/python/utils_lib.cpp:20-237):

- ``generate_depth``: transform points to the camera frame, cull behind-
  camera, (optionally) upsample in polar beam space, project with a min-z
  z-buffer, and filter occluded pixels by neighborhood consensus.
- ``upsample_velodyne``: bin points into a (vbeam, hbeam) polar grid,
  nearest-resize, regenerate points.
- ``upsample_depth``: fill holes from neighbor consensus.
- ``lc_generate``: gather the 128-plane sweep features at projected pixels.

Port of ``depthestimation_tpu/data/velodyne.py``. Two backends with
identical semantics: the OpenMP C++ library ``native/kittiops.cpp`` (the
default, built at first use; a failed build raises) and vectorized numpy,
taken only when the caller passes ``backend="numpy"`` (the tests hold the
two against each other). The JAX package picks native when it builds and
falls back to numpy silently; here the backend is the caller's choice.
"""

from __future__ import annotations

import numpy as np

from depthestimation_tpu_torch.native import kittiops

BACKENDS = ("native", "numpy")


def _native(backend: str):
    """The native module for ``backend`` "native", None for "numpy"."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    return kittiops if backend == "native" else None


# ---------------------------------------------------------------------------
# numpy backend


def _zbuffer_project(pts_cam, intr34, width: int, height: int) -> np.ndarray:
    """Min-z splat of camera-frame points (utils_lib.cpp:191-207:
    u = int(x/z*fx + cx - 0.5))."""
    proj = pts_cam @ intr34.T                       # [N, 3]
    z = pts_cam[:, 2]
    u = (proj[:, 0] / proj[:, 2] - 0.5).astype(np.int64)
    v = (proj[:, 1] / proj[:, 2] - 0.5).astype(np.int64)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z = u[ok], v[ok], z[ok]
    flat = v * width + u
    dmap = np.full(height * width, np.inf, np.float32)
    np.minimum.at(dmap, flat, z.astype(np.float32))
    dmap[np.isinf(dmap)] = 0.0
    return dmap.reshape(height, width)


def _window_shifts(x, offset: int):
    """Iterate the (2*offset+1)^2 - 1 neighbor shifts of the interior."""
    h, w = x.shape
    for dv in range(-offset, offset + 1):
        for du in range(-offset, offset + 1):
            if dv == 0 and du == 0:
                continue
            yield x[offset + dv:h - offset - 1 + dv,
                    offset + du:w - offset - 1 + du]


def _occlusion_filter(dmap, offset: int, filterdiff: float) -> np.ndarray:
    """Zero pixels with a neighbor closer by > filterdiff
    (utils_lib.cpp:209-234; borders come out zero as in the reference)."""
    if offset <= 0:
        return dmap.copy()
    h, w = dmap.shape
    out = np.zeros_like(dmap)
    center = dmap[offset:h - offset - 1, offset:w - offset - 1]
    bad = np.zeros_like(center, bool)
    for n in _window_shifts(dmap, offset):
        bad |= (n != 0) & ((n - center) < -filterdiff)
    out[offset:h - offset - 1, offset:w - offset - 1] = np.where(bad, 0, center)
    return out


def upsample_depth(depth, filtering: int, maxdiff: float,
                   backend: str = "native") -> np.ndarray:
    """Fill zero pixels with the neighbor mean when the neighbor spread is
    < maxdiff (utils_lib.cpp:52-95)."""
    k = _native(backend)
    if k is not None:
        return k.upsample_depth(np.ascontiguousarray(depth, np.float32),
                                int(filtering), float(maxdiff))
    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    o = filtering
    out = np.zeros_like(depth)
    center = depth[o:h - o - 1, o:w - o - 1]
    cnt = np.zeros_like(center)
    ssum = np.zeros_like(center)
    mx = np.zeros_like(center)
    mn = np.full_like(center, 1e8)
    for n in _window_shifts(depth, o):
        valid = n != 0
        cnt += valid
        ssum += np.where(valid, n, 0)
        mx = np.maximum(mx, np.where(valid, n, 0))
        mn = np.minimum(mn, np.where(valid, n, 1e8))
    mean = ssum / np.maximum(cnt, 1)
    fill = (cnt > 0) & (np.abs(mx - mn) < maxdiff)
    filled = np.where(center != 0, center, np.where(fill, mean, 0.0))
    out[o:h - o - 1, o:w - o - 1] = filled
    return out


def upsample_velodyne(pts_cam, params: dict,
                      backend: str = "native") -> np.ndarray:
    """Polar-grid densification (utils_lib.cpp:97-161). pts_cam: [N, >=3]
    camera-frame points; returns [M, 4] homogeneous points.
    ``upsample_velodyne_np`` is the numpy backend."""
    k = _native(backend)
    if k is not None:
        return k.upsample_velodyne(
            np.ascontiguousarray(np.asarray(pts_cam, np.float32)),
            float(params["upsample"]),
            int(params.get("total_vbeams", 128)),
            int(params.get("total_hbeams", 1500)),
            float(params.get("vbeam_fov", 0.2)),
            float(params.get("hbeam_fov", 0.08)))
    return upsample_velodyne_np(pts_cam, params)


def upsample_velodyne_np(pts_cam, params: dict) -> np.ndarray:
    """Numpy backend of :func:`upsample_velodyne` (golden oracle)."""
    scale = float(params["upsample"])
    total_vbeams = int(params.get("total_vbeams", 128))
    total_hbeams = int(params.get("total_hbeams", 1500))
    vbeam_fov = float(params.get("vbeam_fov", 0.2))
    hbeam_fov = float(params.get("hbeam_fov", 0.08))
    phioffset = 10.0

    x, y, z = pts_cam[:, 0], pts_cam[:, 1], pts_cam[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.degrees(np.arctan(x / z))
    phi = np.degrees(np.arcsin(y / np.maximum(r, 1e-9))) - phioffset

    vbeams, hbeams = total_vbeams, total_hbeams
    vf, hf = vbeam_fov, hbeam_fov
    tb = ((theta / hf) + hbeams / 2 - 0.5).astype(np.int64)
    pb = ((phi / vf) + vbeams / 2 - 0.5).astype(np.int64)
    ok = (tb >= 0) & (tb < hbeams) & (pb >= 0) & (pb < vbeams)
    rmap = np.full(vbeams * hbeams, np.inf, np.float32)
    np.minimum.at(rmap, pb[ok] * hbeams + tb[ok], r[ok].astype(np.float32))
    rmap[np.isinf(rmap)] = 0.0
    rmap = rmap.reshape(vbeams, hbeams)

    # nearest resize by `scale` (cv2 INTER_NEAREST index mapping)
    vb2, hb2 = int(total_vbeams * scale), int(total_hbeams * scale)
    vi = np.minimum((np.arange(vb2) / scale).astype(np.int64), vbeams - 1)
    hi = np.minimum((np.arange(hb2) / scale).astype(np.int64), hbeams - 1)
    rmap2 = rmap[vi][:, hi]
    vf2, hf2 = vbeam_fov / scale, hbeam_fov / scale

    pbins, tbins = np.meshgrid(np.arange(vb2), np.arange(hb2), indexing="ij")
    phi2 = np.radians((pbins - vb2 / 2.0) * vf2 + phioffset)
    theta2 = np.radians((tbins - hb2 / 2.0) * hf2)
    rr = rmap2
    out = np.ones((vb2 * hb2, 4), np.float32)
    out[:, 0] = (rr * np.cos(phi2) * np.sin(theta2)).ravel()
    out[:, 1] = (rr * np.sin(phi2)).ravel()
    out[:, 2] = (rr * np.cos(phi2) * np.cos(theta2)).ravel()
    return out


def generate_depth(velodata, intr, M_velo2cam, width: int, height: int,
                   params: dict, backend: str = "native") -> np.ndarray:
    """velodata: [N, 4] homogeneous lidar points; intr: [3, 4] (or [3, 3]);
    returns [height, width] float32 depth (0 = missing). With ``upsample``
    the projection runs in numpy around the backend's densification, as
    in JAX."""
    params = dict(params)
    upsample = float(params.get("upsample", 0) or 0)
    filtering = int(params.get("filtering", 0))
    filterdiff = float(params.get("filterdiff", 1.0))

    intr = np.asarray(intr, np.float32)
    if intr.shape == (3, 3):
        intr = np.concatenate([intr, np.zeros((3, 1), np.float32)], 1)

    k = _native(backend)
    if k is not None and not upsample:
        return k.generate_depth(
            np.ascontiguousarray(velodata, np.float32),
            np.ascontiguousarray(intr, np.float32),
            np.ascontiguousarray(M_velo2cam, np.float32),
            int(width), int(height), filtering, filterdiff)

    pts_cam = np.asarray(velodata, np.float32) @ np.asarray(
        M_velo2cam, np.float32).T
    pts_cam = pts_cam[pts_cam[:, 2] >= 0.1]
    if upsample:
        pts_cam = upsample_velodyne(pts_cam, params, backend)
    dmap = _zbuffer_project(pts_cam[:, :4] if pts_cam.shape[1] >= 4
                            else np.concatenate(
                                [pts_cam, np.ones((len(pts_cam), 1),
                                                  np.float32)], 1),
                            intr, width, height)
    return _occlusion_filter(dmap, filtering, filterdiff)


def lc_generate(proj_points, sweep_int, sweep_z, lc_width: int,
                lc_height: int, nir_img, backend: str = "native"):
    """Gather 128-plane sweep features at projected RGB pixels
    (utils_lib.cpp:20-50). proj_points: [N, 3] (u, v, z).
    ``lc_generate_np`` is the numpy backend."""
    k = _native(backend)
    if k is not None:
        return k.lc_generate(proj_points, sweep_int, sweep_z, lc_width,
                             lc_height, nir_img)
    return lc_generate_np(proj_points, sweep_int, sweep_z, lc_width,
                          lc_height, nir_img)


def lc_generate_np(proj_points, sweep_int, sweep_z, lc_width: int,
                   lc_height: int, nir_img):
    """Numpy backend of :func:`lc_generate` (golden oracle)."""
    n = proj_points.shape[0]
    planes = sweep_int.shape[0]
    feat_int = np.zeros((planes, n), np.float32)
    feat_z = np.zeros((planes, n), np.float32)
    mask = np.zeros((1, n), np.float32)
    nir = np.zeros((1, n), np.float32)

    u = (proj_points[:, 0] + 0.5).astype(np.int64)
    v = (proj_points[:, 1] + 0.5).astype(np.int64)
    z = proj_points[:, 2]
    inside = (u >= 0) & (v >= 0) & (u < lc_width) & (v < lc_height) & (z != 0)
    idx = v * lc_width + u
    nir_flat = np.asarray(nir_img, np.float32).reshape(-1)
    nir[0, inside] = nir_flat[idx[inside]]
    usable = inside & (z <= 18) & ~np.isnan(sweep_z[0].reshape(-1)[
        np.where(inside, idx, 0)])
    cols = idx[usable]
    feat_int[:, usable] = sweep_int.reshape(planes, -1)[:, cols]
    feat_z[:, usable] = sweep_z.reshape(planes, -1)[:, cols]
    mask[0, usable] = 1.0
    return feat_int, feat_z, mask, nir
