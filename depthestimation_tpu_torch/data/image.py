"""PNG decoding and Pillow's bilinear resize, without Pillow.

The JAX package reads every image through PIL (``Image.open``,
``.resize((w, h), Image.BILINEAR)``, ``.convert("L")``); the port's data
path needs neither Pillow nor OpenCV and reproduces those three
operations bit for bit on uint8 images:

- ``read_png``: the chunks are parsed here, the image data inflated with
  the standard library's ``zlib`` and the five row filters reversed by
  ``native/kittiops.cpp:png_unfilter`` (Sub, Average and Paeth read the
  reconstructed byte to the left: a numpy loop over 1242 columns is far
  too slow). 8-bit gray and 8-bit RGB, non-interlaced, as KITTI and the
  ILIM rig ship them; any other type raises ``UnsupportedPNG`` (a
  ``ValueError``) naming it.
- ``resize_bilinear``: Pillow's separable resample
  (``libImaging/Resample.c``): a horizontal pass, then a vertical one,
  each rounded and clipped to uint8. The triangle filter's support scales
  with the downscale factor; its coefficients are normalised in double
  precision and rounded to 22 fractional bits, and the accumulator starts
  at half a unit.
- ``rgb_to_l``: Pillow's integer ITU-R 601 luma (``Convert.c``).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from depthestimation_tpu_torch.native import kittiops

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour types -> (name, channels)
_COLOR_TYPES = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1),
                4: ("gray+alpha", 2), 6: ("RGBA", 4)}
_SUPPORTED = {0, 2}
_PRECISION_BITS = 32 - 8 - 2


class UnsupportedPNG(ValueError):
    """A well-formed PNG of a type ``read_png`` does not read. Not a broken
    sample: the datasets let it through their skip."""


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG file (no IEND chunk)")


def _header(body: bytes):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    name = _COLOR_TYPES.get(ctype, (f"colour type {ctype}", 0))[0]
    if ctype not in _SUPPORTED:
        raise UnsupportedPNG(f"unsupported PNG type: {name} (8-bit gray "
                             "and 8-bit RGB are read)")
    if depth != 8:
        raise UnsupportedPNG(f"unsupported PNG type: {depth}-bit {name} "
                             "(8-bit gray and 8-bit RGB are read)")
    if interlace:
        raise UnsupportedPNG("unsupported PNG type: interlaced (Adam7) "
                             "images are not read")
    if comp or filt:
        raise ValueError(f"PNG compression {comp} / filter method {filt} "
                         "do not exist")
    return w, h, _COLOR_TYPES[ctype][1]


def png_size(path: str) -> tuple:
    """(width, height) from the header alone, as ``Image.open(p).size``."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray) or [H, W, 3] (RGB)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    w, h, ch = header
    raw = zlib.decompress(b"".join(idat))
    img = kittiops.png_unfilter(raw, h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path`` (see ``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter, then
    ``normalize_coeffs_8bpc``: (first source index [out], int32 weights
    [out, ksize]); a weight past a row's window is 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize, dtype=np.int64)[None]
    arg = np.abs((x + xmin[:, None] - center[:, None] + 0.5) * ss)
    k = np.where((arg < 1.0) & (x < xmax[:, None]), 1.0 - arg, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):           # the C loop's order of summation
        ww = ww + k[:, j]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    one = float(1 << _PRECISION_BITS)
    kint = np.where(k < 0, np.trunc(-0.5 + k * one),
                    np.trunc(0.5 + k * one)).astype(np.int32)
    return xmin, kint


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resample pass of ``img`` (uint8, at least 2-D) along
    ``axis`` to ``out_size``."""
    in_size = img.shape[axis]
    xmin, kint = _coeffs(in_size, out_size)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    for j in range(kint.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += (np.take(img, idx, axis=axis).astype(np.int32)
                * kint[:, j].reshape(shape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BILINEAR)`` of a uint8
    [H, W] or [H, W, C] image; ``size`` is (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear takes uint8, got {img.dtype}")
    w, h = int(size[0]), int(size[1])
    if img.shape[1] != w:
        img = _pass(img, w, 1)
    if img.shape[0] != h:
        img = _pass(img, h, 0)
    return np.ascontiguousarray(img)


def rgb_to_l(img: np.ndarray) -> np.ndarray:
    """``Image.convert("L")``: uint8 [H, W, 3] -> [H, W] by
    ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``; a gray image is
    returned as it is."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int32)
    y = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
         + 0x8000) >> 16
    return y.astype(np.uint8)
