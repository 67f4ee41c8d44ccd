"""Area-interpolated downscaling in numpy: ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_AREA)`` for the scene loaders' ``half_res`` and
``--factor`` (the card's host has no ``cv2``).

OpenCV takes two routes, and this module follows both in float32, in
OpenCV's order of operations:

* an integer factor (``src / dst`` an integer on both axes) is a box mean:
  float images sum each box in row-major order, four terms at a time as
  OpenCV's unrolled loop does, and multiply by ``1 / area`` (for the 2 × 2
  box of a 1- or 4-channel image, OpenCV's vector path adds the two rows'
  pairs first; its scalar tail, which a 1-channel row may reach, adds in
  row-major order, 1 ulp apart at most); uint8 images sum in integers and
  round half to even, except the 2 × 2 box, which OpenCV's vector path
  rounds half up;
* any other factor uses fractional-area weights (``computeResizeAreaTab``
  of OpenCV's ``resize.cpp``): each destination pixel is a weighted sum of
  the source pixels its cell covers, summed along a row first and then
  down the rows, in float32, then stored as the input's dtype (uint8
  rounded half to even and saturated).
"""

from __future__ import annotations

import math

import numpy as np


def _area_tab(ssize: int, dsize: int) -> tuple[np.ndarray, np.ndarray]:
    """Per destination index, the source indices and float32 weights of
    its cell, padded to one width with weight 0 (index 0)."""
    scale = ssize / dsize
    cols: list[list[tuple[int, float]]] = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        tab = []
        if s1 - f1 > 1e-3:
            tab.append((s1 - 1, (s1 - f1) / cell))
        tab += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            tab.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        cols.append(tab)
    width = max(len(t) for t in cols)
    idx = np.zeros((dsize, width), np.int64)
    wgt = np.zeros((dsize, width), np.float32)
    for d, tab in enumerate(cols):
        for j, (s, a) in enumerate(tab):
            idx[d, j], wgt[d, j] = s, a
    return idx, wgt


def _fractional(img: np.ndarray, w: int, h: int) -> np.ndarray:
    src = img.astype(np.float32)
    xi, xw = _area_tab(img.shape[1], w)
    yi, yw = _area_tab(img.shape[0], h)
    # Along each source row: buf[x] += S[si] * alpha, entry by entry.
    buf = np.zeros((img.shape[0], w) + img.shape[2:], np.float32)
    ext = (slice(None),) + (None,) * (img.ndim - 2)
    for j in range(xi.shape[1]):
        buf = buf + src[:, xi[:, j]] * xw[:, j][ext]
    # Down the rows: sum[y] += beta * buf[sy], entry by entry.
    out = np.zeros((h, w) + img.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        out = out + yw[:, j][(slice(None), None) + ext[1:]] * buf[yi[:, j]]
    return out


def _box(img: np.ndarray, kx: int, ky: int, w: int, h: int) -> np.ndarray:
    blocks = img[:h * ky, :w * kx].reshape(h, ky, w, kx, *img.shape[2:])
    if img.dtype == np.uint8:
        total = blocks.astype(np.int64).sum(axis=(1, 3))
        if kx == ky == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        mean = total.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    scale = np.float32(1.0 / (kx * ky))
    if kx == ky == 2 and (img.ndim == 2 or img.shape[2] in (1, 4)):
        return (((blocks[:, 0, :, 0] + blocks[:, 0, :, 1])
                 + (blocks[:, 1, :, 0] + blocks[:, 1, :, 1])) * scale)
    # OpenCV's scalar loop, unrolled by four: sum += ((a + b) + c) + d.
    terms = [blocks[:, sy, :, sx] for sy in range(ky) for sx in range(kx)]
    total = np.zeros((h, w) + img.shape[2:], img.dtype)
    k = 0
    while k + 4 <= len(terms):
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2])
                         + terms[k + 3])
        k += 4
    for t in terms[k:]:
        total = total + t
    return total * scale


def area_resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Downscale ``img`` (``[H, W]`` or ``[H, W, C]``, uint8 or float32)
    to ``size = (width, height)`` as ``cv2.INTER_AREA`` does; the result
    keeps the input's dtype (and, as cv2's, drops a single channel axis)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"area_resize takes uint8 or float32, got "
                         f"{img.dtype}")
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (w, h) == (sw, sh):
        return img.copy()
    if not (0 < w <= sw and 0 < h <= sh):
        raise ValueError(f"area_resize only downscales: {sw}x{sh} -> "
                         f"{w}x{h}")
    if sw % w == 0 and sh % h == 0:
        return _box(img, sw // w, sh // h, w, h)
    out = _fractional(img, w, h)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
