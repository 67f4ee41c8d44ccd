"""8-bit PNG reading and writing on ``zlib`` and numpy.

The card's host has neither ``imageio`` nor ``cv2``, and the scene loaders
and fixture generators read and write PNGs. ``read_png`` decodes the
non-interlaced 8-bit colour types (gray, gray + alpha, RGB, RGBA and
palette) through all five row filters and returns what
``imageio.v2.imread`` returns for the same file: ``[H, W]`` for gray,
``[H, W, C]`` otherwise, a palette expanded to its RGB colours. Like
imageio, it ignores a ``tRNS`` chunk.
``write_png`` writes gray, gray + alpha, RGB or RGBA with the Up filter.
``read_image`` reads any other format (an LLFF ``.jpg``) through
``imageio`` when it can be imported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the per-row filters of ``raw`` ``[H, 1 + W·bpp]``; returns
    ``[H, W, bpp]`` uint8.

    Rows filtered None, Sub or Up are decoded a row at a time (Sub as a
    cumulative sum mod 256). A run of Average or Paeth rows, where each
    byte depends on its left neighbour, is decoded along anti-diagonals:
    the pixels of one anti-diagonal depend only on earlier ones.
    """
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: bad PNG row filter {int(ftype.max())}")
    data = raw[:, 1:].reshape(height, width, bpp).astype(np.int32)
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are zeros.
    out = np.zeros((height + 1, width + 1, bpp), np.int32)
    y = 0
    while y < height:
        t = ftype[y]
        if t < 3:
            if t == 0:
                row = data[y]
            elif t == 1:
                row = np.cumsum(data[y], axis=0)
            else:
                row = data[y] + out[y, 1:]
            out[y + 1, 1:] = row & 255
            y += 1
            continue
        end = y
        while end < height and ftype[end] >= 3:
            end += 1
        n = end - y
        for d in range(n + width - 1):
            ys = np.arange(max(0, d - width + 1), min(n, d + 1)) + y
            xs = d - (ys - y)
            a = out[ys + 1, xs]
            b = out[ys, xs + 1]
            c = out[ys, xs]
            avg = (a + b) >> 1
            pred = np.where((ftype[ys] == 3)[:, None], avg, _paeth(a, b, c))
            out[ys + 1, xs + 1] = (data[ys, xs] + pred) & 255
        y = end
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG file to a uint8 array."""
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced PNGs are read here (bit "
            f"depth {depth}, colour type {color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{path}: PNG image data has the wrong size")
    img = _unfilter(raw.reshape(height, 1 + width * bpp), height, width,
                    bpp, path)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return palette[idx]
    return img[..., 0] if bpp == 1 else img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """A uint8 ``[H, W]`` or ``[H, W, C]`` (C = 1, 2, 3, 4) image as PNG
    bytes, every row Up-filtered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {img.shape} as "
                         "PNG")
    height, width, ch = img.shape
    rows = img.reshape(height, width * ch)
    up = rows.copy()
    up[1:] -= rows[:-1]                        # mod 256 in uint8
    raw = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image (see :func:`encode_png`) to ``path``."""
    with open(path, "wb") as fp:
        fp.write(encode_png(img))


def read_image(path: str) -> np.ndarray:
    """A PNG through :func:`read_png`; any other format through
    ``imageio``, which must then be importable."""
    with open(path, "rb") as fp:
        head = fp.read(len(SIGNATURE))
    if head == SIGNATURE:
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise RuntimeError(
            f"{path} is not a PNG, and reading it needs imageio, which is "
            "not installed") from None
    return np.asarray(imageio.imread(path))
