"""Image buffers and PNG I/O.

Framework images follow the reference's field convention
(/root/reference/taichi_pathtracer/1_save_img/__main__.py:8-13): shape
``(W, H, 3)`` with ``img[i, j]`` meaning pixel column ``i`` (left→right) and
row ``j`` (bottom→top). ``write_png``/``read_png`` convert to/from the
top-down ``(H, W, 3)`` raster layout the same way ``ti.tools.imwrite`` does,
so outputs are directly comparable with the reference's golden PNGs. The
PNG codec is numpy + zlib, with no imaging library.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def to_raster(img_wh3) -> np.ndarray:
    """(W, H, 3) float [0,1] → (H, W, 3) uint8, top row first."""
    a = np.asarray(img_wh3)
    a = np.clip(a, 0.0, 1.0)
    a = (a * 255.0 + 0.5).astype(np.uint8)
    return np.transpose(a, (1, 0, 2))[::-1]


def from_raster(raster_hw3: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 top-down → (W, H, 3) float32 in [0,1], bottom-up."""
    a = np.asarray(raster_hw3)[::-1].astype(np.float32) / 255.0
    return np.transpose(a, (1, 0, 2))


def encode_png(raster: np.ndarray) -> bytes:
    """Encode an ``(H, W, 3)`` or ``(H, W, 4)`` uint8 raster as a PNG
    (8-bit truecolour, no filtering, zlib level 6)."""
    a = np.ascontiguousarray(raster, np.uint8)
    h, w, c = a.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)   # filter byte 0 (None) per row

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_PNG_MAGIC + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None/Sub/Up/Average/Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rows = data.reshape(h, stride + 1)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 1:
            # Sub is a running sum along each byte lane of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up = prev[x]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - bpp] if x >= bpp else 0
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc
                            else up if pb <= pc else ul)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """Decode a non-interlaced 8-bit PNG (grey, grey+alpha, RGB or RGBA) to
    an ``(H, W, 3)`` uint8 RGB raster."""
    if buf[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    a = _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)
    if channels < 3:
        a = np.repeat(a[..., :1], 3, axis=-1)
    return np.ascontiguousarray(a[..., :3])


def write_png(img_wh3, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_raster(img_wh3)))


def read_png(path: str) -> np.ndarray:
    """Read a PNG into the framework's (W, H, 3) float [0,1] convention."""
    with open(path, "rb") as f:
        return from_raster(decode_png(f.read()))
