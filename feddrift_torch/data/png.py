"""A minimal pure-Python PNG decoder (zlib inflate and scanline
unfiltering).

A copy of ``feddrift_tpu/data/png.py``: the same bytes give the same
array, and the same files are refused with the same exception type. The
reference reads CINIC-10 as a torchvision ``ImageFolder`` tree of 32x32
PNGs (fedml_api/data_preprocessing/cinic10/data_loader.py); this decoder
reads that format with numpy and the standard library alone: 8-bit depth,
gray / RGB / RGBA / gray-alpha / palette color types, not interlaced. A
file outside that subset, a truncated chunk or pixel data of the wrong
size raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # color type -> samples/pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering (PNG spec §6). Filters 0/1/2 cover what
    common encoders emit for small images and are vectorized; Average and
    Paeth carry a sequential left-dependency and fall back to a byte loop."""
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for r in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += stride + 1
        if ftype == 0:                        # None
            cur = line
        elif ftype == 1:                      # Sub: prefix sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:                      # Up
            cur = (line + prev) % 256
        elif ftype in (3, 4):                 # Average / Paeth
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 3:
                    cur[i] = (line[i] + (a + b) // 2) % 256
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    cur[i] = (line[i] + _paeth(int(a), int(b), int(c))) % 256
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[r] = cur.astype(np.uint8)
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode one PNG byte string to a ``[H, W]`` (gray) or ``[H, W, C]``
    uint8 array. Raises ValueError on malformed or out-of-subset files."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    width = height = bit_depth = color_type = interlace = None
    palette = None
    idat = []
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        if len(chunk) < length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length                    # length + type + payload + crc
        if ctype == b"IHDR":
            (width, height, bit_depth, color_type,
             _comp, _filt, interlace) = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError("missing IHDR")
    if bit_depth != 8:
        raise ValueError(f"unsupported PNG bit depth {bit_depth}")
    if interlace:
        raise ValueError("interlaced PNG unsupported")
    nch = _CHANNELS.get(color_type)
    if nch is None:
        raise ValueError(f"unsupported PNG color type {color_type}")
    if not idat:
        raise ValueError("missing IDAT")
    raw = zlib.decompress(b"".join(idat))
    stride = width * nch
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG pixel data size mismatch")
    px = _unfilter(raw, height, stride, nch).reshape(height, width, nch)
    if color_type == 3:                       # palette lookup -> RGB
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        px = palette[px[..., 0]]
    return px[..., 0] if px.shape[-1] == 1 else px


def decode_png_rgb(data: bytes) -> np.ndarray:
    """decode_png normalized to ``[H, W, 3]``: gray is broadcast, alpha is
    dropped (torchvision's ImageFolder loads via ``Image.convert('RGB')``,
    which composites over black only for exotic modes; CINIC is plain RGB)."""
    img = decode_png(data)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.shape[-1] == 4:
        img = img[..., :3]
    elif img.shape[-1] == 2:                  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    return img
