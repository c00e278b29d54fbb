"""Minimal dependency-free PNG writer/reader (RGBA8 and RGB8): a copy of
fourdgs/io/png.py, which writes the same bytes (numpy only; importing the
reference package would import JAX).

The viewer CLI and the examples dump frames to PNG. Pure Python over zlib,
no PIL/imageio; callers hand over host (numpy) images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] (H, W, C) -> uint8, clipping like the GL framebuffer."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3|4) float [0,1] or uint8 image to `path`."""
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    h, w, c = arr.shape
    assert c in (3, 4), f"need RGB/RGBA, got {c} channels"
    color_type = 2 if c == 3 else 6
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", header)
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB/RGBA PNG written by write_png (filter 0 only is
    required for round-tripping our own files; filters 0-4 are supported)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            assert depth == 8 and interlace == 0, "unsupported PNG variant"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    c = {2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        filt = raw[p]
        line = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(np.int32)
        p += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 1:   # Sub
            cur = line.copy()
            for i in range(c, stride):
                cur[i] = (cur[i] + cur[i - c]) & 0xFF
        elif filt == 2:   # Up
            cur = (line + prev) & 0xFF
        elif filt == 3:   # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif filt == 4:   # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - c] if i >= c else 0
                b = prev[i]
                cc = prev[i - c] if i >= c else 0
                pp = a + b - cc
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, c)
