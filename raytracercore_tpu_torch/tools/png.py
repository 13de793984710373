"""Minimal dependency-free PNG writer (RGB / RGBA uint8).

Replaces the reference's System.Drawing bitmap save (MainWindow.cs:226-254)
for the headless CLI.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3|4] uint8 array as a PNG file."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError("write_png expects [H, W, 3|4]")
    h, w, c = image.shape
    color_type = 2 if c == 3 else 6

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = struct.pack(">I", len(data)) + tag + data
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return out + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)


def read_png(path: str) -> np.ndarray:
    """Read a (non-interlaced, 8-bit RGB/RGBA) PNG back into uint8 [H,W,C].
    Supports only files produced by :func:`write_png` (filter 0)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, *_ = struct.unpack(">IIBBBBB", body)
            assert depth == 8
            c = {2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c + 1
    rows = []
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        assert row[0] == 0, "only filter 0 supported"
        rows.append(np.frombuffer(row[1:], dtype=np.uint8))
    return np.stack(rows).reshape(h, w, c)
