"""PNG images with `zlib` and `struct` alone: the machines the port runs on
need no imaging package (the JAX package reads images with PIL and writes
them with imageio).

`read_png` decodes 8-bit gray, gray + alpha, RGB and RGBA PNGs without
interlace, with any of the five row filters (None, Sub, Up, Average,
Paeth), to the arrays PIL gives: (H, W) for gray, (H, W, C) otherwise,
uint8. 16-bit, palette and interlaced PNGs raise. `read_image` reads a PNG
and names a JPEG in its error: JPEG decoding is not ported. `write_png`
writes the same four color types with filter type 0 on every row.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
# PNG color type -> channels, for the 8-bit types this codec reads
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W) gray or (H, W, C) uint8, C in 1-4 (gray, gray + alpha, RGB,
    RGBA) -> an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1-4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, c * w)], 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_MAGIC
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              _COLOR_TYPE[c], 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def _unfilter(ft: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Undo the row filters. ft (H,) filter types, raw (H, W, C) filtered
    bytes -> (H, W, C) uint8. Each byte's predictor reads its left, upper
    and upper-left neighbours' reconstructed values, so the decode walks
    anti-diagonals x + y = d (every cell of one diagonal depends only on
    earlier diagonals), vectorised over each diagonal's cells."""
    if ft.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ft.max())}")
    h, w, c = raw.shape
    if not ft.any():
        return raw
    out = np.zeros((h + 1, w + 1, c), np.int32)       # a zero row and column
    ftc = ft.astype(np.int32)[:, None]
    src = raw.astype(np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(d, h - 1) + 1)
        x = d - y
        a = out[y + 1, x]                             # left
        b = out[y, x + 1]                             # up
        cc = out[y, x]                                # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        f = ftc[y]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray / gray + alpha / RGB / RGBA PNG without interlace ->
    uint8 (H, W) for gray, (H, W, C) otherwise, as PIL's `np.asarray`
    gives it. Other PNGs raise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: {tag!r} chunk fails its CRC")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit PNGs are read")
    if color_type == 3:
        raise ValueError(f"{path}: palette PNG; only gray, gray + alpha, RGB "
                         "and RGBA PNGs are read")
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: PNG color type {color_type} is unknown")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG; only PNGs without "
                         "interlace are read")
    c = _CHANNELS[color_type]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (w * c + 1)].reshape(h, w * c + 1)
    img = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, c))
    return img[..., 0].copy() if c == 1 else np.ascontiguousarray(img)


def read_image(path: str) -> np.ndarray:
    """A dataset image -> `read_png`'s array. A JPEG raises: its decoding is
    not ported (convert the images to PNG)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:3] == JPEG_MAGIC:
        raise ValueError(f"{path}: JPEG decoding is not ported; convert the "
                         "dataset's images to PNG")
    return read_png(path)
