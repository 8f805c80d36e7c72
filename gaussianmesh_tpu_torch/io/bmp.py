"""BMP images in numpy, to the arrays PIL 12 gives (the JAX reader opens
dataset images with PIL; the machines the port runs on have none).

`read_bmp` reads uncompressed Windows bitmaps with a 40-, 52-, 56-, 108- or
124-byte header, rows bottom-up or top-down, each padded to 4 bytes:

- 24-bit (BI_RGB, or BI_BITFIELDS with PIL's BGR masks) -> (H, W, 3) RGB;
- 32-bit BI_RGB -> RGB: PIL drops the fourth byte;
- 32-bit BI_BITFIELDS with one of the byte-aligned mask sets PIL reads ->
  RGB, or RGBA where a mask names alpha (with a 40-byte header the masks
  follow it and there is no alpha mask);
- 8-bit palette -> (H, W) gray where the palette is the gray ramp (entry i
  is (i, i, i), which PIL opens as mode L), else expanded to RGB, as PIL's
  `convert("RGB")` does (PIL opens it as mode P, whose `np.asarray` is the
  indices: fault B15, which the JAX reader keeps).

RLE8 / RLE4 compression, 1-, 4- and 16-bit pixels, other masks and OS/2
headers raise with the cause. Every step is a numpy array operation over
all pixels: there is no loop over pixels to put in C++.
"""

from __future__ import annotations

import struct

import numpy as np

BMP_MAGIC = b"BM"

_HEADERS = (40, 52, 56, 108, 124)
_COMPRESSIONS = {1: "RLE8", 2: "RLE4", 4: "JPEG", 5: "PNG"}
# PIL's 32-bit BI_BITFIELDS masks (R, G, B, A) -> the byte order of a pixel
_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}


def read_bmp(path: str) -> np.ndarray:
    """A BMP -> uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)


def decode_bmp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_bmp` of a BMP's bytes (`path` names it in errors)."""
    if data[:2] != BMP_MAGIC or len(data) < 18:
        raise ValueError(f"{path}: not a BMP")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize not in _HEADERS:
        raise ValueError(f"{path}: BMP header of {hsize} bytes (OS/2 or unknown); only "
                         "the Windows headers of 40, 52, 56, 108 and 124 bytes are read")
    if len(data) < 14 + hsize:
        raise ValueError(f"{path}: BMP header cut short")
    width, height, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    (colors,) = struct.unpack_from("<I", data, 46)
    top_down = height < 0
    height = abs(height)
    pos = 14 + hsize
    if compression in _COMPRESSIONS:
        raise ValueError(f"{path}: {_COMPRESSIONS[compression]}-compressed BMP; only "
                         "uncompressed BMPs are read")
    if compression not in (0, 3):
        raise ValueError(f"{path}: BMP compression {compression} is unknown")
    if bits not in (8, 24, 32):
        raise ValueError(f"{path}: {bits}-bit BMP; only 8-, 24- and 32-bit BMPs are read")
    order = {24: "BGR", 32: "BGRX"}.get(bits)
    if compression == 3:                # BI_BITFIELDS
        if hsize >= 52:
            masks = struct.unpack_from("<III", data, 54) + (
                struct.unpack_from("<I", data, 66) if hsize >= 56 else (0,))
        else:
            masks = struct.unpack_from("<III", data, pos) + (0,)
            pos += 12
        if bits == 32 and masks in _MASKS_32:
            order = _MASKS_32[masks]
        elif not (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise ValueError(f"{path}: {bits}-bit BMP with bit-field masks "
                             f"{[hex(m) for m in masks]}; only PIL's byte-aligned "
                             "masks of 24- and 32-bit pixels are read")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:      # an offset that points at the palette
        offset += 4 * colors
    stride = ((width * bits + 31) >> 3) & ~3
    if width <= 0 or len(data) < offset + stride * height:
        raise ValueError(f"{path}: BMP pixel data cut short (truncated BMP)")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    px = rows[:, :width * bits // 8].reshape(height, width, bits // 8)
    if bits == 8:
        if not 0 < colors <= 256:
            raise ValueError(f"{path}: 8-bit BMP with a palette of {colors} colours")
        if len(data) < pos + 4 * colors:
            raise ValueError(f"{path}: BMP palette cut short")
        pal = np.frombuffer(data, np.uint8, 4 * colors, pos).reshape(colors, 4)
        ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
        if (pal[:, :3] == ramp[:, None]).all():
            if colors == 2:
                raise ValueError(f"{path}: 8-bit BMP with a black-and-white palette, "
                                 "which PIL reads as 1-bit pixels; not read")
            return np.ascontiguousarray(px[..., 0])     # PIL's mode L: the indices
        rgb = np.zeros((256, 3), np.uint8)
        rgb[:colors] = pal[:, 2::-1]
        return rgb[px[..., 0]]
    take = [order.index(ch) for ch in ("RGBA" if "A" in order else "RGB")]
    return np.ascontiguousarray(px[..., take])
