"""GIF images in numpy and the port's C++ LZW decoder, to the arrays PIL 12
gives (the JAX reader opens dataset images with PIL; the machines the port
runs on have none).

`read_gif` reads the first frame of a `GIF87a` / `GIF89a` file, as
`Image.open` gives it: the logical screen, grown to hold the frame where
the frame runs past it, as PIL grows it; the global and local colour
tables; the graphic control extension's transparent index (other
extensions are skipped); a frame smaller than the screen or offset on it,
the pixels outside it the transparent index where there is one and index 0
where there is not; interlaced rows (the 8 / 8 / 4 / 2 passes) put in
place with one numpy index. The image data is LZW (`io/lzw.py`, GIF's
variant: `gm_lzw_decode`). The result is expanded as the port expands a
palette PNG (PIL opens it as mode P, whose `np.asarray` is the indices:
fault B15, which the JAX reader keeps): RGB, as PIL's `convert("RGB")`, or
RGBA where a transparent index is set, as `convert("RGBA")` (the
transparent index alpha 0); indices past the palette are black. Where PIL
opens the frame as mode L (no colour table, or one that is the gray ramp:
entry i is (i, i, i)) it is (H, W), the indices.

A code past the LZW table, or a string that runs past the frame, raises.
So does image data that ends before the frame is full (at EOI, at the
block terminator or at the end of the file), as PIL 12 raises ("image file
is truncated"); a frame that is full decodes whatever follows it, the
block terminator and the trailer missing included, as PIL's does.
`decode_gif_plain`
decodes with `io/lzw.py::lzw_decode_plain`, which the C++ is held to byte
for byte; the training path never calls it.

`encode_gif` / `write_gif` write one frame of palette indices, optionally
interlaced, with a transparent index, the LZW encoder in C++
(`gm_lzw_encode`), for the tests and `chip_smoke.py`; the training path
does not write GIFs.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import lzw

GIF_MAGICS = (b"GIF87a", b"GIF89a")


def read_gif(path: str) -> np.ndarray:
    """A GIF -> uint8 (H, W, 3) RGB, (H, W, 4) RGBA where a transparent
    index is set, or (H, W) where PIL opens it as mode L."""
    with open(path, "rb") as f:
        return decode_gif(f.read(), path)


def decode_gif(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_gif` of a GIF's bytes (`path` names it in errors)."""
    return _decode(data, path, lzw.lzw_decode)


def decode_gif_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_gif` with the LZW data decoded by the plain version."""
    return _decode(data, path, lzw.lzw_decode_plain)


def _table(data: bytes, pos: int, flags: int, path: str):
    """A colour table flagged in `flags` at `pos` -> (its (2^n, 3) entries,
    or None where PIL drops it as the gray ramp; the position after it)."""
    n = 2 << (flags & 7)
    if len(data) < pos + 3 * n:
        raise ValueError(f"{path}: GIF colour table cut short (truncated GIF)")
    pal = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
    ramp = (pal == np.arange(n)[:, None]).all()
    return (None if ramp else pal), pos + 3 * n


def _blocks(data: bytes, pos: int):
    """Sub-blocks from `pos`, up to the terminator or the file's end ->
    (their bytes joined, the position after them)."""
    parts = []
    while pos < len(data) and data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def _frame_rows(h: int, interlace: bool) -> np.ndarray:
    """The row each stored row of a frame goes to."""
    if not interlace:
        return np.arange(h)
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def _decode(data: bytes, path: str, decode_lzw) -> np.ndarray:
    if data[:6] not in GIF_MAGICS or len(data) < 13:
        raise ValueError(f"{path}: not a GIF")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    palette = None
    if flags & 0x80:
        palette, pos = _table(data, pos, flags, path)
    transparency = None
    while True:                     # extensions up to the first image descriptor
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{path}: GIF without an image")
        tag = data[pos]
        pos += 1
        if tag == 0x21:
            label = data[pos:pos + 1]
            body, pos = _blocks(data, pos + 1)
            if label == b"\xf9" and len(body) >= 4 and body[0] & 1:
                transparency = body[3]
        elif tag == 0x2C:
            break                   # PIL skips any other byte here
    if len(data) < pos + 10:
        raise ValueError(f"{path}: GIF image descriptor cut short (truncated GIF)")
    x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
    pos += 9
    if fflags & 0x80:
        palette, pos = _table(data, pos, fflags, path)
    if fw == 0 or fh == 0:
        raise ValueError(f"{path}: GIF frame of {fw}x{fh} pixels")
    min_bits = data[pos]
    if not 2 <= min_bits <= 8:
        raise ValueError(f"{path}: GIF LZW minimum code size {min_bits}; 2-8 are read")
    try:
        idx = decode_lzw(_blocks(data, pos + 1)[0], fw * fh, "gif", min_bits)
    except ValueError as err:
        raise ValueError(f"{path}: GIF image data: {err}") from None
    if len(idx) < fw * fh:
        raise ValueError(f"{path}: GIF image data ends after {len(idx)} of {fw * fh} "
                         "pixels (truncated GIF)")
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    screen = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    screen[y0 + _frame_rows(fh, bool(fflags & 0x40)), x0:x0 + fw] = idx.reshape(fh, fw)
    if palette is None:             # PIL's mode L
        return screen
    pal = np.zeros((256, 4), np.uint8)
    pal[:len(palette), :3] = palette
    pal[:, 3] = 255
    if transparency is None:
        return np.take(np.ascontiguousarray(pal[:, :3]), screen, axis=0)
    pal[transparency, 3] = 0
    return np.take(pal, screen, axis=0)


def encode_gif(idx: np.ndarray, palette: np.ndarray, interlace: bool = False,
               transparency: int | None = None) -> bytes:
    """(H, W) uint8 palette indices and `palette` (N, 3) uint8 RGB, N <= 256
    -> a GIF89a of one frame (a global colour table of N rounded up to a
    power of two, at least 4; a graphic control extension where
    `transparency` is set; rows in the interlaced order where `interlace`;
    LZW at the table's bits, 255-byte sub-blocks)."""
    idx = np.asarray(idx)
    palette = np.asarray(palette, np.uint8).reshape(-1, 3)
    if idx.dtype != np.uint8 or idx.ndim != 2:
        raise ValueError("encode_gif takes (H, W) uint8 indices")
    if not 0 < len(palette) <= 256 or int(idx.max(initial=0)) >= len(palette):
        raise ValueError(f"encode_gif takes 1-256 colours and indices below them")
    h, w = idx.shape
    bits = max(2, int(len(palette) - 1).bit_length())
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | (bits - 1), 0, 0), table.tobytes()]
    if transparency is not None:
        out.append(b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00")
    out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x40 if interlace else 0))
    stream = lzw.lzw_encode(idx[_frame_rows(h, interlace)], "gif", bits)
    out.append(bytes([bits]))
    for i in range(0, len(stream), 255):
        out += [bytes([len(stream[i:i + 255])]), stream[i:i + 255]]
    out.append(b"\x00\x3b")
    return b"".join(out)


def write_gif(path: str, idx: np.ndarray, palette: np.ndarray, **kwargs) -> None:
    """`encode_gif(idx, palette, **kwargs)` written to `path` (its directory
    made if needed)."""
    data = encode_gif(idx, palette, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
