"""Sun raster images in numpy and the port's C++, to the arrays PIL 12 gives
(the JAX reader opens dataset images with PIL; the machines the port runs
on have none).

`read_sun` reads what PIL's `SunImagePlugin` opens: magic 0x59A66A95, then
width, height, depth, length (unread), type, colour-map type and length,
big-endian; the colour map; the raster, rows padded to 16 bits. Depths:

- 1 -> (H, W) 0 and 255, a set bit black (PIL's `1;I`; PIL opens it as
  mode 1, whose `np.asarray` is a bool array that the JAX reader divides
  by 255: fault B16, so `read_sun` gives `convert("L")`'s 0 and 255);
- 4 -> (H, W), each nibble times 17 (PIL's `L;4`); 8 -> (H, W);
- 24 -> RGB, stored BGR (RGB in type 3, RT_FORMAT_RGB);
- 32 -> RGB, stored BGRX (RGBX in type 3), the fourth byte dropped.

A colour map (type 1, RT_RGB: the reds, then the greens, then the blues,
at most 1,024 bytes) makes a 4- or 8-bit image indices, which PIL opens as
mode P: `read_sun` expands them as `convert("RGB")` does (fault B15), an
index past the map's `length // 3` entries black. PIL cannot load a map of
more than 256 entries, nor one beside a 1-, 24- or 32-bit raster, and
neither does `read_sun`.

Types 0, 1, 3, 4 and 5 are raw; type 2 (RT_BYTE_ENCODED) is the type-1
raster coded as one stream of bytes: 0x80 0 is a literal 0x80, 0x80 c v is
c + 1 copies of v, any other byte is itself (`gm_sun_rle` of
`csrc/image.cpp`; `_rle_plain` here is the same walk in Python, held to it
byte for byte). PIL's `sun_rle` decoder fills rows of `ceil(width * depth
/ 8)` bytes, unpadded, so every type-2 file whose row is an odd number of
bytes reads shifted by a byte a row (fault B24); `read_sun` reads the
padded rows the type-1 raster has, and equals PIL wherever the row is even.

A header PIL's `_open` refuses (another depth or type, a colour map of
another type or over 1,024 bytes, a size of 0, a header cut short) gives
way (`io/giveway.py`); a raster the file cuts raises.

`encode_sun` / `write_sun` write every depth, raw (type 1 or 3) or
byte-encoded, with or without a colour map, for the tests and
`chip_smoke.py`; the training path does not write Sun rasters.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.ops import _cuda

SUN_MAGIC = b"\x59\xa6\x6a\x95"
_HEADER = 32
_DEPTHS = (1, 4, 8, 24, 32)
_RAW_TYPES = (0, 1, 3, 4, 5)
_BYTE_ENCODED = 2


def stride(width: int, depth: int) -> int:
    """The bytes of one raster row: width * depth bits padded to 16."""
    return (width * depth + 15) // 16 * 2


def read_sun(path: str) -> np.ndarray:
    """A Sun raster -> uint8 (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_sun(f.read(), path)


def decode_sun(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_sun` of a Sun raster's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle)


def decode_sun_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_sun` with byte-encoded data walked by the plain version."""
    return _decode(data, path, _rle_plain)


def _rle(data: bytes, total: int) -> np.ndarray:
    """Byte-encoded data -> its first `total` bytes, fewer where the data
    ends first, uint8 (`gm_sun_rle`)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(total, np.uint8)
    info = np.zeros(2, np.int64)
    status = _cuda.host_library("image").gm_sun_rle(src.ctypes.data, len(src), total,
                                                    out.ctypes.data, info.ctypes.data)
    if status:
        raise RuntimeError(f"gm_sun_rle returned {status}")
    return out[:int(info[0])]


def _rle_plain(data: bytes, total: int) -> np.ndarray:
    """`_rle` as a Python loop over the packets (the plain version)."""
    out = bytearray()
    i, n = 0, len(data)
    while len(out) < total and i < n:
        b = data[i]
        if b != 0x80:
            out.append(b)
            i += 1
        elif i + 1 < n and data[i + 1] == 0:
            out.append(0x80)
            i += 2
        elif i + 2 < n:
            out += data[i + 2:i + 3] * min(data[i + 1] + 1, total - len(out))
            i += 3
        else:
            break
    return np.frombuffer(bytes(out), np.uint8)


def header(data: bytes, path: str = "<bytes>"):
    """A Sun raster's header as PIL's `_open` reads it -> (width, height,
    depth, type, the colour map's bytes); gives way where `_open` does."""
    if data[:4] != SUN_MAGIC:
        raise GiveWay(f"{path}: not an SUN raster file")
    if len(data) < _HEADER:
        raise GiveWay(f"{path}: SUN header cut short")
    w, h, depth, _, kind, map_type, map_len = struct.unpack_from(">7I", data, 4)
    if depth not in _DEPTHS:
        raise GiveWay(f"{path}: SUN raster of depth {depth} (PIL: Unsupported Mode/Bit Depth)")
    if map_len and map_len > 1024:
        raise GiveWay(f"{path}: SUN colour map of {map_len} bytes (PIL: Unsupported Color "
                      "Palette Length)")
    if map_len and map_type != 1:
        raise GiveWay(f"{path}: SUN colour map of type {map_type} (PIL: Unsupported Palette "
                      "Type)")
    if kind not in _RAW_TYPES and kind != _BYTE_ENCODED:
        raise GiveWay(f"{path}: SUN raster of type {kind} (PIL: Unsupported Sun Raster file "
                      "type)")
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: SUN raster of {w}x{h} pixels (PIL: not identified)")
    return w, h, depth, kind, data[_HEADER:_HEADER + map_len]


def _decode(data: bytes, path: str, rle) -> np.ndarray:
    w, h, depth, kind, cmap = header(data, path)
    if cmap and depth not in (4, 8):
        raise ValueError(f"{path}: a {depth}-bit SUN raster with a colour map, which PIL "
                         "cannot load (unrecognized image mode)")
    entries = len(cmap) // 3
    if entries > 256:
        raise ValueError(f"{path}: a SUN colour map of {entries} entries, which PIL cannot "
                         "load (invalid palette size)")
    row = stride(w, depth)
    total = row * h
    body = data[_HEADER + len(cmap):]
    if kind == _BYTE_ENCODED:
        raster = rle(body, total)
    else:
        raster = np.frombuffer(body, np.uint8, min(total, len(body)))
    if len(raster) < total:
        raise ValueError(f"{path}: SUN raster data ends after {len(raster)} of {total} bytes "
                         "(image file is truncated)")
    rows = raster.reshape(h, row)
    if depth == 1:
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    if depth == 4:
        px = np.stack([rows >> 4, rows & 15], 2).reshape(h, -1)[:, :w]
    elif depth == 8:
        px = rows[:, :w]
    else:
        px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
        return np.ascontiguousarray(px[..., :3] if kind == 3 else px[..., 2::-1])
    if not cmap:
        return np.ascontiguousarray(px * np.uint8(17) if depth == 4 else px)
    pal = np.zeros((256, 3), np.uint8)
    planes = np.frombuffer(cmap, np.uint8, 3 * entries).reshape(3, entries)
    pal[:entries] = planes.T
    return pal[px]


# ------------------------------------------------------------------ writer

def _byte_encode(raster: np.ndarray) -> np.ndarray:
    """The raster's bytes -> RT_BYTE_ENCODED: runs of 3 or more as 0x80 c
    v (at most 256, crossing rows), the other bytes as themselves, 0x80 as
    0x80 0."""
    n = len(raster)
    start, length, run = runs.segments(raster[None, :], 3, 256, max(n, 1))
    r_start, r_len = start[run], length[run]
    edge = np.zeros(n + 1, np.int64)
    np.add.at(edge, r_start, 1)
    np.add.at(edge, r_start + r_len, -1)
    lit = np.flatnonzero(np.cumsum(edge[:-1]) == 0)
    # a run's last piece of 1 (0x80 0 would be a literal 0x80) is a literal
    lit = np.sort(np.concatenate([lit, r_start[r_len == 1]]))
    r_start, r_len = r_start[r_len > 1], r_len[r_len > 1]
    pos = np.concatenate([r_start, lit])
    order = np.argsort(pos, kind="stable")
    is_run = np.concatenate([np.ones(len(r_start), bool), np.zeros(len(lit), bool)])[order]
    value = raster[pos[order]]
    count = np.concatenate([r_len, np.ones(len(lit), np.int64)])[order]
    size = np.where(is_run, 3, np.where(value == 0x80, 2, 1))
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = np.where(is_run, 0x80, value)
    out[at[is_run] + 1] = (count[is_run] - 1).astype(np.uint8)
    out[at[is_run] + 2] = value[is_run]
    out[at[~is_run & (value == 0x80)] + 1] = 0
    return out


def encode_sun(img: np.ndarray, depth: int | None = None, colormap: np.ndarray | None = None,
               rle: bool = False, rgb_order: bool = False) -> bytes:
    """An image -> the bytes of a Sun raster. `img`: (H, W) at depth 1
    (0 black, anything else white), 4 (nibbles 0-15, or indices into
    `colormap`) or 8 (gray, or indices); (H, W, 3) RGB at depth 24 or 32
    (a fourth byte of 0). `colormap`: (N, 3) uint8, N <= 256, written
    planar. `rle`: type 2, else raw: type 1, or type 3 (RGB order) where
    `rgb_order`."""
    img = np.asarray(img)
    if depth is None:
        depth = 24 if img.ndim == 3 else 8
    h, w = img.shape[:2]
    if (depth in (24, 32)) != (img.ndim == 3) or depth not in _DEPTHS:
        raise ValueError("encode_sun takes (H, W) at depths 1, 4 and 8, (H, W, 3) at 24 and 32")
    row = stride(w, depth)
    if depth == 1:
        packed = np.packbits(img == 0, axis=1)
    elif depth == 4:
        nib = np.zeros((h, 2 * -(-w // 2)), np.uint8)
        nib[:, :w] = img
        packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    elif depth == 8:
        packed = img.astype(np.uint8)
    else:
        px = img if rgb_order else img[..., ::-1]
        if depth == 32:
            px = np.concatenate([px, np.zeros((h, w, 1), np.uint8)], 2)
        packed = px.reshape(h, -1)
    raster = np.zeros((h, row), np.uint8)
    raster[:, :packed.shape[1]] = packed
    body = _byte_encode(raster.ravel()) if rle else raster.ravel()
    cmap = b"" if colormap is None else np.asarray(colormap, np.uint8).T.tobytes()
    kind = _BYTE_ENCODED if rle else (3 if rgb_order else 1)
    return (SUN_MAGIC + struct.pack(">7I", w, h, depth, len(body), kind, int(bool(cmap)),
                                    len(cmap)) + cmap + body.tobytes())


def write_sun(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_sun(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_sun(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
