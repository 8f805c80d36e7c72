"""Targa (TGA) images in numpy and the port's C++, to the arrays PIL 12 gives
(the JAX reader opens dataset images with PIL; the machines the port runs
on have none).

TGA has no magic number: `tga_header` applies the header checks of PIL's
`TgaImagePlugin._open` (colour-map type 0 or 1, a width and height, pixel
depth 1, 8, 16, 24 or 32, image type 1, 2, 3, 9, 10 or 11, a colour map of
16, 24 or 32 bits), and `io/png.py::read_image` tries it only after every
format PIL identifies first (see there). `read_tga` reads what PIL opens:

- types 3 / 11 (gray): 8-bit -> (H, W); 1-bit -> (H, W) 0 and 255, as
  PIL's `convert("L")` (PIL opens it as mode 1, whose `np.asarray` is a
  bool array that the JAX reader divides by 255: fault B16); 16-bit gray +
  alpha -> (H, W, 2), which `data/readers.py` takes as RGBA (fault A2);
- types 2 / 10 (true colour): 24-bit BGR -> RGB; 32-bit BGRA -> RGBA;
  16-bit 5-5-5 -> RGBA, each field widened as PIL's `BGRA;15Z` unpacker
  widens it (v * 255 // 31), the alpha 0 where bit 15 is set and 255 where
  it is not;
- types 1 / 9 (colour-mapped, 8-bit indices): expanded to RGB, as PIL's
  `convert("RGB")` (PIL opens it as mode P, whose `np.asarray` is the
  indices: fault B15, which the JAX reader keeps), from a 24-bit map, or
  RGBA (`convert("RGBA")`) from a 16-bit one; the map's first-entry index
  applied, indices outside the map black.

The image descriptor's count of alpha bits (byte 17, bits 0-3) decides
the alpha, where PIL never reads it (fault B20): 0 means none, so a 32-bit
or 16-bit file comes as RGB, the fourth byte or bit 15 dropped, and a
gray + alpha one as gray (PIL takes the fourth byte as alpha, and the JAX
reader then masks the view with it); any other count keeps PIL's array.
The descriptor's bits 4 and 5 put the origin at each of the four corners,
as PIL honours them; the ID field is skipped.

RLE packets (types 9-11) are walked as PIL's `TgaRleDecode` walks them
(`gm_tga_rle` of `csrc/image.cpp`; `_rle_plain` here is the same walk in
Python, held to it byte for byte): a literal packet may run on into the
next rows, a repeated one may not cross the end of its row (PIL: buffer
overrun). Data that ends before the image is full raises, as PIL raises.
PIL cannot load 15-bit pixels or maps, a 32-bit colour map, a colour map
on true-colour or 1-bit pixels or past entry 255, type 1 without a map,
1-bit RLE and the other depths of each type; each raises with its cause.

`encode_tga` / `write_tga` write raw or RLE gray, RGB, RGBA, 16-bit and
colour-mapped files at each orientation, for the tests and
`chip_smoke.py`; the training path does not write TGAs.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.ops import _cuda

# (image type & 7, depth) -> what PIL's TgaImagePlugin loads it as
_LAYOUTS = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
            (2, 24): "BGR", (2, 32): "BGRA"}
_MAP_BYTES = {16: 2, 24: 3, 32: 4}
_KINDS = {1: "colour-mapped", 2: "true-colour", 3: "gray"}


def tga_header(data: bytes) -> dict | None:
    """The header fields of a file that PIL's `TgaImagePlugin._open`
    accepts, or None where it does not."""
    if len(data) < 18:
        return None
    id_len, cmap, kind, first, n_map, map_depth, _, _, w, h, depth, desc = struct.unpack_from(
        "<BBBHHBHHHHBB", data)
    if (cmap not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32)
            or kind not in (1, 2, 3, 9, 10, 11) or (cmap and map_depth not in _MAP_BYTES)):
        return None
    return dict(id_len=id_len, cmap=cmap, kind=kind, first=first, n_map=n_map,
                map_depth=map_depth, width=w, height=h, depth=depth, desc=desc)


def read_tga(path: str) -> np.ndarray:
    """A TGA -> uint8 (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or
    (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_tga(f.read(), path)


def decode_tga(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_tga` of a TGA's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle)


def decode_tga_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_tga` with RLE packets walked by the plain version."""
    return _decode(data, path, _rle_plain)


def _rle(data: bytes, pixel_bytes: int, row_bytes: int, total: int):
    """RLE packets -> (the bytes decoded, at most `total`; whether a run
    crossed the end of its row) (`gm_tga_rle`)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(total, np.uint8)
    n_out = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_tga_rle(
        src.ctypes.data, len(src), pixel_bytes, row_bytes, total, out.ctypes.data,
        n_out.ctypes.data)
    if status not in (0, 8):
        raise RuntimeError(f"gm_tga_rle returned {status}")
    return out[:int(n_out[0])], status == 8


def _rle_plain(data: bytes, pixel_bytes: int, row_bytes: int, total: int):
    """`_rle` as a Python loop over the packets (the plain version)."""
    out = bytearray()
    i, n = 0, len(data)
    while len(out) < total and i < n:
        h = data[i]
        nb = ((h & 127) + 1) * pixel_bytes
        if h & 128:
            if n - i < 1 + pixel_bytes:
                break
            if len(out) % row_bytes + nb > row_bytes:
                return np.frombuffer(bytes(out), np.uint8), True
            out += data[i + 1:i + 1 + pixel_bytes] * (nb // pixel_bytes)
            i += 1 + pixel_bytes
        else:
            if n - i < 1 + nb:
                break
            out += data[i + 1:i + 1 + min(nb, total - len(out))]
            i += 1 + nb
    return np.frombuffer(bytes(out), np.uint8), False


def _widen15(v: np.ndarray, alpha: bool) -> np.ndarray:
    """16-bit pixels (little-endian 1-5-5-5) -> RGB(A) as PIL's `BGRA;15Z`."""
    fields = [((v >> s) & 31).astype(np.int32) * 255 // 31 for s in (10, 5, 0)]
    if alpha:
        fields.append(np.where(v & 0x8000, 0, 255))
    return np.stack(fields, -1).astype(np.uint8)


def _decode(data: bytes, path: str, rle) -> np.ndarray:
    hd = tga_header(data)
    if hd is None:
        raise ValueError(f"{path}: not a TGA")
    kind, depth, w, h = hd["kind"] & 7, hd["depth"], hd["width"], hd["height"]
    alpha = hd["desc"] & 15 > 0
    layout = _LAYOUTS.get((kind, depth))
    if layout is None:
        raise ValueError(f"{path}: {depth}-bit {_KINDS[kind]} TGA, which PIL cannot load")
    if hd["kind"] & 8 and depth == 1:
        raise ValueError(f"{path}: 1-bit RLE TGA, which PIL cannot load (image file is "
                         "truncated)")
    if layout == "P" and not hd["cmap"]:
        raise ValueError(f"{path}: colour-mapped TGA without a colour map, which PIL "
                         "cannot load")
    if hd["cmap"] and hd["map_depth"] == 32:
        raise ValueError(f"{path}: TGA with a 32-bit colour map, which PIL cannot load "
                         "(unrecognized raw mode)")
    if hd["cmap"] and layout not in ("P", "L", "LA"):
        raise ValueError(f"{path}: {depth}-bit {_KINDS[kind]} TGA with a colour map, which "
                         "PIL cannot load (unrecognized image mode)")
    if hd["cmap"] and hd["first"] + hd["n_map"] > 256:
        raise ValueError(f"{path}: TGA colour map of {hd['n_map']} entries from entry "
                         f"{hd['first']}, past entry 255 (PIL: invalid palette size)")
    pos = 18 + hd["id_len"]
    entry = _MAP_BYTES.get(hd["map_depth"], 0) if hd["cmap"] else 0
    cmap = data[pos:pos + entry * hd["n_map"]]
    pos += entry * hd["n_map"]
    row_bytes = (w * depth + 7) // 8
    total = row_bytes * h
    if hd["kind"] & 8:
        px, crossed = rle(data[pos:], (depth + 7) // 8, row_bytes, total)
        if crossed:
            raise ValueError(f"{path}: a TGA run packet crosses the end of its row (PIL: "
                             "buffer overrun)")
        if len(px) < total:
            raise ValueError(f"{path}: TGA RLE data ends after {len(px)} of {total} bytes "
                             "(cut short)")
    else:
        if len(data) < pos + total:
            raise ValueError(f"{path}: TGA pixel data cut short (truncated TGA)")
        px = np.frombuffer(data, np.uint8, total, pos)
    rows = px.reshape(h, row_bytes)
    if not hd["desc"] & 0x20:                     # bottom-up
        rows = rows[::-1]
    if layout == "1":
        img = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    elif layout == "BGRA;15Z":
        img = _widen15(rows.copy().view("<u2"), alpha)
    else:
        img = rows.reshape(h, w, depth // 8)
        if layout == "BGR" or (layout == "BGRA" and not alpha):
            img = img[..., 2::-1]
        elif layout == "BGRA":
            img = img[..., [2, 1, 0, 3]]
        elif layout == "LA" and not alpha:
            img = img[..., 0]
        elif layout == "L":
            img = img[..., 0]
        elif layout == "P":
            img = _palette(cmap, hd, alpha)[img[..., 0]]
    if hd["desc"] & 0x10:                         # right to left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def _palette(cmap: bytes, hd: dict, alpha: bool) -> np.ndarray:
    """The colour map -> (256, 3 or 4) uint8, as PIL builds it: entry
    `first` + k from the map's k-th entry, the others black."""
    first, n = hd["first"], len(cmap) // _MAP_BYTES[hd["map_depth"]]
    if hd["map_depth"] == 16:
        cols = _widen15(np.frombuffer(cmap, "<u2", n), alpha)
    else:
        cols = np.frombuffer(cmap, np.uint8, 3 * n).reshape(n, 3)[:, ::-1]
    pal = np.zeros((max(256, first + n), cols.shape[1]), np.uint8)
    if cols.shape[1] == 4:
        pal[:, 3] = 255
    pal[first:first + n] = cols
    return pal[:256]


# ------------------------------------------------------------------ writer

def _rle_encode(px: np.ndarray) -> bytes:
    """Pixels (H, W, B) in stored row order -> TGA RLE packets: runs of 2 or
    more equal pixels as repeated packets, the pixels between as literal
    ones, at most 128 pixels a packet, none crossing a row's end."""
    h, w, b = px.shape
    key = np.zeros((h, w), np.uint64)
    for k in range(b):
        key = key << np.uint64(8) | px[..., k].astype(np.uint64)
    start, length, run = runs.segments(key, 2, 128, 128)
    head = np.where(run, 127 + length, length - 1).astype(np.uint8)[:, None]
    take = np.where(run, b, length * b)
    return runs.assemble(px.ravel(), start * b, head, np.ones(len(start), np.int64), take,
                         np.zeros(len(start), np.int64)).tobytes()


def encode_tga(img: np.ndarray, rle: bool = False, palette: np.ndarray | None = None,
               top_down: bool = False, right_to_left: bool = False,
               alpha_bits: int | None = None, bits16: bool = False) -> bytes:
    """uint8 (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or (H, W, 4)
    RGBA -> the bytes of a TGA (`rle`: types 9-11). `palette` (N, 3) uint8
    RGB, N <= 256: `img` is (H, W) indices into it, written as a 24-bit
    colour map. `bits16`: RGB(A) written as 16-bit 5-5-5 pixels (each value
    >> 3; bit 15 set where an RGBA alpha is under 128). `alpha_bits`: the
    descriptor's count (default 8 with alpha, 1 for 16-bit RGBA, else 0).
    `top_down` / `right_to_left` set the origin's corner."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("encode_tga takes uint8 (H, W) or (H, W, C)")
    c = 1 if img.ndim == 2 else img.shape[2]
    cmap = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if c != 1 or len(palette) > 256 or int(img.max(initial=0)) >= len(palette):
            raise ValueError("encode_tga takes (H, W) indices into at most 256 colours")
        kind, depth, cmap = 1, 8, palette[:, ::-1].tobytes()
        px = img[..., None]
    elif bits16:
        if c not in (3, 4):
            raise ValueError("16-bit TGA pixels are RGB or RGBA")
        v = ((img[..., 0].astype(np.uint16) >> 3) << 10 | (img[..., 1] >> 3).astype(
            np.uint16) << 5 | (img[..., 2] >> 3))
        if c == 4:
            v |= np.where(img[..., 3] < 128, 0x8000, 0).astype(np.uint16)
        kind, depth, px = 2, 16, v.astype("<u2").view(np.uint8).reshape(*v.shape, 2)
    elif c in (1, 2):
        kind, depth, px = 3, 8 * c, img.reshape(*img.shape[:2], c)
    elif c in (3, 4):
        kind, depth, px = 2, 8 * c, img[..., [2, 1, 0, 3][:c]]
    else:
        raise ValueError(f"encode_tga takes 1-4 channels, not {c}")
    if alpha_bits is None:
        alpha_bits = (1 if bits16 else 8) if c in (2, 4) else 0
    if not top_down:
        px = px[::-1]
    if right_to_left:
        px = px[:, ::-1]
    px = np.ascontiguousarray(px)
    body = _rle_encode(px) if rle else px.tobytes()
    desc = alpha_bits | (0x20 if top_down else 0) | (0x10 if right_to_left else 0)
    h, w = img.shape[:2]
    head = struct.pack("<BBBHHBHHHHBB", 0, int(palette is not None), kind + 8 * rle, 0,
                       len(cmap) // 3, 24 if cmap else 0, 0, 0, w, h, depth, desc)
    return head + cmap + body


def write_tga(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_tga(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_tga(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
