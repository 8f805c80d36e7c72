"""Windows icons (ICO) and cursors (CUR) in numpy and the port's readers of
the forms they hold, to the arrays PIL 12 gives (the JAX reader opens
dataset images with PIL; the machines the port runs on have none).

`read_ico` reads the directory as PIL's `IcoFile` does (a width or height
byte of 0 is 256; an entry with no bit count takes its depth from its
colour count, else 256), sorts the entries by depth, then, stably, by
area, largest first, and decodes the first:

- a PNG frame (`io/png.py::decode_png`) at the PNG's own size, whatever
  the directory says, under the PNG reader's rules (palettes expanded:
  B6; 1-bit gray scaled: B16);
- a BMP frame: the DIB (`io/bmp.py::bitmap`) at half its header's height,
  expanded to RGBA as PIL's `convert("RGBA")` expands it (a palette to its
  colours: B15; a black-and-white one to 0 and 255: B16), its alpha:
  - where the directory counts 32 bits, each pixel's fourth byte, read
    bottom-up from the pixel data as PIL reads it;
  - else the AND mask, which PIL finds at the entry's offset plus the
    directory's size less the mask's bytes, rows padded to 32 bits,
    bottom-up: a bit of 1 is alpha 0, of 0 alpha 255.

Fault B23: PIL gives a 32-bit frame whose every fourth byte is 0 (an icon
written before alpha channels) alpha 0 everywhere, and the JAX reader
trains the view as background or masks it out whole. `read_ico` takes
such a frame's alpha from its AND mask, as browsers' icon decoders do, and
255 where the entry holds no mask after the pixel rows; a frame with any
fourth byte that is not 0 keeps PIL's alpha.

`read_cur` picks the cursor PIL picks (the first, replaced by each later
one whose width and height bytes are both larger; 0 is 0 here), reads its
DIB at half its height with no mask, to RGB (RGBA where a 32-bit BI_RGB
bitmap starts at byte 22: PIL's rule), and refuses a PNG frame, which PIL
reads as a BMP header it does not know. A file PIL gives way on
(`io/giveway.py`: a directory cut short, no entries, a frame header cut
short, a bitmap of no size) raises `GiveWay`.

`encode_ico` / `encode_cur` write PNG and BMP frames (8-bit palettes, 24
and 32 bits, with AND masks), several to a file, for the tests and
`chip_smoke.py`; the training path does not write icons.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import bmp, png
from gaussianmesh_tpu_torch.io.giveway import GiveWay

ICO_MAGIC = b"\0\0\1\0"
CUR_MAGIC = b"\0\0\2\0"


def read_ico(path: str) -> np.ndarray:
    """An ICO -> uint8 (H, W, 4) RGBA from a BMP frame, or a PNG frame's
    array."""
    with open(path, "rb") as f:
        return decode_ico(f.read(), path)


def decode_ico(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_ico` of an ICO's bytes (`path` names it in errors)."""
    return _decode_ico(data, path, False)


def decode_ico_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_ico` through the plain versions of the frame's decoders."""
    return _decode_ico(data, path, True)


def read_cur(path: str) -> np.ndarray:
    """A CUR -> uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_cur(f.read(), path)


def decode_cur(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_cur` of a CUR's bytes (`path` names it in errors)."""
    return _decode_cur(data, path, False)


def decode_cur_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_cur` with RLE data walked by the plain version."""
    return _decode_cur(data, path, True)


def entries(data: bytes, path: str = "<bytes>") -> list[dict]:
    """An ICO's directory in PIL's order (`IcoFile.__init__`): the entry
    PIL opens first."""
    if len(data) < 6:
        raise GiveWay(f"{path}: ICO header cut short")
    (count,) = struct.unpack_from("<H", data, 4)
    out = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise GiveWay(f"{path}: ICO directory cut short at entry {i} of {count}")
        nb_color, bpp = s[2], struct.unpack_from("<H", s, 6)[0]
        size, offset = struct.unpack_from("<II", s, 8)
        w, h = s[0] or 256, s[1] or 256
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        out.append(dict(width=w, height=h, bpp=bpp, size=size, offset=offset, depth=depth))
    out.sort(key=lambda e: e["depth"])
    out.sort(key=lambda e: e["width"] * e["height"], reverse=True)
    return out


def _rgba(img: np.ndarray) -> np.ndarray:
    """A BMP frame's array as PIL's `convert("RGBA")` gives it (alpha 255)."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, 2)
    if img.shape[2] == 4:
        return img.copy()
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], 2)


def _and_mask(data, at, w, h, path):
    """The AND mask of `h` rows at `at` -> alpha (h, w): 0 where a bit is 1.
    As PIL's raw decoder, it needs the last row's own bytes, not its
    padding."""
    stride = -(-w // 32) * 4
    if at < 0:
        raise ValueError(f"{path}: an ICO entry whose AND mask would start at {at}, before "
                         "the file (its size field is too small)")
    raw = data[at:at + stride * h]
    if len(raw) < stride * (h - 1) + -(-w // 8):
        raise ValueError(f"{path}: ICO AND mask cut short (PIL: not enough image data)")
    rows = np.frombuffer(raw.ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1)[:, :w]
    return np.where(bits, 0, 255).astype(np.uint8)[::-1]


def _decode_ico(data: bytes, path: str, plain: bool) -> np.ndarray:
    if data[:4] != ICO_MAGIC:
        raise ValueError(f"{path}: not an ICO")
    table = entries(data, path)
    if not table:
        raise GiveWay(f"{path}: an ICO of no entries (PIL: IndexError)")
    e = table[0]
    off = e["offset"]
    if data[off:off + 8] == png.PNG_MAGIC:
        try:
            return (png.decode_png_plain if plain else png.decode_png)(data[off:], path)
        except struct.error as err:       # a chunk header cut short: PIL gives way
            raise GiveWay(f"{path}: ICO PNG frame cut short ({err})") from err
    rle = bmp._rle_plain if plain else bmp._rle
    img, pixels, (w, h) = bmp.bitmap(data, path, rle, off, halve="icon")
    out = _rgba(img)
    mask_at = off + e["size"] - -(-w // 32) * 4 * h     # PIL's rule: from the size field
    if e["bpp"] == 32:
        end = pixels + w * h * 4
        if len(data) < end:
            raise ValueError(f"{path}: ICO 32-bit frame's pixels cut short (PIL: buffer is "
                             "not large enough)")
        alpha = np.frombuffer(data, np.uint8, w * h * 4, pixels)[3::4].reshape(h, w)[::-1]
        if not alpha.any():               # B23: no alpha channel; the AND mask
            alpha = (_and_mask(data, mask_at, w, h, path)
                     if end <= mask_at and mask_at + -(-w // 32) * 4 * h <= len(data)
                     else np.full((h, w), 255, np.uint8))
    else:
        alpha = _and_mask(data, mask_at, w, h, path)
    out[..., 3] = alpha
    return out


def _decode_cur(data: bytes, path: str, plain: bool) -> np.ndarray:
    if data[:4] != CUR_MAGIC:
        raise ValueError(f"{path}: not a CUR")
    if len(data) < 6:
        raise GiveWay(f"{path}: CUR header cut short")
    (count,) = struct.unpack_from("<H", data, 4)
    m, pos = b"", 6
    for i in range(count):                # CurImageFile._open's pick
        s = data[pos:pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif len(s) < 2:
            raise GiveWay(f"{path}: CUR directory cut short at entry {i} of {count}")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise GiveWay(f"{path}: a CUR with no cursors (PIL: TypeError)")
    if len(m) < 16:
        raise GiveWay(f"{path}: CUR directory entry cut short")
    (given,) = struct.unpack_from("<I", m, 12)
    at = given or pos                     # PIL seeks only to a nonzero offset
    if data[at:at + 8] == png.PNG_MAGIC:
        raise ValueError(f"{path}: a PNG cursor frame, which PIL reads as a BMP header it "
                         "does not know (Unsupported BMP header type)")
    rle = bmp._rle_plain if plain else bmp._rle
    return bmp.bitmap(data, path, rle, at, halve="cursor", raw_alpha=given == 22)[0]


# ------------------------------------------------------------------ writer

def _frame(f: dict) -> tuple[bytes, int, int, int, int]:
    """One frame (see `encode_ico`) -> (its bytes, width, height, colours,
    bits)."""
    img = np.asarray(f["img"])
    h, w = img.shape[:2]
    if f.get("form", "bmp") == "png":
        return png.encode_png(img), w, h, 0, 32
    if img.ndim == 2:
        pal = np.asarray(f["palette"], np.uint8).reshape(-1, 3)
        dib, bits, colors = bmp.encode_bmp(img, pal, 8)[14:], 8, len(pal) % 256
    else:
        dib, bits, colors = bmp.encode_dib(img), 8 * img.shape[2], 0
    dib = dib[:8] + struct.pack("<i", 2 * h) + dib[12:]
    mask = f.get("mask")
    if mask is not None or bits != 32:
        mask = np.zeros((h, w), bool) if mask is None else np.asarray(mask, bool)
        stride = -(-w // 32) * 4
        rows = np.zeros((h, stride * 8), np.uint8)
        rows[:, :w] = mask
        dib += np.packbits(rows[::-1], axis=1).tobytes()
    return dib, w, h, colors, bits


def _container(magic: bytes, frames: list[dict], hotspot: bool) -> bytes:
    parts = [_frame(f) for f in frames]
    head = magic + struct.pack("<H", len(parts))
    offset = 6 + 16 * len(parts)
    body = b""
    for f, (data, w, h, colors, bits) in zip(frames, parts):
        w, h = f.get("size", (w, h))
        planes, bpp = (0, 0) if hotspot else (1, f.get("bpp", bits))
        head += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, planes, bpp,
                            f.get("size_field", len(data)), offset)
        body += data
        offset += len(data)
    return head + body


def encode_ico(frames: list[dict]) -> bytes:
    """Frames -> the bytes of an ICO, in the order given. Each frame is a
    dict: `img` uint8 (H, W, 3) RGB or (H, W, 4) RGBA (a 24- or 32-bit BMP
    frame), or (H, W) indices with `palette` (N, 3) (an 8-bit one); `form`
    "png" for a PNG frame of `img` (gray, RGB or RGBA) instead; `mask` an
    (H, W) bool AND mask, 1 transparent (all 0 by default; a 32-bit frame
    gets one only where given); `size` the directory's (width, height),
    256 written as 0; `bpp` the directory's bit count; `size_field` its
    byte count."""
    return _container(ICO_MAGIC, frames, False)


def encode_cur(frames: list[dict]) -> bytes:
    """`encode_ico`'s BMP frames as a CUR (hotspot 0, 0)."""
    return _container(CUR_MAGIC, frames, True)


def write_ico(path: str, frames: list[dict], cursor: bool = False) -> None:
    """`encode_ico(frames)` (`cursor`: `encode_cur`) written to `path` (its
    directory made if needed)."""
    data = (encode_cur if cursor else encode_ico)(frames)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
