"""BMP images in numpy and the port's C++, to the arrays PIL 12 gives (the
JAX reader opens dataset images with PIL; the machines the port runs on
have none).

`read_bmp` reads Windows bitmaps with a 40-, 52-, 56-, 108- or 124-byte
header, rows bottom-up or top-down, each padded to 4 bytes; `read_dib` the
same bitmaps without the 14-byte file header (PIL's DIB), the pixels
found after the header, its bit-field masks and its palette as PIL finds
them; `bitmap` serves both and the frames of icons and cursors
(`io/ico.py`):

- 24-bit (BI_RGB, or BI_BITFIELDS with PIL's BGR masks) -> (H, W, 3) RGB;
- 32-bit BI_RGB -> RGB: PIL drops the fourth byte;
- 32-bit BI_BITFIELDS with one of the byte-aligned mask sets PIL reads ->
  RGB, or RGBA where a mask names alpha (with a 40-byte header the masks
  follow it and there is no alpha mask);
- 16-bit BI_RGB (5-5-5) and BI_BITFIELDS 5-6-5 or 5-5-5 -> RGB, each field
  widened as PIL's `BGR;15` / `BGR;16` unpackers widen it (v * 255 // 31,
  v * 255 // 63);
- 1-, 4- and 8-bit palettes, uncompressed or RLE8 / RLE4 (8 and 4 bits):
  expanded to RGB, as PIL's `convert("RGB")` does (PIL opens them as mode
  P, whose `np.asarray` is the indices: fault B15, which the JAX reader
  keeps); a palette that is the gray ramp (entry i is (i, i, i), PIL's mode
  L) -> (H, W), the indices; a 1-bit black-and-white palette (PIL's mode 1)
  -> (H, W) 0 and 255, as PIL's `convert("L")` (`np.asarray` of mode 1 is a
  bool array that the JAX reader divides by 255: fault B16).

RLE data is walked as PIL's `BmpRleDecoder` walks it (`gm_bmp_rle` of
`csrc/image.cpp`; `_rle_plain` here is the same walk in Python, held to it
byte for byte): pixels never written (an end of line, a delta) are index
0, and data that ends before the bitmap is full raises, as PIL raises. Two
escapes follow the format where PIL does not (fault B17): a delta reads
its two bytes (PIL reads four), and an RLE4 absolute run of odd length
reads its last pixel (PIL drops it). Palettes PIL misreads (a gray-ramp or
black-and-white palette on pixels of other widths, which PIL unpacks as
8- or 1-bit pixels), other masks and OS/2 headers raise with the cause.

`encode_bmp` / `write_bmp` write 1-, 4- and 8-bit palette bitmaps,
uncompressed or RLE4 / RLE8, for the tests and `chip_smoke.py` (PIL writes neither RLE nor 4-bit BMPs); the training path
does not write BMPs. `encode_dib` / `write_dib` write 24- and 32-bit DIBs,
BI_RGB or (RGBA) BI_BITFIELDS, for the same callers.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.ops import _cuda

BMP_MAGIC = b"BM"
# PIL's `_dib_accept`: the info header sizes it takes for a DIB
DIB_HEADS = (12, 40, 52, 56, 64, 108, 124)

_HEADERS = (40, 52, 56, 108, 124)
_RLE8, _RLE4, _BITFIELDS = 1, 2, 3
_COMPRESSIONS = {4: "JPEG", 5: "PNG"}
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
# 16-bit masks (R, G, B) PIL reads -> the bits of the green field
_MASKS_16 = {(0xF800, 0x7E0, 0x1F): 6, (0x7C00, 0x3E0, 0x1F): 5}


def read_bmp(path: str) -> np.ndarray:
    """A BMP -> uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)


def decode_bmp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_bmp` of a BMP's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle)


def decode_bmp_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_bmp` with RLE data walked by the plain version."""
    return _decode(data, path, _rle_plain)


def dib_accept(head: bytes) -> bool:
    """PIL's `BmpImagePlugin._dib_accept`: a first little-endian int that is
    the size of an info header."""
    return len(head) >= 4 and struct.unpack_from("<I", head)[0] in DIB_HEADS


def read_dib(path: str) -> np.ndarray:
    """A DIB (a BMP without its 14-byte file header) -> `read_bmp`'s array."""
    with open(path, "rb") as f:
        return decode_dib(f.read(), path)


def decode_dib(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_dib` of a DIB's bytes (`path` names it in errors)."""
    return bitmap(data, path, _rle, 0)[0]


def decode_dib_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_dib` with RLE data walked by the plain version."""
    return bitmap(data, path, _rle_plain, 0)[0]


def _rle(data: bytes, origin: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """RLE8 / RLE4 data from file offset `origin` -> the palette indices in
    stored order, at most width * height (`gm_bmp_rle`)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(width * height, np.uint8)
    n_out = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_bmp_rle(
        src.ctypes.data, len(src), origin, width, height, int(rle4), out.ctypes.data,
        n_out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_bmp_rle returned {status}")
    return out[:int(n_out[0])]


def _rle_plain(data: bytes, origin: int, width: int, height: int,
               rle4: bool) -> np.ndarray:
    """`_rle` as a Python loop over the codes (the plain version)."""
    total = width * height
    out = bytearray()
    x = i = 0
    n = len(data)
    while len(out) < total:
        if i + 2 > n:
            break
        count, byte = data[i], data[i + 1]
        i += 2
        if count:
            count = min(count, max(0, width - x))
            if rle4:
                out += bytes([byte >> 4, byte & 15]) * (count // 2) + bytes([byte >> 4]) * (count & 1)
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if i + 2 > n:
                break
            out += bytes(data[i] + data[i + 1] * width)
            i += 2
            x = len(out) % width
        else:
            nbytes = (byte + 1) // 2 if rle4 else byte
            run = data[i:i + nbytes]
            if rle4:
                nib = np.frombuffer(run, np.uint8)
                out += np.stack([nib >> 4, nib & 15], 1).ravel()[:byte].tobytes()
            else:
                out += run
            i += len(run)
            if len(run) < nbytes:
                break
            x += byte
            i += (origin + i) & 1
    return np.frombuffer(bytes(out[:total]), np.uint8)


def _palette(data, pos, colors, bits, compression, path):
    """The palette -> (RGB (256, 3) uint8, the mode PIL opens it as: "P",
    "L" (the gray ramp) or "1" (black and white))."""
    if not 0 < colors <= 256:
        raise ValueError(f"{path}: {bits}-bit BMP with a palette of {colors} colours")
    if len(data) < pos + 4 * colors:
        raise ValueError(f"{path}: BMP palette cut short")
    pal = np.frombuffer(data, np.uint8, 4 * colors, pos).reshape(colors, 4)
    ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
    mode = "P"
    if (pal[:, :3] == ramp[:, None]).all():
        mode = "1" if colors == 2 else "L"
        rle = compression in (_RLE8, _RLE4)
        if (mode == "1" and (bits != 1 or rle)) or (mode == "L" and bits != 8 and not rle):
            raise ValueError(
                f"{path}: {bits}-bit BMP with a {'black-and-white' if mode == '1' else 'gray-ramp'}"
                f" palette, which PIL reads as {'1-bit' if mode == '1' else '8-bit'} "
                "pixels; not read")
    rgb = np.zeros((256, 3), np.uint8)
    rgb[:colors] = pal[:, 2::-1]
    return rgb, mode


def _decode(data: bytes, path: str, rle) -> np.ndarray:
    if data[:2] != BMP_MAGIC or len(data) < 18:
        raise ValueError(f"{path}: not a BMP")
    (offset,) = struct.unpack_from("<I", data, 10)
    return bitmap(data, path, rle, 14, offset)[0]


def bitmap(data: bytes, path: str, rle, start: int, offset: int = 0, halve: str = "",
           raw_alpha: bool = False):
    """The bitmap whose info header starts at `start`, read as PIL's
    `BmpImageFile._bitmap` reads it -> (the array, the file offset of its
    pixel data, (width, height)). `offset` is the BMP file header's; where
    it is 0 (a DIB, an icon or cursor frame) the pixels follow the header,
    the three bit-field masks of a 40-byte BI_BITFIELDS header and the
    palette of a 1-, 4- or 8-bit bitmap. `halve` "icon" or "cursor": the
    rows of such a frame, half the header's height (its AND mask is the
    other half); none left raises, and gives way for a cursor (PIL checks
    a cursor's size after the halving, an icon's before it). `raw_alpha`:
    a 32-bit BI_RGB bitmap is BGRA (PIL's rule for a cursor's frame at
    byte 22). `rle` walks RLE8 / RLE4 data."""
    if len(data) < start + 4:
        raise GiveWay(f"{path}: BMP info header cut short")
    (hsize,) = struct.unpack_from("<I", data, start)
    if hsize not in _HEADERS:
        raise ValueError(f"{path}: BMP header of {hsize} bytes (OS/2 or unknown); only "
                         "the Windows headers of 40, 52, 56, 108 and 124 bytes are read")
    if len(data) < start + hsize:
        raise ValueError(f"{path}: BMP header cut short")
    width, height, _, bits, compression = struct.unpack_from("<iiHHI", data, start + 4)
    (colors,) = struct.unpack_from("<I", data, start + 32)
    top_down = height < 0
    height = abs(height)
    pos = start + hsize
    if compression in _COMPRESSIONS:
        raise ValueError(f"{path}: {_COMPRESSIONS[compression]}-compressed BMP; only "
                         "uncompressed, RLE8 and RLE4 BMPs are read")
    if compression not in (0, _RLE8, _RLE4, _BITFIELDS):
        raise ValueError(f"{path}: BMP compression {compression} is unknown")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: {bits}-bit BMP; only 1-, 4-, 8-, 16-, 24- and 32-bit "
                         "BMPs are read")
    rle_bits = {_RLE8: 8, _RLE4: 4}.get(compression)
    if rle_bits is not None and bits != rle_bits:
        raise ValueError(f"{path}: {'RLE8' if rle_bits == 8 else 'RLE4'}-compressed BMP of "
                         f"{bits}-bit pixels; RLE8 codes 8-bit and RLE4 4-bit pixels")
    order = {24: "BGR", 32: "BGRA" if raw_alpha and compression == 0 else "BGRX"}.get(bits)
    green = 5 if bits == 16 else None
    if compression == _BITFIELDS:
        if hsize >= 52:
            masks = struct.unpack_from("<III", data, start + 40) + (
                struct.unpack_from("<I", data, start + 52) if hsize >= 56 else (0,))
        else:
            if len(data) < pos + 12:
                raise GiveWay(f"{path}: BMP bit-field masks cut short")
            masks = struct.unpack_from("<III", data, pos) + (0,)
            pos += 12
        if bits == 32 and masks in _MASKS_32:
            order = _MASKS_32[masks]
        elif bits == 16 and masks[:3] in _MASKS_16:
            green = _MASKS_16[masks[:3]]
        elif not (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise ValueError(f"{path}: {bits}-bit BMP with bit-field masks "
                             f"{[hex(m) for m in masks]}; only PIL's masks of 16-, 24- "
                             "and 32-bit pixels are read")
    colors = colors or 1 << bits
    if offset == start + hsize and bits <= 8:   # an offset that points at the palette
        offset += 4 * colors
    offset = offset or pos + (4 * colors if bits <= 8 else 0)
    if width <= 0 or height == 0:
        raise GiveWay(f"{path}: BMP of {width}x{height} pixels (PIL: not identified)")
    if halve:
        height //= 2
        if height == 0:
            raise (GiveWay if halve == "cursor" else ValueError)(
                f"{path}: an {halve} bitmap of height 1: no rows above its AND mask")
    if rle_bits is not None:
        idx = rle(data[offset:], offset, width, height, compression == _RLE4)
        if len(idx) < width * height:
            raise ValueError(f"{path}: {'RLE8' if rle_bits == 8 else 'RLE4'} data ends after "
                             f"{len(idx)} of {width * height} pixels (PIL: not enough "
                             "image data)")
        px = idx.reshape(height, width)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        if len(data) < offset + stride * height:
            raise ValueError(f"{path}: BMP pixel data cut short (truncated BMP)")
        px = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
        if bits < 8:
            px = np.unpackbits(px, axis=1)[:, :width * bits].reshape(height, width, bits)
            px = (px * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(
                -1, dtype=np.uint8)
        else:
            px = px[:, :width * bits // 8].reshape(height, width, bits // 8)
    if not top_down:
        px = px[::-1]
    return _pixels(data, px, pos, colors, bits, compression, order, green, path), offset, (
        width, height)


def _pixels(data, px, pos, colors, bits, compression, order, green, path) -> np.ndarray:
    """Stored pixels, in display order -> the array PIL gives (palettes
    expanded, B15 / B16)."""
    if bits <= 8:
        rgb, mode = _palette(data, pos, colors, bits, compression, path)
        px = px if px.ndim == 2 else px[..., 0]
        if mode == "1":
            return px * np.uint8(255)
        if mode == "L":
            return np.ascontiguousarray(px)
        return np.take(rgb, px, axis=0)
    if bits == 16:
        v = px.view("<u2")[..., 0].astype(np.int32)
        fields = ((v >> (5 + green)) & 31, (v >> 5) & ((1 << green) - 1), v & 31)
        return np.stack([f * 255 // m for f, m in zip(fields, (31, (1 << green) - 1, 31))],
                        -1).astype(np.uint8)
    take = [order.index(ch) for ch in ("RGBA" if "A" in order else "RGB")]
    return np.ascontiguousarray(px[..., take])


# ------------------------------------------------------------------ writer

def _rle_encode(rows: np.ndarray, rle4: bool) -> bytes:
    """Palette indices (H, W), in stored row order -> RLE8 or RLE4 data:
    runs of 3 or more equal pixels as encoded runs, the pixels between as
    absolute runs (RLE4: of even length, which PIL reads as the format
    does), pixels left over as encoded runs of one; an end of line after
    each row, an end of bitmap after the last."""
    h, w = rows.shape
    start, length, run = runs.segments(rows, 3, 255, 254 if rle4 else 255)
    short = ~run & (length - (length & 1 if rle4 else 0) < (4 if rle4 else 3))
    odd = ~run & ~short & (length & 1).astype(bool) & rle4
    # literal pixels that do not go into an absolute run: encoded runs of one
    ones = np.concatenate([np.repeat(start[short], length[short])
                           + np.arange(int(length[short].sum()))
                           - np.repeat(np.cumsum(length[short]) - length[short],
                                       length[short]),
                           start[odd] + length[odd] - 1])
    lit = ~run & ~short
    lit_len = length[lit] - odd[lit]
    x = rows.ravel()
    starts = np.concatenate([start[run], ones, start[lit], (np.arange(h) + 1) * w])
    lens = np.concatenate([length[run], np.ones(len(ones), np.int64), lit_len,
                           np.zeros(h, np.int64)])
    kind = np.concatenate([np.zeros(int(run.sum()) + len(ones), np.int64),
                           np.ones(len(lit_len), np.int64), np.full(h, 2)])
    key = starts * 2 - (kind == 2)        # an end of line after its row
    order = np.argsort(key, kind="stable")
    starts, lens, kind = starts[order], lens[order], kind[order]
    value = x[np.minimum(starts, x.size - 1)]
    if rle4:
        value = value << 4 | value
    take = np.where(kind == 1, lens // 2 if rle4 else lens, 0)
    head = np.stack([np.where(kind == 0, lens, 0), np.where(kind == 0, value,
                     np.where(kind == 1, lens, 0))], 1).astype(np.uint8)
    if rle4:
        pairs = np.append(x, 0)
        src = (pairs[:-1] << 4 | pairs[1:]).astype(np.uint8)
    else:
        src = x
    out = runs.assemble(src, starts, head, np.full(len(starts), 2), take, take & 1,
                        step=2 if rle4 else 1)
    return out.tobytes() + b"\x00\x01"


def encode_bmp(img: np.ndarray, palette: np.ndarray, bits: int = 8,
               rle: bool = False) -> bytes:
    """(H, W) uint8 palette indices with `palette` (N, 3) uint8 RGB, N <=
    2^bits, at `bits` 1, 4 or 8 (`rle`: RLE4 at 4 bits, RLE8 at 8) -> the
    bytes of a BMP (40-byte header, rows bottom-up)."""
    img = np.asarray(img)
    palette = np.asarray(palette, np.uint8).reshape(-1, 3)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("encode_bmp takes (H, W) uint8 indices")
    if bits not in (1, 4, 8) or len(palette) > 1 << bits:
        raise ValueError(f"encode_bmp takes at most 2^bits colours at 1, 4 or 8 bits, "
                         f"not {len(palette)} at {bits}")
    if int(img.max(initial=0)) >= len(palette):
        raise ValueError(f"index {int(img.max())} past a palette of {len(palette)}")
    if rle and bits == 1:
        raise ValueError("BMP has no RLE for 1-bit pixels")
    pal = np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)],
                         1).tobytes()
    rows = img[::-1]
    h, w = img.shape
    if rle:
        body = _rle_encode(rows, bits == 4)
        compression = _RLE4 if bits == 4 else _RLE8
    else:
        if bits < 8:
            per = 8 // bits
            shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * bits
            padded = np.zeros((h, -(-w // per) * per), np.uint8)
            padded[:, :w] = rows
            rows = (padded.reshape(h, -1, per) << shifts).sum(-1, dtype=np.uint8)
        out = np.zeros((h, ((w * bits + 31) >> 3) & ~3), np.uint8)
        out[:, :rows.shape[1]] = rows
        body = out.tobytes()
        compression = 0
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, compression, len(body), 2835,
                       2835, len(palette), len(palette))
    off = 14 + 40 + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + pal + body


def write_bmp(path: str, img: np.ndarray, palette: np.ndarray, **kwargs) -> None:
    """`encode_bmp(img, palette, **kwargs)` written to `path` (its directory
    made if needed)."""
    data = encode_bmp(img, palette, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def encode_dib(img: np.ndarray, bitfields: bool = False) -> bytes:
    """uint8 (H, W, 3) RGB -> the bytes of a 24-bit DIB (a 40-byte header,
    rows bottom-up, no file header); (H, W, 4) RGBA -> a 32-bit one: with
    `bitfields`, BI_BITFIELDS with a 108-byte header whose masks name the
    alpha (PIL reads RGBA), else BI_RGB with a 40-byte header (PIL reads
    RGB and drops the fourth byte)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("encode_dib takes uint8 (H, W, 3) or (H, W, 4)")
    h, w, c = img.shape
    if bitfields and c != 4:
        raise ValueError("encode_dib writes bit-field masks for RGBA only")
    bits = 8 * c
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :w * c] = img[..., [2, 1, 0, 3][:c]].reshape(h, w * c)
    body = out[::-1].tobytes()
    info = struct.pack("<IiiHHIIiiII", 108 if bitfields else 40, w, h, 1, bits,
                       _BITFIELDS if bitfields else 0, len(body), 2835, 2835, 0, 0)
    if bitfields:       # the four masks, LCS_sRGB, no end points or gamma
        info += struct.pack("<IIIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000,
                            0x73524742) + bytes(48)
    return info + body


def write_dib(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_dib(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_dib(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
