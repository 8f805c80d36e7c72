"""FITS images in numpy, read by the format's definition where PIL 12
misreads it (the JAX reader opens dataset images with PIL; the machines
the port runs on have none).

`read_fits` walks the header as PIL's `FitsImagePlugin._open` does: 80-byte
cards (`KEYWORD = value / comment`), a header unit ending at `END` and
padded to 2880 bytes, the first card `SIMPLE = T`, and after a primary
header of no image (`NAXIS = 0`) the `XTENSION` units, whose cards join
the primary's. The first header with an image gives the size (`NAXIS1` x
`NAXIS2`; `NAXIS = 1` is one column) and `BITPIX` the samples. Its data
unit starts at the end of that header unit; rows run bottom-up.

- BITPIX 8 gives the bytes, rows flipped, as PIL reads them. A cube
  (`NAXIS3` > 1) gives its first plane, as PIL does (whether the planes
  are colours is not settled: fault note C7). A `BZERO` / `BSCALE` other
  than 0 / 1 is refused: PIL ignores them (fault B32).
- PIL misreads every wider form (fault B32): it opens BITPIX 16 as
  little-endian `I;16` (big-endian 1, 2, 3 read 256, 512, 768), 32 as
  byte-swapped `I`, -32 and -64 as byte-swapped float32, and ignores
  `BZERO` and `BSCALE`. By the definition samples are big-endian two's
  complement (IEEE floats for -32 / -64) and the value is BZERO + BSCALE
  * sample. BITPIX 16 with BZERO 32768 and BSCALE 1, FITS's convention for
  unsigned 16-bit samples, is read so and gives each value's high byte
  (fault B7's rule); every other wider form is refused, naming B32 (and
  B21 for floats, which the JAX reader trains as the values / 255).
- PIL reads the data from 80 bytes before the end of the first card it
  reads past the header, which lies inside the header where the data unit
  is shorter than 80 bytes (unpadded): the port reads from the unit's start
  (B32 too).
- A `BINTABLE` extension with `ZIMAGE = T` and `ZCMPTYPE = 'GZIP_1  '` is
  PIL's tile-compressed form: the heap after the table (its `NAXIS1` x
  `NAXIS2` bytes) is gzip members (the standard library's `gzip`) of
  4-byte big-endian words a pixel, rows bottom-up, the image `ZNAXIS1` x
  `ZNAXIS2` of `ZBITPIX` bits. ZBITPIX 8 takes each word's low byte, as
  PIL's `FitsGzipDecoder` does (whether a writer stores 8-bit tiles a byte
  a pixel instead is not settled: fault note C8); the wider ones follow
  B32's rule above on the words' values.

A first card other than `SIMPLE = T`, a card PIL looks up that is missing,
a BITPIX PIL has no mode for, a width or height under 1 give way
(`io/giveway.py`), as in PIL; a file ending inside a header ("Truncated
FITS file"), no image ("No image data") or a number that is not one make
PIL's `_open` fail, and `read_fits` raises. Data the file cuts raise.

`encode_fits` / `write_fits` write 8- and 16-bit images, raw or GZIP_1,
for the tests and `chip_smoke.py`; the training path does not write FITS.
"""

from __future__ import annotations

import gzip
import os
import zlib

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

CARD, UNIT = 80, 2880
_GZIP = (b"'BINTABLE'", b"'GZIP_1  '")
_B32 = ("PIL reads it byte-swapped and ignores BZERO and BSCALE (fault B32)")


def fits_accept(head: bytes) -> bool:
    """PIL's `FitsImagePlugin._accept`."""
    return head.startswith(b"SIMPLE")


def read_fits(path: str) -> np.ndarray:
    """A FITS image -> uint8 (H, W)."""
    with open(path, "rb") as f:
        return decode_fits(f.read(), path)


def _int(headers: dict, key: bytes, path: str) -> int:
    try:
        value = headers[key]
    except KeyError:                       # PIL's KeyError: the next format
        raise GiveWay(f"{path}: FITS header has no {key.decode()}") from None
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{path}: FITS {key.decode()} {value!r} is not a number (PIL: "
                         "invalid literal for int())") from None


def _size(headers: dict, prefix: bytes, path: str):
    naxis = _int(headers, prefix + b"NAXIS", path)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1", path)
    return _int(headers, prefix + b"NAXIS1", path), _int(headers, prefix + b"NAXIS2", path)


def _parse(headers: dict, path: str):
    """PIL's `_parse_headers` -> None (no image) or dict(size, bits, gzip,
    heap: the heap's offset in the data unit)."""
    gz = (headers.get(b"XTENSION") == _GZIP[0] and headers.get(b"ZIMAGE") == b"T")
    if gz:
        if b"ZCMPTYPE" not in headers:
            raise GiveWay(f"{path}: FITS header has no ZCMPTYPE")
        gz = headers[b"ZCMPTYPE"] == _GZIP[1]
    heap, prefix = 0, b""
    if gz:
        table = _size(headers, b"", path) or (0, 0)
        heap = table[0] * table[1] * (_int(headers, b"BITPIX", path) // 8)
        prefix = b"Z"
    size = _size(headers, prefix, path)
    if not size:
        return None
    return dict(size=size, bits=_int(headers, prefix + b"BITPIX", path), gzip=gz, heap=heap)


def header(data: bytes, path: str = "<bytes>") -> tuple[dict, dict]:
    """PIL's `_open` card loop on a FITS file's bytes -> (the image's
    `_parse` dict with `start`, where its data unit starts; the cards);
    gives way or raises where `_open` does."""
    headers: dict = {}
    in_progress = False
    image = None
    pos = 0
    while True:
        card = data[pos:pos + CARD]
        pos += len(card)
        if not card:
            raise ValueError(f"{path}: Truncated FITS file (a header with no END, or no data "
                             "after it)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break                                      # a data unit
        elif keyword == b"END":
            pos = -(-pos // UNIT) * UNIT
            if image is None:
                image = _parse(headers, path)
                if image is not None:
                    image["start"] = pos
            in_progress = False
            continue
        if image is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not fits_accept(keyword) or value != b"T"):
            raise GiveWay(f"{path}: Not a FITS file")
        headers[keyword] = value
    if image is None:
        raise ValueError(f"{path}: No image data in the FITS file")
    return image, headers


def _scaling(headers: dict, path: str) -> tuple[float, float]:
    out = []
    for key, default in ((b"BZERO", 0.0), (b"BSCALE", 1.0)):
        try:
            out.append(float(headers[key]) if key in headers else default)
        except ValueError:
            raise ValueError(f"{path}: FITS {key.decode()} {headers[key]!r} is not a number "
                             "the port reads") from None
    return out[0], out[1]


def _refuse(path: str, bits: int, bzero: float, bscale: float, what: str):
    floats = " float samples, which the JAX reader trains as the values / 255 (fault B21):" \
        if bits < 0 else ""
    raise ValueError(f"{path}: a FITS {what} of BITPIX {bits}, BZERO {bzero:g} and BSCALE "
                     f"{bscale:g};{floats} {_B32}; not read")


def decode_fits(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_fits` of a FITS file's bytes (`path` names it in errors)."""
    image, headers = header(data, path)
    (w, h), bits = image["size"], image["bits"]
    if bits not in (8, 16, 32, -32, -64) or w <= 0 or h <= 0:
        raise GiveWay(f"{path}: a FITS image of BITPIX {bits} and size {w}x{h} (PIL: not "
                      "identified)")
    bzero, bscale = _scaling(headers, path)
    unsigned16 = bits == 16 and bzero == 32768 and bscale == 1
    if not (bits == 8 and bzero == 0 and bscale == 1 or unsigned16):
        _refuse(path, bits, bzero, bscale, "tile-compressed image" if image["gzip"]
                else "image")
    if image["gzip"]:
        return _gzip_tiles(data[image["start"] + image["heap"]:], w, h, bits, path)
    size = bits // 8
    need = w * h * size
    body = data[image["start"]:image["start"] + need]
    if len(body) < need:
        raise ValueError(f"{path}: FITS data ends after {len(body)} of {need} bytes (PIL: "
                         "buffer is not large enough)")
    rows = np.frombuffer(body, np.uint8).reshape(h, w * size)[::-1]
    if size == 1:
        return np.ascontiguousarray(rows)
    return np.ascontiguousarray(rows[:, 0::2] ^ 0x80)  # (sample + 32768) >> 8


def _gzip_tiles(heap: bytes, w: int, h: int, bits: int, path: str) -> np.ndarray:
    """PIL's `FitsGzipDecoder` on the heap: 4-byte words a pixel, rows
    bottom-up; ZBITPIX 8 the words' low bytes, 16 (unsigned) the high
    byte of each word's value + 32768."""
    try:
        value = gzip.decompress(heap)
    except (OSError, EOFError, zlib.error) as err:
        raise ValueError(f"{path}: the FITS GZIP_1 heap does not decompress ({err})") \
            from None
    if len(value) < 4 * w * h:
        raise ValueError(f"{path}: the FITS GZIP_1 heap holds {len(value)} of {4 * w * h} "
                         "bytes (PIL: not enough image data)")
    words = np.frombuffer(value, ">i4", w * h).reshape(h, w)[::-1]
    if bits == 8:
        return np.ascontiguousarray((words & 0xFF).astype(np.uint8))
    v = words.astype(np.int64) + 32768
    if v.min() < 0 or v.max() > 65535:
        raise ValueError(f"{path}: FITS GZIP_1 values outside 0-65535 for unsigned 16-bit "
                         "samples; not read")
    return np.ascontiguousarray((v >> 8).astype(np.uint8))


def _card(key: str, value) -> bytes:
    if isinstance(value, str):                      # strings from column 11
        text = f"'{value:<8}'"
    else:
        text = f"{'T' if value is True else 'F' if value is False else value:>20}"
    return f"{key:<8}= {text}".ljust(CARD).encode("ascii")


def _unit(cards: list, pad: bool = True) -> bytes:
    out = b"".join(cards) + b"END".ljust(CARD)
    return out + b" " * (-len(out) % UNIT) if pad else out


def encode_fits(img: np.ndarray, compress: bool = False, pad: bool = True) -> bytes:
    """(H, W) uint8 (BITPIX 8) or uint16 (BITPIX 16, BZERO 32768: the
    unsigned convention) -> the bytes of a FITS file, rows
    bottom-up; `compress`: PIL's GZIP_1 tile form (an empty primary, one
    `BINTABLE` row whose heap is one gzip member of 4-byte words a pixel);
    `pad`: the data unit padded to 2880 bytes, as the standard wants."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("encode_fits takes (H, W) uint8 or uint16 images")
    h, w = img.shape
    bits = 8 if img.dtype == np.uint8 else 16
    zero = 0 if bits == 8 else 32768
    stored = img.astype(np.int64)[::-1] - zero
    scale = [_card("BZERO", zero), _card("BSCALE", 1)] if zero else []
    if compress:
        primary = _unit([_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
                         _card("EXTEND", True)])
        heap = gzip.compress(stored.astype(">i4").tobytes(), compresslevel=6, mtime=0)
        table = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8), _card("NAXIS", 2),
                 _card("NAXIS1", 8), _card("NAXIS2", 1), _card("PCOUNT", len(heap)),
                 _card("GCOUNT", 1), _card("TFIELDS", 1), _card("TTYPE1", "COMPRESSED_DATA"),
                 _card("TFORM1", "1PB"), _card("ZIMAGE", True), _card("ZBITPIX", bits),
                 _card("ZNAXIS", 2), _card("ZNAXIS1", w), _card("ZNAXIS2", h),
                 _card("ZTILE1", w), _card("ZTILE2", h), _card("ZCMPTYPE", "GZIP_1"), *scale]
        body = np.array([len(heap), 0], ">i4").tobytes() + heap
        out = primary + _unit(table) + body
    else:
        cards = [_card("SIMPLE", True), _card("BITPIX", bits), _card("NAXIS", 2),
                 _card("NAXIS1", w), _card("NAXIS2", h), *scale]
        out = _unit(cards) + stored.astype(">u1" if bits == 8 else ">i2").tobytes()
    return out + bytes(-len(out) % UNIT) if pad else out


def write_fits(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_fits(img, **kwargs)` written to `path` (its directory made
    if needed)."""
    data = encode_fits(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
