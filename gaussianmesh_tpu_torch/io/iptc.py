"""IPTC/NAA image records in numpy and the port's JPEG decoder, to the
arrays PIL 12 gives (the JAX reader opens dataset images with PIL; the
machines the port runs on have none).

`read_iptc` reads what PIL's `IptcImagePlugin` opens. PIL registers IPTC
with no `_accept`, so it tries IPTC's `_open` on every file that reaches
it, and so does `io/png.py::read_image`; `open_iptc` follows that `_open`
on the file: fields of a 0x1C, a record and dataset number and a size (a
16-bit word, or up to 4 bytes more where the word's top bit is set) until
five zero bytes, the end, or the first (8, 10) field, the image data. Its
(3, 60) field gives the layers and whether they are components, (3, 20)
and (3, 30) the width and height, (3, 120) the compression: 1 raw rows
(one byte a sample), 5 a JPEG. The image is every (8, 10) field's data in
turn.

- One layer that is not a component opens as L: raw rows are read in
  numpy; a JPEG through the port's `io/jpeg.py`, a gray one of the
  header's size (PIL's loader takes a colour JPEG's stored pixels, four
  bytes each, as the L image's samples, and lays another size's samples
  out in rows of the header's width: `read_iptc` refuses both).
- Three or four component layers open as RGB or CMYK, but PIL's `load`
  fills one band (the (3, 65) field's, else the first) from the first
  w x h samples and leaves the others 0 (fault B31): `read_iptc` refuses
  such a file with that cause. No copy of the IIM's definition of the
  (3, 60) record was at hand to read the bands by.
- Another compression raises PIL's "Unknown IPTC image compression", which
  PIL raises as OSError from `_open`: `Image.open` itself fails, so this
  is a `ValueError`, not a give-way.

A head whose first field PIL's `field` refuses (no 0x1C, a record it does
not know), a missing record, or a size of 0 gives way (`io/giveway.py`);
a field size over 132 ("illegal field length") fails `Image.open` itself.

`encode_iptc` / `write_iptc` write gray raw and JPEG records, and the
raw colour records of fault B31, for the tests and `chip_smoke.py`; the
training path does not write IPTC.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import jpeg
from gaussianmesh_tpu_torch.io.giveway import GiveWay

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_IMAGE = (8, 10)
_CHUNK = 0x7FFF                            # the writer's most bytes a field


class _Opens(Exception):
    """`Image.open` itself fails: PIL raises other than SyntaxError."""


def _int(c) -> int:
    """PIL's `_i`: the last 4 bytes, big-endian (TypeError on None)."""
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp):
    """PIL's `IptcImageFile.field` -> (tag or None, size); GiveWay where it
    raises SyntaxError, IndexError or struct.error, `_Opens` for OSError."""
    s = fp.read(5)
    if not s.strip(b"\0"):
        return None, 0
    try:
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in _RECORDS:
            raise GiveWay("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise _Opens("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _int(fp.read(size - 128))
        else:
            size = struct.unpack_from(">H", s, 3)[0]
    except (IndexError, struct.error) as err:
        raise GiveWay(f"IPTC field cut short ({err})") from None
    return tag, size


def open_iptc(fp, path: str = "<bytes>") -> dict:
    """PIL's `IptcImageFile._open` on the file object `fp` (at its start)
    -> {mode, size, compression, band, offset (None where no image data
    came)}; gives way where `_open` does; raises ValueError where
    `Image.open` itself fails."""
    info = {}
    try:
        while True:
            offset = fp.tell()
            tag, size = _field(fp)
            if not tag or tag == _IMAGE:
                break
            data = fp.read(size) if size else None
            if tag in info:
                info[tag] = (info[tag] + [data] if isinstance(info[tag], list)
                             else [info[tag], data])
            else:
                info[tag] = data
        layers_field = info[(3, 60)]
        layers, component = layers_field[0], layers_field[1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        size = _int(info[(3, 20)]), _int(info[(3, 30)])
        # a missing (3, 120) is PIL's KeyError turned OSError, not a give-way
        compression = ({1: "raw", 5: "jpeg"}.get(_int(info[(3, 120)]))
                       if (3, 120) in info else None)
    except (KeyError, IndexError, TypeError) as err:
        raise GiveWay(f"{path}: IPTC records missing or cut ({type(err).__name__}: {err})") \
            from None
    except GiveWay as err:
        raise GiveWay(f"{path}: {err}") from None
    except _Opens as err:
        raise ValueError(f"{path}: {err}, which PIL cannot open") from None
    if compression is None:
        raise ValueError(f"{path}: Unknown IPTC image compression, which PIL cannot open")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise GiveWay(f"{path}: an IPTC file of mode {mode!r} and size {size} (PIL: not "
                      "identified by this driver)")
    return dict(mode=mode, size=size, compression=compression, band=band,
                offset=offset if tag == _IMAGE else None)


def read_iptc(path: str) -> np.ndarray:
    """An IPTC/NAA file -> uint8 (H, W)."""
    with open(path, "rb") as f:
        return _load(open_iptc(f, path), f, path)


def decode_iptc(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_iptc` of an IPTC file's bytes (`path` names it in errors)."""
    fp = io.BytesIO(data)
    return _load(open_iptc(fp, path), fp, path)


def _load(head: dict, fp, path: str) -> np.ndarray:
    """PIL's `IptcImageFile.load`: the (8, 10) fields' data joined."""
    if head["offset"] is None:
        raise ValueError(f"{path}: an IPTC file with no image data (PIL: cannot load this "
                         "image)")
    fp.seek(head["offset"])
    parts = []
    while True:
        try:
            tag, size = _field(fp)
        except (GiveWay, _Opens) as err:
            raise ValueError(f"{path}: IPTC image data ends in a bad field ({err})") from None
        if tag != _IMAGE:
            break
        part = fp.read(size)
        parts.append(part)
        if len(part) < size:
            break
    data = b"".join(parts)
    (w, h), mode = head["size"], head["mode"]
    if head["band"] is not None:
        raise ValueError(f"{path}: an IPTC image of {mode} layers, which PIL reads as one "
                         f"band (band {head['band']}) of the first {w}x{h} samples and the "
                         "others 0 (fault B31); not read")
    if head["compression"] == "raw":
        if len(data) < w * h:
            raise ValueError(f"{path}: IPTC image data ends after {len(data)} of {w * h} "
                             "bytes (PIL: image file is truncated)")
        return np.frombuffer(data, np.uint8, w * h).reshape(h, w).copy()
    if data[:3] != jpeg.JPEG_MAGIC:
        raise ValueError(f"{path}: IPTC image data of compression 5 that is not a JPEG; not "
                         "read")
    try:
        img = jpeg.decode_jpeg(data, path)
    except (ValueError, IndexError, struct.error) as err:
        raise ValueError(f"{path}: the JPEG in an IPTC image: {err}") from None
    if img.ndim != 2:
        raise ValueError(f"{path}: a colour JPEG in an IPTC image of one layer, whose "
                         "stored pixels (four bytes each) PIL reads as gray samples; not read")
    if img.shape != (h, w):
        raise ValueError(f"{path}: an IPTC JPEG of {img.shape[1]}x{img.shape[0]} in an image "
                         f"of {w}x{h}, whose samples PIL lays out in rows of the header's "
                         "width (past them where it is larger); not read")
    return img


# ------------------------------------------------------------------ writer

def _record(rec: int, ds: int, data: bytes) -> bytes:
    return struct.pack(">BBBH", 0x1C, rec, ds, len(data)) + data


def encode_iptc(img: np.ndarray, compression: str = "raw", quality: int = 90,
                band: int | None = None, chunk: int = _CHUNK) -> bytes:
    """An image -> the bytes of an IPTC/NAA file: an envelope record, the
    image records (3, 60) / (3, 20) / (3, 30) / (3, 120) ((3, 65) where
    `band` is given), then the data in (8, 10) fields of at most `chunk`
    bytes (32,767, the most a 16-bit size holds). (H, W) gray as raw rows or a JPEG (`compression` "raw" or
    "jpeg"); (H, W, 3) or (H, W, 4) raw planes, one after another (the
    colour files PIL misreads: fault B31)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    layers = 1 if img.ndim == 2 else img.shape[2]
    if compression == "jpeg":
        if layers != 1:
            raise ValueError("encode_iptc writes JPEG records of gray images only")
        body = jpeg.encode_jpeg(img, quality)
    else:
        body = (img if layers == 1 else img.transpose(2, 0, 1)).tobytes()
    head = _record(1, 90, b"\x1b%G") + _record(2, 0, b"\0\x02")
    head += _record(3, 60, bytes((layers, int(layers > 1))))
    head += _record(3, 20, struct.pack(">H", w)) + _record(3, 30, struct.pack(">H", h))
    head += _record(3, 120, bytes((5 if compression == "jpeg" else 1,)))
    if band is not None:
        head += _record(3, 65, bytes((band + 1,)))
    parts = [_record(8, 10, body[i:i + chunk]) for i in range(0, len(body), chunk)]
    return head + b"".join(parts)


def write_iptc(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_iptc(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_iptc(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
