"""IM Tools (IMT) images in numpy, to the arrays PIL 12 gives (the JAX
reader opens dataset images with PIL; the machines the port runs on have
none).

`read_imt` reads what PIL's `ImtImagePlugin` opens. PIL registers IMT with
no `_accept`, so it tries IMT's `_open` on every file that reaches it, and
so does `io/png.py::read_image`; `open_imt` follows that `_open` byte for
byte on the file: a line feed in the first 100 bytes, then `key value`
lines (PIL's `field` pattern, read through its 100-byte buffer) up to a
form feed (0x0C), after which the image's rows follow, top-down, one byte
a pixel. `width` and `height` set the size; `pixel n8` sets mode L, the
only mode IMT has. A line `*...` is a comment; an empty line, one over 100
bytes or one that does not match ends the header.

A header with no `pixel n8` or no size gives way (`io/giveway.py`); a
`width` or `height` that is not a number makes `Image.open` itself fail
(PIL's `int` raises ValueError), and `read_imt` raises. A header that ends
with no form feed opens in PIL and then cannot load ("cannot load this
image"), and rows the file cuts raise; `read_imt` raises with those causes.

`encode_imt` / `write_imt` write gray images, for the tests and
`chip_smoke.py`; the training path does not write IMT.
"""

from __future__ import annotations

import io
import os
import re

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_imt(fp, path: str = "<bytes>") -> dict:
    """PIL's `ImtImageFile._open` on the file object `fp` (at its start) ->
    {size, offset (None where no form feed came)}; gives way where `_open`
    does; raises ValueError where `int` does."""
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise GiveWay(f"{path}: not an IM file")
    xsize = ysize = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
        except ValueError as err:
            raise ValueError(f"{path}: an IMT {k.decode()} that is not a number, which PIL "
                             f"cannot open ({err})") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise GiveWay(f"{path}: an IMT header of mode {mode!r} and size {size} (PIL: not "
                      "identified by this driver)")
    return dict(size=size, offset=offset)


def read_imt(path: str) -> np.ndarray:
    """An IMT image -> uint8 (H, W)."""
    with open(path, "rb") as f:
        return _load(open_imt(f, path), f, path)


def decode_imt(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_imt` of an IMT file's bytes (`path` names it in errors)."""
    fp = io.BytesIO(data)
    return _load(open_imt(fp, path), fp, path)


def _load(head: dict, fp, path: str) -> np.ndarray:
    (w, h), offset = head["size"], head["offset"]
    if offset is None:
        raise ValueError(f"{path}: an IMT header with no form feed before its data (PIL: "
                         "cannot load this image)")
    fp.seek(offset)
    body = fp.read(w * h)
    if len(body) < w * h:
        raise ValueError(f"{path}: IMT data ends after {len(body)} of {w * h} bytes (PIL: "
                         "image file is truncated)")
    return np.frombuffer(body, np.uint8).reshape(h, w).copy()


def encode_imt(img: np.ndarray) -> bytes:
    """(H, W) uint8 -> the bytes of an IMT file: a comment, `width`,
    `height` and `pixel n8` lines, a form feed, the rows."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError("encode_imt takes (H, W) gray images")
    h, w = img.shape
    head = f"*image\nwidth {w}\nheight {h}\npixel n8\n\x0c".encode("ascii")
    return head + img.tobytes()


def write_imt(path: str, img: np.ndarray) -> None:
    """`encode_imt(img)` written to `path` (its directory made if needed)."""
    data = encode_imt(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
