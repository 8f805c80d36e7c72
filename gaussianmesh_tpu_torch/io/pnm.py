"""Netpbm images (PBM, PGM, PPM: P1-P6) in numpy, to the arrays PIL 12 gives
(the JAX reader opens dataset images with PIL; the machines the port runs
on have none).

`read_pnm` reads the header as PIL's `PpmImagePlugin` does (the magic, then
whitespace-separated tokens of at most 10 bytes, `#` comments to the end of
their line) and the samples:

- P4 (raw bitmap; rows padded to a byte) and P1 (ASCII `0` / `1`, spaces
  between them optional) -> (H, W) 0 and 255, 1 black (PIL opens them as
  mode 1, whose `np.asarray` is a bool array that the JAX reader divides by
  255: fault B16);
- P5 / P2 (gray) -> (H, W); P6 / P3 (RGB) -> (H, W, 3). A maxval other
  than 255 is scaled as PIL scales it, round(v / maxval * 255) (Python's
  rounding, half to even; a raw sample over maxval is clipped, an ASCII one
  raises); 16-bit raw samples are big-endian. Gray with a maxval over 255
  PIL opens as mode I, scaled to 0-65535, which the JAX reader divides by
  255 (values up to 257: fault B19); `read_pnm` gives the high byte of
  PIL's value, as `io/png.py` does for 16-bit gray PNGs.

ASCII samples are parsed in numpy (the comments cut out as PIL cuts them,
the digits of each token summed by place), raw ones reshaped; there is no
per-sample loop, so no C++ route. PIL's other magics are refused with
their cause: `Pf` (PFM, float samples, which the JAX reader trains as
values / 255: fault B21), Pillow's own `PyP`, `PyRGBA`, `PyCMYK` and
`P0CMYK`, and PAM's `P7`, which PIL does not read (`is_pnm` does not take
it, as PIL's `_accept` does not: `P7 332` is an XV thumbnail,
`io/xvthumb.py`). A magic PIL's `_open` does not know (`P0`, `P1x`, ...)
and a width or height under 1 give way (`io/giveway.py`), as in PIL; the
header's numbers are read as PIL reads them, by Python's `int`.

`encode_pnm` / `write_pnm` write P5 / P6 (8- or 16-bit), P2 / P3 and P4 /
P1 files, for the tests and `chip_smoke.py`; the training path does not
write them.
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

WHITESPACE = b" \t\n\v\f\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}
_REFUSED = {
    b"Pf": "a PFM file (Pf) of float samples, which the JAX reader trains as the "
           "values / 255 (fault B21)",
    b"PyP": "Pillow's own palette PPM (PyP)",
    b"PyRGBA": "Pillow's own RGBA PPM (PyRGBA)",
    b"PyCMYK": "Pillow's own CMYK PPM (PyCMYK)",
    b"P0CMYK": "a CMYK PPM (P0CMYK)",
}
_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")
PAM_REFUSED = "a PAM file (P7), which PIL does not read"


def is_pnm(head: bytes) -> bool:
    """Whether PIL's `PpmImagePlugin` takes a file with these first bytes
    (its `_accept`: `P0`-`P6`, `Pf`, `Py`)."""
    return len(head) >= 2 and head[:1] == b"P" and head[1] in b"0123456fy"


def magic_of(data: bytes) -> bytes:
    """The magic as PIL's `_read_magic` reads it: up to 6 bytes, to the
    first whitespace."""
    magic = bytearray()
    for c in data[:6]:
        if c in WHITESPACE:
            break
        magic.append(c)
    return bytes(magic)


def read_pnm(path: str) -> np.ndarray:
    """A PBM, PGM or PPM -> uint8 (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_pnm(f.read(), path)


def _token(data: bytes, pos: int, path: str):
    """The next header token from `pos`, as PIL's `_read_token` reads it ->
    (token, the position after the byte that ended it)."""
    token = bytearray()
    n = len(data)
    while len(token) <= 10 and pos < n:
        c = data[pos]
        pos += 1
        if c in WHITESPACE:
            if token:
                break
        elif c == 0x23:                                # '#': skip to CR, LF or the end
            while pos < n and data[pos] not in b"\r\n":
                pos += 1
            pos += 1
        else:
            token.append(c)
    if not token:
        raise ValueError(f"{path}: PNM header ends early (PIL: reached EOF while "
                         "reading header)")
    if len(token) > 10:
        raise ValueError(f"{path}: PNM header token {bytes(token)!r} too long")
    return bytes(token), pos


def _number(token: bytes, what: str, path: str) -> int:
    """A header number as PIL's `int` reads it (a sign and underscores
    too)."""
    try:
        return int(token)
    except ValueError:
        raise ValueError(f"{path}: PNM {what} {token!r} is not a number") from None


def _ascii_values(data: bytes, count: int, path: str) -> np.ndarray:
    """The first `count` ASCII samples of `data` (comments cut out) ->
    int64, each token's digits summed by place."""
    a = np.frombuffer(_COMMENT.sub(b"", data), np.uint8)
    digit = (a >= 48) & (a <= 57)
    space = np.isin(a, np.frombuffer(WHITESPACE, np.uint8))
    starts = np.flatnonzero(digit & ~np.concatenate([[False], digit[:-1]]))
    stop = len(a)
    if len(starts) >= count:
        stop = starts[count - 1]
        stop += int(np.argmax(~digit[stop:])) if not digit[stop:].all() else len(a) - stop
    bad = ~(digit | space)[:stop]
    if bad.any():
        at = int(np.argmax(bad))
        raise ValueError(f"{path}: PNM data holds {bytes(a[at:at + 1])!r}, not a "
                         "sample")
    if len(starts) < count:
        raise ValueError(f"{path}: PNM data holds {len(starts)} of {count} samples "
                         "(not enough image data)")
    ends = np.flatnonzero(digit[:stop] & ~np.concatenate([digit[1:stop], [False]])) + 1
    starts = starts[:count]
    length = ends - starts
    if length.max(initial=0) > 10:
        raise ValueError(f"{path}: PNM sample token too long")
    idx = np.flatnonzero(digit[:stop])
    tok = np.repeat(np.arange(count), length)
    place = np.power(10, ends[tok] - 1 - idx, dtype=np.int64)
    return np.bincount(tok, (a[idx].astype(np.int64) - 48) * place,
                       minlength=count).astype(np.int64)


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """PIL's min(out_max, round(v / maxval * out_max)) in float64."""
    return np.minimum(out_max, np.rint(v / maxval * out_max)).astype(np.int64)


def decode_pnm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_pnm` of a PNM file's bytes (`path` names it in errors)."""
    magic = magic_of(data)
    pos = len(magic) + 1                              # the whitespace after it
    if magic in _REFUSED:
        raise ValueError(f"{path}: {_REFUSED[magic]}; not read")
    if magic == b"P7":
        raise ValueError(f"{path}: {PAM_REFUSED}")
    if magic not in _MODES:
        raise GiveWay(f"{path}: not a PPM file (magic {magic!r})")
    mode = _MODES[magic]
    tok, pos = _token(data, pos, path)
    w = _number(tok, "width", path)
    tok, pos = _token(data, pos, path)
    h = _number(tok, "height", path)
    if mode != "1":
        tok, pos = _token(data, pos, path)
        maxval = _number(tok, "maxval", path)
        if not 0 < maxval < 65536:
            raise ValueError(f"{path}: PNM maxval {maxval} is not in 1-65535")
    if w <= 0 or h <= 0:                              # ImageFile's size check
        raise GiveWay(f"{path}: PNM image of {w}x{h} pixels")
    c = 3 if mode == "RGB" else 1
    if mode == "1":
        if magic == b"P4":
            row = (w + 7) // 8
            if len(data) < pos + row * h:
                raise ValueError(f"{path}: PBM data cut short (truncated)")
            bits = np.unpackbits(np.frombuffer(data, np.uint8, row * h, pos).reshape(h, row),
                                 axis=1)[:, :w]
        else:
            body = np.frombuffer(_COMMENT.sub(b"", data[pos:]), np.uint8)
            body = body[~np.isin(body, np.frombuffer(WHITESPACE, np.uint8))][:w * h]
            bad = (body != 48) & (body != 49)
            if bad.any():
                raise ValueError(f"{path}: PBM data holds {bytes(body[bad][:1])!r}, not 0 "
                                 "or 1")
            if len(body) < w * h:
                raise ValueError(f"{path}: PBM data holds {len(body)} of {w * h} pixels "
                                 "(not enough image data)")
            bits = (body - 48).reshape(h, w)
        return ((1 - bits) * 255).astype(np.uint8)
    wide = mode == "L" and maxval > 255            # PIL's mode I: 0-65535
    count = w * h * c
    if magic in (b"P2", b"P3"):
        v = _ascii_values(data[pos:], count, path)
        if v.max(initial=0) > maxval:
            raise ValueError(f"{path}: PNM sample {int(v.max())} over maxval {maxval}")
    else:
        size = 2 if maxval > 255 else 1
        if len(data) < pos + count * size:
            raise ValueError(f"{path}: PNM data cut short (truncated)")
        v = np.frombuffer(data, ">u2" if size == 2 else np.uint8, count, pos)
        if maxval == 255 or (wide and maxval == 65535):
            v = v.astype(np.int64)
            return _shape((v >> 8 if wide else v).astype(np.uint8), h, w, c)
    v = _scale(v, maxval, 65535 if wide else 255)
    return _shape((v >> 8 if wide else v).astype(np.uint8), h, w, c)


def _shape(v: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    return v.reshape(h, w) if c == 1 else v.reshape(h, w, c)


# ------------------------------------------------------------------ writer

@functools.cache
def _digits() -> list:
    return [str(i).encode() for i in range(65536)]


def encode_pnm(img: np.ndarray, ascii: bool = False, maxval: int = 255) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB, or uint16 samples of `maxval` up
    to 65535 -> the bytes of a P5 / P6 (`ascii`: P2 / P3) file; a bool
    (H, W) array -> P4 / P1, True black."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.dtype == bool:
        if ascii:
            body = b"\n".join(b" ".join(b"1" if x else b"0" for x in r) for r in img)
            return b"P1\n%d %d\n" % (w, h) + body + b"\n"
        return b"P4\n%d %d\n" % (w, h) + np.packbits(img, axis=1).tobytes()
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in (1, 3) or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("encode_pnm takes bool (H, W), or uint8 / uint16 (H, W) or "
                         "(H, W, 3)")
    if int(img.max(initial=0)) > maxval or not 0 < maxval < 65536:
        raise ValueError(f"samples over maxval {maxval}")
    magic = (b"P2" if c == 1 else b"P3") if ascii else (b"P5" if c == 1 else b"P6")
    head = magic + b"\n%d %d\n%d\n" % (w, h, maxval)
    if ascii:
        rows = img.reshape(h, -1)
        return head + b"\n".join(b" ".join(map(_digits().__getitem__, r.tolist()))
                                 for r in rows) + b"\n"
    return head + img.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def write_pnm(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_pnm(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_pnm(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
