"""X11 bitmaps (XBM) in numpy, to the arrays PIL 12 gives where PIL reads
them right (the JAX reader opens dataset images with PIL; the machines the
port runs on have none).

`read_xbm` finds the header as PIL's `XbmImagePlugin` does: its regex
`xbm_head` on the first 512 bytes (`#define <name>_width`, `_height`, an
optional `_x_hot` / `_y_hot` hotspot, then anything up to the last
`_bits[]`), else the file gives way (`io/giveway.py`), as does a size of 0.
The data is the C array that follows: byte literals in hex (`0x` or `0X`
and one or two digits) between `{` and `}`, separated by commas, C
comments allowed. Each row is `ceil(width / 8)` bytes, bits least
significant first; a set bit is 255 and a clear one 0 (PIL opens XBM as
mode 1, whose `np.asarray` is a bool array that the JAX reader divides by
255: fault B16, so `read_xbm` gives `convert("L")`'s 0 and 255). Bytes
past the image are not read.

PIL's `xbm` decoder takes the two characters after every `x` past the
header as a byte, a character that is not a hex digit as 0. So it reads
`0x5` as 0x50, skips `0X` literals, and takes an `x` in a comment or
before the `{` for a byte (fault B29); `read_xbm` reads the literals' own
values and equals PIL on the two-digit form X11 writes. A literal that is
not a byte in hex (a decimal, three hex digits, other text) raises. An X10
bitmap (`static short`: 16-bit words) raises, as PIL reads one byte a word
(the word's first two hex digits, which hold its high bits) and misreads
every such file. The tokens are parsed in numpy (the array checked by one
regex, the digits looked up), so there is no C++ route.

`encode_xbm` / `write_xbm` write the X11 form, for the tests and
`chip_smoke.py`; the training path does not write XBM.
"""

from __future__ import annotations

import os
import re

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

# PIL 12's `XbmImagePlugin.xbm_head`, verbatim
XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_COMMENT = re.compile(rb"/\*.*?\*/", re.S)
_TOKEN = rb"\s*0[xX][0-9a-fA-F]{1,2}\s*"
_ARRAY = re.compile(rb"(?:%s,)*(?:%s)?\s*" % (_TOKEN, _TOKEN))
_HEX = np.full(256, -1, np.int16)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _HEX[bytes([_c]).upper()[0]] = _i


def xbm_accept(head: bytes) -> bool:
    """PIL's `_accept` on the 16 bytes `Image.open` reads first."""
    return head[:16].lstrip().startswith(b"#define")


def read_xbm(path: str) -> np.ndarray:
    """An XBM -> uint8 (H, W), 0 and 255."""
    with open(path, "rb") as f:
        return decode_xbm(f.read(), path)


def header(data: bytes, path: str = "<bytes>"):
    """An XBM's header as PIL's `_open` reads it -> (width, height, hotspot
    (x, y) or None, where the data starts); gives way where `_open` does."""
    m = XBM_HEAD.match(data[:512])
    if not m:
        raise GiveWay(f"{path}: not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: XBM of {w}x{h} pixels (PIL: not identified)")
    hot = (int(m.group("xhot")), int(m.group("yhot"))) if m.group("hotspot") else None
    return w, h, hot, m.end()


def decode_xbm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_xbm` of an XBM's bytes (`path` names it in errors)."""
    w, h, _, start = header(data, path)
    decl = data[:start]
    decl = decl[decl.rfind(b"\n") + 1:]
    if re.search(rb"\bshort\b", decl):
        raise ValueError(f"{path}: an X10 bitmap ({decl.decode('latin-1').strip()}) of 16-bit "
                         "words, which PIL misreads (one byte a word: its first two hex "
                         "digits); not read")
    body = data[start:]
    brace = body.find(b"{")
    if brace < 0:
        raise ValueError(f"{path}: XBM data has no {{ (image file is truncated)")
    end = body.find(b"}", brace)
    array = _COMMENT.sub(b" ", body[brace + 1:end if end >= 0 else len(body)])
    if not _ARRAY.fullmatch(array):
        bad = next((t.strip() for t in array.split(b",")
                    if not re.fullmatch(_TOKEN, t) and t.strip()), b",")
        raise ValueError(f"{path}: XBM data holds {bad[:20]!r}, not a byte in hex")
    text = np.frombuffer(array, np.uint8)
    at = np.flatnonzero((text == ord("x")) | (text == ord("X")))
    row = (w + 7) // 8
    if len(at) < row * h:
        raise ValueError(f"{path}: XBM data holds {len(at)} of {row * h} bytes (image file is "
                         "truncated)")
    at = at[:row * h]
    text = np.append(text, np.uint8(ord(" ")))
    hi, lo = _HEX[text[at + 1]], _HEX[text[at + 2]]
    value = np.where(lo >= 0, hi * 16 + lo, hi).astype(np.uint8)
    bits = np.unpackbits(value.reshape(h, row), axis=1, bitorder="little")[:, :w]
    return bits * np.uint8(255)


def encode_xbm(img: np.ndarray, hotspot: tuple[int, int] | None = None,
               name: str = "im", per_line: int = 12) -> bytes:
    """(H, W) (0 clear, anything else set) -> an XBM in X11's form
    (`XWriteBitmapFile`'s: two hex digits a byte, `per_line` a line)."""
    img = np.asarray(img)
    h, w = img.shape
    packed = np.packbits(img != 0, axis=1, bitorder="little").ravel()
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    tok = np.zeros((len(packed), 6), np.uint8)
    tok[:] = np.frombuffer(b"0x00, ", np.uint8)
    tok[:, 2], tok[:, 3] = digits[packed >> 4], digits[packed & 15]
    if len(tok):
        tok[(np.arange(len(tok)) % per_line) == per_line - 1, 5] = ord("\n")
        tok[-1, 4:] = np.frombuffer(b"};", np.uint8)
    head = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot is not None:
        head += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n"
    head += f"static unsigned char {name}_bits[] = {{\n   "
    return head.encode() + tok.tobytes() + b"\n"


def write_xbm(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_xbm(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_xbm(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
