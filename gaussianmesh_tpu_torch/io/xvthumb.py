"""XV thumbnails in numpy, to the arrays PIL 12 gives (the JAX reader
opens dataset images with PIL; the machines the port runs on have none).

`read_xvthumb` reads what PIL's `XVThumbImagePlugin` opens: the magic
`P7 332`, the rest of its line, lines starting `#`, then a line whose
first two words are the width and the height, and from the next byte the
rows, one byte a pixel, top-down. PIL opens them as mode P on the fixed
RGB332 palette, which the JAX reader trains as the indices (fault B15's
kind); `read_xvthumb` gives the palette's colours, as `convert("RGB")`
does (the table built as the plugin builds `PALETTE`).

The file ending before the size line, or a width or height under 1, gives
way (`io/giveway.py`), as in PIL; a size line of one word or none, or a
word that is not a number, makes PIL's `_open` itself fail (its
ValueError), and `read_xvthumb` raises. Rows the file cuts raise.

`encode_xvthumb` / `write_xvthumb` write index images, for the tests and
`chip_smoke.py`; the training path does not write thumbnails.
"""

from __future__ import annotations

import os

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

XV_MAGIC = b"P7 332"
# RGB332: index r << 5 | g << 2 | b, as the plugin's loops build `PALETTE`
PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                    for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def xvthumb_accept(head: bytes) -> bool:
    """PIL's `XVThumbImagePlugin._accept`."""
    return head.startswith(XV_MAGIC)


def read_xvthumb(path: str) -> np.ndarray:
    """An XV thumbnail -> uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_xvthumb(f.read(), path)


def _readline(data: bytes, pos: int) -> tuple[bytes, int]:
    """A file's `readline` from `pos` -> (the line with its line feed, the
    position after it)."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def header(data: bytes, path: str = "<bytes>") -> tuple[int, int, int]:
    """PIL's `_open` on a thumbnail's bytes -> (width, height, where the
    rows start); gives way or raises where `_open` does."""
    if not xvthumb_accept(data):
        raise GiveWay(f"{path}: not an XV thumbnail file")
    _, pos = _readline(data, len(XV_MAGIC))
    while True:
        s, pos = _readline(data, pos)
        if not s:
            raise GiveWay(f"{path}: Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:                                 # not a '#' comment
            break
    words = s.strip().split(maxsplit=2)[:2]
    if len(words) < 2:
        raise ValueError(f"{path}: an XV thumbnail size line of {len(words)} word(s) "
                         "(PIL: not enough values to unpack)")
    try:
        w, h = int(words[0]), int(words[1])
    except ValueError as err:
        raise ValueError(f"{path}: an XV thumbnail size that is not a number ({err})") \
            from None
    if w <= 0 or h <= 0:
        raise GiveWay(f"{path}: an XV thumbnail of {w}x{h} pixels (PIL: not identified)")
    return w, h, pos


def decode_xvthumb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_xvthumb` of a thumbnail's bytes (`path` names it in errors)."""
    w, h, pos = header(data, path)
    body = data[pos:pos + w * h]
    if len(body) < w * h:
        raise ValueError(f"{path}: XV thumbnail data ends after {len(body)} of {w * h} bytes "
                         "(PIL: buffer is not large enough)")
    return PALETTE[np.frombuffer(body, np.uint8).reshape(h, w)]


def encode_xvthumb(idx: np.ndarray) -> bytes:
    """(H, W) uint8 RGB332 indices -> the bytes of an XV thumbnail (XV's
    own header lines: a comment, `#END_OF_COMMENTS`, `w h 255`)."""
    idx = np.ascontiguousarray(idx, np.uint8)
    if idx.ndim != 2:
        raise ValueError("encode_xvthumb takes (H, W) indices")
    h, w = idx.shape
    return (XV_MAGIC + b"\n#IMGINFO:thumbnail\n#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (w, h) + idx.tobytes())


def rgb332(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> the RGB332 index of each pixel's levels (its
    high 3, 3 and 2 bits)."""
    img = np.asarray(img, np.uint8)
    return (img[..., 0] & 0xE0) | (img[..., 1] & 0xE0) >> 3 | img[..., 2] >> 6


def write_xvthumb(path: str, idx: np.ndarray) -> None:
    """`encode_xvthumb(idx)` written to `path` (its directory made if
    needed)."""
    data = encode_xvthumb(idx)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
