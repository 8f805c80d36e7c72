"""FTEX textures (`.ftc` / `.ftu`) in numpy and the port's BC1 decoder, to
the arrays PIL 12 gives (the JAX reader opens dataset images with PIL; the
machines the port runs on have none).

`read_ftex` reads what PIL's `FtexImagePlugin` opens, all little-endian:
`FTEX`, the version, the width and the height (signed words), the mipmap
and format counts, then the format and where its first mipmap is: a
length and that many bytes (-1 reads to the end of the file, as a file's
`read(-1)` does). Format 0 is DXT1, BC1 blocks decoded to RGBA as PIL's
`bcn` decoder does (`io/bcn.py`: `gm_bc1_decode`; the alpha becomes the
training mask, by fault A2's rule); format 1 raw RGB rows. Only the first
mipmap is read, as PIL reads it.

A header cut short, or a mipmap position past the file, gives way
(`io/giveway.py`), as in PIL; a format count other than 1 (PIL's
`assert`), another format, a negative position or a length under -1 make
PIL's `_open` fail, and `read_ftex` raises. A width or height under 1
fails too: PIL closes the file once `_open` has read it, so the formats
after FTEX cannot seek it. A mipmap shorter than the image needs raises
("image file is truncated").

`encode_ftex` / `write_ftex` write both formats (DXT1 through
`bcn.encode_bc1`), for the tests and `chip_smoke.py`; the training path
does not write textures.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import bcn
from gaussianmesh_tpu_torch.io.giveway import GiveWay

FTEX_MAGIC = b"FTEX"
DXT1, UNCOMPRESSED = 0, 1


def read_ftex(path: str) -> np.ndarray:
    """An FTEX texture -> uint8 (H, W, 4) (DXT1) or (H, W, 3) (raw)."""
    with open(path, "rb") as f:
        return decode_ftex(f.read(), path)


def header(data: bytes, path: str = "<bytes>") -> tuple[int, int, int, bytes]:
    """PIL's `FtexImageFile._open` on a texture's bytes -> (width, height,
    format, the first mipmap's bytes); gives way or raises where `_open`
    does."""
    if not data.startswith(FTEX_MAGIC):
        raise GiveWay(f"{path}: not an FTEX file")
    try:
        w, h, _mipmaps, formats = struct.unpack_from("<4x4x2i2i", data)
        if formats != 1:
            raise ValueError(f"{path}: an FTEX file of {formats} formats (PIL asserts 1)")
        fmt, where = struct.unpack_from("<2i", data, 24)
        if where < 0:
            raise ValueError(f"{path}: an FTEX mipmap at {where} (PIL: Invalid argument)")
        (size,) = struct.unpack_from("<i", data, where)
    except struct.error:
        raise GiveWay(f"{path}: FTEX header cut short") from None
    if size < -1:
        raise ValueError(f"{path}: an FTEX mipmap of {size} bytes (PIL: read length must be "
                         "non-negative or -1)")
    start = where + 4
    mipmap = data[start:] if size == -1 else data[start:start + size]
    if fmt not in (DXT1, UNCOMPRESSED):
        raise ValueError(f"{path}: Invalid texture compression format: {fmt}")
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: an FTEX texture of {w}x{h} pixels, which PIL gives up on "
                         "after closing the file (seek of closed file)")
    return w, h, fmt, mipmap


def decode_ftex(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_ftex` of a texture's bytes (`path` names it in errors)."""
    return _decode(data, path, bcn.decode_bc1)


def decode_ftex_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_ftex` with BC1 in numpy (`bcn._bc1_plain`)."""
    return _decode(data, path, bcn._bc1_plain)


def _decode(data: bytes, path: str, bc1) -> np.ndarray:
    w, h, fmt, mipmap = header(data, path)
    if fmt == DXT1:
        return bc1(mipmap, w, h, path)
    need = w * h * 3
    if len(mipmap) < need:
        raise ValueError(f"{path}: FTEX mipmap holds {len(mipmap)} of {need} bytes (PIL: "
                         "image file is truncated)")
    return np.frombuffer(mipmap, np.uint8, need).reshape(h, w, 3).copy()


def encode_ftex(img: np.ndarray, fmt: int = DXT1) -> tuple[bytes, np.ndarray]:
    """(H, W, 3) uint8 -> (the bytes of an FTEX texture of format `fmt`,
    DXT1 or UNCOMPRESSED, one mipmap; what it decodes to: the BC1 blocks'
    RGBA, or the image)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or fmt not in (DXT1, UNCOMPRESSED):
        raise ValueError("encode_ftex takes (H, W, 3) RGB images, format DXT1 or "
                         "UNCOMPRESSED")
    h, w = img.shape[:2]
    body, want = bcn.encode_bc1(img) if fmt == DXT1 else (img.tobytes(), img)
    head = FTEX_MAGIC + struct.pack("<i2i2i2i", 1, w, h, 1, 1, fmt, 32)
    return head + struct.pack("<i", len(body)) + body, want


def write_ftex(path: str, img: np.ndarray, **kwargs) -> np.ndarray:
    """`encode_ftex(img, **kwargs)` written to `path` (its directory made
    if needed) -> what the texture decodes to."""
    data, want = encode_ftex(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return want
