"""GIMP brushes (GBR) in numpy, to the arrays PIL 12 gives (the JAX reader
opens dataset images with PIL; the machines the port runs on have none).

`read_gbr` reads what PIL's `GbrImagePlugin` opens: big-endian words of
the header's size (20 or more), the version (1 or 2), the width, the
height and the bytes a pixel (1 or 4); version 2 then has "GIMP" and the
spacing; a comment fills the header to its size. The pixels follow,
uncompressed: 1 byte a pixel is L, 4 are RGBA, in either version.

A head PIL's `_accept` or `_open` refuses (a header size under 20,
another version or depth, a size of 0, no "GIMP" in version 2, a header
cut short) gives way (`io/giveway.py`); pixel data the file cuts raises
with PIL's cause. A version-2 header size of 20-27 makes PIL read the
comment to the end of the file (`read` of a negative count), so such a
file has no pixel data left, and `read_gbr` raises as PIL does.

`encode_gbr` / `write_gbr` write both versions, for the tests and
`chip_smoke.py`; the training path does not write brushes.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay


def gbr_accept(head: bytes) -> bool:
    """PIL's `GbrImagePlugin._accept`: a header size of 20 or more, then
    version 1 or 2 (big-endian words)."""
    return (len(head) >= 8 and int.from_bytes(head[:4], "big") >= 20
            and int.from_bytes(head[4:8], "big") in (1, 2))


def read_gbr(path: str) -> np.ndarray:
    """A GIMP brush -> uint8 (H, W) or (H, W, 4)."""
    with open(path, "rb") as f:
        return decode_gbr(f.read(), path)


def header(data: bytes, path: str = "<bytes>"):
    """A brush's `_open` -> (width, height, bytes a pixel, where the pixels
    start); gives way where `_open` does."""
    try:
        size, version, w, h, depth = struct.unpack_from(">5I", data)
    except struct.error:
        raise GiveWay(f"{path}: GBR header cut short") from None
    if size < 20:
        raise GiveWay(f"{path}: not a GIMP brush")
    if version not in (1, 2):
        raise GiveWay(f"{path}: Unsupported GIMP brush version: {version}")
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: not a GIMP brush")
    if depth not in (1, 4):
        raise GiveWay(f"{path}: Unsupported GIMP brush color depth: {depth}")
    if version == 1:
        start = size
    else:
        if data[20:24] != b"GIMP":
            raise GiveWay(f"{path}: not a GIMP brush, bad magic number")
        if len(data) < 28:
            raise GiveWay(f"{path}: GBR spacing cut short")
        # PIL reads size - 28 bytes of comment: a negative count reads it all
        start = size if size >= 28 else len(data)
    return w, h, depth, start


def decode_gbr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_gbr` of a brush's bytes (`path` names it in errors)."""
    w, h, depth, start = header(data, path)
    need = w * h * depth
    pixels = np.frombuffer(data, np.uint8, max(0, min(need, len(data) - start)),
                           min(start, len(data)))
    if len(pixels) < need:
        raise ValueError(f"{path}: GBR pixel data ends after {len(pixels)} of {need} bytes "
                         "(PIL: not enough image data)")
    return pixels.reshape(h, w) if depth == 1 else pixels.reshape(h, w, 4)


def encode_gbr(img: np.ndarray, version: int = 2, comment: bytes = b"brush") -> bytes:
    """(H, W) gray or (H, W, 4) RGBA uint8 -> the bytes of a brush of
    `version` 1 or 2 (the comment NUL-terminated, as GIMP writes it; a
    spacing of 10)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3) or img.ndim == 3 and img.shape[2] != 4 or version not in (1, 2):
        raise ValueError("encode_gbr takes (H, W) or (H, W, 4) images, version 1 or 2")
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    text = comment + b"\0"
    extra = b"" if version == 1 else b"GIMP" + struct.pack(">I", 10)
    size = 20 + len(extra) + len(text)
    return (struct.pack(">5I", size, version, w, h, depth) + extra + text + img.tobytes())


def write_gbr(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_gbr(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_gbr(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
