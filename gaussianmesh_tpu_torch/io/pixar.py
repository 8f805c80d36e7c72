"""PIXAR raster images in numpy, to the arrays PIL 12 gives (the JAX reader
opens dataset images with PIL; the machines the port runs on have none).

`read_pixar` reads what PIL's `PixarImagePlugin` opens: the magic
`80 E8 00 00`, a 512-byte header whose little-endian words at bytes 418
and 416 are the width and the height and at 424 and 426 the channels and
the depth, then, from byte 1024, the rows of raw RGB samples, top-down.
Only channels 14 and depth 2 have a mode in PIL (RGB); any other pair
leaves it empty, and a header cut before byte 428, a width or height of 0
do too, so the file gives way (`io/giveway.py`). Rows the file cuts raise
("image file is truncated").

`encode_pixar` / `write_pixar` write RGB images, for the tests and
`chip_smoke.py`; the training path does not write PIXAR.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

PIXAR_MAGIC = b"\x80\xe8\x00\x00"
DATA_START = 1024


def read_pixar(path: str) -> np.ndarray:
    """A PIXAR image -> uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_pixar(f.read(), path)


def decode_pixar(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_pixar` of a PIXAR file's bytes (`path` names it in errors)."""
    if not data.startswith(PIXAR_MAGIC):
        raise GiveWay(f"{path}: not a PIXAR file")
    head = data[:512]
    try:
        h, w = struct.unpack_from("<HH", head, 416)
        mode = struct.unpack_from("<HH", head, 424)
    except struct.error:
        raise GiveWay(f"{path}: PIXAR header cut short") from None
    if mode != (14, 2) or w == 0 or h == 0:
        raise GiveWay(f"{path}: a PIXAR image of channels / depth {mode} and size {w}x{h} "
                      "(PIL: not identified)")
    need = w * h * 3
    body = data[DATA_START:DATA_START + need]
    if len(body) < need:
        raise ValueError(f"{path}: PIXAR data ends after {len(body)} of {need} bytes (PIL: "
                         "image file is truncated)")
    return np.frombuffer(body, np.uint8).reshape(h, w, 3).copy()


def encode_pixar(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of a PIXAR file (channels 14, depth 2;
    the header's other fields 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_pixar takes (H, W, 3) RGB images")
    h, w = img.shape[:2]
    if not (0 < w < 65536 and 0 < h < 65536):
        raise ValueError(f"a PIXAR image of {w}x{h} pixels")
    head = bytearray(DATA_START)
    head[:4] = PIXAR_MAGIC
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + img.tobytes()


def write_pixar(path: str, img: np.ndarray) -> None:
    """`encode_pixar(img)` written to `path` (its directory made if
    needed)."""
    data = encode_pixar(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
