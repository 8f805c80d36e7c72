"""SPIDER images: recognised as PIL 12 recognises them, and refused (the JAX
reader opens dataset images with PIL; the machines the port runs on have
none).

PIL's `SpiderImagePlugin` has no magic and registers no `_accept`, so
`Image.open` runs its `_open` on every file that reaches it, and so does
`io/png.py::read_image` (after SGI, before SUN). `open_spider` follows
that `_open` on the first 108 bytes: 27 floats, big-endian first, then
little-endian, taken where `isSpiderHeader` passes (words 1, 2, 5, 12,
13, 22 and 23 integers, as `isInt` decides: NaN and the infinities are
not; `iform`, word 5, one of 1, 3, -11, -12, -21, -22; the header's bytes,
word 22, equal to its records times their length, words 13 and 23, and
not 0); then `iform` 1 (a 2D image) and the stack words 24 and 27: 0 and
0 a single image, a stack and 0 the stack's first image. A file shorter
than 108 bytes, a header that passes in neither order, another `iform`,
inconsistent stack words or a width or height under 1 give way
(`io/giveway.py`); a stack word that is NaN or infinite, and an image
within a stack opened first (PIL has no `stkoffset` then), make PIL's
`_open` fail, and `open_spider` raises.

What PIL opens is mode F, 32-bit float samples that the JAX reader trains
as the values / 255 (fault B21's kind, as PFM's and IM's floats), so
`read_spider` refuses it with that cause. Reading float samples is queued
with floating-point TIFF (ROADMAP queue 1, "the rest").
"""

from __future__ import annotations

import struct

from gaussianmesh_tpu_torch.io.giveway import GiveWay

IFORMS = (1, 3, -11, -12, -21, -22)
HEAD_BYTES = 27 * 4


def _is_int(f: float) -> int:
    """PIL's `isInt`."""
    try:
        i = int(f)
        return 1 if f - i == 0 else 0
    except (ValueError, OverflowError):
        return 0


def spider_header(t: tuple) -> int:
    """PIL's `isSpiderHeader` on the header's floats -> the header's bytes,
    or 0 where it is not a SPIDER header."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not _is_int(h[i]):
            return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    if labbyt != labrec * lenbyt:
        return 0
    return labbyt


def open_spider(data: bytes, path: str = "<bytes>") -> tuple[int, int]:
    """PIL's `SpiderImageFile._open` on a file's first bytes -> (width,
    height); gives way or raises where `_open` does."""
    head = data[:HEAD_BYTES]
    if len(head) < HEAD_BYTES:
        raise GiveWay(f"{path}: not a valid Spider file (shorter than {HEAD_BYTES} bytes)")
    for order in ">", "<":
        t = struct.unpack(order + "27f", head)
        hdrlen = spider_header(t)
        if hdrlen:
            break
    else:
        raise GiveWay(f"{path}: not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise GiveWay(f"{path}: not a Spider 2D image (iform {int(h[5])})")
    size = int(h[12]), int(h[2])
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])                                 # the stack's image count
    except (ValueError, OverflowError) as err:
        raise ValueError(f"{path}: a SPIDER header PIL cannot open ({err})") from None
    if istack == 0 and imgnumber > 0:
        raise ValueError(f"{path}: a SPIDER image within a stack, which PIL opens with no "
                         "stack offset ('SpiderImageFile' object has no attribute "
                         "'stkoffset')")
    if istack < 0 or imgnumber < 0 or istack > 0 and imgnumber > 0:
        raise GiveWay(f"{path}: inconsistent stack header values")
    if size[0] <= 0 or size[1] <= 0:
        raise GiveWay(f"{path}: a SPIDER image of {size[0]}x{size[1]} pixels (PIL: not "
                      "identified)")
    return size


def read_spider(path: str):
    """A SPIDER file -> raises: `GiveWay` where PIL's `_open` gives way, a
    ValueError where it fails or opens the image (float samples: fault
    B21's kind)."""
    with open(path, "rb") as f:
        return decode_spider(f.read(HEAD_BYTES), path)


def decode_spider(data: bytes, path: str = "<bytes>"):
    """`read_spider` of a file's bytes (`path` names it in errors)."""
    w, h = open_spider(data, path)
    raise ValueError(f"{path}: a SPIDER 2D image of {w}x{h} 32-bit float samples (PIL's mode "
                     "F), which the JAX reader trains as the values / 255 (fault B21's "
                     "kind); not read")
