"""Blizzard Mipmap textures (`.blp`) in numpy, the port's JPEG decoder and
its BCn decoders, to the arrays PIL 12 gives (the JAX reader opens dataset
images with PIL; the machines the port runs on have none).

`read_blp` reads what PIL's `BlpImagePlugin` opens, all little-endian.
The header: `BLP1` or `BLP2`, the compression; BLP1's alpha depth, size,
encoding and subtype (28 bytes), or BLP2's encoding, alpha depth, alpha
encoding, mipmap flag and size (20); then 16 mipmap offsets and 16
lengths. A nonzero alpha depth makes the image RGBA, else RGB. Only
mipmap 0 is read, as PIL reads it:

- BLP1, compression 0 (JPEG): a JPEG header of its own length, then from
  mipmap 0's offset (or on at once, where that lies before) its length of
  bytes, the two decoded as one JPEG by `io/jpeg.py`. Three components (or
  one) are read as PIL reads them: the RGB its JPEG plugin gives, taken as
  B, G, R. Four components are B, G, R and the alpha (fault B35: PIL
  decodes them as CMYK and converts, so the alpha darkens the colour and
  is lost); where the header's alpha depth is 0 the alpha is dropped. A
  header alpha over three components reads 255.
- BLP1, compression 1, encodings 4 and 5, and BLP2's encoding 1 (palette):
  a 256-entry BGRA palette after the offsets, then mipmap 0's length of
  indices (BLP1 from just past the palette, BLP2 from mipmap 0's offset),
  each its entry's R, G, B and, where the image is RGBA, the entry's fourth
  byte as PIL reads it (whether real files keep their alpha there or in a
  plane after the indices is open question C9).
- BLP2's encoding 2 (DXT): alpha encoding 0, 1 or 7 (DXT1, DXT3, DXT5) from
  mipmap 0's offset, through BLP's own decoders (`io/bcn.py` with
  `shift565`: the 565 channels shifted up, 31 reading 248, where DDS's
  `bcn` decoder reads 255; which the files mean is open question C10). A
  DXT3 or DXT5 texture of alpha depth 0 reads its RGB (fault B36: PIL's
  decoders emit four bytes a pixel into the three of an RGB image, so
  every pixel after the first takes its neighbour's bytes), and a width
  that is not a multiple of 4 reads each tile row's first pixels (fault
  B37: PIL fills the rows from the decoded tiles' wider rows in turn).

A header cut short, or a width or height of 0, gives way
(`io/giveway.py`), as in PIL. What PIL's decoder cannot load raises with
its cause: a file cut inside the offsets, the palette or the data
("Truncated File Read"), fewer indices than pixels ("not enough image
data"), BLP2's encoding 3 (raw BGRA, "Unknown BLP encoding"), other
encodings, compressions and alpha encodings, a JPEG the port's decoder
refuses.

`encode_blp` / `write_blp` write BLP1 JPEG textures of three components,
BLP2 palette textures and BLP2 DXT1 textures of alpha depth 0, for the
tests and `chip_smoke.py`; the training path does not write textures.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import bcn, jpeg
from gaussianmesh_tpu_torch.io.giveway import GiveWay

BLP_MAGICS = (b"BLP1", b"BLP2")
JPEG, PALETTE = 0, 1                          # BLP1 compressions (BLP2: 1 for both)
UNCOMPRESSED, DXT, RAW_BGRA = 1, 2, 3         # BLP2 encodings
DXT_KINDS = {0: bcn.BC1, 1: bcn.BC2, 7: bcn.BC3}  # BLP2 alpha encoding -> BCn kind


def read_blp(path: str) -> np.ndarray:
    """A BLP texture -> uint8 (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_blp(f.read(), path)


def header(data: bytes, path: str = "<bytes>") -> dict:
    """PIL's `BlpImageFile._open` on a texture's bytes -> its fields (magic,
    compression, alpha, encoding, alpha_encoding, width, height, and where
    the offsets start); gives way where `_open` does."""
    if data[:4] not in BLP_MAGICS:
        raise GiveWay(f"{path}: not a BLP file")
    try:
        (compression,) = struct.unpack_from("<i", data, 4)
        if data[:4] == b"BLP1":
            (alpha,) = struct.unpack_from("<I", data, 8)
            w, h, encoding = struct.unpack_from("<IIi", data, 12)
            head, alpha_encoding = 28, None
        else:
            encoding, alpha, alpha_encoding = struct.unpack_from("<3b", data, 8)
            w, h = struct.unpack_from("<II", data, 12)
            head = 20
    except struct.error:
        raise GiveWay(f"{path}: BLP header cut short") from None
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: a BLP texture of {w}x{h} pixels")
    return dict(magic=data[:4], compression=compression, alpha=alpha != 0,
                encoding=encoding, alpha_encoding=alpha_encoding, width=w, height=h,
                head=head)


def decode_blp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_blp` of a texture's bytes (`path` names it in errors)."""
    return _decode(data, path, native=True)


def decode_blp_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_blp` with the JPEG and the blocks decoded in Python and numpy
    (`jpeg.decode_jpeg(native=False)`, `bcn.decode_plain`)."""
    return _decode(data, path, native=False)


def _read(data: bytes, at: int, n: int, path: str) -> bytes:
    """PIL's `_safe_read` of n bytes at `at` (nothing where n <= 0)."""
    if n <= 0:
        return b""
    if at + n > len(data):
        raise ValueError(f"{path}: BLP data cut short: {max(len(data) - at, 0)} of {n} bytes "
                         f"at byte {at} (PIL: Truncated File Read)")
    return data[at:at + n]


def _palette(data: bytes, hd: dict, at: int, n: int, path: str) -> np.ndarray:
    """`_read_bgra`: n indices at `at` through the palette after the
    offsets -> (H, W, 3 or 4)."""
    pal = np.frombuffer(_read(data, hd["head"] + 128, 1024, path), np.uint8).reshape(256, 4)
    idx = np.frombuffer(_read(data, at, n, path), np.uint8)
    w, h = hd["width"], hd["height"]
    if len(idx) < w * h:
        raise ValueError(f"{path}: BLP palette data holds {len(idx)} of {w * h} indices (PIL: "
                         "not enough image data)")
    rgba = pal[idx[:w * h].reshape(h, w)][..., [2, 1, 0, 3]]
    return np.ascontiguousarray(rgba if hd["alpha"] else rgba[..., :3])


def _jpeg(data: bytes, hd: dict, offset: int, length: int, native: bool, path: str):
    """BLP1's JPEG form (B35 for four components)."""
    at = hd["head"] + 128
    (size,) = struct.unpack("<I", _read(data, at, 4, path))
    head = _read(data, at + 4, size, path)
    at += 4 + size
    _read(data, at, offset - at, path)       # PIL reads on to mipmap 0, if it lies ahead
    body = head + _read(data, max(at, offset), length, path)
    planes = jpeg.decode_jpeg(body, path, native=native, color="raw_cmyk")
    if planes.ndim == 2:
        planes = planes[..., None]
    if planes.shape[2] == 4:                   # B, G, R and the alpha
        bgra = planes[..., [2, 1, 0, 3]]
        return np.ascontiguousarray(bgra if hd["alpha"] else bgra[..., :3])
    rgb = np.ascontiguousarray(np.broadcast_to(planes[..., ::-1], planes.shape[:2] + (3,)))
    if hd["alpha"]:
        return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], 2)
    return rgb


def _dxt(data: bytes, hd: dict, offset: int, native: bool, path: str) -> np.ndarray:
    """BLP2's DXT forms through BLP's own rules (B36, B37)."""
    kind = DXT_KINDS.get(hd["alpha_encoding"])
    if kind is None:
        raise ValueError(f"{path}: Unsupported BLP alpha encoding {hd['alpha_encoding']}")
    w, h = hd["width"], hd["height"]
    need = bcn.BLOCK_BYTES[kind] * bcn.bc1_blocks(w, h)
    body = _read(data, offset, need, path)
    decode = bcn.decode if native else bcn.decode_plain
    rgba = decode(kind, body, w, h, path, shift565=True)
    return rgba if hd["alpha"] else np.ascontiguousarray(rgba[..., :3])


def _decode(data: bytes, path: str, native: bool) -> np.ndarray:
    hd = header(data, path)
    offsets = struct.unpack("<16I", _read(data, hd["head"], 64, path))
    lengths = struct.unpack("<16I", _read(data, hd["head"] + 64, 64, path))
    comp, enc = hd["compression"], hd["encoding"]
    if hd["magic"] == b"BLP1":
        if comp == JPEG:
            return _jpeg(data, hd, offsets[0], lengths[0], native, path)
        if comp != PALETTE:
            raise ValueError(f"{path}: Unsupported BLP compression {comp} (BLP1)")
        if enc not in (4, 5):
            raise ValueError(f"{path}: Unsupported BLP encoding {enc} (BLP1)")
        return _palette(data, hd, hd["head"] + 128 + 1024, lengths[0], path)
    _read(data, hd["head"] + 128, 1024, path)           # the palette, read in every form
    if comp != 1:
        raise ValueError(f"{path}: Unknown BLP compression {comp} (BLP2)")
    if enc == UNCOMPRESSED:
        return _palette(data, hd, offsets[0], lengths[0], path)
    if enc == DXT:
        return _dxt(data, hd, offsets[0], native, path)
    cause = " (raw BGRA, which PIL cannot load)" if enc == RAW_BGRA else ""
    raise ValueError(f"{path}: Unknown BLP encoding {enc}{cause}")


# ------------------------------------------------------------------ writers

FORMS = ("BLP1_JPEG", "BLP2_PALETTE", "BLP2_DXT1")


def encode_blp(img: np.ndarray, form: str, *, palette: np.ndarray | None = None,
               quality: int = 90) -> tuple[bytes, np.ndarray]:
    """An image -> (the bytes of a BLP texture of `form`, alpha depth 0,
    what it decodes to): BLP1_JPEG of (H, W, 3) RGB (its B, G, R as a 4:4:4
    baseline JPEG, the markers before the scan as the shared header, the
    scan as mipmap 0), BLP2_PALETTE of
    (H, W) indices into `palette` ((256, 3) RGB), BLP2_DXT1 of (H, W, 3)
    RGB (`bcn.encode_bc1`'s blocks, read with BLP's rule)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    pal = bytes(1024)
    if form == "BLP1_JPEG":
        stream = jpeg.encode_jpeg(np.ascontiguousarray(img[..., ::-1]), quality=quality,
                                  subsampling="4:4:4")
        sos = stream.index(b"\xff\xda")
        shared, body = stream[:sos], stream[sos:]
        head = b"BLP1" + struct.pack("<iIIIii", JPEG, 0, w, h, 5, 0)
        first = len(head) + 128 + 4 + len(shared)
        data = (head + struct.pack("<16I", first, *[0] * 15)
                + struct.pack("<16I", len(body), *[0] * 15)
                + struct.pack("<I", len(shared)) + shared + body)
        return data, decode_blp(data)
    head = b"BLP2" + struct.pack("<i4b", 1, UNCOMPRESSED if form == "BLP2_PALETTE" else DXT,
                                 0, 0, 0) + struct.pack("<II", w, h)
    if form == "BLP2_PALETTE":
        if palette is None or img.ndim != 2:
            raise ValueError("BLP2_PALETTE takes (H, W) indices and a (256, 3) palette")
        bgra = np.zeros((256, 4), np.uint8)
        bgra[:len(palette), :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal, body, want = bgra.tobytes(), img.tobytes(), np.asarray(palette, np.uint8)[img]
    elif form == "BLP2_DXT1":
        body, _ = bcn.encode_bc1(img)
        want = bcn.decode_plain(bcn.BC1, body, w, h, shift565=True)[..., :3]
    else:
        raise ValueError(f"encode_blp writes {', '.join(FORMS)}, not {form!r}")
    first = len(head) + 128 + len(pal)
    data = (head + struct.pack("<16I", first, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15) + pal + body)
    return data, np.ascontiguousarray(want)


def write_blp(path: str, img: np.ndarray, form: str, **kwargs) -> np.ndarray:
    """`encode_blp(img, form, **kwargs)` written to `path` (its directory
    made if needed) -> what the texture decodes to."""
    data, want = encode_blp(img, form, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return want
