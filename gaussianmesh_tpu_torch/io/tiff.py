"""TIFF images with numpy and `zlib`, to the arrays PIL 12 gives (the JAX
reader opens dataset images with PIL, which hands compressed TIFFs to
libtiff; the machines the port runs on have neither).

`read_tiff` reads the first image (IFD) of a little- or big-endian TIFF
stored in strips with `PlanarConfiguration` 1 (samples interleaved) and
8-bit unsigned samples:

- gray (`Photometric` 1) -> (H, W); `Photometric` 0 (white is zero)
  inverted, as PIL inverts it; gray + unassociated alpha (`ExtraSamples`
  2) -> (H, W, 2), as PIL's mode LA;
- RGB -> (H, W, 3); RGB + unassociated alpha (`ExtraSamples` 2, or a
  fourth sample with no `ExtraSamples`) -> (H, W, 4); further unspecified
  samples (`ExtraSamples` 0) are dropped, as PIL drops them;
- an 8-bit palette (`Photometric` 3) expanded to RGB through the high
  byte of each `ColorMap` entry, as PIL's `convert("RGB")` does (PIL opens
  it as mode P, whose `np.asarray` is the indices: fault B15, which the
  JAX reader keeps).

Strips are uncompressed (`Compression` 1) or Deflate (8, and the older
32946), each decompressed by `zlib`; with Deflate, `Predictor` 2 is undone
as libtiff undoes it (a cumulative sum mod 256 along each row, per
sample). libtiff ignores the predictor of an uncompressed file, and so
does this. Tiles, planar files, associated alpha, 16-bit and other
samples, `FillOrder` 2, LZW, PackBits, JPEG-in-TIFF and every other
compression raise with the cause. Every step is a numpy array operation
over a strip: there is no loop over pixels to put in C++.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

TIFF_MAGICS = (b"II*\x00", b"MM\x00*")
_BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")
# the first bytes `read_tiff` takes: BigTIFF to raise naming it
TIFF_HEADS = TIFF_MAGICS + _BIGTIFF_MAGICS

# tag type -> struct code (the integer types; other tags are not read)
_TYPES = {1: "B", 3: "H", 4: "I"}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4", 5: "LZW",
                 6: "old-style JPEG", 7: "JPEG", 32773: "PackBits", 34712: "JPEG 2000",
                 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_DEFLATE = (8, 32946)
# (Photometric, samples, ExtraSamples) -> the samples kept and whether they
# are inverted (PIL's OPEN_INFO for 8-bit samples, without associated alpha)
_LAYOUTS = {
    (0, 1, ()): (1, True), (1, 1, ()): (1, False), (1, 2, (2,)): (2, False),
    (2, 3, ()): (3, False), (2, 4, ()): (4, False), (2, 4, (2,)): (4, False),
    (2, 4, (0,)): (3, False), (2, 5, (0, 0)): (3, False), (2, 6, (0, 0, 0)): (3, False),
    (2, 5, (2, 0)): (4, False), (2, 6, (2, 0, 0)): (4, False),
    (3, 1, ()): (1, False), (3, 2, (0,)): (1, False),
}


def read_tiff(path: str) -> np.ndarray:
    """A TIFF -> uint8 (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or
    (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)


def _tags(data: bytes, path: str) -> dict:
    """The first IFD's BYTE, SHORT and LONG tags -> {tag: [values]}."""
    if data[:4] in _BIGTIFF_MAGICS:
        raise ValueError(f"{path}: BigTIFF; only classic TIFFs are read")
    if data[:4] not in TIFF_MAGICS:
        raise ValueError(f"{path}: not a TIFF")
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(e + "I", data, 4)
    try:
        (n,) = struct.unpack_from(e + "H", data, ifd)
        tags = {}
        for i in range(n):
            tag, typ, count, _ = struct.unpack_from(e + "HHI4s", data, ifd + 2 + 12 * i)
            if typ not in _TYPES:
                continue
            size = struct.calcsize(_TYPES[typ]) * count
            at = ifd + 2 + 12 * i + 8
            if size > 4:
                (at,) = struct.unpack_from(e + "I", data, at)
            tags[tag] = list(struct.unpack_from(e + _TYPES[typ] * count, data, at))
    except struct.error:
        raise ValueError(f"{path}: TIFF directory cut short (truncated TIFF)") from None
    return tags


def decode_tiff(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_tiff` of a TIFF's bytes (`path` names it in errors)."""
    tags = _tags(data, path)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{path}: TIFF without its width or height")
    width, height = tags[256][0], tags[257][0]
    photometric = tags.get(262, [0])[0]
    compression = tags.get(259, [1])[0]
    spp = tags.get(277, [1])[0]
    bits = tags.get(258, [1])
    bits = bits * spp if len(bits) == 1 else bits[:spp]
    extra = tuple(tags.get(338, ()))
    if 322 in tags or 323 in tags:
        raise ValueError(f"{path}: tiled TIFF; only strips are read")
    if tags.get(284, [1])[0] != 1:
        raise ValueError(f"{path}: planar TIFF (PlanarConfiguration 2); only "
                         "interleaved samples are read")
    if set(bits) != {8} or len(bits) != spp:
        raise ValueError(f"{path}: TIFF of {bits}-bit samples; only 8-bit samples are read")
    if set(tags.get(339, [1])) != {1}:
        raise ValueError(f"{path}: TIFF sample format {tags[339]}; only unsigned "
                         "integer samples are read")
    if tags.get(266, [1])[0] != 1:
        raise ValueError(f"{path}: TIFF with FillOrder 2; not read")
    if extra[:1] == (1,):
        raise ValueError(f"{path}: TIFF with associated (premultiplied) alpha; only "
                         "unassociated alpha is read")
    if (photometric, spp, extra) not in _LAYOUTS:
        raise ValueError(f"{path}: TIFF of Photometric {photometric} with {spp} samples "
                         f"and ExtraSamples {list(extra)}; only 8-bit gray, gray + "
                         "alpha, RGB, RGBA and palette TIFFs are read")
    if compression in _COMPRESSIONS:
        raise ValueError(f"{path}: {_COMPRESSIONS[compression]}-compressed TIFF; only "
                         "uncompressed and Deflate TIFFs are read")
    if compression not in (1,) + _DEFLATE:
        raise ValueError(f"{path}: TIFF compression {compression} is unknown")
    predictor = tags.get(317, [1])[0] if compression in _DEFLATE else 1
    if predictor not in (1, 2):
        raise ValueError(f"{path}: TIFF predictor {predictor}; only 1 and 2 "
                         "(horizontal differencing) are read")
    if 273 not in tags or 279 not in tags:
        raise ValueError(f"{path}: TIFF without strip offsets or byte counts")
    per_strip = min(tags.get(278, [height])[0], height) or height
    offsets, counts = tags[273], tags[279]
    n_strips = -(-height // per_strip)
    if len(offsets) < n_strips or len(counts) < n_strips:
        raise ValueError(f"{path}: {len(offsets)} TIFF strips, {n_strips} expected")
    row_bytes = width * spp
    strips = []
    for i in range(n_strips):
        rows = min(per_strip, height - i * per_strip)
        raw = data[offsets[i]:offsets[i] + counts[i]]
        if compression in _DEFLATE:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as err:
                raise ValueError(f"{path}: TIFF strip {i} fails to inflate: {err}") from None
        if len(raw) < rows * row_bytes:
            raise ValueError(f"{path}: TIFF strip {i} cut short (truncated TIFF)")
        s = np.frombuffer(raw, np.uint8, rows * row_bytes).reshape(rows, width, spp)
        if predictor == 2:
            s = np.cumsum(s, axis=1, dtype=np.uint8)
        strips.append(s)
    img = np.concatenate(strips)
    keep, invert = _LAYOUTS[(photometric, spp, extra)]
    img = img[..., :keep]
    if invert:
        img = 255 - img
    if photometric == 3:
        cmap = np.array(tags.get(320, []), np.int64)
        if len(cmap) != 3 * 256:
            raise ValueError(f"{path}: palette TIFF without a ColorMap of 3 x 256 entries")
        pal = (cmap.reshape(3, 256).T // 256).astype(np.uint8)
        return pal[img[..., 0]]
    return img[..., 0].copy() if keep == 1 else np.ascontiguousarray(img)
