"""TIFF images with numpy, `zlib` and the port's C++, to the arrays PIL 12
gives (the JAX reader opens dataset images with PIL, which hands compressed
TIFFs to libtiff; the machines the port runs on have neither).

`read_tiff` reads the first image (IFD) of a little- or big-endian TIFF
stored in strips with `PlanarConfiguration` 1 (samples interleaved) and
unsigned samples of 8 or 16 bits, or 1, 2 or 4 bits for one sample:

- gray (`Photometric` 1) -> (H, W); `Photometric` 0 (white is zero)
  inverted, as PIL inverts it; gray + unassociated alpha (`ExtraSamples`
  2) -> (H, W, 2), as PIL's mode LA;
- RGB -> (H, W, 3); RGB + unassociated alpha (`ExtraSamples` 2, or a
  fourth sample with no `ExtraSamples`) -> (H, W, 4); further unspecified
  samples (`ExtraSamples` 0) are dropped, as PIL drops them;
- a palette (`Photometric` 3) expanded to RGB through the high byte of
  each `ColorMap` entry, as PIL's `convert("RGB")` does (PIL opens it as
  mode P, whose `np.asarray` is the indices: fault B15, which the JAX
  reader keeps);
- 16-bit gray, RGB and RGBA keep the high byte of each sample, as PIL's
  `RGB;16L` / `RGB;16B` raw modes do for RGB(A) (PIL opens 16-bit gray as
  mode I;16, values up to 65,535 that the JAX reader divides by 255:
  fault B7);
- 1-bit gray (bilevel) as 0 and 255, as PIL's `convert("L")` of its mode
  1 (whose `np.asarray` is a bool array that the JAX reader divides by 255:
  fault B16); 2- and 4-bit gray scaled to 0..255 as PIL scales them.

Strips are uncompressed (`Compression` 1), Deflate (8, and the older
32946, by `zlib`), LZW (5, `io/lzw.py`: `gm_lzw_decode`) or PackBits
(32773, `gm_packbits_decode`), each to the strip's size: LZW or PackBits
that stops short or runs past it raises. After Deflate or LZW,
`Predictor` 2 is undone as libtiff undoes it, a cumulative sum along each
row per sample, mod 256 or mod 65,536 on 16-bit samples (libtiff ignores
the predictor of uncompressed and PackBits strips, and so does this).
Tiles, planar files, associated alpha, 12-bit, 16-bit white-is-zero and
other samples, `FillOrder` 2, libtiff's old-style LZW (LSB first, which
libtiff tells by a strip's first two bytes), CCITT, JPEG-in-TIFF and every
other compression raise with the cause. `decode_tiff_plain` decodes LZW
and PackBits strips with the plain versions (`io/lzw.py::lzw_decode_plain`,
`packbits_decode_plain`), which the C++ is held to byte for byte; the
training path never calls them.

`encode_tiff` / `write_tiff` write 8- or 16-bit gray, gray + alpha, RGB
and RGBA in either byte order, LZW (predictor 1 or 2; the LZW encoder in
C++, `gm_lzw_encode`) or PackBits, for the tests and `chip_smoke.py`; the
training path does not write TIFFs.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from gaussianmesh_tpu_torch.io import lzw, runs
from gaussianmesh_tpu_torch.ops import _cuda

TIFF_MAGICS = (b"II*\x00", b"MM\x00*")
_BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")
# the first bytes `read_tiff` takes: BigTIFF to raise naming it
TIFF_HEADS = TIFF_MAGICS + _BIGTIFF_MAGICS

# tag type -> struct code (the integer types; other tags are not read)
_TYPES = {1: "B", 3: "H", 4: "I"}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4",
                 6: "old-style JPEG", 7: "JPEG", 34712: "JPEG 2000",
                 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_NONE, _LZW, _PACKBITS = 1, 5, 32773
_DEFLATE = (8, 32946)
_READ = (_NONE, _LZW, _PACKBITS) + _DEFLATE
# (Photometric, samples, ExtraSamples) -> the samples kept and whether they
# are inverted (PIL's OPEN_INFO for 8-bit samples, without associated alpha)
_LAYOUTS = {
    (0, 1, ()): (1, True), (1, 1, ()): (1, False), (1, 2, (2,)): (2, False),
    (2, 3, ()): (3, False), (2, 4, ()): (4, False), (2, 4, (2,)): (4, False),
    (2, 4, (0,)): (3, False), (2, 5, (0, 0)): (3, False), (2, 6, (0, 0, 0)): (3, False),
    (2, 5, (2, 0)): (4, False), (2, 6, (2, 0, 0)): (4, False),
    (3, 1, ()): (1, False), (3, 2, (0,)): (1, False),
}
# the same for 16-bit samples (PIL's I;16 / I;16B, RGB;16, RGBA;16, RGBX;16)
_LAYOUTS_16 = {
    (1, 1, ()): (1, False), (2, 3, ()): (3, False), (2, 4, ()): (4, False),
    (2, 4, (2,)): (4, False), (2, 4, (0,)): (3, False),
}
# ... and for 1-, 2- and 4-bit samples: gray, white-is-zero gray, palette
_LAYOUTS_SUB = {(0, 1, ()): (1, True), (1, 1, ()): (1, False), (3, 1, ()): (1, False)}
_PREDICTED = (_LZW,) + _DEFLATE
_STATUS_OVERFLOW = 8                   # csrc/image.cpp's kOverflow


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


def packbits_decode(data: bytes, out_size: int) -> np.ndarray:
    """TIFF PackBits -> at most `out_size` bytes, uint8 (`gm_packbits_decode`
    of `csrc/image.cpp`): fewer where the data ends first; a packet past
    `out_size` raises."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(out_size, np.uint8)
    n_out = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_packbits_decode(
        src.ctypes.data, len(src), out.ctypes.data, out_size, n_out.ctypes.data)
    if status == _STATUS_OVERFLOW:
        raise _packbits_overflow(out_size)
    if status:
        raise RuntimeError(f"gm_packbits_decode returned {status}")
    return out[:int(n_out[0])]


def _packbits_overflow(out_size):
    return ValueError(f"PackBits data decodes past the {out_size} bytes it should fill")


def packbits_decode_plain(data: bytes, out_size: int) -> np.ndarray:
    """`packbits_decode` as a Python loop over the packets (the plain
    version)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < out_size:
        h = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if h == -128:
            continue
        length = 1 - h if h < 0 else h + 1
        if length > out_size - len(out):
            raise _packbits_overflow(out_size)
        if h < 0:
            if i == n:
                break
            out += data[i:i + 1] * length
            i += 1
        else:
            if length > n - i:
                break
            out += data[i:i + length]
            i += length
    return np.frombuffer(bytes(out), np.uint8)


def packbits_encode(rows: np.ndarray) -> bytes:
    """(H, row bytes) uint8 -> PackBits, each row on its own (as libtiff
    writes): runs of 3 or more equal bytes as repeat packets, the bytes
    between as literal packets, 128 at most each."""
    start, length, run = runs.segments(rows, 3, 128, 128)
    x = rows.ravel()
    head = np.stack([np.where(run, (1 - length) & 0xFF, length - 1), x[start]], 1)
    return runs.assemble(x, start, head.astype(np.uint8), np.where(run, 2, 1),
                         np.where(run, 0, length), np.zeros_like(length)).tobytes()


def decode_tiff(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_tiff` of a TIFF's bytes (`path` names it in errors)."""
    return _decode(data, path, lzw.lzw_decode, packbits_decode)


def decode_tiff_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_tiff` with LZW and PackBits strips decoded by the plain
    versions."""
    return _decode(data, path, lzw.lzw_decode_plain, packbits_decode_plain)


def _layout(path, photometric, spp, bits, extra):
    """-> (sample bits, samples kept, inverted) of a layout the reader takes,
    else raises with the cause."""
    if set(bits) == {8} and len(bits) == spp:
        table = _LAYOUTS
    elif set(bits) == {16} and len(bits) == spp:
        table = _LAYOUTS_16
        if (photometric, spp) == (0, 1):
            raise ValueError(f"{path}: 16-bit white-is-zero TIFF (Photometric 0), which "
                             "PIL reads without inverting it; not read")
    elif spp == 1 and bits[0] in (1, 2, 4):
        table = _LAYOUTS_SUB
    else:
        raise ValueError(f"{path}: TIFF of {bits}-bit samples; only 8- and 16-bit "
                         "samples, and 1-, 2- and 4-bit gray and palette, are read")
    if extra[:1] == (1,):
        raise ValueError(f"{path}: TIFF with associated (premultiplied) alpha; only "
                         "unassociated alpha is read")
    if (photometric, spp, extra) not in table:
        raise ValueError(f"{path}: {bits[0]}-bit TIFF of Photometric {photometric} with "
                         f"{spp} samples and ExtraSamples {list(extra)}; only gray, gray "
                         "+ alpha, RGB, RGBA and palette TIFFs of the layouts PIL opens "
                         "are read")
    return (bits[0],) + table[(photometric, spp, extra)]


def _strip(raw, i, size, compression, path, decode_lzw, decode_packbits):
    """Strip i's stored bytes -> `size` bytes, uint8."""
    if compression in _DEFLATE:
        try:
            raw = zlib.decompress(raw)
        except zlib.error as err:
            raise ValueError(f"{path}: TIFF strip {i} fails to inflate: {err}") from None
        out = np.frombuffer(raw, np.uint8)[:size]
    elif compression in (_LZW, _PACKBITS):
        if compression == _LZW and raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1:
            raise ValueError(f"{path}: TIFF strip {i} is old-style LZW (LSB first, "
                             "libtiff's compatibility codec); not read")
        try:
            out = (decode_lzw if compression == _LZW else decode_packbits)(raw, size)
        except ValueError as err:
            raise ValueError(f"{path}: TIFF strip {i}: {err}") from None
    else:
        out = np.frombuffer(raw, np.uint8)[:size]
    if len(out) < size:
        raise ValueError(f"{path}: TIFF strip {i} cut short (truncated TIFF)")
    return out


def _decode(data: bytes, path: str, decode_lzw, decode_packbits) -> np.ndarray:
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
    if set(tags.get(339, [1])) != {1}:
        raise ValueError(f"{path}: TIFF sample format {tags[339]}; only unsigned "
                         "integer samples are read")
    if tags.get(266, [1])[0] != 1:
        raise ValueError(f"{path}: TIFF with FillOrder 2; not read")
    depth, keep, invert = _layout(path, photometric, spp, bits, extra)
    if compression in _COMPRESSIONS:
        raise ValueError(f"{path}: {_COMPRESSIONS[compression]}-compressed TIFF; only "
                         "uncompressed, LZW, PackBits and Deflate TIFFs are read")
    if compression not in _READ:
        raise ValueError(f"{path}: TIFF compression {compression} is unknown")
    predictor = tags.get(317, [1])[0] if compression in _PREDICTED else 1
    if predictor not in (1, 2):
        raise ValueError(f"{path}: TIFF predictor {predictor}; only 1 and 2 "
                         "(horizontal differencing) are read")
    if predictor == 2 and depth < 8:
        raise ValueError(f"{path}: TIFF predictor 2 on {depth}-bit samples, which "
                         "libtiff refuses")
    if 273 not in tags or 279 not in tags:
        raise ValueError(f"{path}: TIFF without strip offsets or byte counts")
    per_strip = min(tags.get(278, [height])[0], height) or height
    offsets, counts = tags[273], tags[279]
    n_strips = -(-height // per_strip)
    if len(offsets) < n_strips or len(counts) < n_strips:
        raise ValueError(f"{path}: {len(offsets)} TIFF strips, {n_strips} expected")
    row_bytes = -(-width * spp * depth // 8)
    rows = np.concatenate([
        _strip(data[offsets[i]:offsets[i] + counts[i]], i,
               min(per_strip, height - i * per_strip) * row_bytes, compression, path,
               decode_lzw, decode_packbits)
        for i in range(n_strips)]).reshape(height, row_bytes)
    if depth < 8:
        v = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(height, width, depth)
        img = (v * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)[..., None]
        if photometric != 3:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16:
        img = rows.view("<u2" if data[:2] == b"II" else ">u2").reshape(height, width, spp)
        if predictor == 2:
            img = np.cumsum(img, axis=1, dtype=np.uint16)
        img = (img >> 8).astype(np.uint8)
    else:
        img = rows.reshape(height, width, spp)
        if predictor == 2:
            img = np.cumsum(img, axis=1, dtype=np.uint8)
    img = img[..., :keep]
    if invert:
        img = 255 - img
    if photometric == 3:
        cmap = np.array(tags.get(320, []), np.int64)
        if len(cmap) != 3 << depth:
            raise ValueError(f"{path}: {depth}-bit palette TIFF without a ColorMap of "
                             f"3 x {1 << depth} entries")
        pal = (cmap.reshape(3, -1).T // 256).astype(np.uint8)
        return np.take(pal, img[..., 0], axis=0)
    return img[..., 0].copy() if keep == 1 else np.ascontiguousarray(img)


# ------------------------------------------------------------------ writer
_WRITE_COMPRESSION = {"lzw": _LZW, "packbits": _PACKBITS}


def encode_tiff(img: np.ndarray, compression: str = "lzw", predictor: int = 1,
                byteorder: str = "<", rows_per_strip: int | None = None) -> bytes:
    """uint8 or uint16 (H, W) gray, or (H, W, C) with C in 2-4 (gray +
    alpha in uint8 alone, RGB, RGBA; alpha as ExtraSamples 2) -> a one-IFD TIFF in strips
    of `rows_per_strip` rows (default: 64 KB strips, as PIL writes them),
    `compression` "lzw" or "packbits", `predictor` 2 (horizontal
    differencing, with LZW) or 1, in byte order `byteorder` "<" (II) or ">"
    (MM)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_tiff takes uint8 or uint16, not {img.dtype}")
    img = img if img.ndim == 3 else img[..., None]
    h, w, c = img.shape
    if c not in (1, 2, 3, 4) or (c == 2 and img.dtype == np.uint16):
        raise ValueError(f"encode_tiff takes 1-4 channels of 8 bits and 1, 3 or 4 of "
                         f"16 (PIL opens no 16-bit gray + alpha), not {c} of {img.dtype}")
    if compression not in _WRITE_COMPRESSION:
        raise ValueError(f"compression {compression!r}: one of {list(_WRITE_COMPRESSION)}")
    comp = _WRITE_COMPRESSION[compression]
    if predictor == 2 and comp != _LZW:
        raise ValueError("predictor 2 with PackBits, which libtiff does not undo")
    depth = img.dtype.itemsize * 8
    row_bytes = w * c * depth // 8
    rps = rows_per_strip or max(1, min(h, 65536 // row_bytes))
    samples = img.astype(img.dtype.newbyteorder(byteorder))
    strips = []
    for y in range(0, h, rps):
        s = samples[y:y + rps]
        if predictor == 2:
            s = np.diff(s, axis=1, prepend=np.zeros_like(s[:, :1])).astype(s.dtype)
        raw = np.ascontiguousarray(s).view(np.uint8).reshape(len(s), row_bytes)
        strips.append(lzw.lzw_encode(raw) if comp == _LZW else packbits_encode(raw))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [depth] * c), (259, 3, [comp]),
            (262, 3, [1 if c <= 2 else 2]), (273, 4, [0] * len(strips)), (277, 3, [c]),
            (278, 4, [rps]), (279, 4, [len(s) for s in strips]), (284, 3, [1])]
    if predictor == 2:
        tags.append((317, 3, [2]))
    if c in (2, 4):
        tags.append((338, 3, [2]))
    tags.sort()
    e = byteorder
    ifd_at = 8
    blob_at = ifd_at + 2 + 12 * len(tags) + 4
    sizes = [struct.calcsize(_TYPES[t]) * len(v) for _, t, v in tags]
    data_at = blob_at + sum(s for s in sizes if s > 4)
    offs = list(np.cumsum([0] + [len(s) for s in strips])[:-1] + data_at)
    entries, blob = [], []
    for (tag, typ, vals), size in zip(tags, sizes):
        vals = offs if tag == 273 else vals
        packed = struct.pack(e + _TYPES[typ] * len(vals), *(int(v) for v in vals))
        if size > 4:
            field = struct.pack(e + "I", blob_at + sum(len(b) for b in blob))
            blob.append(packed)
        else:
            field = packed + bytes(4 - size)
        entries.append(struct.pack(e + "HHI", tag, typ, len(vals)) + field)
    return b"".join([b"II*\x00" if e == "<" else b"MM\x00*", struct.pack(e + "I", ifd_at),
                     struct.pack(e + "H", len(tags)), *entries, bytes(4), *blob, *strips])


def write_tiff(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_tiff(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_tiff(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
