"""TIFF images with numpy, `zlib`, `lzma` and the port's C++, to the arrays
PIL 12 gives (the JAX reader opens dataset images with PIL, which hands
compressed TIFFs to libtiff; the machines the port runs on have neither).

`read_tiff` reads the first image (IFD) of a little- or big-endian TIFF
stored in strips or tiles (`TileWidth` / `TileLength`; edge tiles are
stored whole and cropped), its samples interleaved or planar
(`PlanarConfiguration` 2: a strip or tile of each sample, plane after
plane), unsigned samples of 8 or 16 bits, or 1, 2 or 4 bits for one
sample:

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
- CMYK (`Photometric` 5, `InkSet` 1) -> (H, W, 3), PIL's `convert("RGB")`
  (`jpeg.cmyk_to_rgb`; PIL opens it as mode CMYK, whose K the JAX reader
  takes as an alpha mask: fault B14);
- 16-bit gray, RGB, RGBA and CMYK keep the high byte of each sample, as
  PIL's `RGB;16L` / `RGB;16B` raw modes do for RGB(A) (PIL opens 16-bit
  gray as mode I;16, values up to 65,535 that the JAX reader divides by
  255: fault B7);
- 1-bit gray (bilevel) as 0 and 255, as PIL's `convert("L")` of its mode
  1 (whose `np.asarray` is a bool array that the JAX reader divides by 255:
  fault B16); 2- and 4-bit gray scaled to 0..255 as PIL scales them.

Strips and tiles are uncompressed (`Compression` 1), Deflate (8, and the
older 32946, by `zlib`), LZMA (34925, by the standard library's `lzma`,
the xz container libtiff writes), Zstandard (50000, `io/zstd.py`:
`gm_zstd_decode`), LZW (5, `io/lzw.py`: `gm_lzw_decode`) or PackBits
(32773, `gm_packbits_decode`), each to its size: LZW or PackBits that stops
short or runs past it raises. Zstandard follows libtiff's `ZSTDDecode`: the
strip's first frame only, bytes after it and what it gives past the size
dropped; a frame that gives fewer bytes (two frames of half a strip each, a
skippable frame first, a frame cut short) raises naming the strip, as PIL
fails on it ("Not enough data"), and so do a bad checksum and the other
faults libzstd refuses. After Deflate, LZMA, Zstandard or LZW,
`Predictor` 2 is undone as libtiff undoes it, a cumulative sum along each
row of the strip or tile per sample (a tile's rows start at its own left
edge), mod 256 or mod 65,536 on 16-bit samples (libtiff ignores the
predictor of uncompressed and PackBits data, and so does this).

JPEG compression (7): each strip or tile is a JPEG stream of its own,
abbreviated where the `JPEGTables` tag holds its tables, decoded by
`io/jpeg.py::decode_jpeg` with the colour fixed as libtiff fixes it for
PIL: Photometric 1, 2 and 5 (gray, RGB, CMYK) take the components as they
are, whatever the stream's markers say (JCS_UNKNOWN); Photometric 6
(YCbCr) goes through libjpeg's YCbCr -> RGB with fancy upsampling, which
stops at each strip's or tile's edge (PIL asks libtiff for
JPEGCOLORMODE_RGB). As libtiff's `JPEGPreDecode` checks: a stream has
`SamplesPerPixel` components; its frame is the strip's or tile's size,
or taller for the last strip (cropped); a smaller frame raises (libtiff
warns and leaves rows undefined); the first component's sampling factors
are `YCbCrSubsampling` (2, 2 where the tag is absent) for YCbCr and 1, 1
otherwise, the others' 1, 1 ("Improper JPEG sampling factors").

Associated alpha, 12-bit and floating-point samples, 16-bit white-is-zero,
`FillOrder` 2, libtiff's old-style LZW (LSB first, which libtiff tells by
a strip's first two bytes), CCITT, old-style JPEG (6), planar JPEG,
YCbCr that is not JPEG-compressed (subsampled samples), WebP, BigTIFF and
every other compression raise with the cause. `decode_tiff_plain` decodes
LZW, PackBits and Zstandard data with the plain versions
(`io/lzw.py::lzw_decode_plain`, `packbits_decode_plain`,
`io/zstd.py::decode_plain`) and JPEG streams with `read_jpeg_plain`'s
decoder, which the C++ is held to byte for byte; the training path never
calls them.

`encode_tiff` / `write_tiff` write 8- or 16-bit gray, gray + alpha, RGB,
RGBA and CMYK in either byte order, in strips or tiles, interleaved or
planar, uncompressed, LZW (predictor 1 or 2; the LZW encoder in C++,
`gm_lzw_encode`), PackBits, Deflate, LZMA or Zstandard (predictor 1 or 2;
`gm_zstd_encode`, a frame a strip or tile), or JPEG
(Photometric 1, 2 or 5 as they are, or RGB as YCbCr, Photometric 6 with
its `YCbCrSubsampling`; a `JPEGTables` tag and abbreviated streams), for
the tests and `chip_smoke.py`; the training path does not write TIFFs.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from gaussianmesh_tpu_torch.io import jpeg, lzw, runs, zstd
from gaussianmesh_tpu_torch.ops import _cuda

TIFF_MAGICS = (b"II*\x00", b"MM\x00*")
_BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")
# the first bytes `read_tiff` takes: BigTIFF to raise naming it
TIFF_HEADS = TIFF_MAGICS + _BIGTIFF_MAGICS

# tag type -> struct code (the integer types; UNDEFINED (7) as bytes for the
# tags of _BYTE_TAGS; other tags are not read)
_TYPES = {1: "B", 3: "H", 4: "I"}
_UNDEFINED = 7
_BYTE_TAGS = (347,)                    # JPEGTables
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4",
                 6: "old-style JPEG", 34712: "JPEG 2000", 50001: "WebP"}
_NONE, _LZW, _JPEG, _PACKBITS, _LZMA, _ZSTD = 1, 5, 7, 32773, 34925, 50000
_DEFLATE = (8, 32946)
_READ = (_NONE, _LZW, _JPEG, _PACKBITS, _LZMA, _ZSTD) + _DEFLATE
# (Photometric, samples, ExtraSamples) -> the samples kept and whether they
# are inverted (PIL's OPEN_INFO for 8-bit samples, without associated alpha)
_LAYOUTS = {
    (0, 1, ()): (1, True), (1, 1, ()): (1, False), (1, 2, (2,)): (2, False),
    (2, 3, ()): (3, False), (2, 4, ()): (4, False), (2, 4, (2,)): (4, False),
    (2, 4, (0,)): (3, False), (2, 5, (0, 0)): (3, False), (2, 6, (0, 0, 0)): (3, False),
    (2, 5, (2, 0)): (4, False), (2, 6, (2, 0, 0)): (4, False),
    (3, 1, ()): (1, False), (3, 2, (0,)): (1, False),
    (5, 4, ()): (4, False), (5, 5, (0,)): (4, False), (5, 6, (0, 0)): (4, False),
}
# the same for 16-bit samples (PIL's I;16 / I;16B, RGB;16, RGBA;16, RGBX;16,
# CMYK;16)
_LAYOUTS_16 = {
    (1, 1, ()): (1, False), (2, 3, ()): (3, False), (2, 4, ()): (4, False),
    (2, 4, (2,)): (4, False), (2, 4, (0,)): (3, False), (5, 4, ()): (4, False),
}
# ... and for 1-, 2- and 4-bit samples: gray, white-is-zero gray, palette
_LAYOUTS_SUB = {(0, 1, ()): (1, True), (1, 1, ()): (1, False), (3, 1, ()): (1, False)}
# JPEG compression: (Photometric, samples) read, 8-bit, no ExtraSamples
_JPEG_LAYOUTS = ((1, 1), (2, 3), (5, 4), (6, 3))
_PREDICTED = (_LZW, _LZMA, _ZSTD) + _DEFLATE
_STATUS_OVERFLOW = 8                   # csrc/image.cpp's kOverflow


def read_tiff(path: str) -> np.ndarray:
    """A TIFF -> uint8 (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or
    (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)


def _tags(data: bytes, path: str) -> dict:
    """The first IFD's BYTE, SHORT and LONG tags -> {tag: [values]}, and
    the UNDEFINED tags of _BYTE_TAGS -> {tag: bytes}."""
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
            code = "B" if typ == _UNDEFINED and tag in _BYTE_TAGS else _TYPES.get(typ)
            if code is None:
                continue
            size = struct.calcsize(code) * count
            at = ifd + 2 + 12 * i + 8
            if size > 4:
                (at,) = struct.unpack_from(e + "I", data, at)
            if typ == _UNDEFINED:
                if at + count > len(data):
                    raise struct.error
                tags[tag] = bytes(data[at:at + count])
            else:
                tags[tag] = list(struct.unpack_from(e + code * count, data, at))
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
    return packbits_rows(rows)[0]


def packbits_rows(rows: np.ndarray) -> tuple[bytes, np.ndarray]:
    """`packbits_encode(rows)` and the bytes of each row's packets."""
    start, length, run = runs.segments(rows, 3, 128, 128)
    x = rows.ravel()
    head = np.stack([np.where(run, (1 - length) & 0xFF, length - 1), x[start]], 1)
    out = runs.assemble(x, start, head.astype(np.uint8), np.where(run, 2, 1),
                        np.where(run, 0, length), np.zeros_like(length)).tobytes()
    size = np.where(run, 2, 1 + length)
    return out, np.bincount(start // rows.shape[1], size, minlength=len(rows)).astype(np.int64)


def decode_tiff(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_tiff` of a TIFF's bytes (`path` names it in errors)."""
    return _decode(data, path, lzw.lzw_decode, packbits_decode, zstd.decode, True)


def decode_tiff_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_tiff` with LZW, PackBits and Zstandard data decoded by the
    plain versions, and JPEG streams by `read_jpeg_plain`'s decoder."""
    return _decode(data, path, lzw.lzw_decode_plain, packbits_decode_plain,
                   zstd.decode_plain, False)


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
    if photometric == 6:
        raise ValueError(f"{path}: YCbCr TIFF (Photometric 6) that is not JPEG-compressed "
                         "(subsampled YCbCr samples); not read")
    if (photometric, spp, extra) not in table:
        raise ValueError(f"{path}: {bits[0]}-bit TIFF of Photometric {photometric} with "
                         f"{spp} samples and ExtraSamples {list(extra)}; only gray, gray "
                         "+ alpha, RGB, RGBA, CMYK and palette TIFFs of the layouts PIL "
                         "opens are read")
    return (bits[0],) + table[(photometric, spp, extra)]


def _strip(raw, where, size, compression, path, decode_lzw, decode_packbits, decode_zstd):
    """The stored bytes of `where` (strip or tile i) -> `size` bytes,
    uint8."""
    if compression in _DEFLATE:
        try:
            raw = zlib.decompress(raw)
        except zlib.error as err:
            raise ValueError(f"{path}: TIFF {where} fails to inflate: {err}") from None
        out = np.frombuffer(raw, np.uint8)[:size]
    elif compression == _LZMA:
        try:
            import lzma
        except ImportError:
            raise ValueError(f"{path}: LZMA-compressed TIFF, and this Python has no lzma "
                             "module") from None
        try:        # as libtiff's LZMADecode: the bytes it needs, trailing data ignored
            raw = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw, size)
        except lzma.LZMAError as err:
            raise ValueError(f"{path}: TIFF {where} fails to decompress (LZMA): "
                             f"{err}") from None
        out = np.frombuffer(raw, np.uint8)
    elif compression == _ZSTD:
        try:        # as libtiff's ZSTDDecode: the first frame, to the size
            out = decode_zstd(raw, size)
        except ValueError as err:
            raise ValueError(f"{path}: TIFF {where}: {err}") from None
        if len(out) < size:
            raise ValueError(f"{path}: TIFF {where}: its first Zstandard frame gives "
                             f"{len(out)} of its {size} bytes (libtiff reads no further "
                             "frame: not enough data)")
    elif compression in (_LZW, _PACKBITS):
        if compression == _LZW and raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1:
            raise ValueError(f"{path}: TIFF {where} is old-style LZW (LSB first, "
                             "libtiff's compatibility codec); not read")
        try:
            out = (decode_lzw if compression == _LZW else decode_packbits)(raw, size)
        except ValueError as err:
            raise ValueError(f"{path}: TIFF {where}: {err}") from None
    else:
        out = np.frombuffer(raw, np.uint8)[:size]
    if len(out) < size:
        raise ValueError(f"{path}: TIFF {where} cut short (truncated TIFF)")
    return out


def _chunks(tags, path, width, height, planes):
    """The strips or tiles -> (their kind, (width, height) of each, per
    chunk its (offset, byte count, plane, x0, y0, rows)), in file order:
    plane after plane, then row after row of chunks."""
    if 322 in tags or 323 in tags:
        if not all(t in tags for t in (322, 323, 324, 325)):
            raise ValueError(f"{path}: tiled TIFF without its tile size, tile offsets or "
                             "tile byte counts")
        cw, ch = tags[322][0], tags[323][0]
        if cw <= 0 or ch <= 0:
            raise ValueError(f"{path}: TIFF tiles of {cw}x{ch}")
        kind, offsets, counts = "tile", tags[324], tags[325]
    else:
        if 273 not in tags or 279 not in tags:
            raise ValueError(f"{path}: TIFF without strip offsets or byte counts")
        cw, ch = width, min(tags.get(278, [height])[0], height) or height
        kind, offsets, counts = "strip", tags[273], tags[279]
    across, down = -(-width // cw), -(-height // ch)
    n = across * down * planes
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f"{path}: {len(offsets)} TIFF {kind}s, {n} expected")
    out = []
    for i in range(n):
        p, rest = divmod(i, across * down)
        y0, x0 = rest // across * ch, rest % across * cw
        rows = ch if kind == "tile" else min(ch, height - y0)
        out.append((offsets[i], counts[i], p, x0, y0, rows))
    return kind, (cw, ch), out


def _samples(raw, rows, cols, n, depth, e):
    """A strip's or tile's bytes -> (rows, cols, n) samples: uint8, uint16 in
    the file's byte order, or for 1-, 2- and 4-bit samples their values."""
    if depth < 8:
        v = np.unpackbits(raw.reshape(rows, -1), axis=1)[:, :cols * depth]
        v = v.reshape(rows, cols, depth)
        return (v * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)[..., None]
    if depth == 16:
        return np.frombuffer(raw.tobytes(), e + "u2").reshape(rows, cols, n)
    return raw.reshape(rows, cols, n)


def _decode(data: bytes, path: str, decode_lzw, decode_packbits, decode_zstd,
            native: bool) -> np.ndarray:
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
    planar = tags.get(284, [1])[0]
    if planar not in (1, 2):
        raise ValueError(f"{path}: TIFF PlanarConfiguration {planar}; only 1 and 2 exist")
    if set(tags.get(339, [1])) != {1}:
        raise ValueError(f"{path}: TIFF sample format {tags[339]}; only unsigned "
                         "integer samples are read")
    if tags.get(266, [1])[0] != 1:
        raise ValueError(f"{path}: TIFF with FillOrder 2; not read")
    if compression in _COMPRESSIONS:
        raise ValueError(f"{path}: {_COMPRESSIONS[compression]}-compressed TIFF; only "
                         "uncompressed, LZW, PackBits, Deflate, LZMA, Zstandard and JPEG "
                         "TIFFs are read")
    if compression not in _READ:
        raise ValueError(f"{path}: TIFF compression {compression} is unknown")
    if photometric == 5 and tags.get(332, [1])[0] != 1:
        raise ValueError(f"{path}: separated TIFF of InkSet {tags[332][0]} (inks other "
                         "than CMYK); only CMYK is read")
    if compression == _JPEG:
        return _decode_jpeg(data, tags, path, width, height, photometric, spp, bits,
                            extra, planar, native)
    depth, keep, invert = _layout(path, photometric, spp, bits, extra)
    predictor = tags.get(317, [1])[0] if compression in _PREDICTED else 1
    if predictor not in (1, 2):
        raise ValueError(f"{path}: TIFF predictor {predictor}; only 1 and 2 "
                         "(horizontal differencing) are read")
    if predictor == 2 and depth < 8:
        raise ValueError(f"{path}: TIFF predictor 2 on {depth}-bit samples, which "
                         "libtiff refuses")
    e = "<" if data[:2] == b"II" else ">"
    per = 1 if planar == 2 else spp                 # samples in a strip or tile
    kind, (cw, _), chunks = _chunks(tags, path, width, height, spp if planar == 2 else 1)
    row_bytes = -(-cw * per * depth // 8)
    img = np.zeros((height, width, spp if depth >= 8 else 1),
                   np.uint16 if depth == 16 else np.uint8)
    for i, (off, count, p, x0, y0, rows) in enumerate(chunks):
        raw = _strip(data[off:off + count], f"{kind} {i}", rows * row_bytes, compression,
                     path, decode_lzw, decode_packbits, decode_zstd)
        s = _samples(raw, rows, cw, per, depth, e)
        if predictor == 2:
            s = np.cumsum(s, axis=1, dtype=s.dtype)
        r, c = min(rows, height - y0), min(cw, width - x0)
        img[y0:y0 + r, x0:x0 + c, p:p + per] = s[:r, :c]
    if depth < 8:
        if photometric != 3:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16:
        img = (img >> 8).astype(np.uint8)
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
    if photometric == 5:
        return jpeg.cmyk_to_rgb(img)
    return img[..., 0].copy() if keep == 1 else np.ascontiguousarray(img)


def _decode_jpeg(data, tags, path, width, height, photometric, spp, bits, extra, planar,
                 native) -> np.ndarray:
    """A JPEG-compressed TIFF (see the module docstring)."""
    if planar == 2:
        raise ValueError(f"{path}: planar JPEG-compressed TIFF (PlanarConfiguration 2); "
                         "not read")
    if set(bits) != {8} or len(bits) != spp:
        raise ValueError(f"{path}: JPEG-compressed TIFF of {bits}-bit samples; only 8-bit "
                         "samples are read")
    if (photometric, spp) not in _JPEG_LAYOUTS or extra:
        raise ValueError(f"{path}: JPEG-compressed TIFF of Photometric {photometric} with "
                         f"{spp} samples and ExtraSamples {list(extra)}; only gray, RGB, "
                         "YCbCr and CMYK are read")
    tables = jpeg.jpeg_tables(tags[347], f"{path}: JPEGTables") if 347 in tags else None
    sampling = tuple(tags.get(530, [2, 2])[:2]) if photometric == 6 else (1, 1)
    kind, (cw, ch), chunks = _chunks(tags, path, width, height, 1)

    def check(where, rows, last):
        def on_frame(frame):
            if frame.lossless:
                raise ValueError(f"{where}: a lossless JPEG (SOF3) in a JPEG-compressed "
                                 "TIFF; not read")
            n = len(frame.ids)
            if n != spp:
                raise ValueError(f"{where}: a JPEG of {n} components in a TIFF of {spp} "
                                 "samples (improper JPEG component count)")
            if frame.width > cw or frame.height > rows and not last:
                raise ValueError(f"{where}: JPEG frame of {frame.width}x{frame.height} "
                                 f"exceeds the {kind}'s {cw}x{rows}")
            if frame.width < cw or frame.height < rows:
                raise ValueError(f"{where}: JPEG frame of {frame.width}x{frame.height} "
                                 f"smaller than the {kind}'s {cw}x{rows} (libtiff leaves "
                                 "the rest undefined)")
            got = list(zip(frame.h, frame.v))
            if got[0] != sampling or any(hv != (1, 1) for hv in got[1:]):
                raise ValueError(f"{where}: improper JPEG sampling factors {got}; the "
                                 f"TIFF's say {sampling} for the first component and "
                                 "(1, 1) for the others")
        return on_frame

    color = "ycc" if photometric == 6 else "as_is"
    img = np.zeros((height, width) + (() if spp == 1 else (3,)), np.uint8)
    for i, (off, count, _, x0, y0, rows) in enumerate(chunks):
        where = f"{path}: TIFF {kind} {i}"
        last = kind == "strip" and i == len(chunks) - 1
        if off + count > len(data):
            raise ValueError(f"{where} cut short (truncated TIFF)")
        arr = jpeg.decode_jpeg(data[off:off + count], where, native=native, tables=tables,
                               color=color, on_frame=check(where, rows, last))
        r, c = min(rows, height - y0), min(cw, width - x0)
        img[y0:y0 + r, x0:x0 + c] = arr[:r, :c]
    return img


# ------------------------------------------------------------------ writer
_WRITE_COMPRESSION = {"none": _NONE, "lzw": _LZW, "packbits": _PACKBITS, "deflate": 8,
                      "lzma": _LZMA, "zstd": _ZSTD, "jpeg": _JPEG}
# YCbCrSubsampling of write_jpeg's chroma subsamplings
_YCBCR_SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2)}
_WRITE_TYPES = {3: "H", 4: "I", _UNDEFINED: "B"}


def _encode_chunk(s, comp, predictor, byteorder, jpeg_kw):
    """(rows, cols, n) samples of a strip or tile -> its stored bytes."""
    if comp == _JPEG:
        return jpeg.encode_jpeg(s[..., 0] if s.shape[2] == 1 else s, tables=False,
                                **jpeg_kw)
    if predictor == 2:
        s = np.diff(s, axis=1, prepend=np.zeros_like(s[:, :1])).astype(s.dtype)
    raw = np.ascontiguousarray(s.astype(s.dtype.newbyteorder(byteorder))).view(
        np.uint8).reshape(len(s), -1)
    if comp == _LZW:
        return lzw.lzw_encode(raw)
    if comp == _PACKBITS:
        return packbits_encode(raw)
    if comp == 8:
        return zlib.compress(raw.tobytes())
    if comp == _LZMA:
        import lzma
        return lzma.compress(raw.tobytes(), lzma.FORMAT_XZ, lzma.CHECK_NONE)
    if comp == _ZSTD:
        return zstd.encode(raw)
    return raw.tobytes()


def encode_tiff(img: np.ndarray, compression: str = "lzw", predictor: int = 1,
                byteorder: str = "<", rows_per_strip: int | None = None,
                tile: tuple | None = None, planar: bool = False, cmyk: bool = False,
                ycbcr: bool = False, quality: int = 90,
                subsampling: str = "4:2:0") -> bytes:
    """uint8 or uint16 (H, W) gray, or (H, W, C) with C in 2-4 (gray +
    alpha in uint8 alone, RGB, RGBA, or with `cmyk` CMYK: Photometric 5,
    InkSet 1; alpha as ExtraSamples 2) -> a one-IFD TIFF in byte order
    `byteorder` "<" (II) or ">" (MM): in strips of `rows_per_strip` rows
    (default: 64 KB strips, as PIL writes them; JPEG: a multiple of the MCU
    height), or in `tile` (width, height) tiles, edge tiles padded with
    their edge samples; `planar` writes each sample's plane in turn
    (PlanarConfiguration 2). `compression` "none", "lzw", "packbits",
    "deflate", "lzma", "zstd" or "jpeg" (uint8; gray, RGB or CMYK as they are at
    4:4:4, or with `ycbcr` RGB as YCbCr, Photometric 6, chroma subsampled by
    `subsampling`, at libjpeg's `quality`; a JPEGTables tag and abbreviated
    streams, the last strip's frame its own height, as libtiff writes
    them); `predictor` 2 (horizontal differencing, along each strip's or
    tile's rows) with LZW, Deflate, LZMA or Zstandard, or 1."""
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
    if predictor == 2 and comp not in _PREDICTED:
        raise ValueError(f"predictor 2 with {compression}, which libtiff does not undo")
    if cmyk and c != 4:
        raise ValueError(f"a CMYK TIFF takes 4 channels, not {c}")
    if ycbcr and (comp != _JPEG or c != 3):
        raise ValueError("ycbcr: RGB with JPEG compression")
    depth = img.dtype.itemsize * 8
    jpeg_kw, unit = {}, (1, 1)
    if comp == _JPEG:
        if depth != 8 or planar or c == 2 or (c == 4 and not cmyk):
            raise ValueError("JPEG compression takes 8-bit interleaved gray, RGB or CMYK")
        sub = _YCBCR_SUBSAMPLING[subsampling if ycbcr else "4:4:4"]
        jpeg_kw = dict(quality=quality, subsampling=subsampling if ycbcr else "4:4:4",
                       color="auto" if ycbcr else "as_is")
        unit = (8 * sub[0], 8 * sub[1])
    photometric = 5 if cmyk else 6 if ycbcr else 1 if c <= 2 else 2
    per = 1 if planar else c
    if tile is not None:
        cw, ch = tile
        if cw % max(16, unit[0]) or ch % max(16, unit[1]):
            raise ValueError(f"tiles of {cw}x{ch}: a multiple of 16 (and of the JPEG MCU)")
    else:
        cw = w
        ch = rows_per_strip or max(1, min(h, 65536 // (w * per * depth // 8)))
        if comp == _JPEG and not rows_per_strip:
            ch = max(unit[1], ch // unit[1] * unit[1])
        if comp == _JPEG and ch % unit[1] and ch < h:
            raise ValueError(f"JPEG strips of {ch} rows: a multiple of {unit[1]}")
    across, down = -(-w // cw), -(-h // ch)
    chunks = []
    for p in range(c if planar else 1):
        sel = img[..., p:p + 1] if planar else img
        for ty in range(down):
            for tx in range(across):
                s = sel[ty * ch:(ty + 1) * ch, tx * cw:(tx + 1) * cw]
                if tile is not None:
                    s = np.pad(s, ((0, ch - len(s)), (0, cw - s.shape[1]), (0, 0)),
                               mode="edge")
                chunks.append(_encode_chunk(s, comp, predictor, byteorder, jpeg_kw))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [depth] * c), (259, 3, [comp]),
            (262, 3, [photometric]), (277, 3, [c]), (284, 3, [2 if planar else 1])]
    if tile is None:
        tags += [(273, 4, [0] * len(chunks)), (278, 4, [ch]),
                 (279, 4, [len(s) for s in chunks])]
    else:
        tags += [(322, 4, [cw]), (323, 4, [ch]), (324, 4, [0] * len(chunks)),
                 (325, 4, [len(s) for s in chunks])]
    if predictor == 2:
        tags.append((317, 3, [2]))
    if cmyk:
        tags.append((332, 3, [1]))
    elif c in (2, 4):
        tags.append((338, 3, [2]))
    if comp == _JPEG:
        tables = jpeg.encode_jpeg_tables(quality, 2 if ycbcr else 1)
        tags.append((347, _UNDEFINED, list(tables)))
        if ycbcr:
            tags.append((530, 3, list(sub)))
    tags.sort()
    e = byteorder
    ifd_at = 8
    blob_at = ifd_at + 2 + 12 * len(tags) + 4
    sizes = [struct.calcsize(_WRITE_TYPES[t]) * len(v) for _, t, v in tags]
    data_at = blob_at + sum(s for s in sizes if s > 4)
    offs = list(np.cumsum([0] + [len(s) for s in chunks])[:-1] + data_at)
    entries, blob = [], []
    for (tag, typ, vals), size in zip(tags, sizes):
        vals = offs if tag in (273, 324) else vals
        packed = struct.pack(e + _WRITE_TYPES[typ] * len(vals), *(int(v) for v in vals))
        if size > 4:
            field = struct.pack(e + "I", blob_at + sum(len(b) for b in blob))
            blob.append(packed)
        else:
            field = packed + bytes(4 - size)
        entries.append(struct.pack(e + "HHI", tag, typ, len(vals)) + field)
    return b"".join([b"II*\x00" if e == "<" else b"MM\x00*", struct.pack(e + "I", ifd_at),
                     struct.pack(e + "H", len(tags)), *entries, bytes(4), *blob, *chunks])


def write_tiff(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_tiff(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_tiff(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
