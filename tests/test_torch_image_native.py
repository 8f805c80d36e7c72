"""The port's C++ image codecs (`csrc/image.cpp`: JPEG scans and planes, PNG
row unfiltering, PIL's bicubic pass) against their plain numpy versions
and PIL, byte for byte, on the CPU: every JPEG sampling and gray, odd
sizes, restart intervals, non-interleaved scans, SOF1, long Huffman codes
and the corrupt streams (the same errors); PNGs at every depth and colour
type with rows cycling through all five filters, palettes with tRNS,
Adam7; resize in L / LA / RGB / RGBA up, down and on the resolution ladder.
The training path's readers never reach a plain version (the LZW,
PackBits and RLE ones of `tests/test_torch_image_formats_lzw.py`, the
Zstandard walk of `io/zstd.py`, the
BC1 one of FTEX textures, the BCn ones of DDS and BLP textures, BC6H's
and the lossless JPEG walk included), and a build that cannot happen
raises."""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu_torch.data import cameras, readers
from gaussianmesh_tpu_torch.io import (bcn, blp, bmp, dds, fli, ftex, gif, jpeg, lzw, pcx, png,
                                      pnm, qoi, resample, sgi, tga, tiff, webp, zstd)
from gaussianmesh_tpu_torch.ops import _cuda
from tests.test_torch_jpeg import _image as _jpeg_image, _segment, _segments
from tests.test_torch_readers import ADAM7, _blender_set, _chunk, _jpeg_colmap_set
from tests.test_torch_resample import CASES, MODES, _image as _resize_image

torch.set_num_threads(2)

JPEG_SIZES = [(1, 1), (17, 9), (33, 17), (65, 9)]     # (width, height), 8k + 1 among them


def _same(path):
    """read_jpeg (C++) == read_jpeg_plain (numpy) == PIL, dtype and shape."""
    got, plain = jpeg.read_jpeg(path), jpeg.read_jpeg_plain(path)
    assert got.dtype == plain.dtype == np.uint8 and got.shape == plain.shape
    assert np.array_equal(got, plain), np.abs(got.astype(int) - plain).max()
    want = np.asarray(Image.open(path))
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()
    return want


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "gray"])
def test_jpeg_native_equals_plain_and_pil(tmp_path, sampling, size):
    """`write_jpeg`'s files (every sampling, 4:4:0 included) at qualities 50
    and 100, and PIL's (its samplings) plain, optimized and with restart
    markers every block."""
    gray = sampling == "gray"
    img = _jpeg_image(*size, 1 if gray else 3, seed=size[0] + 7 * size[1])
    path = str(tmp_path / "x.jpg")
    for quality in (50, 100):
        jpeg.write_jpeg(path, img, quality=quality,
                        **({} if gray else {"subsampling": sampling}))
        _same(path)
    if sampling == "4:4:0":         # PIL writes 4:4:4, 4:2:2 and 4:2:0
        return
    for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 1}):
        kw = dict(quality=90, **extra, **({} if gray else {"subsampling": sampling}))
        try:
            Image.fromarray(img).save(path, "JPEG", **kw)
        except OSError:             # PIL's own encoder fails on some optimize cases
            continue
        _same(path)


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                                {"restart_marker_rows": 1}], ids=["blocks1", "blocks5", "rows1"])
def test_jpeg_restart_intervals(tmp_path, kw):
    path = str(tmp_path / "r.jpg")
    Image.fromarray(_jpeg_image(67, 35, 3, seed=3)).save(path, "JPEG", quality=85, **kw)
    assert b"\xff\xdd" in open(path, "rb").read()
    _same(path)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
def test_jpeg_non_interleaved_scans(tmp_path, sampling):
    """Y, Cb and Cr in three scans of one component each (each over its
    component's own block grid), built from `write_jpeg`'s gray files."""
    w, h = 33, 19
    f = 2 if sampling == "4:2:0" else 1
    cw, ch = -(-w // f), -(-h // f)
    planes = [_jpeg_image(w, h, 1, seed=5), _jpeg_image(cw, ch, 1, seed=6, noise=8.0),
              _jpeg_image(cw, ch, 1, seed=7, noise=8.0)]
    path = str(tmp_path / "ni.jpg")
    scans = []
    for p in planes:
        jpeg.write_jpeg(path, p, quality=90)
        segs, scan = _segments(open(path, "rb").read())
        scans.append(scan)
    tables = [_segment(m, b) for m, b in segs if m in (0xE0, 0xDB, 0xC4)]
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, f << 4 | f, 0, 2, 0x11, 0,
                                                     3, 0x11, 0])
    out = [b"\xff\xd8", *tables, _segment(0xC0, sof)]
    for i, scan in enumerate(scans):
        out += [_segment(0xDA, bytes([1, i + 1, 0x00, 0, 63, 0])), scan]
    with open(path, "wb") as fh:
        fh.write(b"".join(out + [b"\xff\xd9"]))
    _same(path)


def test_jpeg_sof1_and_long_huffman_codes(tmp_path):
    """An extended-sequential (SOF1) file, and noise at quality 100 under
    the Annex K tables, whose AC codes run to 16 bits (past the decoder's
    9-bit fast table)."""
    path = str(tmp_path / "n.jpg")
    noise = np.random.default_rng(0).integers(0, 256, (40, 72, 3), dtype=np.uint8)
    Image.fromarray(noise).save(path, "JPEG", quality=100, subsampling=0)
    segs, _ = _segments(open(path, "rb").read())
    dht = [b for m, b in segs if m == 0xC4]
    assert any(sum(b[1 + 9:1 + 16]) > 0 for b in dht)       # code lengths 10-16
    _same(path)
    data = open(path, "rb").read()
    at = data.index(b"\xff\xc0")
    with open(path, "wb") as fh:
        fh.write(data[:at] + b"\xff\xc1" + data[at + 2:])
    _same(path)


def _both_raise(path, match):
    for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
        with pytest.raises(ValueError, match=match) as err:
            read(path)
        yield str(err.value)


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
def test_jpeg_truncated_raises_as_plain(tmp_path, cut):
    path = str(tmp_path / "t.jpg")
    Image.fromarray(_jpeg_image(64, 40, 3, seed=1)).save(path, "JPEG", quality=95)
    data = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(data[:int(len(data) * cut)])
    native, plain = _both_raise(path, "truncated JPEG")
    assert native == plain


@pytest.mark.parametrize("drop", [1, 2])
def test_jpeg_scan_short_by_a_byte_or_two_raises_as_plain(tmp_path, drop):
    """The entropy-coded data short by its last byte or two (the EOI kept):
    the last symbols read the zero padding, so only the bit count at the
    end of the interval says the data ran out."""
    path = str(tmp_path / "s.jpg")
    Image.fromarray(_jpeg_image(40, 24, 3, seed=4)).save(path, "JPEG", quality=90)
    head, body = _split_scan(open(path, "rb").read())
    with open(path, "wb") as fh:
        fh.write(head + body[:-drop] + b"\xff\xd9")
    native, plain = _both_raise(path, "truncated JPEG")
    assert native == plain


def test_jpeg_colour_tables_every_chroma_pair():
    """The fixed-point YCbCr -> RGB conversion on every (Cb, Cr) pair: a
    4:4:4 frame of 256 x 256 flat blocks (DC alone, a quantiser of 8, so a
    block's samples are its DC + 128), Cb the block column, Cr the block
    row, Y varying across them; C++ planes == numpy planes."""
    n = 256
    sof = struct.pack(">BHHB", 8, 8 * n, 8 * n, 3) + bytes([1, 0x11, 0, 2, 0x11, 0,
                                                             3, 0x11, 0])
    frame = jpeg._Frame(sof, "<frame>")
    by, bx = np.mgrid[0:n, 0:n]
    for c, value in enumerate(((7 * bx + 13 * by) % 256, bx, by)):
        frame.coef[c][..., 0] = value - 128
        frame.q[c] = np.full(64, 8, np.int64)
    got, want = jpeg._planes_native(frame, jpeg.YCC), jpeg._planes_plain(frame, jpeg.YCC)
    assert got.shape == want.shape == (8 * n, 8 * n, 3)
    assert np.array_equal(got[::8, ::8], got[7::8, 7::8])        # flat blocks
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


def test_jpeg_corrupt_streams_raise_as_plain(tmp_path):
    """Restart markers taken out of a file that declares an interval, and
    an entropy-coded stream of 0xFF bytes, which no code word matches."""
    path = str(tmp_path / "c.jpg")
    Image.fromarray(_jpeg_image(48, 32, 3, seed=2)).save(path, "JPEG", quality=90,
                                                         restart_marker_blocks=1)
    head, body = _split_scan(open(path, "rb").read())
    for r in range(0xD0, 0xD8):
        body = body.replace(bytes([0xFF, r]), b"")
    with open(path, "wb") as fh:
        fh.write(head + body + b"\xff\xd9")
    assert len(set(_both_raise(path, "restart intervals"))) == 1
    Image.fromarray(_jpeg_image(48, 32, 3, seed=2)).save(path, "JPEG", quality=90)
    head, _ = _split_scan(open(path, "rb").read())
    with open(path, "wb") as fh:
        fh.write(head + b"\xff\x00" * 64 + b"\xff\xd9")
    assert len(set(_both_raise(path, "no Huffman code matches"))) == 1


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "gray"])
def test_progressive_native_equals_plain_and_pil(tmp_path, sampling, size):
    """Progressive files (SOF2): `write_jpeg(progressive=True)`'s at every
    sampling, 4:4:0 included, at qualities 50 and 100, and PIL's plain,
    optimized and with restart markers every block; the C++ scan decoder
    (`gm_jpeg_scan_progressive`), the plain one and PIL equal."""
    gray = sampling == "gray"
    img = _jpeg_image(*size, 1 if gray else 3, seed=size[0] + 5 * size[1])
    path = str(tmp_path / "p.jpg")
    for quality in (50, 100):
        jpeg.write_jpeg(path, img, quality=quality, progressive=True,
                        **({} if gray else {"subsampling": sampling}))
        _same(path)
    if sampling == "4:4:0":
        return
    for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 1}):
        kw = dict(quality=90, progressive=True, **extra,
                  **({} if gray else {"subsampling": sampling}))
        Image.fromarray(img).save(path, "JPEG", **kw)
        _same(path)


def _outcome(read, path):
    try:
        return read(path)
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("restart", [0, 2])
def test_progressive_damaged_streams_as_plain(tmp_path, restart):
    """A progressive file (PIL's, restart interval 0 or 2 blocks) cut at 24
    places and with 40 single bytes of its scans changed (seeded): on each,
    the C++ decoder returns the plain one's bytes or raises its error."""
    path = str(tmp_path / "d.jpg")
    kw = {"restart_marker_blocks": restart} if restart else {}
    Image.fromarray(_jpeg_image(48, 40, 3, seed=9)).save(path, "JPEG", quality=80,
                                                         progressive=True, **kw)
    data = open(path, "rb").read()
    first = data.index(b"\xff\xda")
    rng = np.random.default_rng(restart)
    damaged = [data[:int(first + f * (len(data) - first))] + b"\xff\xd9"
               for f in np.linspace(0.02, 0.98, 24)]
    for at, value in zip(rng.integers(first + 12, len(data) - 2, 40),
                         rng.integers(0, 256, 40)):
        if data[at] != 0xFF and data[at - 1] != 0xFF and value != 0xFF:
            damaged.append(data[:at] + bytes([value]) + data[at + 1:])
    errors = set()
    for i, d in enumerate(damaged):
        with open(path, "wb") as fh:
            fh.write(d)
        native, plain = _outcome(jpeg.read_jpeg, path), _outcome(jpeg.read_jpeg_plain, path)
        assert type(native) is type(plain), (i, native if isinstance(native, str) else plain)
        if isinstance(native, str):
            assert native == plain, i
            errors.add(native.split(": ", 1)[-1])
        else:
            assert np.array_equal(native, plain), i
    assert any("truncated" in e for e in errors), errors


def _split_scan(data):
    """A one-scan JPEG -> (its bytes to the end of the SOS header, the
    entropy-coded bytes)."""
    sos = data.index(b"\xff\xda")
    head = data[:sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")]
    return head, data[len(head):-2]


# ---------------------------------------------------------------------- PNG

def _row_bytes(samples, depth):
    """(h, w, c) samples -> (h, row bytes) uint8: big-endian 16-bit, or
    sub-byte samples packed MSB first."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter(rows, bpp, filters):
    """Forward PNG filtering, row y with filters[y % len] -> the IDAT rows."""
    x = rows.astype(np.int32)
    out = []
    for y in range(len(x)):
        f = filters[y % len(filters)]
        row, up = x[y], (x[y - 1] if y else np.zeros_like(x[y]))
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[:len(row)]
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:len(row)]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][f] if f <= 4 else 0
        out.append(bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def _png(samples, color_type, depth, filters, interlace=0, plte=None, trns=None):
    """A PNG of (h, w, c) samples at `depth`, every row of every pass
    filtered by the cycle `filters`."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    idat = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            idat += _filter(_row_bytes(sub, depth), bpp, filters)
    out = png.PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                                      0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(idat)) + _chunk(b"IEND", b"")


def _same_png(data):
    got, plain = png.decode_png(data), png.decode_png_plain(data)
    assert got.dtype == plain.dtype == np.uint8 and got.shape == plain.shape
    assert np.array_equal(got, plain), np.abs(got.astype(int) - plain).max()
    return got


CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (4, 8), (4, 16), (2, 8), (2, 16),
         (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["progressive_rows", "adam7"])
@pytest.mark.parametrize("color_type,depth", TYPES, ids=lambda v: str(v))
def test_png_native_equals_plain_every_filter_and_depth(color_type, depth, interlace):
    """Gray at 1-16 bits, gray + alpha, RGB and RGBA at 8 and 16, rows
    cycling through filters 0-4 (and 4-1 backwards), Adam7 or not, at
    sizes with empty passes and odd row lengths; 8-bit ones equal PIL's."""
    rng = np.random.default_rng(depth * 10 + color_type)
    c = CHANNELS[color_type]
    for h, w in ((13, 17), (1, 1), (5, 3), (9, 31)):
        y, x = np.mgrid[0:h, 0:w]
        ramp = (3 * x + 5 * y)[..., None] + 40 * np.arange(c)
        scale = 257 if depth == 16 else 1          # both bytes of a 16-bit sample vary
        samples = (ramp + rng.integers(0, 7, (h, w, c))) * scale % (1 << depth)
        for filters in ([1, 2, 3, 4, 0], [4, 3, 2, 1]):
            data = _png(samples, color_type, depth, filters, interlace)
            got = _same_png(data)
            if depth == 8:
                want = np.asarray(Image.open(io.BytesIO(data)))
                assert np.array_equal(got, want), (h, w, filters)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("interlace", [0, 1], ids=["progressive_rows", "adam7"])
def test_png_palette_with_trns(bits, interlace):
    """Palette PNGs with a tRNS chunk, filtered and interlaced: C++ ==
    numpy == PIL's convert("RGBA")."""
    rng = np.random.default_rng(bits + 5 * interlace)
    n = 1 << bits
    idx = rng.integers(0, n, (11, 19, 1))
    plte = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
    trns = rng.integers(0, 256, max(1, n // 2), dtype=np.uint8).tobytes()
    data = _png(idx, 3, bits, [1, 2, 3, 4, 0], interlace, plte=plte, trns=trns)
    got = _same_png(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert np.array_equal(got, want)


def test_png_pil_adaptive_filters_and_a_bad_filter():
    """PIL's own RGBA file (its adaptive row filters, more than one type),
    and filter type 5, which both versions refuse alike."""
    rng = np.random.default_rng(8)
    y, x = np.mgrid[0:48, 0:64]
    img = np.clip(np.stack([x * 3, y * 5, x + y, 255 - y], -1) + rng.integers(0, 9, (48, 64, 4)),
                  0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, "PNG")
    data = buf.getvalue()
    assert np.array_equal(_same_png(data), img)
    bad = _png(img, 6, 8, [1, 5])
    errors = []
    for decode in (png.decode_png, png.decode_png_plain):
        with pytest.raises(ValueError, match="unknown PNG filter type 5") as err:
            decode(bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------------- resize

@pytest.mark.parametrize("c", [1, 2, 3, 4], ids=lambda c: MODES[c])
def test_resize_native_equals_plain_and_pil(c):
    """The resample tests' cases (ladder factors, odd sizes, one axis,
    upscales) and the ladder's 1920 -> 1600 and 2400 -> 1600 widths."""
    cases = CASES + [((1920, 6), (1600, 5)), ((2400, 4), (1600, 3)), ((8, 640), (4, 320))]
    for (w, h), size in cases:
        img = _resize_image(w, h, c, seed=w + h + c)
        got, plain = resample.resize(img, size), resample.resize_plain(img, size)
        want = np.asarray(Image.fromarray(img, MODES[c]).resize(size))
        assert got.shape == plain.shape == want.shape, (w, h, size)
        assert np.array_equal(got, plain) and np.array_equal(got, want), (w, h, size)


# ------------------------------------------------------------ the main path

def _new_forms_set(root):
    """`_jpeg_colmap_set` with its views as LZW TIFF (predictor 2), PackBits
    TIFF, GIF, RLE8 and RLE4 BMP and Zstandard TIFF (predictor 2), in turn."""
    root = _jpeg_colmap_set(root)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        img = jpeg.read_jpeg(path)
        kind = i % 6
        if kind == 5:
            tiff.write_tiff(path, img, compression="zstd", predictor=2)
            continue
        if kind < 2:
            tiff.write_tiff(path, img, compression=("lzw", "packbits")[kind],
                            predictor=2 - kind)
            continue
        q = Image.fromarray(img).quantize(16 if kind == 4 else 200)
        pal = np.asarray(q.getpalette()[:3 * (16 if kind == 4 else 200)], np.uint8)
        if kind == 2:
            gif.write_gif(path, np.asarray(q), pal)
        else:
            bmp.write_bmp(path, np.asarray(q), palette=pal, bits=4 if kind == 4 else 8,
                          rle=True)
    return root


def _webp_set(root):
    """`_jpeg_colmap_set` with its views as lossy WebPs, PIL's (quality 80)
    and `write_webp`'s (4 segments, 2 partitions), in turn."""
    root = _jpeg_colmap_set(root)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        img = jpeg.read_jpeg(path)
        if i % 2:
            webp.write_webp(path, img, quality_index=20, segments=4, partitions=2)
        else:
            Image.fromarray(img).save(path, "WEBP", quality=80)
    return root


def _raw_set(root):
    """`_jpeg_colmap_set` with its views as RLE TGA, QOI, RLE SGI, PCX and
    PPM, in turn."""
    root = _jpeg_colmap_set(root)
    writers = (lambda p, img: tga.write_tga(p, img, rle=True), qoi.write_qoi,
               lambda p, img: sgi.write_sgi(p, img, rle=True), pcx.write_pcx, pnm.write_pnm)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        writers[i % 5](path, jpeg.read_jpeg(path))
    return root


def _fli_set(root):
    """`_jpeg_colmap_set` with its views as FLI of BRUN and FLC of COPY (64
    levels) on a 256-colour grid palette, in turn."""
    root = _jpeg_colmap_set(root)
    steps = [np.arange(n) * 255 // (n - 1) for n in (8, 8, 4)]
    pal = np.stack(np.meshgrid(*steps, indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        img = jpeg.read_jpeg(path)
        img = np.dstack([img] * 3) if img.ndim == 2 else img
        q = img.astype(np.int64) * np.array([8, 8, 4]) // 256
        idx = ((q[..., 0] * 8 + q[..., 1]) * 4 + q[..., 2]).astype(np.uint8)
        fli.write_fli(path, idx, pal, **(dict(chunk="copy", flc=True, levels=64) if i % 2
                                         else {}))
    return root


def _ftex_set(root):
    """`_jpeg_colmap_set` with its views as FTEX textures, DXT1 (BC1) and
    raw RGB, in turn."""
    root = _jpeg_colmap_set(root)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        img = jpeg.read_jpeg(path)
        img = np.dstack([img] * 3) if img.ndim == 2 else img
        ftex.write_ftex(path, img, fmt=ftex.UNCOMPRESSED if i % 2 else ftex.DXT1)
    return root


def _texture_set(root):
    """`_jpeg_colmap_set` with its six views rewritten as DDS (BC4, DX10
    BC7, 565 masks) and BLP (BLP1 JPEG, BLP2 palette, BLP2 DXT1)
    textures."""
    root = _jpeg_colmap_set(root)
    pal = np.random.default_rng(0).integers(0, 256, (256, 3), dtype=np.uint8)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        img = jpeg.read_jpeg(path)
        img = np.dstack([img] * 3) if img.ndim == 2 else img
        k = i % 6
        if k < 3:
            arg = (img[..., 1], np.dstack([img, img[..., :1]]), img)[k]
            dds.write_dds(path, arg, ("BC4", "BC7", "RGB565")[k])
        else:
            blp.write_blp(path, img[..., 0] if k == 4 else img, blp.FORMS[k - 3], palette=pal)
    return root


def _bc6h_lossless_sets(tmp_path):
    """`_jpeg_colmap_set` with its six views rewritten as DX10 BC6H textures
    (unsigned and signed), and again as lossless JPEGs (gray and RGB, every
    scan layout)."""
    bc6h, lossless = _jpeg_colmap_set(tmp_path / "h"), _jpeg_colmap_set(tmp_path / "l")
    for i, name in enumerate(sorted(os.listdir(f"{bc6h}/images"))):
        path = f"{bc6h}/images/{name}"
        img = jpeg.read_jpeg(path)
        dds.write_dds(path, np.dstack([img] * 3) if img.ndim == 2 else img,
                      ("BC6H", "BC6HS")[i % 2])
        path = f"{lossless}/images/{name}"
        data = jpeg.encode_jpeg_lossless(jpeg.read_jpeg(path), 1 + i, i % 3, 0, i % 2 == 0)
        with open(path, "wb") as fh:
            fh.write(data)
    return bc6h, lossless


def test_training_readers_never_call_a_plain_version(tmp_path, monkeypatch):
    """`read_scene` of a JPEG COLMAP set on the -r -1 ladder (decode and
    resize), of the same set with progressive JPEGs, of a Blender set of
    PIL-filtered RGBA PNGs at -r 2, of the COLMAP set in LZW and PackBits
    TIFF, GIF, RLE BMP and Zstandard TIFF views, of it in lossy WebP views
    and of it in RLE TGA, QOI, RLE SGI, PCX and PPM views, of it in FLI and FLC views and
    of it in FTEX (DXT1 and raw) views, of it in DDS and BLP views, of it in
    DX10 BC6H views and of it in lossless JPEG views, with every plain piece
    made to raise: the same scenes as before."""
    colmap_root = _jpeg_colmap_set(tmp_path / "c")
    prog_root = _jpeg_colmap_set(tmp_path / "p")
    new_root = _new_forms_set(tmp_path / "n")
    webp_root = _webp_set(tmp_path / "w")
    raw_root = _raw_set(tmp_path / "r")
    fli_root = _fli_set(tmp_path / "f")
    ftex_root = _ftex_set(tmp_path / "t")
    texture_root = _texture_set(tmp_path / "x")
    bc6h_root, lossless_root = _bc6h_lossless_sets(tmp_path)
    for name in os.listdir(f"{prog_root}/images"):
        path = f"{prog_root}/images/{name}"
        Image.open(path).save(path, "JPEG", quality=90, progressive=True)
    blender_root = _blender_set(tmp_path / "b", with_ply=True, w=40, h=28)
    frame = open(f"{blender_root}/train/r_0.png", "rb").read()
    raw = zlib.decompress(frame[frame.index(b"IDAT") + 4:frame.index(b"IEND") - 8])
    assert any(raw[y * (1 + 40 * 4)] for y in range(28))      # filtered rows
    kw = dict(eval_split=True, is_exist_bg=True)
    before = (readers.read_scene(colmap_root, resolution=-1, **kw),
              readers.read_scene(prog_root, resolution=-1, **kw),
              readers.read_scene(blender_root, resolution=2, eval_split=True),
              readers.read_scene(new_root, resolution=-1, **kw),
              readers.read_scene(webp_root, resolution=-1, **kw),
              readers.read_scene(raw_root, resolution=-1, **kw),
              readers.read_scene(fli_root, resolution=-1, **kw),
              readers.read_scene(ftex_root, resolution=-1, **kw),
              readers.read_scene(texture_root, resolution=-1, **kw),
              readers.read_scene(bc6h_root, resolution=-1, **kw),
              readers.read_scene(lossless_root, resolution=-1, **kw))

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for mod, names in ((jpeg, ("_scan_plain", "_planes_plain", "_huffman", "_idct",
                               "_upsample", "_ycc_to_rgb", "_decode_tables",
                               "_scan_plain_progressive", "_progressive_plain",
                               "_peek_table", "_lossless_plain", "_undifference",
                               "_arith_plain", "_qm_decoder", "_arith_dc", "_arith_ac_value",
                               "_arith_ac_band", "_arith_ac_refine")),
                       (png, ("_unfilter_plain",)), (resample, ("_pass_plain",)),
                       (lzw, ("lzw_decode_plain", "lzw_encode_plain")),
                       (tiff, ("packbits_decode_plain",)), (bmp, ("_rle_plain",)),
                       (webp, ("vp8_decode_plain", "yuv_to_rgb_plain", "decode_webp_plain",
                               "_Bits", "_coeffs_plain", "_reconstruct_plain",
                               "_filter_plain")),
                       (tga, ("_rle_plain",)), (qoi, ("_ops_plain",)), (sgi, ("_rle_plain",)),
                       (pcx, ("_rle_plain",)), (fli, ("_frame_plain",)),
                       (bcn, ("_bc1_plain", "decode_plain", "_bc7", "_bc4", "_colour",
                              "_bc6h", "_half_to_8", "bc6h_endpoints")),
                       (dds, ("decode_dds_plain",)), (blp, ("decode_blp_plain",)),
                       (zstd, ("decode_plain", "xxh64_plain", "_header", "_frame_size",
                               "_block", "_literals", "_huffman_table", "_fse_weights",
                               "_huffman_stream", "_huffman_fast", "_ncount", "_seq_table",
                               "_Back"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    after = (readers.read_scene(colmap_root, resolution=-1, **kw),
             readers.read_scene(prog_root, resolution=-1, **kw),
             readers.read_scene(blender_root, resolution=2, eval_split=True),
             readers.read_scene(new_root, resolution=-1, **kw),
             readers.read_scene(webp_root, resolution=-1, **kw),
             readers.read_scene(raw_root, resolution=-1, **kw),
             readers.read_scene(fli_root, resolution=-1, **kw),
             readers.read_scene(ftex_root, resolution=-1, **kw),
             readers.read_scene(texture_root, resolution=-1, **kw),
             readers.read_scene(bc6h_root, resolution=-1, **kw),
             readers.read_scene(lossless_root, resolution=-1, **kw))
    for a, b in zip(before, after):
        for ca, cb in zip(a.train_cameras + a.test_cameras, b.train_cameras + b.test_cameras):
            assert np.array_equal(ca.image, cb.image) and np.array_equal(ca.mask, cb.mask)
    assert after[0].train_cameras[0].image.shape[1:] == cameras.pick_resolution(1700, 22, -1)[::-1]
    assert after[2].train_cameras[0].image.shape[1:] == (14, 20)


@pytest.fixture
def fresh_library(tmp_path, monkeypatch):
    """host_library's cache emptied and its build directory empty, before
    and after (the real library loads again afterwards)."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    _cuda.host_library.cache_clear()
    yield
    _cuda.host_library.cache_clear()


def _every_entry_point(tmp_path):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_jpeg_image(16, 8, 3, seed=0)).save(path, "JPEG")
    yield lambda: jpeg.read_jpeg(path)
    yield lambda: png.decode_png(_png(np.zeros((4, 4, 3), int), 2, 8, [1, 2]))
    yield lambda: resample.resize(np.zeros((4, 4, 3), np.uint8), (2, 2))
    stream = lzw.lzw_encode_plain(bytes(48))
    yield lambda: lzw.lzw_decode(stream, 48)
    yield lambda: tiff.packbits_decode(b"\xfe\x00", 3)
    yield lambda: bmp.decode_bmp(_rle_bmp())
    yield lambda: lzw.lzw_encode(bytes(4))
    yield lambda: fli.decode_fli(fli.encode_fli(np.zeros((2, 4), np.uint8),
                                                np.zeros((1, 3), np.uint8)))
    texture = ftex.encode_ftex(np.zeros((4, 4, 3), np.uint8))[0]     # encoded in numpy
    yield lambda: ftex.decode_ftex(texture)
    dxt5 = dds.encode_dds(np.zeros((4, 4, 4), np.uint8), "DXT5")[0]
    yield lambda: dds.decode_dds(dxt5)
    dxt1 = blp.encode_blp(np.zeros((4, 4, 3), np.uint8), "BLP2_DXT1")[0]
    yield lambda: blp.decode_blp(dxt1)
    bc6h = dds.encode_dds(np.zeros((4, 4, 3), np.uint8), "BC6HS")[0]
    yield lambda: dds.decode_dds(bc6h)
    lossless = jpeg.encode_jpeg_lossless(np.zeros((4, 4, 3), np.uint8), 7)
    yield lambda: jpeg.decode_jpeg(lossless)
    arith = os.path.join(os.path.dirname(__file__), "data", "jpeg_arith", "ycc420_prog_23x17.jpg")
    yield lambda: jpeg.read_jpeg(arith)
    yield lambda: jpeg.encode_jpeg(np.zeros((8, 8), np.uint8), arithmetic=True)


def _rle_bmp():
    """A 2 x 1 RLE8 BMP."""
    info = struct.pack("<IiiHHIIiiII", 40, 2, 1, 1, 8, 1, 4, 0, 0, 2, 2)
    return (b"BM" + struct.pack("<IHHI", 66, 0, 0, 62) + info
            + bytes([1, 2, 3, 0, 4, 5, 6, 0]) + bytes([2, 1, 0, 1]))


def test_no_compiler_raises_not_falls_back(tmp_path, monkeypatch, fresh_library):
    """With no g++ to be found, each public entry point raises (the JPEG,
    PNG, resize, LZW, PackBits, RLE, FLI, FTEX, DDS (BC6H too), BLP,
    lossless JPEG and arithmetic-coded JPEG ones, its QM encoder too); none
    falls back to its plain version."""
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    for call in _every_entry_point(tmp_path):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch,
                                                      fresh_library):
    """A source g++ refuses: the error carries g++'s own message."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "image.cpp").write_text("int gm_jpeg_scan( { this is not C++ }\n")
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    for call in _every_entry_point(tmp_path):
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for image.*error"):
            call()
