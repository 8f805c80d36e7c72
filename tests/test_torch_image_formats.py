"""The port's image readers on the forms the JAX reader opens through PIL,
on the CPU: progressive JPEGs (`io/jpeg.py`, the C++ scan decoder and its
plain version) against PIL 12 bit for bit, and each progression libjpeg
refuses, or only warns about, raising with its cause; `write_jpeg(...,
progressive=True)` decoded by PIL to the bytes of the baseline file of
the same image; BMP (`io/bmp.py`) and TIFF (`io/tiff.py`) against PIL's
`np.asarray` (palettes against `convert("RGB")`, fault B15) and the
forms they refuse; gray + alpha images in `_load_image` against the JAX
reader on PIL's RGBA conversion of the same file (fault A2); and a COLMAP
scene of a progressive JPEG, a BMP, a Deflate TIFF and a PNG through
`read_scene` against the JAX reader and into `cli.train_mesh`.

Fixtures are written by PIL to a path (PIL's progressive encoder cannot
suspend into a `BytesIO`), with PIL's encoder buffer raised so that it
writes quality-100 progressive files too."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import bmp, gif, jpeg, lzw, png, tiff
from tests.test_torch_image_native import _same
from tests.test_torch_jpeg import _image
from tests.test_torch_readers import _assert_scene_equal

torch.set_num_threads(2)

SIZES = [(1, 1), (17, 9), (131, 257), (257, 131)]          # (width, height)
SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0", "gray"]


@pytest.fixture(autouse=True)
def _pil_buffer(monkeypatch):
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 24)


# ------------------------------------------------------- progressive JPEG
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", SUBSAMPLING)
def test_progressive_jpeg_equals_pil(tmp_path, size, sampling):
    """PIL's progressive files (libjpeg's `jpeg_simple_progression`: DC first
    and refinement, AC first and refinement with EOB runs) at qualities 50 /
    90 / 100, plain, with optimized tables, and with restart intervals of 3
    blocks and of one MCU row (each restart resets the EOB run): the C++
    decoder, the plain one and PIL give the same bytes."""
    gray = sampling == "gray"
    img = _image(*size, 1 if gray else 3, seed=size[0] * size[1])
    path = str(tmp_path / "p.jpg")
    for quality in (50, 90, 100):
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 3},
                      {"restart_marker_rows": 1}):
            kw = dict(quality=quality, progressive=True, **extra)
            if not gray:
                kw["subsampling"] = sampling
            Image.fromarray(img).save(path, "JPEG", **kw)
            assert open(path, "rb").read().find(b"\xff\xc2") > 0
            _same(path)


def test_progressive_smooth_image_long_eob_runs(tmp_path):
    """A smooth 512x384 image: most blocks' AC bands are zero, so EOB runs
    span many blocks, cut at every restart interval of 5 blocks and of an MCU
    row; 4:2:0 and gray."""
    y, x = np.mgrid[0:384, 0:512]
    img = np.stack([128 + 60 * np.sin(x / 90.0 + k) * np.cos(y / 70.0) for k in range(3)],
                   -1).astype(np.uint8)
    path = str(tmp_path / "s.jpg")
    for extra in ({}, {"restart_marker_blocks": 5}, {"restart_marker_rows": 1}):
        Image.fromarray(img).save(path, quality=75, progressive=True, **extra)
        _same(path)
        Image.fromarray(img[..., 1]).save(path, quality=75, progressive=True, **extra)
        _same(path)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "gray"])
def test_progressive_writer_decodes_to_the_baseline(tmp_path, sampling):
    """`write_jpeg(progressive=True)` writes the baseline file's quantised
    coefficients in `jpeg_simple_progression`'s scans, each with its own
    optimal Huffman tables and EOB runs: PIL decodes it to the bytes of
    `write_jpeg`'s baseline file of the same image, and so do the port's two
    decoders. Sizes 1x1 to 257x131 at qualities 50 / 90 / 100, a sparse
    image (long zero runs: ZRLs in the refinements) and a flat one wider
    than 2^15 - 1 blocks (EOB runs cut at their limit)."""
    c = 1 if sampling == "gray" else 3
    sub = "4:2:0" if sampling == "gray" else sampling
    rng = np.random.default_rng(7)
    sparse = np.full((64, 80, c), 128, np.uint8)
    at = rng.integers(0, [64, 80], (60, 2))
    sparse[at[:, 0], at[:, 1]] = rng.integers(0, 256, (60, c))
    images = [_image(w, h, c, seed=w + h) for w, h in SIZES] + [
        sparse[..., 0] if c == 1 else sparse,
        np.full((1104, 2048) + ((3,) if c == 3 else ()), 90, np.uint8)]     # 35,328 blocks
    base, prog = str(tmp_path / "b.jpg"), str(tmp_path / "p.jpg")
    for i, img in enumerate(images):
        quality = (50, 90, 100)[i % 3]
        jpeg.write_jpeg(base, img, quality=quality, subsampling=sub)
        jpeg.write_jpeg(prog, img, quality=quality, subsampling=sub, progressive=True)
        data = open(prog, "rb").read()
        assert data.count(b"\xff\xda") == (10 if c == 3 else 6) and b"\xff\xc2" in data
        want = np.asarray(Image.open(base))
        assert np.array_equal(_same(prog), want), (i, quality)


def _jpeg_parts(data: bytes):
    """A JPEG -> [(marker, body, entropy-coded bytes after it)] from its SOI
    to its EOI."""
    parts, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        body, pos = data[pos + 4:pos + 2 + n], pos + 2 + n
        end = pos
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in
                       (0x00, 0xD0, 0xD1, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7)):
                end += 1
        parts.append((marker, body, data[pos:end]))
        pos = end
    return parts


def _jpeg_join(parts) -> bytes:
    return b"\xff\xd8" + b"".join(struct.pack(">BBH", 0xFF, m, len(b) + 2) + b + e
                                  for m, b, e in parts) + b"\xff\xd9"


def _sos(body: bytes, comps=None, ss=None, se=None, ah=None, al=None) -> bytes:
    """An SOS body with its component list or scan parameters replaced."""
    ns = body[0]
    old = [body[1 + 2 * i:3 + 2 * i] for i in range(ns)]
    s0, e0, a = body[1 + 2 * ns:4 + 2 * ns]
    comps = old if comps is None else comps
    return (bytes([len(comps)]) + b"".join(comps) + bytes([
        s0 if ss is None else ss, e0 if se is None else se,
        ((a >> 4) if ah is None else ah) << 4 | ((a & 15) if al is None else al)]))


def _progressive_file(tmp_path, gray=False):
    img = _image(40, 24, 1 if gray else 3, seed=2)
    path = str(tmp_path / "p.jpg")
    Image.fromarray(img).save(path, "JPEG", quality=85, progressive=True)
    return path, _jpeg_parts(open(path, "rb").read())


def _scans(parts):
    return [i for i, (m, _, _) in enumerate(parts) if m == 0xDA]


def _edit(parts, index, **kw):
    m, body, ent = parts[index]
    out = list(parts)
    out[index] = (m, _sos(body, **kw), ent)
    return out


# each crafted from PIL's 10-scan file: (the edit, the error's words)
_BAD = {
    # JERR_BAD_PROGRESSION: start_pass_phuff_decoder's checks
    "dc_scan_past_0": (lambda p, s: _edit(p, s[0], se=5), "a DC scan must end at 0"),
    "ac_ss_after_se": (lambda p, s: _edit(p, s[1], ss=6, se=5), "1 <= Ss <= Se <= 63"),
    "ac_se_64": (lambda p, s: _edit(p, s[2], se=64), "1 <= Ss <= Se <= 63"),
    "ac_two_components": (lambda p, s: _edit(p, s[1], comps=[b"\x01\x00", b"\x02\x00"]),
                          "one component, not 2"),
    "al_not_ah_minus_1": (lambda p, s: _edit(p, s[5], al=0), "Al = Ah - 1"),
    "al_over_13": (lambda p, s: _edit(p, s[0], al=14), "Al over 13"),
    # JWRN_BOGUS_PROGRESSION, which libjpeg only warns about
    "ac_before_dc": (lambda p, s: [p[i] for i in range(len(p)) if i != s[0]],
                     "before its DC scan"),
    "refinement_skips_a_bit": (lambda p, s: _edit(p, s[6], ah=2, al=1),
                               "refined from Ah 2 where 1 bits are known"),
    "first_scan_twice": (lambda p, s: p[:s[1] + 1] + [p[s[1]]] + p[s[1] + 1:],
                         "refined from Ah 0 where 2 bits are known"),
    # the last three scans (the AC refinements to bit 0) dropped
    "unrefined": (lambda p, s: p[:s[-3]], "coefficients left unrefined; libjpeg would "
                                          "smooth them"),
}


@pytest.mark.parametrize("kind", list(_BAD))
def test_bad_progressions_raise_with_their_cause(tmp_path, kind):
    """Each scan parameter libjpeg refuses (JERR_BAD_PROGRESSION), each order
    it only warns about (JWRN_BOGUS_PROGRESSION) and a file whose last scans
    are missing (libjpeg-turbo would smooth the blocks) raise a ValueError
    naming the cause, through the C++ path and the plain one alike; PIL
    opens the warned and unrefined files."""
    path, parts = _progressive_file(tmp_path)
    edit, words = _BAD[kind]
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as fh:
        fh.write(_jpeg_join(edit(parts, _scans(parts))))
    if kind in ("ac_before_dc", "refinement_skips_a_bit", "unrefined"):
        np.asarray(Image.open(bad))
    for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
        with pytest.raises(ValueError, match=words):
            read(bad)


def test_unrefined_dc_alone_decodes_as_libjpeg(tmp_path):
    """A file whose AC bands are all sent in full but whose DC lacks its last
    bit: libjpeg-turbo does not smooth it (only coefficients 1-9 count), and
    neither decoder raises: PIL's bytes."""
    path, parts = _progressive_file(tmp_path, gray=True)
    scans = _scans(parts)
    # gray script: DC (0,0,0,1), AC (1,5,0,2) (6,63,0,2) (1,63,2,1), DC (0,0,1,0),
    # AC (1,63,1,0): drop the DC refinement
    kept = [p for i, p in enumerate(parts) if i != scans[4]]
    bad = str(tmp_path / "dc.jpg")
    with open(bad, "wb") as fh:
        fh.write(_jpeg_join(kept))
    _same(bad)


def test_truncated_inside_an_ac_refinement_raises(tmp_path):
    """A file cut inside its last scan (an AC refinement), EOI appended:
    "truncated" through both decoders."""
    path, parts = _progressive_file(tmp_path)
    m, body, ent = parts[-1]
    assert body[-1] == 0x10 and body[-3:-1] == b"\x01\x3f"
    cut = str(tmp_path / "cut.jpg")
    with open(cut, "wb") as fh:
        fh.write(_jpeg_join(parts[:-1] + [(m, body, ent[:len(ent) // 3])]))
    for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
        with pytest.raises(ValueError, match="truncated"):
            read(cut)


def test_refinement_coefficient_of_size_2_raises(tmp_path):
    """An AC refinement whose Huffman table codes a new coefficient of size
    2 (the symbol 0x01 of the last scan's DHT changed to 0x02; libjpeg warns,
    JWRN_HUFF_BAD_CODE): both decoders raise."""
    path, parts = _progressive_file(tmp_path)
    i = max(j for j, (m, _, _) in enumerate(parts) if m == 0xC4)
    m, body, ent = parts[i]
    assert body[0] >> 4 == 1                        # an AC table
    n = sum(body[1:17])
    vals = bytearray(body[17:17 + n])
    vals[vals.index(0x01)] = 0x02
    out = list(parts)
    out[i] = (m, body[:17] + bytes(vals) + body[17 + n:], ent)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as fh:
        fh.write(_jpeg_join(out))
    for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
        with pytest.raises(ValueError, match="not of size 1"):
            read(bad)


# -------------------------------------------------------------------- BMP
def _bmp(px_rows, width, height, bits, header=40, compression=0, masks=None,
         palette=b"", top_down=False, colors=0, offset=None):
    """A BMP from its stored rows (bottom-up unless `top_down`), unpadded;
    for RLE (`compression` 1 or 2), the rows are the RLE data as it is."""
    stride = ((width * bits + 31) >> 3) & ~3
    data = b"".join(r if compression in (1, 2) else r[:stride] + bytes(max(0, stride - len(r)))
                    for r in px_rows)
    info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height,
                       1, bits, compression, len(data), 2835, 2835, colors, colors)
    tail = b""
    if masks is not None and header >= 52:
        info += struct.pack("<III", *masks[:3]) + (
            struct.pack("<I", masks[3]) if header >= 56 else b"")
    elif masks is not None:
        tail = struct.pack("<III", *masks[:3])
    info += bytes(header - len(info))
    off = 14 + len(info) + len(tail) + len(palette) if offset is None else offset
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + tail
            + palette + data)


def _rows(img, order, top_down=False):
    """(H, W, C) RGB(A) -> the BMP's rows of bytes in `order` (e.g. "BGRX")."""
    src = {"R": 0, "G": 1, "B": 2, "A": 3}
    px = np.stack([img[..., src[ch]] if ch in src else np.full(img.shape[:2], 7, np.uint8)
                   for ch in order], -1)
    rows = [r.tobytes() for r in px]
    return rows if top_down else rows[::-1]


def _check_bmp(path, data, want=None, rgb=False):
    """`data` written to `path` reads as PIL's array (`rgb`: its
    `convert("RGB")`), or as `want`."""
    with open(path, "wb") as fh:
        fh.write(data)
    got = png.read_image(path)
    if want is None:
        want = np.asarray(Image.open(path).convert("RGB") if rgb else Image.open(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("width", [1, 5, 13])
def test_bmp_equals_pil(tmp_path, width):
    """PIL's own BMPs (RGB 24-bit, RGBA as 32-bit BI_RGB, which PIL reads back
    as RGB, L as an 8-bit gray ramp, P as a palette) and hand-made ones:
    top-down rows, 32-bit BI_BITFIELDS with an alpha mask in 108- and
    124-byte headers and without one after a 40-byte header, 24-bit
    BI_BITFIELDS, a 52-byte header; each equal to PIL's `np.asarray`, a
    palette to PIL's `convert("RGB")` (fault B15: the JAX reader takes the
    indices). Widths 1, 5 and 13 pad every row."""
    rng = np.random.default_rng(width)
    h = 7
    rgba = rng.integers(0, 256, (h, width, 4), dtype=np.uint8)
    path = str(tmp_path / "x.bmp")
    for mode in ("RGB", "RGBA", "L"):
        im = Image.fromarray(rgba if mode == "RGBA" else rgba[..., 0] if mode == "L"
                             else rgba[..., :3], mode)
        im.save(path)
        _check_bmp(path, open(path, "rb").read())
    Image.fromarray(rgba[..., :3]).quantize(17).save(path)
    assert Image.open(path).mode == "P"
    _check_bmp(path, open(path, "rb").read(), rgb=True)
    assert png.read_image(path).ndim == 3
    rgb = rgba[..., :3]
    cases = [
        (_bmp(_rows(rgb, "BGR", True), width, h, 24, top_down=True), "RGB"),
        (_bmp(_rows(rgba, "BGRA"), width, h, 32, header=108, compression=3,
              masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)), "RGBA"),
        (_bmp(_rows(rgba, "RGBA", True), width, h, 32, header=124, compression=3,
              masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), top_down=True), "RGBA"),
        (_bmp(_rows(rgba, "XBGR"), width, h, 32, compression=3,
              masks=(0xFF000000, 0xFF0000, 0xFF00, 0)), "RGB"),
        (_bmp(_rows(rgb, "BGR"), width, h, 24, compression=3,
              masks=(0xFF0000, 0xFF00, 0xFF)), "RGB"),
        (_bmp(_rows(rgb, "BGRX"), width, h, 32, header=52), "RGB"),
        (_bmp(_rows(rgba, "BGRA"), width, h, 32, header=108, compression=3,
              masks=(0, 0, 0, 0)), "RGBA"),                 # PIL's BGRA
    ]
    for data, mode in cases:
        with open(path, "wb") as fh:
            fh.write(data)
        assert Image.open(path).mode == mode
        _check_bmp(path, data)


def test_bmp_palettes_gray_and_colour(tmp_path):
    """An 8-bit palette of 200 entries that is the gray ramp (PIL: mode L, the
    indices), one of gray entries out of ramp order and one of colours
    (PIL: mode P; the port expands both as `convert("RGB")`), top-down, and
    with the data offset pointing at the palette (PIL skips it)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 200, (6, 11), dtype=np.uint8)
    rows = [r.tobytes() for r in idx[::-1]]
    ramp = b"".join(bytes([i, i, i, 0]) for i in range(200))
    shuffled = b"".join(bytes([v, v, v, 0]) for v in rng.permutation(200).astype(np.uint8))
    colour = rng.integers(0, 256, (200, 4), dtype=np.uint8).tobytes()
    path = str(tmp_path / "p.bmp")
    _check_bmp(path, _bmp(rows, 11, 6, 8, palette=ramp, colors=200))
    assert Image.open(path).mode == "L"
    for pal in (shuffled, colour):
        for kw in ({}, {"offset": 54}):
            _check_bmp(path, _bmp(rows, 11, 6, 8, palette=pal, colors=200, **kw), rgb=True)
            assert Image.open(path).mode == "P"
        want = png.read_image(path)
        _check_bmp(path, _bmp(rows[::-1], 11, 6, 8, palette=pal, colors=200,
                              top_down=True), rgb=True)
        assert np.array_equal(png.read_image(path), want)


@pytest.mark.parametrize("kind", ["rle8", "rle4", "1-bit", "4-bit", "16-bit"])
def test_bmp_forms_once_refused_equal_pil(tmp_path, kind):
    """RLE8 and RLE4 (with ends of line that leave pixels at index 0), 1-bit
    (black and white: PIL's mode 1 as `convert("L")`, 0 and 255, fault B16;
    and a colour pair), 4-bit and 16-bit (BI_RGB 5-5-5) BMPs, which the
    readers once refused: equal to PIL's arrays (palettes to
    `convert("RGB")`, fault B15)."""
    path = str(tmp_path / "x.bmp")
    rng = np.random.default_rng(len(kind))
    pal = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    pal[:, 3] = 0
    if kind == "rle8":
        data = _bmp([bytes([3, 7, 0, 3, 1, 2, 9, 0, 0, 0, 5, 4, 0, 0, 8, 1])], 8, 2, 8,
                    compression=1, palette=pal.tobytes())
    elif kind == "rle4":
        data = _bmp([bytes([3, 0x7A, 0, 4, 0x12, 0x34, 0, 0, 6, 0x45, 0, 0])], 7, 2, 4,
                    compression=2, palette=pal[:16].tobytes())
    elif kind == "1-bit":
        Image.fromarray(rng.uniform(size=(4, 9)) < 0.5).save(path)
        assert Image.open(path).mode == "1"
        _check_bmp(path, open(path, "rb").read(),
                   want=np.asarray(Image.open(path).convert("L")))
        data = _bmp([bytes([0b10110101, 0b10000000])] * 3, 9, 3, 1, palette=pal[:2].tobytes())
    elif kind == "4-bit":
        data = _bmp([bytes([0x12, 0x3F, 0xA0])] * 2, 5, 2, 4, palette=pal[:16].tobytes())
    else:
        data = _bmp([rng.integers(0, 256, 8, dtype=np.uint8).tobytes()] * 2, 4, 2, 16)
    with open(path, "wb") as fh:
        fh.write(data)
    mode = Image.open(path).mode
    assert mode == ("RGB" if kind == "16-bit" else "P")
    _check_bmp(path, data, rgb=mode == "P")


@pytest.mark.parametrize("kind", ["masks", "os2", "truncated", "rle_ends_early",
                                  "gray_ramp_4_bit", "jpeg"])
def test_bmp_refused_forms_raise(tmp_path, kind):
    """Masks PIL does not read, an OS/2 header, a file cut short, RLE data
    that ends before the bitmap is full (PIL: "not enough image data"), a
    4-bit gray-ramp palette (which PIL unpacks as 8-bit pixels) and JPEG
    compression raise a ValueError naming the cause."""
    path = str(tmp_path / "x.bmp")
    row = [bytes(8)] * 2
    ramp = b"".join(bytes([i, i, i, 0]) for i in range(16))
    data, words = {
        "masks": (_bmp(row, 2, 2, 32, compression=3, masks=(0xFF00, 0xFF, 0xFF0000)),
                  "bit-field masks"),
        "os2": (b"BM" + struct.pack("<IHHI", 40, 0, 0, 26) + struct.pack("<IHHHH", 12, 2, 2,
                                                                        1, 24) + bytes(14),
                "OS/2"),
        "truncated": (_bmp([bytes(12)] * 4, 4, 4, 24)[:-20], "truncated"),
        "rle_ends_early": (_bmp([bytes([4, 1, 0, 1])], 4, 2, 8, compression=1,
                                palette=bytes(1024)), "ends after 4 of 8 pixels"),
        "gray_ramp_4_bit": (_bmp(row, 8, 2, 4, palette=ramp), "reads as 8-bit"),
        "jpeg": (_bmp(row, 2, 2, 24, compression=4), "JPEG-compressed"),
    }[kind]
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(ValueError, match=words):
        png.read_image(path)


# ------------------------------------------------------------------- TIFF
def _packbits_literal(raw):
    """PackBits of literal packets of up to 128 bytes (valid, if not small)."""
    return b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128]
                    for i in range(0, len(raw), 128))


def _tiff(img, order="<", compression=1, predictor=1, rows_per_strip=None,
          photometric=None, extra=None, cmap=None, more=()):
    """A TIFF of uint8 or uint16 samples (H, W) or (H, W, C), written here in
    either byte order: strips of `rows_per_strip` rows, each compressed after
    horizontal differencing for predictor 2 (where libtiff applies it): by zlib for Deflate, by the
    port's plain LZW encoder for LZW (5), as literal packets for PackBits
    (32773)."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, c = img.shape
    bits = 16 if img.dtype == np.uint16 else 8
    rps = rows_per_strip or h
    strips = []
    for y in range(0, h, rps):
        s = img[y:y + rps].astype(np.int32)
        if predictor == 2 and compression not in (1, 32773):
            s = np.diff(s, axis=1, prepend=0)
        s = (s % (1 << bits)).astype(f"{order}u{bits // 8}").tobytes()
        strips.append(s if compression == 1 else lzw.lzw_encode_plain(s)
                      if compression == 5 else _packbits_literal(s)
                      if compression == 32773 else zlib.compress(s))
    photometric = (1 if c <= 2 else 2) if photometric is None else photometric
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [compression]),
            (262, 3, [photometric]), (277, 3, [c]), (278, 4, [rps]),
            (273, 4, [0] * len(strips)), (279, 4, [len(s) for s in strips])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if extra is not None:
        tags.append((338, 3, list(extra)))
    if cmap is not None:
        tags.append((320, 3, list(cmap)))
    tags = sorted(tags + list(more))
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", 8)
    ifd_len = 2 + 12 * len(tags) + 4
    blobs, at = b"", 8 + ifd_len
    values = {}
    for tag, typ, vals in tags:
        size = {3: 2, 4: 4}[typ] * len(vals)
        if size > 4:
            values[tag] = at + len(blobs)
            blobs += b"\x00" * size
    data_at = at + len(blobs)
    offs = np.cumsum([0] + [len(s) for s in strips])[:-1] + data_at
    entries, blob = b"", bytearray(blobs)
    for tag, typ, vals in tags:
        vals = [int(v) for v in (offs if tag == 273 else vals)]
        packed = struct.pack(order + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if tag in values:
            blob[values[tag] - at:values[tag] - at + len(packed)] = packed
            field = struct.pack(order + "I", values[tag])
        else:
            field = packed + bytes(4 - len(packed))
        entries += struct.pack(order + "HHI", tag, typ, len(vals)) + field
    return (head + struct.pack(order + "H", len(tags)) + entries + b"\x00" * 4
            + bytes(blob) + b"".join(strips))


def _check_tiff(path, data, want=None):
    with open(path, "wb") as fh:
        fh.write(data)
    got = png.read_image(path)
    want = np.asarray(Image.open(path)) if want is None else want
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("compression", [1, 8, 32946])
@pytest.mark.parametrize("order", ["<", ">"])
def test_tiff_equals_pil(tmp_path, compression, order):
    """Hand-made TIFFs in both byte orders, one strip and strips of 3 rows,
    with predictor 1 and 2: gray, white-is-zero gray (PIL inverts it), gray +
    alpha, RGB, RGBA with and without ExtraSamples 2, RGB with an unspecified
    extra sample (dropped) and an 8-bit palette (expanded as PIL's
    `convert("RGB")`, fault B15), each equal to PIL's `np.asarray`.
    libtiff ignores the predictor of an uncompressed file, and so does the
    port."""
    rng = np.random.default_rng(compression)
    h, w = 11, 7
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    cmap = rng.integers(0, 65536, 768)
    path = str(tmp_path / "x.tif")
    for predictor in (1, 2):
        for rps in (None, 3):
            kw = dict(order=order, compression=compression, predictor=predictor,
                      rows_per_strip=rps)
            cases = [
                (_tiff(px[..., 0], **kw), "L"),
                (_tiff(px[..., 0], photometric=0, **kw), "L"),
                (_tiff(px[..., :2], extra=[2], **kw), "LA"),
                (_tiff(px[..., :3], **kw), "RGB"),
                (_tiff(px, extra=[2], **kw), "RGBA"),
                (_tiff(px, **kw), "RGBA"),
                (_tiff(px, extra=[0], **kw), "RGB"),
            ]
            for data, mode in cases:
                with open(path, "wb") as fh:
                    fh.write(data)
                assert Image.open(path).mode == mode
                _check_tiff(path, data)
            data = _tiff(px[..., 0], photometric=3, cmap=cmap, **kw)
            with open(path, "wb") as fh:
                fh.write(data)
            assert Image.open(path).mode == "P"
            _check_tiff(path, data, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_pil_written_tiffs(tmp_path, mode):
    """PIL's own TIFFs (uncompressed, and Deflate through libtiff, with
    predictor 2 and in strips of 2 rows): equal to PIL's `np.asarray`, a
    palette to `convert("RGB")`."""
    rng = np.random.default_rng(len(mode))
    img = rng.integers(0, 256, (9, 10, 4), dtype=np.uint8)
    if mode == "L":
        im = Image.fromarray(img[..., 0])
    elif mode == "P":
        im = Image.fromarray(img[..., :3]).quantize(12)
    else:
        im = Image.fromarray(img[..., :len(mode)], mode)
    path = str(tmp_path / "x.tif")
    for kw in ({}, {"compression": "tiff_adobe_deflate"},
               {"compression": "tiff_deflate", "tiffinfo": {317: 2, 278: 2}}):
        im.save(path, **kw)
        opened = Image.open(path)
        want = np.asarray(opened.convert("RGB") if mode == "P" else opened)
        _check_tiff(path, open(path, "rb").read(), want)


@pytest.mark.parametrize("kind", ["lzw", "packbits", "16-bit"])
def test_tiff_forms_once_refused_equal_pil(tmp_path, kind):
    """LZW and PackBits TIFFs that PIL writes through libtiff, and PIL's
    16-bit gray TIFF (mode I;16, which the JAX reader divides by 255: fault
    B7; the port keeps the high byte of PIL's values), which the readers once
    refused."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    path = str(tmp_path / "x.tif")
    if kind == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(path)
        assert Image.open(path).mode == "I;16"
        want = (np.asarray(Image.open(path)) >> 8).astype(np.uint8)
    else:
        Image.fromarray(img).save(path, compression={"lzw": "tiff_lzw",
                                                     "packbits": "packbits"}[kind])
        want = np.asarray(Image.open(path))
    _check_tiff(path, open(path, "rb").read(), want)


@pytest.mark.parametrize("kind", ["old_style_lzw", "ccitt", "webp_in_tiff", "12-bit",
                                  "old_style_jpeg", "planar_jpeg", "associated",
                                  "float_predictor", "fill_order", "ycbcr_uncompressed",
                                  "truncated", "bigtiff"])
def test_tiff_refused_forms_raise(tmp_path, kind):
    """libtiff's old-style LZW (LSB first), CCITT and WebP compression,
    12-bit samples, old-style JPEG (6), planar JPEG-compressed data,
    associated alpha, the floating-point predictor, FillOrder 2, YCbCr that
    is not JPEG-compressed (subsampled samples), a strip cut short and
    BigTIFF raise a ValueError naming the cause, through the C++ and the
    plain route. (Tiled, planar, JPEG and CMYK TIFFs are read:
    tests/test_torch_tiff_layouts.py; Zstandard ones:
    tests/test_torch_tiff_zstd.py.)"""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    path = str(tmp_path / "x.tif")
    words = {"old_style_lzw": "old-style LZW", "ccitt": "CCITT", "webp_in_tiff": "WebP",
             "12-bit": "12", "old_style_jpeg": "old-style JPEG",
             "planar_jpeg": "planar JPEG", "associated": "associated",
             "float_predictor": "predictor 3", "fill_order": "FillOrder",
             "ycbcr_uncompressed": "YCbCr", "truncated": "truncated",
             "bigtiff": "BigTIFF"}[kind]
    if kind == "ccitt":
        Image.fromarray(img[..., 0] > 128).save(path, compression="group4")
    else:
        data = {
            "old_style_lzw": lambda: _tiff(img, compression=5, more=[]).replace(
                lzw.lzw_encode_plain(img.tobytes()),
                lzw.lzw_encode_plain(img.tobytes(), "gif", 8)),
            "12-bit": lambda: _tiff(img[..., 0], more=[]).replace(
                struct.pack("<HHIHH", 258, 3, 1, 8, 0), struct.pack("<HHIHH", 258, 3, 1, 12, 0)),
            "webp_in_tiff": lambda: _tiff(img, compression=50001),
            "old_style_jpeg": lambda: _tiff(img, compression=6),
            "planar_jpeg": lambda: _tiff(img, compression=7, more=[(284, 3, [2])]),
            "associated": lambda: _tiff(np.concatenate([img, img[..., :1]], -1), extra=[1]),
            "float_predictor": lambda: _tiff(img, compression=8, predictor=3),
            "fill_order": lambda: _tiff(img, more=[(266, 3, [2])]),
            "ycbcr_uncompressed": lambda: _tiff(img, photometric=6, more=[(530, 3, [2, 2])]),
            "truncated": lambda: _tiff(img)[:-30],
            "bigtiff": lambda: b"II+\x00" + bytes(12),
        }[kind]()
        with open(path, "wb") as fh:
            fh.write(data)
    for read in (png.read_image, lambda p: tiff.decode_tiff_plain(open(p, "rb").read(), p)):
        with pytest.raises(ValueError, match=words):
            read(path)
    with pytest.raises(ValueError, match=words):
        png.read_image(path)


def test_read_image_dispatch_and_other_formats(tmp_path):
    """`read_image` goes by the first bytes, whatever the file's name: BMP,
    TIFF, PNG, GIF (PIL's, a palette: `convert("RGB")`), lossy WebP (PIL's
    `convert("RGB")`) and lossless WebP (exactly the image written; it
    raised naming VP8L before the port read it)."""
    img = np.random.default_rng(0).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    for fmt in ("BMP", "TIFF", "PNG"):
        path = str(tmp_path / f"{fmt}.jpg")
        Image.fromarray(img).save(path, fmt)
        assert np.array_equal(png.read_image(path), img)
    path = str(tmp_path / "gif.jpg")
    Image.fromarray(img).save(path, "GIF")
    assert np.array_equal(png.read_image(path), np.asarray(Image.open(path).convert("RGB")))
    webp = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(webp, "WEBP", quality=80)
    assert np.array_equal(png.read_image(webp), np.asarray(Image.open(webp).convert("RGB")))
    Image.fromarray(img).save(webp, "WEBP", lossless=True)
    assert np.array_equal(png.read_image(webp), img)
    assert np.array_equal(png.read_image(webp), np.asarray(Image.open(webp)))


# ---------------------------------------------------------- gray + alpha
@pytest.mark.parametrize("resolution", [1, 2])
@pytest.mark.parametrize("with_bg", [False, True])
def test_gray_alpha_loads_as_pil_rgba(tmp_path, resolution, with_bg):
    """An 8-bit LA PNG in `_load_image` (fault A2): gray in R, G and B, the
    alpha a mask, composited over `bg` where there is one; against the JAX
    `_load_image` of PIL's `Image.open(p).resize(size).convert("RGBA")`
    written as an RGBA PNG: images and masks equal. An LA mask file keeps its
    first channel."""
    rng = np.random.default_rng(resolution + 2 * with_bg)
    la = rng.integers(0, 256, (26, 34, 2), dtype=np.uint8)
    la[..., 1] = np.where(rng.uniform(size=(26, 34)) < 0.3, 255, la[..., 1])
    path, oracle = str(tmp_path / "la.png"), str(tmp_path / "rgba.png")
    Image.fromarray(la, "LA").save(path)
    size = (34 // resolution, 26 // resolution)
    im = Image.open(path)
    (im.resize(size) if size != im.size else im).convert("RGBA").save(oracle)
    bg = np.array([1.0, 0.5, 0.0]) if with_bg else None
    got_img, got_mask = readers._load_image(path, resolution, bg)
    want_img, want_mask = jreaders._load_image(oracle, 1, bg)
    assert got_img.dtype == want_img.dtype and np.array_equal(got_img, want_img)
    assert got_mask.dtype == want_mask.dtype and np.array_equal(got_mask, want_mask)
    assert got_img.shape == (3, size[1], size[0])
    _, m = readers._load_image(oracle, 1, None, mask_path=path if resolution == 1 else None)
    if resolution == 1:
        assert np.array_equal(m[0], la[..., 0].astype(np.float32) / 255.0)


# ---------------------------------------------------- a scene of each form
def _mixed_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    nine views rewritten: progressive JPEGs (PIL, quality 90), BMPs, Deflate
    TIFFs with predictor 2 (PIL through libtiff), PNGs, in turn. -> proxy."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = Image.fromarray(jpeg.read_jpeg(path))
        kind = i % 4
        if kind == 0:
            img.save(path, "JPEG", quality=90, progressive=True)
        elif kind == 1:
            img.save(path, "BMP")
        elif kind == 2:
            img.save(path, "TIFF", compression="tiff_adobe_deflate", tiffinfo={317: 2})
        else:
            img.save(path, "PNG")
    return mesh


def test_mixed_colmap_scene_matches_jax_and_trains(tmp_path):
    """`read_scene` on one COLMAP set of progressive JPEG, BMP, Deflate TIFF
    and PNG views equals the JAX reader's (images exactly, cameras as
    `tests/test_torch_readers.py` compares them) at -r 1 and 2, and
    `cli.train_mesh --device cpu` trains 2 iterations on it."""
    root = str(tmp_path / "s")
    mesh = _mixed_scene(root)
    for resolution in (1, 2):
        kw = dict(resolution=resolution, eval_split=True)
        _assert_scene_equal(readers.read_scene(root, **kw), jreaders.read_scene(root, **kw))
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
