"""Tiled, planar, JPEG-compressed and LZMA TIFFs in the port's readers
(`io/tiff.py`, the JPEG streams through `io/jpeg.py::decode_jpeg`) against
PIL 12.1 (libtiff 4.7, libjpeg-turbo) on the CPU: each form equal to
`np.asarray(Image.open(p))` byte for byte, the C++ route (`decode_tiff`) equal
to the plain one (`decode_tiff_plain`); edge tiles of 1 pixel, odd sizes,
both byte orders, 8 and 16 bits, `Predictor` 2 inside tiles; libtiff's
rules for JPEG strips and tiles (`JPEGTables`, the last strip's frame,
the sampling factors against `YCbCrSubsampling`); damaged tables and cut
files raising through both routes; the fixtures of `tests/data/tiff/`;
and a COLMAP scene mixing the new forms through `read_scene` against the
JAX reader and into `cli.train_mesh`."""

from __future__ import annotations

import importlib.util
import io
import json
import os
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, png, tiff
from tests.test_torch_readers import _assert_scene_equal

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "tiff")
_spec = importlib.util.spec_from_file_location(
    "make_tiff_fixtures_torch", os.path.join(ROOT, "tools", "make_tiff_fixtures_torch.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

COMPRESSIONS = ["none", "lzw", "packbits", "deflate", "lzma"]


def _both(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The C++ route and the plain one: equal bytes, dtype and shape."""
    got, plain = tiff.decode_tiff(data, path), tiff.decode_tiff_plain(data, path)
    assert got.dtype == plain.dtype == np.uint8 and got.shape == plain.shape
    assert np.array_equal(got, plain), np.abs(got.astype(int) - plain).max()
    return got


def _pil(tmp_path, data: bytes, convert: bool = False) -> np.ndarray:
    path = str(tmp_path / "pil.tif")
    with open(path, "wb") as fh:
        fh.write(data)
    im = Image.open(path)
    return np.asarray(im.convert("RGB") if convert else im)


def _check(tmp_path, data: bytes, want=None, convert=False) -> np.ndarray:
    """read_image and the plain route equal PIL's array (or `want`)."""
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as fh:
        fh.write(data)
    want = _pil(tmp_path, data, convert) if want is None else want
    got = _both(data, path)
    assert np.array_equal(png.read_image(path), got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()
    return got


def _samples(img):
    """An 8-bit image -> a 16-bit one whose high bytes are it, low bytes seeded."""
    low = np.random.default_rng(img.size).integers(0, 256, img.shape)
    return img.astype(np.uint16) * 256 + low.astype(np.uint16)


# ------------------------------------------------------------------ tiles
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_tiled_tiffs_equal_pil(tmp_path, compression, depth):
    """Tiles of 16x16 and 32x16 over 33x17 and 16x49 images (edge tiles one
    pixel wide or tall) and a 1x1 image, both byte orders, gray, RGB and RGBA
    (and gray + alpha at 8 bits), `Predictor` 2 where libtiff applies it:
    differenced along each tile's rows from the tile's left edge, which PIL
    (libtiff) undoes to the same bytes."""
    predictors = (1, 2) if compression in ("lzw", "deflate", "lzma") else (1,)
    for w, h, tile in ((33, 17, (16, 16)), (16, 49, (32, 16)), (1, 1, (16, 16))):
        img = fx.natural(h, w, 4, w + h + depth)
        for c in ((1, 2, 3, 4) if depth == 8 else (1, 3, 4)):
            px = img[..., 0] if c == 1 else img[..., :c]
            px = _samples(px) if depth == 16 else px
            want = (px >> 8).astype(np.uint8) if depth == 16 and c == 1 else None
            for predictor in predictors:
                for order in "<>":
                    _check(tmp_path, tiff.encode_tiff(px, compression, predictor, order,
                                                      tile=tile), want)


def _build(tags, chunks, tiled=False) -> bytes:
    """A little-endian TIFF, hand-made: `tags` [(tag, type 3, 4 or 7,
    values)] and the strips' or tiles' bytes, their offsets and byte counts
    added."""
    size = {3: 2, 4: 4, 7: 1}
    code = {3: "H", 4: "I", 7: "B"}
    off_tag, count_tag = (324, 325) if tiled else (273, 279)
    tags = sorted(list(tags) + [(off_tag, 4, [0] * len(chunks)),
                                (count_tag, 4, [len(c) for c in chunks])])
    data_at = 8 + 2 + 12 * len(tags) + 4
    blob_len = sum(size[t] * len(v) for _, t, v in tags if size[t] * len(v) > 4)
    offsets = list(np.cumsum([0] + [len(c) for c in chunks])[:-1] + data_at + blob_len)
    entries, blob = [], b""
    for tag, typ, vals in tags:
        vals = offsets if tag == off_tag else vals
        packed = struct.pack("<" + code[typ] * len(vals), *[int(v) for v in vals])
        if len(packed) > 4:
            field = struct.pack("<I", data_at + len(blob))
            blob += packed
        else:
            field = packed.ljust(4, b"\x00")
        entries.append(struct.pack("<HHI", tag, typ, len(vals)) + field)
    return (b"II*\x00" + struct.pack("<IH", 8, len(tags)) + b"".join(entries) + bytes(4)
            + blob + b"".join(chunks))


def _base_tags(w, h, bits, compression, photometric, more=None):
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, bits), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [len(bits)])}
    tags.update(more or {})
    return [(t, typ, v) for t, (typ, v) in tags.items()]


def test_tile_predictor_runs_from_each_tile_edge(tmp_path):
    """A tile's predictor starts at its own left edge: tiles holding the
    image rows' differences instead decode, in the port and in PIL, to the
    image in the first tile of each row and to other bytes in the second."""
    img = fx.natural(16, 32, 3, 5)
    _check(tmp_path, tiff.encode_tiff(img, "deflate", 2, tile=(16, 16)), img)
    rows = np.diff(img.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    chunks = [zlib.compress(np.ascontiguousarray(rows[:, x:x + 16]).tobytes())
              for x in (0, 16)]
    data = _build(_base_tags(32, 16, [8] * 3, 8, 2, {322: (3, [16]), 323: (3, [16]),
                                                       317: (3, [2])}), chunks, tiled=True)
    got = _check(tmp_path, data)
    assert np.array_equal(got[:, :16], img[:, :16])
    assert not np.array_equal(got[:, 16:], img[:, 16:])


# ------------------------------------------------------------------ planes
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_planar_tiffs_equal_pil(tmp_path, compression, depth):
    """PlanarConfiguration 2 in strips (one strip, strips of 5 rows) and
    tiles, both byte orders, RGB, RGBA and CMYK (PIL's `convert("RGB")`),
    each compression, `Predictor` 2 per plane where libtiff applies it.
    Two forms PIL misreads are held to the samples written instead: gray +
    alpha (PIL's libtiff path gives an alpha of 0, its raw path refuses
    the rawmode) and uncompressed 16-bit planes (PIL's raw path reads each
    plane's bytes as samples)."""
    predictors = (1, 2) if compression in ("lzw", "deflate", "lzma") else (1,)
    img = fx.natural(13, 21, 4, 7)
    for c, cmyk in ((3, False), (4, False), (4, True), (2, False)):
        px = _samples(img[..., :c]) if depth == 16 else img[..., :c]
        if depth == 16 and c == 2:
            continue
        pil_wrong = c == 2 or (depth == 16 and compression == "none")
        for predictor in predictors:
            for layout in ({}, {"rows_per_strip": 5}, {"tile": (16, 16)}):
                for order in "<>":
                    data = tiff.encode_tiff(px, compression, predictor, order, planar=True,
                                            cmyk=cmyk, **layout)
                    if pil_wrong:
                        want = (px >> 8).astype(np.uint8) if depth == 16 else px
                        want = jpeg.cmyk_to_rgb(want) if cmyk else want
                        got = _both(data)
                        assert np.array_equal(got, want)
                        if c == 2 and compression != "none":
                            assert (_pil(tmp_path, data)[..., 1] == 0).all()
                    else:
                        _check(tmp_path, data, convert=cmyk)


# ------------------------------------------------------------------- JPEG
JPEG_KINDS = {
    "gray": dict(channels=1), "rgb": dict(channels=3),
    "ycbcr444": dict(channels=3, ycbcr=True, subsampling="4:4:4"),
    "ycbcr420": dict(channels=3, ycbcr=True, subsampling="4:2:0"),
    "ycbcr422": dict(channels=3, ycbcr=True, subsampling="4:2:2"),
    "ycbcr440": dict(channels=3, ycbcr=True, subsampling="4:4:0"),
    "cmyk": dict(channels=4, cmyk=True),
}


@pytest.mark.parametrize("kind", list(JPEG_KINDS))
def test_jpeg_tiffs_equal_pil(tmp_path, kind):
    """JPEG-compressed TIFFs of `encode_tiff` (a `JPEGTables` tag, abbreviated
    streams): Photometric 1, 2 and 5 as they are, 6 (YCbCr) at each
    subsampling, in one strip, strips of 16 rows (the last one's frame its
    own height) and tiles of 16 and 32x48 (edge tiles cropped), at 1x1,
    17x9 and 70x40 in both byte orders: equal to PIL (CMYK: its
    `convert("RGB")`), the C++ to the plain decoder."""
    kw = dict(JPEG_KINDS[kind])
    c = kw.pop("channels")
    for w, h in ((1, 1), (17, 9), (70, 40)):
        img = fx.natural(h, w, c, w * h)
        img = img[..., 0] if c == 1 else img
        for layout in ({}, {"rows_per_strip": 16}, {"tile": (16, 16)}, {"tile": (32, 48)}):
            if kw.get("subsampling") in ("4:2:2", "4:2:0") and layout.get("tile") == (16, 16):
                layout = {"tile": (32, 16)}
            for order in "<>":
                data = tiff.encode_tiff(img, "jpeg", byteorder=order, quality=85, **layout,
                                        **kw)
                _check(tmp_path, data, convert=c == 4)


def test_pil_written_jpeg_and_lzma_tiffs(tmp_path):
    """PIL's own JPEG-compressed TIFFs (RGB, Photometric 2, its components
    as stored; YCbCr, Photometric 6, from a `convert("YCbCr")` image; gray;
    CMYK) at qualities 50 and 95, and LZMA TIFFs (L, RGB, RGBA, with and
    without predictor 2, in strips of 3 rows)."""
    img = fx.natural(29, 45, 4, 3)
    for quality in (50, 95):
        for im in (Image.fromarray(img[..., :3]), Image.fromarray(img[..., :3]).convert("YCbCr"),
                   Image.fromarray(img[..., 0]), Image.fromarray(img[..., :3]).convert("CMYK")):
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression="jpeg", quality=quality)
            _check(tmp_path, buf.getvalue(), convert=im.mode == "CMYK")
    for mode in ("L", "RGB", "RGBA"):
        im = Image.fromarray(img[..., 0] if mode == "L" else img[..., :len(mode)], mode)
        for info in ({}, {317: 2}, {317: 2, 278: 3}):
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression="lzma", tiffinfo=info)
            assert tiff._tags(buf.getvalue(), "x")[259] == [34925]
            _check(tmp_path, buf.getvalue())


def _jpeg_tiff(strips, h, w, photometric, sub=None, tables=None, rps=16):
    """A TIFF whose strips of `rps` rows are the given JPEG streams."""
    more = {278: (4, [rps]), 284: (3, [1])}
    if sub is not None:
        more[530] = (3, list(sub))
    if tables is not None:
        more[347] = (7, list(tables))
    return _build(_base_tags(w, h, [8] * 3, 7, photometric, more), strips)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_raises(tmp_path, data):
    with pytest.raises(OSError):
        _pil(tmp_path, data)


def _raises(data, words):
    """Both routes raise a ValueError naming `words`, the same message."""
    msgs = []
    for fn in (tiff.decode_tiff, tiff.decode_tiff_plain):
        with pytest.raises(ValueError, match=words) as err:
            fn(data)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_jpeg_tiff_strips_as_libtiff_takes_them(tmp_path):
    """Full JPEG streams (tables and a JFIF marker in each strip, no
    `JPEGTables`) in strips of 16 rows: Photometric 6 at 4:2:0 equals each
    strip's own JFIF decode, fancy upsampling stopping at each strip's
    edge; a last strip coded at the full 16 rows is cropped; without the
    tag, YCbCrSubsampling is (2, 2). libtiff refuses, and so does the port:
    a tag that disagrees with the streams' sampling factors, Photometric 2
    streams with subsampled chroma, a frame wider than the image or taller
    than a strip that is not the last; a frame shorter than its strip, which
    libtiff only warns about (its rows are left undefined), raises here."""
    h, w = 37, 53
    img = fx.natural(h, w, 3, 11)
    strips = [img[y:y + 16] for y in range(0, h, 16)]
    coded = [_pil_jpeg(s, quality=90, subsampling=2) for s in strips]
    per_strip = np.concatenate([np.asarray(Image.open(io.BytesIO(c))) for c in coded])
    for sub in ((2, 2), None):
        data = _jpeg_tiff(coded, h, w, 6, sub)
        assert np.array_equal(_check(tmp_path, data), per_strip)
    last = np.concatenate([strips[-1], np.repeat(strips[-1][-1:], 11, 0)])
    data = _jpeg_tiff(coded[:-1] + [_pil_jpeg(last, quality=90, subsampling=2)], h, w, 6,
                      (2, 2))
    assert np.array_equal(_check(tmp_path, data), per_strip)
    cases = [
        (_jpeg_tiff(coded, h, w, 6, (1, 1)), "sampling factors"),
        (_jpeg_tiff([_pil_jpeg(s, quality=90, subsampling=0) for s in strips], h, w, 6,
                    (2, 2)), "sampling factors"),
        (_jpeg_tiff(coded, h, w, 2), "sampling factors"),
        (_jpeg_tiff([_pil_jpeg(np.concatenate([strips[0]] * 2, 1), quality=90,
                               subsampling=2)] + coded[1:], h, w, 6, (2, 2)), "exceeds"),
        (_jpeg_tiff([_pil_jpeg(np.concatenate([strips[0]] * 2, 0), quality=90,
                               subsampling=2)] + coded[1:], h, w, 6, (2, 2)), "exceeds"),
    ]
    for data, words in cases:
        _pil_raises(tmp_path, data)
        _raises(data, words)
    short = _jpeg_tiff([_pil_jpeg(strips[0][:8], quality=90, subsampling=2)] + coded[1:],
                       h, w, 6, (2, 2))
    _raises(short, "smaller")


def test_jpeg_tiff_rgb_streams_taken_as_they_are(tmp_path):
    """Photometric 2 with JFIF-marked 4:4:4 streams: libtiff fixes the
    colour space to JCS_UNKNOWN, so PIL returns the stored YCbCr
    components; so does the port (the stream alone reads as RGB)."""
    h, w = 20, 30
    img = fx.natural(h, w, 3, 12)
    coded = [_pil_jpeg(img[y:y + 16], quality=90, subsampling=0) for y in range(0, h, 16)]
    got = _check(tmp_path, _jpeg_tiff(coded, h, w, 2))
    alone = np.concatenate([jpeg.decode_jpeg(c) for c in coded])
    assert not np.array_equal(got, alone)
    planes = np.concatenate([jpeg.decode_jpeg(c, color="as_is") for c in coded])
    assert np.array_equal(got, planes)


def test_damaged_jpegtables_raise(tmp_path):
    """A `JPEGTables` stream that does not start with SOI, holds a frame
    header, lacks a quantisation table the strips use, or is missing
    altogether raises through both routes, as libtiff fails; one cut
    inside a table, which libjpeg fills with fake EOI markers and reads on,
    raises here too. Without its EOI the stream is read, as libjpeg
    supplies one; without its Huffman tables, libjpeg-turbo's Annex K
    tables stand in (the writer's own, so the image is the same)."""
    img = fx.natural(24, 40, 3, 13)
    good = tiff.encode_tiff(img, "jpeg", ycbcr=True, rows_per_strip=16)
    tables = tiff._tags(good, "x")[347]
    assert tables[:4] == b"\xff\xd8\xff\xdb" and tables[-2:] == b"\xff\xd9"
    want = _check(tmp_path, good)

    def rebuilt(new_tables):
        tags = tiff._tags(good, "x")
        strips = [good[o:o + n] for o, n in zip(tags[273], tags[279])]
        return _jpeg_tiff(strips, 24, 40, 6, (2, 2), new_tables)

    assert np.array_equal(_check(tmp_path, rebuilt(tables)), want)
    assert np.array_equal(_check(tmp_path, rebuilt(tables[:-2])), want)
    dht = tables.index(b"\xff\xc4")
    assert np.array_equal(_check(tmp_path, rebuilt(tables[:dht] + b"\xff\xd9")), want)
    sof = jpeg._segment(0xC0, struct.pack(">BHHB", 8, 8, 8, 1) + bytes([1, 0x11, 0]))
    for bad, words, pil_fails in (
            (tables[2:], "SOI", True),
            (tables[:-2] + sof + b"\xff\xd9", "bogus", True),
            (tables[:dht - 30], "cut short", False),
            (tables[:dht + 40], "cut short", False),
            (None, "not defined", True)):
        data = rebuilt(bad)
        if pil_fails:
            _pil_raises(tmp_path, data)
        _raises(data, words)


def test_cut_and_damaged_tiffs_raise(tmp_path):
    """A tiled LZW file cut inside its last tile, an LZMA strip cut short
    and one with a damaged byte, a JPEG strip cut at half its length and
    an uncompressed tiled file short of a tile raise through both
    routes; an LZMA strip with bytes after its stream decodes (libtiff
    stops at the stream's end); a missing `lzma` module raises naming it."""
    img = fx.natural(20, 40, 3, 14)
    data = tiff.encode_tiff(img, "lzw", 2, tile=(16, 16))
    _raises(data[:-5], "cut short|ends|truncated")
    lz = tiff.encode_tiff(img, "lzma", rows_per_strip=20)
    _raises(lz[:len(lz) // 2], "LZMA|cut short")
    assert lz[-20] != 0x55
    _raises(lz[:-20] + b"\x55" + lz[-19:], "LZMA")
    assert np.array_equal(_both(lz + b"\x00" * 7), img)
    jp = tiff.encode_tiff(img, "jpeg", ycbcr=True, rows_per_strip=16)
    tags = tiff._tags(jp, "x")
    o, n = tags[273][-1], tags[279][-1]
    _raises(jp[:o + n // 2], "cut short|truncated|ends early")
    raw = tiff.encode_tiff(img, "none", tile=(16, 16))
    _raises(raw[:-100], "cut short")
    sys.modules["lzma"] = None
    try:
        _raises(lz, "lzma module")
    finally:
        del sys.modules["lzma"]


def test_forms_still_refused_name_their_cause(tmp_path):
    """Planar JPEG, JPEG of 16-bit samples, JPEG with an extra sample, a
    tiled file without its tile offsets and a separated file of InkSet 2
    (inks other than CMYK) raise naming the cause; InkSet 1 reads as CMYK."""
    img = fx.natural(16, 16, 4, 15)
    stream = [jpeg.encode_jpeg(img[..., :3], color="as_is")]
    for bits, more, words in (([8] * 3, {284: (3, [2])}, "planar JPEG"),
                              ([16] * 3, {}, "16"), ([8] * 4, {}, "ExtraSamples")):
        _raises(_build(_base_tags(16, 16, bits, 7, 2, more), stream), words)
    _raises(_build(_base_tags(16, 16, [8] * 3, 1, 2, {322: (3, [16]), 323: (3, [16])}),
                   [img[..., :3].tobytes()]), "tile offsets")
    for inkset, words in ((2, "InkSet"), (1, None)):
        data = _build(_base_tags(16, 16, [8] * 4, 1, 5, {332: (3, [inkset])}),
                      [img.tobytes()])
        if words:
            _raises(data, words)
        else:
            _check(tmp_path, data, convert=True)


# -------------------------------------------------------------- fixtures
def test_fixture_digests_are_pil():
    """digests.json is what PIL gives on each fixture today (the fixtures
    cannot drift), and they fit in 96 KB."""
    table = json.load(open(os.path.join(FIXTURES, "digests.json")))
    names = {n for n in os.listdir(FIXTURES) if os.path.isfile(os.path.join(FIXTURES, n))}
    assert len(table) >= 12 and set(table) == names - {"digests.json"}
    total = os.path.getsize(os.path.join(FIXTURES, "digests.json"))
    for name, want in table.items():
        data = open(os.path.join(FIXTURES, name), "rb").read()
        total += len(data)
        assert fx.digests(data) == want, name
    assert total <= 96 * 1024


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES,
                                                                    "digests.json")))))
def test_fixture_decodes_to_its_digest(name):
    """Each fixture through `read_image` and through the plain route gives its
    recorded digest and shape."""
    want = json.load(open(os.path.join(FIXTURES, "digests.json")))[name]
    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    got = png.read_image(path)
    plain = tiff.decode_tiff_plain(data) if name.endswith(".tif") else \
        jpeg.decode_jpeg(data, native=False)
    for a in (got, plain):
        assert fx.sha(a) == want["array"] and list(a.shape) == want["shape"], name


# ------------------------------------------------------------------ scene
def _b14_scene(root, oracle):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    nine views rewritten in turn as: tiled LZW with predictor 2, planar
    Deflate with predictor 2, JPEG-in-TIFF YCbCr 4:2:0 in strips of 16
    rows (the port's writer), PIL's JPEG-in-TIFF (RGB) and LZMA TIFF, PIL's
    CMYK TIFF and CMYK JPEG, the writer's YCCK JPEG and a tiled 16-bit
    file. `oracle` is a copy in which each CMYK view is PIL's
    `convert("RGB")` of it as a PNG (fault B14's oracle). -> proxy."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        cmyk = np.asarray(Image.fromarray(img).convert("CMYK"))
        cmyk = np.concatenate([cmyk[..., :3] // 2, 255 - img.max(-1, keepdims=True)], -1)
        data = [
            lambda: tiff.encode_tiff(img, "lzw", 2, tile=(32, 32)),
            lambda: tiff.encode_tiff(img, "deflate", 2, planar=True, rows_per_strip=5),
            lambda: tiff.encode_tiff(img, "jpeg", ycbcr=True, rows_per_strip=16),
            lambda: _pil_save(img, "TIFF", compression="jpeg"),
            lambda: _pil_save(img, "TIFF", compression="lzma", tiffinfo={317: 2}),
            lambda: _pil_save(cmyk, "TIFF", mode="CMYK", compression="tiff_lzw"),
            lambda: _pil_save(cmyk, "JPEG", mode="CMYK", quality=90),
            lambda: jpeg.encode_jpeg(cmyk, 90, color="ycck"),
            lambda: tiff.encode_tiff(img.astype(np.uint16) * 257, "deflate", 2,
                                     tile=(16, 32)),
        ][i]()
        with open(path, "wb") as fh:
            fh.write(data)
    shutil.copytree(root, oracle)
    for i, name in enumerate(sorted(os.listdir(images))):
        im = Image.open(os.path.join(images, name))
        if im.mode == "CMYK":
            im.convert("RGB").save(os.path.join(oracle, "images", name), "PNG")
    return mesh


def _pil_save(img, fmt, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    (Image.fromarray(img, mode) if mode else Image.fromarray(img)).save(buf, fmt, **kw)
    return buf.getvalue()


def test_new_forms_scene_matches_jax_and_trains(tmp_path):
    """`read_scene` on a COLMAP set of the new forms equals the JAX reader's
    at -r 1 and 2 (the CMYK views against the JAX reader on PIL's
    `convert("RGB")` of each, written as a PNG: 3 channels and no mask,
    fault B14 repaired), and `cli.train_mesh --device cpu` trains 2
    iterations on it."""
    root, oracle = str(tmp_path / "s"), str(tmp_path / "oracle")
    mesh = _b14_scene(root, oracle)
    for resolution in (1, 2):
        kw = dict(resolution=resolution, eval_split=True)
        got = readers.read_scene(root, **kw)
        os.rename(root, str(tmp_path / "port"))          # the oracle at the same path
        os.rename(oracle, root)
        want = jreaders.read_scene(root, **kw)
        os.rename(root, oracle)
        os.rename(str(tmp_path / "port"), root)
        _assert_scene_equal(got, want)
        assert all(c.mask is None for c in got.train_cameras + got.test_cameras)
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
