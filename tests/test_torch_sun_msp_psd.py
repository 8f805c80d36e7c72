"""The port's Sun raster (`io/sun.py`), Windows Paint (`io/msp.py`) and
Photoshop (`io/psd.py`) readers on the CPU, against PIL 12 bit for bit where
PIL reads the file right: Sun rasters of every depth, raw and byte-encoded,
with colour maps; MSP versions 1 (PIL-written) and 2; PSDs raw and
PackBits in every mode PIL opens, with the sections PIL skips. The C++
walks (`gm_sun_rle`, `gm_msp_rle`) equal their plain versions on damaged
streams, the same bytes or the same error, and PIL decodes alike or raises
where PIL is right. Each fault is held to its own oracle: B24 (a
byte-encoded Sun raster of odd rows) to PIL's reading of the type-1 file of
the same raster; B27 (a PackBits PSD of more channels than its mode keeps)
to PIL's reading of the raw file; B28 (a bitmap PSD) to Adobe's polarity;
B26 (Lab) refused; B14 (CMYK), B15 (palettes) and B16 (1 bit) to PIL's
`convert`. The refused forms raise with their cause, `read_image`'s order
and give-way rule hold for the new heads (a Sun raster PIL takes for a GBR
brush is read as one), the fixtures of `tests/data/rle_text/` give their
recorded digests through both routes, and a COLMAP scene of one view in each new
form (XBM and XPM too) equals the JAX reader on PIL's conversions through
`read_scene`, reaches no plain piece, and trains 2 iterations of
`cli.train_mesh --device cpu`."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, msp, png, psd, sun, tga, tiff, xbm, xpm
from tests.test_torch_pnm_tga import _image
from tests.test_torch_readers import _assert_scene_equal
from tools.make_rle_text_fixtures_torch import port_array, psd_raw, sun_type1

torch.set_num_threads(2)

RLE_TEXT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "rle_text")
SIZES = [(3, 1), (22, 9), (131, 41)]                     # (width, height)


def _pil(data):
    """PIL's array of a file with the port's rule applied (the fixture
    tool's `port_array`), or the exception PIL raises."""
    try:
        return port_array(data)[0]
    except Exception as err:          # PIL raises OSError, ValueError, SyntaxError
        return err


def _outcome(decode, data):
    try:
        return decode(data, "<file>")
    except ValueError as err:
        return str(err)


def _write(tmp_path, data, name="f"):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _check(tmp_path, data, plain, fmt, want=None):
    """`read_image` of `data` (C++) = `plain` of it = PIL's array under the
    port's rule (or `want`); PIL opens it as `fmt` -> the array."""
    path = _write(tmp_path, data)
    assert Image.open(path).format == fmt
    got = png.read_image(path)
    assert got.dtype == np.uint8
    assert np.array_equal(plain(data), got)
    want = _pil(data) if want is None else want
    assert isinstance(want, np.ndarray), want
    assert got.shape == want.shape and np.array_equal(got, want), (got.shape, want.shape)
    return got


def _both_raise(tmp_path, data, plain, words, pil_raises=True):
    """`read_image` and `plain` raise the same ValueError naming `words`;
    PIL raises too where `pil_raises`."""
    path = _write(tmp_path, data, "bad")
    with pytest.raises(ValueError) as err:
        png.read_image(path)
    native = str(err.value).replace(path, "<file>")
    assert words in native, native
    assert _outcome(plain, data) == native
    if pil_raises:
        assert isinstance(_pil(data), Exception)
    return native


def _banded(h, w, c, seed):
    """Steps of 24 and a 5 % speckle: runs and literals for run-length codes."""
    img = _image(w, h, c, seed) // 24 * 24
    spots = np.random.default_rng(seed).random((h, w)) < 0.05
    img[spots] = 0x80
    return img


def _damaged(tmp_path, data, decode, plain, header, n, seed, pil_right=True):
    """`n` damaged copies of `data` (bytes after `header` changed, or cut):
    the C++ route gives the plain one's bytes or raises its error, and,
    where `pil_right`, PIL decodes the same array or raises."""
    rng = np.random.default_rng(seed)
    raised = 0
    for k in range(n):
        b = bytearray(data)
        if k % 3 == 0:
            b = b[:rng.integers(header, len(b))]
        else:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(header, len(b))] = rng.integers(0, 256)
        b = bytes(b)
        native, simple = _outcome(decode, b), _outcome(plain, b)
        assert type(native) is type(simple), k
        assert (native == simple) if isinstance(native, str) else np.array_equal(native, simple)
        raised += isinstance(native, str)
        if pil_right:
            want = _pil(b)
            assert isinstance(want, Exception) == isinstance(native, str), (k, native, want)
            if not isinstance(native, str):
                assert np.array_equal(native, want), k
    return raised


# ------------------------------------------------------------------ SUN
SUN_FORMS = {
    "raw8": dict(), "raw24_bgr": dict(rgb=True), "raw24_type3": dict(rgb=True, rgb_order=True),
    "raw32_bgrx": dict(rgb=True, depth=32), "raw32_type3": dict(rgb=True, depth=32,
                                                                rgb_order=True),
    "raw1_b16": dict(depth=1), "raw4": dict(depth=4), "raw8_colormap_b15": dict(cmap=40),
    "raw4_colormap_b15": dict(depth=4, cmap=10), "rle8": dict(rle=True),
    "rle24": dict(rgb=True, rle=True), "rle32": dict(rgb=True, depth=32, rle=True),
    "rle1_b16": dict(depth=1, rle=True), "rle4": dict(depth=4, rle=True),
    "rle8_colormap_b15": dict(cmap=200, rle=True),
}


def _sun(form, w, h, seed):
    """Form `form` of SUN_FORMS at w x h -> (the file, the samples read
    back by the format's definition)."""
    kw = dict(SUN_FORMS[form])
    img = _banded(h, w, 3, seed)
    depth = kw.pop("depth", 24 if kw.get("rgb") else 8)
    rgb, cmap = kw.pop("rgb", False), kw.pop("cmap", 0)
    pal = np.random.default_rng(seed).integers(0, 256, (max(cmap, 1), 3), dtype=np.uint8)
    if rgb:
        data, want = sun.encode_sun(img, depth=depth, **kw), img
    elif depth == 1:
        bits = (img[..., 0] > 100) * np.uint8(255)
        data, want = sun.encode_sun(bits, depth=1, **kw), bits
    elif cmap:
        idx = (img[..., 0] % (16 if depth == 4 else cmap + 7)).astype(np.uint8)   # some past it
        full = np.zeros((256, 3), np.uint8)
        full[:cmap] = pal
        data, want = sun.encode_sun(idx, depth=depth, colormap=pal, **kw), full[idx]
    elif depth == 4:
        nib = img[..., 0] >> 4
        data, want = sun.encode_sun(nib, depth=4, **kw), nib * np.uint8(17)
    else:
        data, want = sun.encode_sun(img[..., 0], **kw), img[..., 0]
    return data, want, depth


@pytest.mark.parametrize("size", SIZES + [(23, 9), (130, 41)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", list(SUN_FORMS))
def test_sun_equals_pil(tmp_path, form, size):
    """Every depth and type, with colour maps (indices past the map black,
    B15) and 1 bit (B16): C++ = plain = the samples written = PIL where the
    row is an even number of bytes or the raster raw; a byte-encoded raster
    of odd rows = PIL's reading of its type-1 file (B24)."""
    w, h = size
    data, want, depth = _sun(form, w, h, w + h)
    got = _check(tmp_path, data, sun.decode_sun_plain, "SUN", want=want)
    if form.startswith("rle") and (w * depth + 7) // 8 % 2:
        assert np.array_equal(got, _pil(sun_type1(data)))
    else:
        assert np.array_equal(got, _pil(data))


def test_sun_runs_over_256_and_across_rows(tmp_path):
    """`encode_sun`'s byte encoding of runs of 1 to 600 bytes of 0x80 and of
    5 (a run cut into pieces of 256 whose last piece is 1 byte, written as
    a literal), and a white 8-bit raster of even rows whose runs cross
    rows: C++ = plain = PIL = the samples written."""
    for n in range(1, 600):
        for raster in (np.full(n, 0x80, np.uint8), np.full(n, 5, np.uint8)):
            coded = sun._byte_encode(raster).tobytes()
            assert np.array_equal(_sun_walks(coded, n), raster), n
    img = np.full((41, 300), 255, np.uint8)
    img[20, 100] = 0x80
    assert np.array_equal(_check(tmp_path, sun.encode_sun(img, rle=True),
                                 sun.decode_sun_plain, "SUN"), img)


def test_b24_odd_rows_read_as_the_type1_raster(tmp_path):
    """Fault B24: PIL's `sun_rle` fills unpadded rows. The runs of a width-3
    8-bit file decode to 1 2 3 128 9 9 9 9; the type-1 raster has rows
    [1 2 3 (pad)] [9 9 9 (pad)], which PIL reads right from a type-1 file,
    and `read_sun` gives them, where PIL gives [1 2 3] [128 9 9]. The JAX
    `_load_image` of the type-1 file equals the port's of the type-2 one."""
    head = sun.SUN_MAGIC + struct.pack(">7I", 3, 2, 8, 8, 2, 0, 0)
    rle = head + bytes([1, 2, 3, 0x80, 0, 0x80, 3, 9])
    raw = head[:20] + struct.pack(">I", 1) + head[24:] + bytes([1, 2, 3, 128, 9, 9, 9, 9])
    assert np.asarray(Image.open(io.BytesIO(rle))).tolist() == [[1, 2, 3], [128, 9, 9]]
    assert np.asarray(Image.open(io.BytesIO(raw))).tolist() == [[1, 2, 3], [9, 9, 9]]
    for decode in (sun.decode_sun, sun.decode_sun_plain):
        assert decode(rle).tolist() == [[1, 2, 3], [9, 9, 9]]
    assert sun_type1(rle) == raw
    img = _banded(17, 23, 3, 5)
    for resolution in (1, 2):
        path = _write(tmp_path, sun.encode_sun(img, rle=True), "v.ras")
        oracle = _write(tmp_path, sun.encode_sun(img), "t1.ras")
        got, _ = readers._load_image(path, resolution, None)
        want, _ = jreaders._load_image(oracle, resolution, None)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert not np.array_equal(jreaders._load_image(path, resolution, None)[0], want)


def _sun_walks(data, total):
    native, plain = sun._rle(data, total), sun._rle_plain(data, total)
    assert np.array_equal(native, plain)
    return plain


@pytest.mark.parametrize("stream, total, want", [
    (b"", 4, []),
    (bytes([0x80, 0, 5]), 4, [0x80, 5]),                    # a literal 0x80
    (bytes([0x80, 2, 7, 1]), 8, [7, 7, 7, 1]),              # a run of 3
    (bytes([0x80, 255, 4]), 3, [4, 4, 4]),                  # a run of 256 clipped
    (bytes([0x80, 255, 4, 9]), 300, [4] * 256 + [9]),
    (bytes([5, 0x80]), 4, [5]),                             # a packet the data cuts
    (bytes([5, 0x80, 3]), 4, [5]),
    (bytes([1, 2, 3, 4, 5]), 2, [1, 2]),                    # the rest unread
])
def test_sun_rle_walk_edges(stream, total, want):
    """`gm_sun_rle` = its plain walk at the stream's edges."""
    assert _sun_walks(stream, total).tolist() == want


@pytest.mark.parametrize("form, size", [("rle8", (22, 9)), ("rle24", (22, 9)),
                                        ("rle8_colormap_b15", (40, 6)), ("rle1_b16", (33, 7)),
                                        ("rle8", (23, 9))])
def test_sun_rle_damaged_as_plain_and_pil(tmp_path, form, size):
    """64 damaged files a form (bytes of the encoded raster changed, or the
    file cut): the C++ and the plain route the same array or error, and,
    where the rows are even, PIL the same array or an error where they
    raise."""
    data, _, depth = _sun(form, *size, seed=11)
    even = (size[0] * depth + 7) // 8 % 2 == 0
    raised = _damaged(tmp_path, data, sun.decode_sun, sun.decode_sun_plain,
                      32 + len(sun.header(data)[4]), 64, size[0], even)
    assert 0 < raised < 64


def _sun_refused():
    img = _banded(4, 6, 3, 21)
    gray = img[..., 0]
    head = lambda **kw: sun.SUN_MAGIC + struct.pack(">7I", *(kw.get(k, v) for k, v in (
        ("w", 6), ("h", 4), ("depth", 8), ("length", 24), ("kind", 1), ("map_type", 0),
        ("map_len", 0))))
    return {
        "depth_16": (head(depth=16) + bytes(48), "depth 16", False),
        "type_6": (head(kind=6) + bytes(24), "type 6", False),
        "map_type_2": (head(map_type=2, map_len=3) + bytes(27), "colour map of type 2", False),
        "map_1025": (head(map_type=1, map_len=1025) + bytes(1049), "1025 bytes", False),
        "size_0": (head(h=0) + bytes(24), "0 pixels", False),
        "header_cut": (head()[:20], "header cut short", False),
        "map_1_bit": (sun.encode_sun(gray > 9, depth=1, colormap=np.zeros((2, 3), np.uint8)),
                      "1-bit SUN raster with a colour map", True),
        "map_24_bit": (sun.encode_sun(img, colormap=np.zeros((2, 3), np.uint8)),
                       "24-bit SUN raster with a colour map", True),
        "map_257": (head(map_type=1, map_len=771) + bytes(771 + 24), "257 entries", True),
        "raw_cut": (sun.encode_sun(gray)[:-3], "image file is truncated", True),
        "rle_cut": (sun.encode_sun(gray, rle=True)[:-2], "image file is truncated", True),
    }


@pytest.mark.parametrize("case", list(_sun_refused()))
def test_sun_refused_forms_raise(tmp_path, case):
    """Headers PIL's `_open` refuses give way (so `read_image` names no
    format but the cause), and the forms PIL cannot load raise with its
    cause, through `read_image` and the plain route alike; PIL raises on
    each."""
    data, words, loads = _sun_refused()[case]
    if loads:
        _both_raise(tmp_path, data, sun.decode_sun_plain, words)
    else:
        path = _write(tmp_path, data, "bad")
        with pytest.raises(ValueError, match="not a JPEG") as err:
            png.read_image(path)
        assert words in str(err.value)
        assert isinstance(_pil(data), Exception)


# ------------------------------------------------------------------ MSP
@pytest.mark.parametrize("size", SIZES + [(1, 1), (17, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_msp_equals_pil(tmp_path, size):
    """PIL's MSP (version 1) and `encode_msp`'s versions 1 and 2 (with and
    without blank rows): C++ = plain = PIL's `convert("L")` (B16) = the
    bits written; PIL reads the port's files."""
    w, h = size
    bits = (_image(w, h, 1, w * h)[..., 0] > 120) * np.uint8(255)
    bits[: h // 2] = 255
    buf = io.BytesIO()
    Image.fromarray(bits > 0).save(buf, "MSP")
    assert np.array_equal(_check(tmp_path, buf.getvalue(), msp.decode_msp_plain, "MSP"), bits)
    for kw in (dict(version=1), dict(version=2), dict(version=2, blank_rows=False)):
        got = _check(tmp_path, msp.encode_msp(bits, **kw), msp.decode_msp_plain, "MSP")
        assert np.array_equal(got, bits)


def _msp_walks(data, rows, row_bytes):
    native, plain = msp._rle(data, rows, row_bytes), msp._rle_plain(data, rows, row_bytes)
    assert native[1:] == plain[1:] and np.array_equal(native[0], plain[0])
    return native


@pytest.mark.parametrize("data, rows, want", [
    (struct.pack("<2H", 3, 0) + bytes([0, 2, 0xAA]), 2, (b"\xaa\xaa\xff\xff", 4, None)),
    (struct.pack("<H", 2) + bytes([0, 0]), 1, (b"", 0, (12, 0))),          # a run cut
    (struct.pack("<H", 3) + bytes([5, 1, 2]), 1, (b"\x01\x02", 2, None)),  # a literal cut
    (struct.pack("<2H", 0, 4) + bytes([0, 5, 1]), 2, (b"\xff\xff", 2, (1, 1))),  # a row cut
    (struct.pack("<2H", 1, 1)[:3], 2, (b"", 0, (1, -1))),                  # the map cut
    (struct.pack("<H", 3) + bytes([0, 3, 7]), 1, (b"\x07\x07", 3, None)),  # a byte over
])
def test_msp_rle_walk_edges(data, rows, want):
    """`gm_msp_rle` = its plain walk, rows of 2 bytes: a blank row, a run
    and a literal cut by their row, a row or the map cut by the file (the
    status and row), a row that gives more bytes than its width."""
    px, count, failed = _msp_walks(data, rows, 2)
    assert (px.tobytes(), count, failed) == want


@pytest.mark.parametrize("size", [(23, 17), (64, 9), (131, 41)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_msp_v2_damaged_as_plain_and_pil(tmp_path, size):
    """64 damaged version-2 files a size (bytes of the row map or rows
    changed, or the file cut): the C++ and the plain route the same array
    or error, and PIL the same array, or an error where they raise."""
    w, h = size
    bits = (_banded(h, w, 1, w)[..., 0] > 100) * np.uint8(255)
    bits[1] = 255
    raised = _damaged(tmp_path, msp.encode_msp(bits, version=2), msp.decode_msp,
                      msp.decode_msp_plain, 32, 64, w)
    assert 0 < raised < 64


def _msp_refused():
    bits = (_image(10, 4, 1, 31)[..., 0] > 100) * np.uint8(255)
    v2 = msp.encode_msp(bits, version=2, blank_rows=False)
    bad_sum = bytearray(msp.encode_msp(bits))
    bad_sum[24] ^= 1
    corrupt = v2[:32] + struct.pack("<4H", 2, 3, 3, 3) + bytes([0, 3]) + bytes([0, 2, 9]) * 3
    return {
        "v1_cut": (msp.encode_msp(bits)[:-2], "image file is truncated", "raise"),
        "v2_map_cut": (v2[:32 + 5], "Truncated MSP file in row map", "raise"),
        "v2_row_cut": (v2[:-1], "Truncated MSP file, expected", "raise"),
        "v2_run_cut": (corrupt, "Corrupted MSP file in row 0", "raise"),
        "v2_rows_short": (v2[:32] + struct.pack("<4H", 1, 1, 1, 1) + bytes([1]) * 4,
                          "not enough image data", "raise"),
        "bad_checksum": (bytes(bad_sum), "bad MSP checksum", "give way"),
        "size_0": (msp.encode_msp(np.zeros((3, 0), np.uint8)), "0x3 pixels", "give way"),
    }


@pytest.mark.parametrize("case", list(_msp_refused()))
def test_msp_refused_forms_raise(tmp_path, case):
    """Each error PIL raises on an MSP, through `read_image` and the plain
    route alike; a bad checksum or a size of 0 gives way (no format takes
    the file)."""
    data, words, kind = _msp_refused()[case]
    if kind == "raise":
        _both_raise(tmp_path, data, msp.decode_msp_plain, words)
    else:
        with pytest.raises(ValueError, match="not a JPEG") as err:
            png.read_image(_write(tmp_path, data))
        assert words in str(err.value)
        assert isinstance(_pil(data), Exception)


# ------------------------------------------------------------------ PSD
PSD_FORMS = ("gray", "multichannel", "duotone", "bitmap_8bit", "rgb", "rgba", "rgb_5_channels",
             "cmyk_b14", "indexed_b15")


def _psd_form(form, w, h, packbits):
    """Form `form` of PSD_FORMS at w x h -> (the file, the samples read
    back)."""
    img = _banded(h, w, 4, w + h)
    pal = np.random.default_rng(w).integers(0, 256, (256, 3), dtype=np.uint8)
    gray = img[..., 0]
    if form == "bitmap_8bit":                  # colour mode 0 at 8 bits: PIL's L
        data = bytearray(psd.encode_psd(gray, packbits=packbits))
        data[24:26] = struct.pack(">H", 0)
        return bytes(data), gray
    kw, want = {"gray": (dict(img=gray), gray),
                "multichannel": (dict(img=img[..., :2], mode=7), gray),
                "duotone": (dict(img=gray, mode=8), gray),
                "rgb": (dict(img=img[..., :3]), img[..., :3]),
                "rgba": (dict(img=img), img),
                "rgb_5_channels": (dict(img=img, extra=1), img[..., :3]),
                "cmyk_b14": (dict(img=img, mode=4), jpeg.cmyk_to_rgb(img)),
                "indexed_b15": (dict(img=gray, mode=2, palette=pal), pal[gray])}[form]
    return psd.encode_psd(packbits=packbits, **kw), want


@pytest.mark.parametrize("packbits", [False, True], ids=["raw", "packbits"])
@pytest.mark.parametrize("form", PSD_FORMS)
@pytest.mark.parametrize("size", SIZES + [(1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_psd_equals_pil(tmp_path, size, form, packbits):
    """Every mode PIL opens at 8 bits, raw and PackBits: C++ = plain = PIL
    (CMYK as its `convert("RGB")`, B14; indexed as `convert("RGB")`, B15)
    = the samples written. A PackBits file of more channels than its mode
    keeps is B27's (`test_b27_packbits_extra_channels`), so a 5-channel RGB
    is held to PIL raw only."""
    data, want = _psd_form(form, *size, packbits)
    multi = form in ("rgb_5_channels", "multichannel")
    _check(tmp_path, data, psd.decode_psd_plain, "PSD",
           want=want if packbits and multi else None)
    assert np.array_equal(psd.decode_psd(data), want)


@pytest.mark.parametrize("size", [(3, 1), (23, 17)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", ["gray_alpha", "rgb_spot_alpha", "cmyk_alpha",
                                  "indexed_alpha"])
def test_b27_packbits_extra_channels(tmp_path, form, size):
    """Fault B27: PIL reads the PackBits counts of only the channels its
    mode keeps, so a file of more channels decodes part of the count table
    as pixels (or runs out). `read_psd` equals PIL's reading of the raw file
    of the same planes (PIL's own PackBits decoder expanding the rows), and
    the samples written."""
    w, h = size
    img = _banded(h, w, 4, w)
    pal = np.random.default_rng(w).integers(0, 256, (256, 3), dtype=np.uint8)
    kw = {"gray_alpha": dict(img=img[..., 0], extra=1),
          "rgb_spot_alpha": dict(img=img[..., :3], extra=2),
          "cmyk_alpha": dict(img=img, mode=4, extra=1),
          "indexed_alpha": dict(img=img[..., 0], mode=2, palette=pal, extra=1)}[form]
    data = psd.encode_psd(packbits=True, **kw)
    oracle = _pil(psd_raw(data))
    got = _check(tmp_path, data, psd.decode_psd_plain, "PSD", want=oracle)
    raw_pil = Image.open(io.BytesIO(data))
    try:
        misread = not np.array_equal(np.asarray(raw_pil.convert(
            "RGB" if raw_pil.mode in ("CMYK", "P") else raw_pil.mode)), got)
    except OSError:
        misread = True
    assert misread
    assert np.array_equal(got, psd.decode_psd(psd.encode_psd(**kw)))


@pytest.mark.parametrize("packbits", [False, True], ids=["raw", "packbits"])
def test_b28_bitmap_is_black_where_set(tmp_path, packbits):
    """Fault B28: a bitmap PSD's set bit is black in Adobe's format; PIL
    reads it white. `read_psd` gives 0 where set, 255 where clear: PIL's
    `convert("L")` inverted. The port's `_load_image` equals the JAX
    reader's on that inversion written as a PNG, at -r 1 and 2, and differs
    from the JAX reader's on the file."""
    ink = _image(23, 17, 1, 3)[..., 0] > 128
    data = psd.encode_psd(ink * np.uint8(255), mode=0, packbits=packbits)
    path = _write(tmp_path, data, "b.psd")
    pil = np.asarray(Image.open(path).convert("L"))
    assert np.array_equal(pil, ink * np.uint8(255))
    got = _check(tmp_path, data, psd.decode_psd_plain, "PSD", want=255 - pil)
    assert np.array_equal(got, np.where(ink, 0, 255))
    oracle = str(tmp_path / "oracle.png")
    Image.fromarray(255 - pil).save(oracle)
    for resolution in (1, 2):
        a, _ = readers._load_image(path, resolution, None)
        b, _ = jreaders._load_image(oracle, resolution, None)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert not np.array_equal(jreaders._load_image(path, resolution, None)[0], b)


@pytest.mark.parametrize("resolution", [1, 2])
def test_b14_b15_psd_load_as_pil_converts(tmp_path, resolution):
    """B14 and B15 on PSD: the port's `_load_image` of a CMYK PSD and of an
    indexed one equals the JAX reader's of PIL's `convert("RGB")` written
    as a PNG, with no mask; the JAX reader on the CMYK file takes K as a
    mask, and on the indexed one trains the indices."""
    img = _banded(17, 23, 4, 41)
    pal = np.random.default_rng(41).integers(0, 256, (256, 3), dtype=np.uint8)
    for data, jax_mask in ((psd.encode_psd(img, mode=4, packbits=True), True),
                           (psd.encode_psd(img[..., 0], mode=2, palette=pal), False)):
        path = _write(tmp_path, data, "v.psd")
        oracle = str(tmp_path / "oracle.png")
        Image.open(path).convert("RGB").save(oracle)
        a, am = readers._load_image(path, resolution, None)
        b, bm = jreaders._load_image(oracle, resolution, None)
        assert am is None and bm is None and np.array_equal(a, b)
        c, cm = jreaders._load_image(path, resolution, None)
        assert (cm is not None) == jax_mask and not np.array_equal(c, b)


def test_psd_sections_walked_as_pil(tmp_path):
    """Resources (odd and even names and sizes, an ICC profile) and a layer
    section before the composite are skipped as PIL skips them."""
    img = _banded(9, 13, 3, 51)
    base = psd.encode_psd(img, packbits=True)
    for name, size in ((b"", 4), (b"ab", 5), (b"abc", 0)):
        res = (b"8BIM" + struct.pack(">HB", 1039, len(name)) + name
               + b"\0" * (not len(name) & 1) + struct.pack(">I", size) + b"x" * size
               + b"\0" * (size & 1))
        layers = struct.pack(">I", 6) + b"\0\0"
        data = (base[:30] + struct.pack(">I", len(res)) + res + struct.pack(">I", len(layers))
                + layers + base[38:])
        assert np.array_equal(_check(tmp_path, data, psd.decode_psd_plain, "PSD"), img)


def _psd_refused():
    img = _banded(4, 5, 3, 61)
    rgb = psd.encode_psd(img)
    lab = psd.encode_psd(img, mode=9)
    zip_ = rgb[:38] + struct.pack(">H", 2) + rgb[40:]
    indexed = psd.encode_psd(img[..., 0], mode=2, palette=np.zeros((256, 3), np.uint8))
    return {
        "lab_b26": (lab, "fault B26", True, False),
        "zip": (zip_, "compression 2 (ZIP)", True, True),
        "few_channels": (rgb[:12] + struct.pack(">H", 2) + rgb[14:], "not enough channels",
                         True, True),
        "indexed_no_table": (indexed[:26] + struct.pack(">I", 0) + indexed[30 + 768:],
                             "not a 768-byte colour table", True, False),
        "raw_cut": (rgb[:-4], "image file is truncated", True, True),
        "packbits_row_long": (_packbits_row_edit(img, b"\x02\x07\x07\x07\xfe\x09"),
                              "decodes past the 5 bytes", True, False),
        "packbits_row_short": (_packbits_row_edit(img, b"\x02\x07\x07\x07"),
                               "gives 3 of its 5 bytes", True, False),
        "16_bit": (rgb[:22] + struct.pack(">H", 16) + rgb[24:], "16-bit PSD", False, True),
        "psb": (rgb[:4] + struct.pack(">H", 2) + rgb[6:], "version 2 (PSB)", False, True),
        "lab_16_bit": (lab[:22] + struct.pack(">H", 16) + lab[24:], "16-bit", False, True),
        "header_cut": (rgb[:20], "header cut short", False, True),
    }


def _packbits_row_edit(img, row0):
    """A PackBits RGB PSD whose first row is `row0`, its count set."""
    data = bytearray(psd.encode_psd(img, packbits=True))
    h = img.shape[0]
    counts = list(struct.unpack_from(f">{3 * h}H", data, 40))
    start = 40 + 6 * h
    body = bytes(data[start + counts[0]:])
    counts[0] = len(row0)
    return bytes(data[:40]) + struct.pack(f">{3 * h}H", *counts) + row0 + body


@pytest.mark.parametrize("case", list(_psd_refused()))
def test_psd_refused_forms_raise(tmp_path, case):
    """Lab (B26), ZIP composites, too few channels, an indexed file with no
    colour table, a cut raster and a PackBits row that overruns its width
    raise with their cause through `read_image` and the plain route; a
    16-bit file, a PSB and a cut header give way, as PIL does (no format
    takes them)."""
    data, words, loads, pil_raises = _psd_refused()[case]
    if loads:
        _both_raise(tmp_path, data, psd.decode_psd_plain, words, pil_raises)
    else:
        with pytest.raises(ValueError, match="not a JPEG") as err:
            png.read_image(_write(tmp_path, data))
        assert words in str(err.value)
        assert isinstance(_pil(data), Exception)


# ------------------------------------------------------------------ dispatch
def test_dispatch_heads_order_and_gbr(tmp_path):
    """Each new format by its head (PIL's format equal): MSP, PSD and SUN in
    PIL's places, XBM and XPM after WebP (and before XVTHUMB, the last);
    none of their heads passes TGA's checks; a Sun raster of width 1 whose length field is 1 or 4 is a GIMP
    brush to PIL, tried first, and is read as the brush (whose pixels lie
    past the file's end, so both raise PIL's "not enough image data"),
    while one of width 2 (GBR version 2, which needs "GIMP" at byte 20) is
    read as SUN."""
    names = [name for name, _, _ in png._ORDER]
    assert names.index("TIFF") < names.index("MSP") < names.index("PSD") < names.index("QOI")
    assert names.index("SGI") < names.index("SUN") < names.index("TGA")
    assert names.index("WebP") < names.index("XBM") < names.index("XPM") \
        < names.index("XVTHUMB") == len(names) - 1
    img = _banded(5, 7, 3, 71)
    files = {"SUN": sun.encode_sun(img, rle=True), "MSP": msp.encode_msp(img[..., 0], 2),
             "PSD": psd.encode_psd(img), "XBM": xbm.encode_xbm(img[..., 0] > 99),
             "XPM": xpm.encode_xpm(img)}
    for fmt, data in files.items():
        assert tga.tga_header(data[:68]) is None
        path = _write(tmp_path, data, fmt)
        assert Image.open(path).format == fmt
        assert np.array_equal(png.read_image(path), _pil(data))
    column = img[:3, :1, 0]
    for w, length, fmt in ((1, 4, "GBR"), (1, 1, "GBR"), (1, 5, "SUN"), (2, 4, "SUN")):
        data = bytearray(sun.encode_sun(np.repeat(column, w, 1)))
        data[16:20] = struct.pack(">I", length)
        path = _write(tmp_path, bytes(data), f"g{w}{length}")
        assert Image.open(path).format == fmt
        if fmt == "GBR":
            with pytest.raises(ValueError, match="not enough image data"):
                png.read_image(path)
            with pytest.raises(ValueError, match="not enough image data"):
                np.asarray(Image.open(path))
        else:
            assert np.array_equal(png.read_image(path), np.repeat(column, w, 1))


def test_give_way_goes_on_as_pil(tmp_path):
    """A new format's header PIL gives way on is handed on: no other format
    takes these heads, so `read_image` raises naming every cause, as PIL
    cannot identify them."""
    cases = {
        "sun_depth_2": sun.SUN_MAGIC + struct.pack(">7I", 4, 4, 2, 8, 1, 0, 0) + bytes(8),
        "msp_checksum": b"LinS" + bytes(28),
        "psd_version_3": b"8BPS" + struct.pack(">H", 3) + bytes(40),
        "xbm_no_bits": b"#define a_width 3\n#define a_height 2\n{0x01, 0x02};\n",
        "xpm_no_values": b"/* XPM */\nstatic char *a[] = {\n};\n",
    }
    for name, data in cases.items():
        path = _write(tmp_path, data, name)
        with pytest.raises(ValueError, match="not a JPEG") as err:
            png.read_image(path)
        assert name.split("_")[0].upper() + ":" in str(err.value), err.value
        assert isinstance(_pil(data), Exception)


# ------------------------------------------------------------------ fixtures
with open(os.path.join(RLE_TEXT, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)
PLAIN = {".ras": sun.decode_sun_plain, ".msp": msp.decode_msp_plain,
         ".psd": psd.decode_psd_plain, ".xbm": xbm.decode_xbm, ".xpm": xpm.decode_xpm}


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith((".ras", ".msp",
                                                                          ".psd"))))
def test_rle_fixtures_give_their_digests(name):
    """Each SUN, MSP and PSD fixture of `tests/data/rle_text/` through
    `read_image` (C++) and the plain route gives its recorded digest and
    shape, and PIL, with the recorded rule applied, gives it again here."""
    check_fixture(name)


def check_fixture(name):
    path = os.path.join(RLE_TEXT, name)
    with open(path, "rb") as fh:
        data = fh.read()
    want = DIGESTS[name]
    for got in (png.read_image(path), PLAIN[os.path.splitext(name)[1]](data)):
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == want["array"]
        assert list(got.shape) == want["shape"]
    from tools.make_rle_text_fixtures_torch import digests
    assert digests(data) == want


# ------------------------------------------------------ a scene of each form
def _rle_text_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    nine views rewritten as a byte-encoded 24-bit Sun raster, an 8-bit one
    with a colour map (B15), an MSP version 2 (B16), a PackBits RGB PSD, a
    CMYK PSD (B14), a bitmap PSD (B28), an XBM (B16), an XPM of 256
    colours (B15) and an XPM of `#RGB` colours (B25), in turn. -> (proxy,
    {image name: PIL's array under the port's rule})."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    levels = np.array([8, 8, 4])
    oracle = {}
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        gray, ink = img[..., 1], img[..., 1] > 200
        q = (img.astype(np.int64) * levels // 256)
        idx = ((q[..., 0] * levels[1] + q[..., 1]) * levels[2] + q[..., 2]).astype(np.uint8)
        steps = [(np.arange(n) * 255 // (n - 1)) for n in levels]
        pal = np.stack(np.meshgrid(*steps, indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
        data = (sun.encode_sun(img, rle=True),
                sun.encode_sun(idx, colormap=pal),
                msp.encode_msp(ink, version=2),
                psd.encode_psd(img, packbits=True),
                psd.encode_psd(np.concatenate([img, 255 - gray[..., None]], 2), mode=4),
                psd.encode_psd(ink * np.uint8(255), mode=0, packbits=True),
                xbm.encode_xbm(ink),
                xpm.encode_xpm(idx, pal),
                xpm.encode_xpm(idx, pal, digits=3))[i % 9]
        with open(path, "wb") as fh:
            fh.write(data)
        oracle[name] = port_array(data)[0]
    return mesh, oracle


def test_rle_text_colmap_scene_matches_jax_and_trains(tmp_path, monkeypatch):
    """`read_scene` on one COLMAP set of the nine new forms equals, at -r 1
    and 2, the JAX reader's on the same set with each view replaced by
    PIL's array under the port's rule written as a PNG (PIL's `convert` for
    B14, B15, B16; B28's inversion; B25's `#RRGGBB` colours), exactly;
    the JAX reader on the files themselves differs on the seven views of a
    fault. Read again with every plain piece made to raise, the same scene;
    and `cli.train_mesh --device cpu` trains 2 iterations on it."""
    root = str(tmp_path / "s")
    mesh, oracle = _rle_text_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    faulty = jreaders.read_scene(root, **kw[0])

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for mod, name in ((sun, "_rle_plain"), (msp, "_rle_plain"), (tiff, "packbits_decode_plain"),
                      (png, "_unfilter_plain")):
        monkeypatch.setattr(mod, name, plain)
    for g, k in zip(got, kw):
        _assert_scene_equal(readers.read_scene(root, **k), g)
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
    monkeypatch.undo()
    for name, a in oracle.items():
        Image.fromarray(a).save(os.path.join(root, "images", name), "PNG")
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))
    wrong = {c.image_name: c.image for c in faulty.train_cameras + faulty.test_cameras}
    ported = {c.image_name: c.image for c in got[0].train_cameras + got[0].test_cameras}
    assert sum(not np.array_equal(wrong[n], a) for n, a in ported.items()) == 7
