"""The port's PIXAR, McIdas, XV thumbnail and FITS readers (`io/pixar.py`,
`io/mcidas.py`, `io/xvthumb.py`, `io/fits.py`) against PIL 12, and the
repairs of the PNM head (A4, A5).

Each form PIL reads right equals PIL's array under the port's rule (B7 for
2-byte McIdas samples, B15 for XV thumbnails' RGB332 indices); each head
PIL's `_open` gives way on gives way, each it fails on raises, and each it
opens and the port refuses raises a ValueError naming the cause (McIdas
4-byte samples, the FITS forms PIL misreads). B32 (PIL misreads FITS wider
than 8 bits, and an unpadded data unit under 80 bytes) is held against
oracles PIL reads right: the same unsigned samples as a 16-bit PNG, the
samples written. A4: `is_pnm` is PIL's `PpmImagePlugin._accept`, so an XV
thumbnail is read; A5: a magic PIL's PPM `_open` does not know, or a PNM
size under 1, gives way (an IM file whose first line starts with one is
read as IM)."""

import io
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu_torch.io import fits, mcidas, pixar, png, pnm, xvthumb
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from tools.make_raw_sample_fixtures_torch import natural

torch.set_num_threads(2)

SIZES = [(1, 1), (2, 3), (23, 17), (300, 5)]                 # (width, height)


def _plugin(fmt):
    """PIL's image class of `fmt`, every plugin registered first in the
    order a fresh process's `Image.open` registers them (importing one
    plugin module alone would put it ahead of the others)."""
    Image.preinit()
    Image.init()
    return Image.OPEN[fmt][0]


def _write(tmp_path, data, name="f"):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _pil(cls, path, rule=None):
    """PIL's plugin `cls` on the file at `path` (opened by name, as the JAX
    reader opens it) -> "give way" (its `_open` raised SyntaxError, or
    `ImageFile` turned a lookup error into one), "fail" (any other error,
    loading included) or its array under `rule`."""
    try:
        im = cls(path)
    except SyntaxError:
        return "give way"
    except Exception:
        return "fail"
    try:
        im.load()
    except Exception:
        return "fail"
    if rule == "B7":
        return (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8)
    if rule == "B15":
        return np.asarray(im.convert("RGB"))
    return np.asarray(im)


def _port(decode, data):
    try:
        return decode(data, "<file>")
    except GiveWay:
        return "give way"
    except ValueError:
        return "fail"


def _same(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------------ PIXAR
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pixar_equals_pil(tmp_path, size):
    """`encode_pixar`'s RGB files through `read_image` equal PIL's array."""
    img = natural(size[1], size[0], 3, size[0] + size[1])
    path = _write(tmp_path, pixar.encode_pixar(img))
    assert Image.open(path).format == "PIXAR"
    got = png.read_image(path)
    assert np.array_equal(got, np.asarray(Image.open(path))) and np.array_equal(got, img)


def _pixar_head(w=3, h=2, pair=(14, 2)):
    head = bytearray(pixar.encode_pixar(np.zeros((1, 1, 3), np.uint8))[:pixar.DATA_START])
    struct.pack_into("<HHxxxxHH", head, 416, h, w, *pair)
    return bytes(head)


PIXAR_CASES = {
    "rgb": _pixar_head() + bytes(range(18)),
    "other_depth": _pixar_head(pair=(14, 1)) + bytes(18),
    "other_channels": _pixar_head(pair=(1, 2)) + bytes(18),
    "header_cut_at_427": _pixar_head()[:427],
    "header_cut_at_428": _pixar_head()[:428],
    "width_0": _pixar_head(w=0) + bytes(18),
    "rows_cut": _pixar_head() + bytes(17),
}


@pytest.mark.parametrize("case", list(PIXAR_CASES))
def test_pixar_rules_as_pil(tmp_path, case):
    """Each PIXAR head gives way, fails or reads as PIL's `_open` and
    loader do: only channels 14 / depth 2 is RGB."""
    data = PIXAR_CASES[case]
    path = _write(tmp_path, data)
    want = _pil(_plugin("PIXAR"), path)
    assert _same(_port(pixar.decode_pixar, data), want), case


# ------------------------------------------------------------------ McIdas
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", ["1byte", "2byte_b7", "1byte_prefix_3bands",
                                  "2byte_2bands_c6"])
def test_mcidas_equals_pil(tmp_path, form, size):
    """McIdas areas of 1- and 2-byte samples, with a line prefix and with
    several bands, through `read_image`: PIL's array, a 2-byte sample's
    high byte (B7); a line of several bands gives its first W10 samples."""
    w, h = size
    rng = np.random.default_rng(w * 7 + h)
    kw = {"1byte": {}, "2byte_b7": dict(size=2), "1byte_prefix_3bands": dict(prefix=5, bands=3),
          "2byte_2bands_c6": dict(size=2, bands=2)}[form]
    img = rng.integers(0, 256 if kw.get("size", 1) == 1 else 65536, (h, w)).astype(
        np.uint8 if kw.get("size", 1) == 1 else np.uint16)
    path = _write(tmp_path, mcidas.encode_mcidas(img, **kw))
    assert Image.open(path).format == "MCIDAS"
    want = _pil(_plugin("MCIDAS"), path, "B7" if "2byte" in form else None)
    got = png.read_image(path)
    assert np.array_equal(got, want)
    assert np.array_equal(got, img if img.dtype == np.uint8 else (img >> 8).astype(np.uint8))


def _area(w=3, h=2, size=1, bands=1, w15=0, w34=256):
    words = [0] * 65
    words[2], words[9], words[10], words[11], words[14], words[15], words[34] = \
        4, h, w, size, bands, w15, w34
    return struct.pack(">64i", *words[1:])


MCIDAS_CASES = {
    "plain": _area() + bytes(range(1, 7)),
    "three_bytes_a_sample": _area(size=3) + bytes(18),
    "width_0": _area(w=0) + bytes(6),
    "height_negative": _area(h=-2) + bytes(6),
    "directory_cut": _area()[:255],
    "data_start_negative": _area(w34=-10) + bytes(6),
    "lines_packed_bands_0": _area(bands=0) + bytes(range(1, 7)),
    "lines_packed_line_negative": _area(bands=-1) + bytes(range(1, 20)),
    "lines_overlap": _area(bands=0, w15=1) + bytes(range(1, 9)),
    "prefix_negative_overlap": _area(w15=-1) + bytes(range(1, 7)),
    "two_bands_last_line_short": _area(bands=2) + bytes(range(1, 10)),
    "rows_cut": _area() + bytes(5),
    "data_past_the_file": _area(w34=10000) + bytes(6),
    "two_byte_rows_cut": _area(size=2) + bytes(11),
}


@pytest.mark.parametrize("case", list(MCIDAS_CASES))
def test_mcidas_rules_as_pil(tmp_path, case):
    """Each McIdas directory gives way, fails or reads as PIL's `_open` and
    its loader (the file memory-mapped, as `Image.open` of a path maps it:
    lines that overlap read so) do."""
    data = MCIDAS_CASES[case]
    path = _write(tmp_path, data)
    want = _pil(_plugin("MCIDAS"), path, "B7" if "two_byte" in case else None)
    assert _same(_port(mcidas.decode_mcidas, data), want), case


def test_mcidas_4byte_refused(tmp_path):
    """4-byte samples, which PIL opens as mode I (32-bit: B21's kind for
    the JAX reader), raise naming the cause."""
    path = _write(tmp_path, _area(w=2, h=1, size=4) + bytes([0, 0, 1, 2, 0, 0, 3, 4]))
    im = Image.open(path)
    assert (im.format, im.mode) == ("MCIDAS", "I") and np.asarray(im).max() == 772
    with pytest.raises(ValueError, match="32-bit samples.*B21"):
        png.read_image(path)


# ------------------------------------------------------------------ XV thumbnails
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_xvthumb_equals_pil_rgb(tmp_path, size):
    """XV thumbnails through `read_image`: PIL's `convert("RGB")` (B15: the
    JAX reader would train the RGB332 indices)."""
    w, h = size
    idx = np.random.default_rng(w + 3 * h).integers(0, 256, (h, w)).astype(np.uint8)
    path = _write(tmp_path, xvthumb.encode_xvthumb(idx))
    im = Image.open(path)
    assert (im.format, im.mode) == ("XVThumb", "P")
    assert np.array_equal(png.read_image(path), np.asarray(im.convert("RGB")))
    assert np.array_equal(xvthumb.PALETTE.tobytes(),
                          sys.modules[_plugin("XVTHUMB").__module__].PALETTE)


XV_CASES = {
    "comments": b"P7 332\n#XVVERSION:Version 2.28\n#END\n2 1 255\n\x00\xff",
    "words_on_the_magic_line": b"P7 332 anything\n2 1\n\x01\x02",
    "crlf": b"P7 332\r\n#c\r\n2 1\r\n\x01\x02",
    "spaces_and_tabs": b"P7 332\n 2\t1  3 4\n\x01\x02",
    "size_of_one_word": b"P7 332\n2\n\x01\x02",
    "size_not_a_number": b"P7 332\nx 1\n\x01\x02",
    "size_line_empty": b"P7 332\n\n\x01\x02",
    "underscores_and_sign": b"P7 332\n+1_0 1\n" + bytes(10),
    "eof_in_comments": b"P7 332\n#c\n",
    "magic_alone": b"P7 332",
    "width_0": b"P7 332\n0 1\n\x01",
    "width_negative": b"P7 332\n-2 1\n\x01",
    "rows_cut": b"P7 332\n2 1\n\x01",
    "no_line_feed_after_size": b"P7 332\n2 1",
}


@pytest.mark.parametrize("case", list(XV_CASES))
def test_xvthumb_rules_as_pil(tmp_path, case):
    """Each thumbnail header gives way, fails or reads as PIL's `_open`:
    the end of the file before the size line or a size under 1 gives way;
    a size line of fewer than two words or one not a number fails."""
    data = XV_CASES[case]
    path = _write(tmp_path, data)
    want = _pil(_plugin("XVTHUMB"), path, "B15")
    assert _same(_port(xvthumb.decode_xvthumb, data), want), case


def test_a4_pnm_head_is_pils_accept_and_xv_thumbnails_are_read(tmp_path):
    """A4: `is_pnm` took `P7`, so an XV thumbnail (`P7 332`), which PIL
    opens as `XVThumb`, raised "a PAM file" before XVTHUMB's turn; it is
    PIL's `_accept` on every head `P?` now, and the thumbnail reads as
    PIL's `convert("RGB")`. A PAM file, which no format takes, still raises
    naming PAM."""
    for c in range(256):
        head = b"P" + bytes([c]) + b" 1 1 255\n"
        assert pnm.is_pnm(head) == bool(Image.OPEN["PPM"][1](head)), c
    idx = natural(9, 11, 1, 3)[..., 0]
    path = _write(tmp_path, xvthumb.encode_xvthumb(idx), "x")
    assert not pnm.is_pnm(open(path, "rb").read(68))
    assert np.array_equal(png.read_image(path), np.asarray(Image.open(path).convert("RGB")))
    pam = _write(tmp_path, b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n\0\0\0", "p")
    with pytest.raises(ValueError, match="PAM"):
        png.read_image(pam)
    with pytest.raises(Image.UnidentifiedImageError):
        Image.open(pam)


def test_a5_unknown_ppm_magic_and_empty_size_give_way(tmp_path):
    """A5: PIL's PPM `_open` raises SyntaxError on a magic it does not know
    (`P1abc`, `Py`, `P0`) and `ImageFile` on a size under 1, so the file goes
    on to the next format; the port raised instead. An IM file whose first
    line starts with such a magic reads as the IM PIL opens, a PNM of width
    0 or -3 fails as PIL cannot identify it, and header numbers are read
    by `int` as PIL reads them (`+3`, `1_0`)."""
    gray = natural(3, 4, 1, 2)[..., 0]
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, "IM")
    for first in (b"P1abc: 2\r\n", b"Pyx: 1\r\n", b"P0: 1\r\n"):
        path = _write(tmp_path, first + buf.getvalue())
        assert Image.open(path).format == "IM"
        assert np.array_equal(png.read_image(path), gray)
        with pytest.raises(GiveWay, match="not a PPM file"):
            pnm.decode_pnm(open(path, "rb").read())
    for head in (b"P5 0 2 255\n", b"P5 -3 2 255\n" + bytes(6), b"P4 0 2\n"):
        path = _write(tmp_path, head)
        with pytest.raises(Image.UnidentifiedImageError):
            Image.open(path)
        with pytest.raises(ValueError, match="not a JPEG.*PNM image of"):
            png.read_image(path)
    for head, size in ((b"P5 +3 2 255\n", 6), (b"P5 1_0 1 +255\n", 10)):
        path = _write(tmp_path, head + bytes(range(size)))
        assert np.array_equal(png.read_image(path), np.asarray(Image.open(path)))


# ------------------------------------------------------------------ FITS
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("compress", [False, True], ids=["raw", "gzip_1"])
def test_fits_8bit_equals_pil(tmp_path, compress, size):
    """8-bit FITS images, raw and in PIL's GZIP_1 tile form, padded as the
    standard wants, through `read_image`: PIL's array (rows bottom-up)."""
    w, h = size
    img = natural(h, w, 1, w * 5 + h)[..., 0]
    path = _write(tmp_path, fits.encode_fits(img, compress=compress))
    im = Image.open(path)
    assert (im.format, im.mode) == ("FITS", "L")
    got = png.read_image(path)
    assert np.array_equal(got, np.asarray(im)) and np.array_equal(got, img)


def test_b32_unsigned_16bit_against_a_png_of_the_samples(tmp_path):
    """B32: PIL opens a big-endian 16-bit FITS with BZERO 32768 (unsigned
    samples) as little-endian `I;16` and drops BZERO, so its array differs
    from PIL's reading of the same samples as a 16-bit PNG; the port reads
    the FITS by its definition, raw and GZIP_1, equal to its reading of
    that PNG under B7's rule (the high byte)."""
    u16 = np.random.default_rng(4).integers(0, 65536, (9, 13)).astype(np.uint16)
    oracle = _write(tmp_path, b"", "o.png")
    Image.fromarray(u16).save(oracle)
    want = np.asarray(Image.open(oracle))
    assert np.array_equal(want, u16)
    for compress in (False, True):
        path = _write(tmp_path, fits.encode_fits(u16, compress=compress), "f.fits")
        assert not np.array_equal(np.asarray(Image.open(path)), want)
        got = png.read_image(path)
        assert np.array_equal(got, png.read_image(oracle))
        assert np.array_equal(got, (u16 >> 8).astype(np.uint8))


def test_b32_unpadded_short_data_unit(tmp_path):
    """B32: with a data unit of fewer than 80 bytes not padded to 2880, PIL
    reads from inside the header (its spaces); padded, it reads the samples
    written. The port reads the samples either way."""
    img = natural(3, 5, 1, 1)[..., 0]
    short = _write(tmp_path, fits.encode_fits(img, pad=False), "short")
    padded = _write(tmp_path, fits.encode_fits(img), "padded")
    assert np.array_equal(np.asarray(Image.open(padded)), img)
    assert not np.array_equal(np.asarray(Image.open(short)), img)
    assert (np.asarray(Image.open(short)) == 32).any()
    for path in (short, padded):
        assert np.array_equal(png.read_image(path), img)


def _fits(cards, body=b"", pad=True):
    out = fits._unit([fits._card(k, v) for k, v in cards])
    out += body
    return out + bytes(-len(out) % fits.UNIT) if pad else out


def _image_cards(bits=8, naxes=(3, 2), **extra):
    return [("SIMPLE", True), ("BITPIX", bits), ("NAXIS", len(naxes))] + [
        (f"NAXIS{k + 1}", n) for k, n in enumerate(naxes)] + list(extra.items())


FITS_REFUSED = {
    "bitpix16_signed": (_image_cards(16), 12, "BITPIX 16, BZERO 0"),
    "bitpix16_bscale2": (_image_cards(16, BZERO=32768, BSCALE=2), 12, "BSCALE 2"),
    "bitpix32": (_image_cards(32), 24, "BITPIX 32"),
    "bitpix_minus32": (_image_cards(-32), 24, "B21"),
    "bitpix_minus64": (_image_cards(-64), 48, "B21"),
    "bitpix8_bzero": (_image_cards(8, BZERO=-128), 6, "BZERO -128"),
}


@pytest.mark.parametrize("case", list(FITS_REFUSED))
def test_fits_forms_pil_misreads_refused(tmp_path, case):
    """The forms PIL opens and misreads (B32: byte-swapped, BZERO / BSCALE
    dropped) raise, naming B32 and what the header holds (and B21 for float
    samples)."""
    cards, n, words = FITS_REFUSED[case]
    path = _write(tmp_path, _fits(cards, bytes(range(1, n + 1))))
    assert Image.open(path).format == "FITS"
    with pytest.raises(ValueError, match="B32") as err:
        png.read_image(path)
    assert words in str(err.value)


_GZ = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 8), ("NAXIS2", 1),
       ("ZIMAGE", True), ("ZBITPIX", 8), ("ZNAXIS", 2), ("ZNAXIS1", 3), ("ZNAXIS2", 2)]
_EMPTY = [("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0)]
FITS_CASES = {
    "plain": _fits(_image_cards(), bytes(range(1, 7))),
    "simple_false": _fits([("SIMPLE", False)] + _image_cards()[1:], bytes(6)),
    "no_naxis": _fits([("SIMPLE", True), ("BITPIX", 8)], bytes(6)),
    "no_naxis2": _fits(_image_cards()[:-1], bytes(6)),
    "naxis_not_a_number": _fits([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", "x")], bytes(6)),
    "bitpix_12": _fits(_image_cards(12), bytes(12)),
    "width_0": _fits(_image_cards(naxes=(0, 2)), bytes(6)),
    "header_without_end": fits._unit([fits._card(k, v) for k, v in _image_cards()])[:400],
    "no_data_after_the_header": _fits(_image_cards(), pad=False),
    "no_image": _fits(_EMPTY, bytes(80)),
    "rows_cut": _fits(_image_cards(naxes=(30, 4)), bytes(100), pad=False),
    "one_axis": _fits(_image_cards(naxes=(4,)), bytes(range(4))),
    "cube_c7": _fits(_image_cards(naxes=(3, 2, 2)), bytes(range(12))),
    "image_extension": _fits(_EMPTY) + _fits([("XTENSION", "IMAGE")] + _image_cards()[1:],
                                             bytes(range(6))),
    "gzip_without_zcmptype": _fits(_EMPTY) + _fits(_GZ, bytes(8)),
    "gzip_heap_not_gzip": _fits(_EMPTY) + _fits(_GZ + [("ZCMPTYPE", "GZIP_1")],
                                                bytes(8) + b"not gzip"),
    "gzip_other_compression": _fits(_EMPTY) + _fits(_GZ + [("ZCMPTYPE", "RICE_1")],
                                                    bytes(range(30))),
    "comment_and_slash": _fits(_image_cards() + [("COMMENT", "a / b")], bytes(range(6))),
}


@pytest.mark.parametrize("case", list(FITS_CASES))
def test_fits_rules_as_pil(tmp_path, case):
    """Each FITS header gives way, fails or reads as PIL's `_open` card loop
    and loader: a missing card PIL looks up or a BITPIX it has no mode for
    gives way; a header the file cuts, no image or a number that is not one
    fails; one axis is a column, a cube's first plane is read (C7), an
    image extension after an empty primary is read; a table that is not
    GZIP_1 is read as its raw bytes, as PIL reads it."""
    data = FITS_CASES[case]
    path = _write(tmp_path, data)
    want = _pil(_plugin("FITS"), path)
    assert _same(_port(fits.decode_fits, data), want), case
