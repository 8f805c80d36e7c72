"""The port's X11 bitmap (`io/xbm.py`) and pixmap (`io/xpm.py`) readers on
the CPU, against PIL 12 bit for bit where PIL reads the file right:
PIL-written XBMs (with and without a hotspot) and the port's, XPMs of 2 to
300 colours at 1 to 8 characters a pixel, and the rules PIL reads XPM by
(the first `c` of a colour line, `/* pixels */` skipped once, pixel lines
that run on past a row). Each fault is held to its own oracle: B29 (XBM
literals PIL misreads: one digit, `0X`, an `x` in a comment) to PIL's
reading of the same bytes written in two digits; B25 (XPM `#RGB`,
`#RRRGGGBBB` and `#RRRRGGGGBBBB` colours) to X11's rule, as PIL's reading
of the colours written as `#RRGGBB`; B15 (a palette XPM) and B16 (1 bit) to
PIL's `convert`. The refused forms raise with PIL's cause (an X10 bitmap, a
named colour, a pixel of the `None` colour, too few pixels), the fixtures
of `tests/data/rle_text/` give their recorded digests, and a COLMAP scene
whose masks are 1-bit XBMs equals the JAX reader's on PIL's `convert("L")`
of them through `read_scene`."""

import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, png, xbm, xpm
from tests.test_torch_pnm_tga import _image
from tests.test_torch_readers import _assert_scene_equal, _jpeg_colmap_set
from tests.test_torch_sun_msp_psd import (DIGESTS, _both_raise, _check, _pil, _write,
                                          check_fixture)
from tools.make_rle_text_fixtures_torch import xbm_two_digits, xpm_six_digits

torch.set_num_threads(2)

SIZES = [(1, 1), (3, 2), (17, 9), (131, 41)]                     # (width, height)


def _decode_xbm(data, path="<file>"):
    return xbm.decode_xbm(data, path)


def _decode_xpm(data, path="<file>"):
    return xpm.decode_xpm(data, path)


# ------------------------------------------------------------------ XBM
@pytest.mark.parametrize("hotspot", [None, (1, 0)], ids=["plain", "hotspot"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_xbm_equals_pil(tmp_path, size, hotspot):
    """PIL's XBMs and `encode_xbm`'s (X11's form), with and without a
    hotspot: `read_image` = PIL's `convert("L")` (B16) = the bits written,
    a set bit 255; the header's hotspot is PIL's."""
    w, h = size
    bits = (_image(w, h, 1, w + h)[..., 0] > 120) * np.uint8(255)
    buf = io.BytesIO()
    Image.fromarray(bits > 0).save(buf, "XBM", **({"hotspot": hotspot} if hotspot else {}))
    for data in (buf.getvalue(), xbm.encode_xbm(bits, hotspot=hotspot, per_line=5)):
        assert np.array_equal(_check(tmp_path, data, _decode_xbm, "XBM"), bits)
        assert xbm.header(data)[2] == Image.open(io.BytesIO(data)).info.get("hotspot")


def test_xbm_forms_pil_reads_right(tmp_path):
    """Leading whitespace, CRLF lines, `unsigned` and `static` left out, a
    trailing comma, uppercase digits, two arrays in the first 512 bytes
    (PIL's header regex takes the last `_bits[]`), and bytes past the image
    (not read)."""
    bits = (_image(11, 3, 1, 9)[..., 0] > 120) * np.uint8(255)
    x11 = xbm.encode_xbm(bits, name="a")
    cases = [b" \n\t" + x11, x11.replace(b"\n", b"\r\n"),
             x11.replace(b"static unsigned char", b"char"), x11.replace(b"};", b",};"),
             re.sub(rb"0x([0-9a-f]{2})", lambda m: b"0x" + m.group(1).upper(), x11),
             x11.replace(b"};", b", 0x55, 0x66};"),
             xbm.encode_xbm(255 - bits, name="z") + x11]
    for data in cases:
        assert np.array_equal(_check(tmp_path, data, _decode_xbm, "XBM"), bits)


@pytest.mark.parametrize("case", ["one_digit", "upper_x", "comment_x", "x_before_brace"])
def test_b29_xbm_literals_pil_misreads(tmp_path, case):
    """Fault B29: PIL takes the two characters after every `x` past the
    header for a byte (`0x5,` as 0x50), skips `0X` literals and reads an
    `x` in a comment or before the `{`. `read_xbm` reads each C literal's
    value, PIL's reading of the same bytes in two digits, and the port's
    `_load_image` equals the JAX reader's on that file at -r 1 and 2."""
    bits = (_image(13, 6, 1, 3)[..., 0] > 60) * np.uint8(255)
    bits[0, :3] = [255, 0, 255]
    x11 = xbm.encode_xbm(bits, name="b")
    data = {"one_digit": re.sub(rb"0x0([0-9a-f])\b", rb"0x\1", x11),
            "upper_x": x11.replace(b"0x", b"0X", 3),
            "comment_x": x11.replace(b"{\n", b"{ /* the bits, 0x01 first */\n"),
            "x_before_brace": x11.replace(b"[] = {", b"[] /* xy */ = {")}[case]
    assert data != x11 and xbm_two_digits(data) == xbm_two_digits(x11)
    path = _write(tmp_path, data, "b.xbm")
    got = _check(tmp_path, data, _decode_xbm, "XBM", want=bits)
    oracle = str(tmp_path / "oracle.xbm")
    with open(oracle, "wb") as fh:
        fh.write(xbm_two_digits(data))
    assert np.array_equal(_pil(xbm_two_digits(data)), got)
    try:
        assert not np.array_equal(np.asarray(Image.open(path).convert("L")), got)
    except OSError:                          # PIL runs out of bytes: truncated
        pass
    for resolution in (1, 2):
        a, _ = readers._load_image(path, resolution, None)
        b, _ = readers._load_image(oracle, resolution, None)
        c = np.asarray(Image.open(oracle).convert("L"))
        png_oracle = str(tmp_path / "oracle.png")
        Image.fromarray(c).save(png_oracle)
        d, _ = jreaders._load_image(png_oracle, resolution, None)
        assert np.array_equal(a, b) and a.dtype == d.dtype and np.array_equal(a, d)


def _xbm_refused():
    head = b"#define a_width 10\n#define a_height 2\n"
    return {
        "x10_short": (head + b"static short a_bits[] = {\n0x1234, 0x5678};\n", "X10 bitmap"),
        "x10_unsigned_short": (head + b"static unsigned short a_bits[] = {0x1234, 0x5678};",
                               "X10 bitmap"),
        "decimal": (head + b"static char a_bits[] = {12, 0x01, 0x02, 0x03};", "b'12'"),
        "three_digits": (head + b"static char a_bits[] = {0x123, 0x01, 0x02, 0x03};",
                         "b'0x123'"),
        "double_comma": (head + b"static char a_bits[] = {0x01,, 0x02, 0x03, 0x04};", "b','"),
        "cut": (head + b"static char a_bits[] = {0x01, 0x02, 0x03", "3 of 4 bytes"),
        "no_brace": (head + b"static char a_bits[] = 0x01, 0x02;", "no {"),
    }


@pytest.mark.parametrize("case", list(_xbm_refused()))
def test_xbm_refused_forms_raise(tmp_path, case):
    """An X10 bitmap (16-bit words, which PIL reads a byte a word and so
    misreads or runs out), a literal that is not a byte in hex and an
    array cut short raise, naming the cause."""
    data, words = _xbm_refused()[case]
    _both_raise(tmp_path, data, _decode_xbm, words, pil_raises=case in ("x10_short", "cut",
                                                                         "no_brace"))


# ------------------------------------------------------------------ XPM
@pytest.mark.parametrize("cpp", [None, 2, 3, 8], ids=lambda c: f"cpp{c}")
@pytest.mark.parametrize("colours", [2, 40, 256, 300])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_xpm_equals_pil(tmp_path, size, colours, cpp):
    """`encode_xpm`'s files of 2 to 300 colours (PIL: mode P up to 256,
    expanded as `convert("RGB")`, B15; RGB above) at the fewest characters
    a pixel or 2, 3 and 8: `read_image` = PIL = the colours written."""
    w, h = size
    rng = np.random.default_rng(w + colours)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    idx = rng.integers(0, colours, (h, w))
    data = xpm.encode_xpm(idx, pal, cpp=cpp)
    assert np.array_equal(_check(tmp_path, data, _decode_xpm, "XPM"), pal[idx])


def test_xpm_rules_as_pil(tmp_path):
    """PIL's rules: the first `c` of a colour line after other contexts, a
    key repeated (the last colour, the first place), `/* pixels */` skipped
    once (a second one is no pixels: the text between its quotes), pixel
    lines of other lengths running on across rows, CRLF lines, lines after
    the image unread, an unused `None` colour."""
    pal = np.array([[255, 0, 0], [0, 128, 255], [9, 9, 9]], np.uint8)
    idx = np.array([[0, 1, 2, 0], [2, 1, 0, 1], [1, 1, 2, 2]])
    base = xpm.encode_xpm(idx, pal, cpp=1)
    key0, key1 = base.split(b"\n")[4][1:2], base.split(b"\n")[5][1:2]
    cases = [
        base.replace(b'" c #', b'" m #000000 s name c #', 1),
        base.replace(b"\n", b"\r\n"),
        base.replace(b'/* pixels */\n', b'/* pixels */\n/* a comment */\n'),
        base.replace(b'"\n};', b'",\n"zzzz"\n};'),
        base.replace(b"/* pixels */\n", b'"~ c None",\n/* pixels */\n').replace(
            b'"4 3 3 1"', b'"4 3 4 1"'),
    ]
    for data in cases:
        assert np.array_equal(_check(tmp_path, data, _decode_xpm, "XPM"), pal[idx])
    dup = base.replace(b'"4 3 3 1"', b'"4 3 4 1"').replace(
        b"/* pixels */\n", b'"' + key0 + b' c #0000FF",\n/* pixels */\n')
    blue = pal.copy()
    blue[0] = (0, 0, 255)
    assert np.array_equal(_check(tmp_path, dup, _decode_xpm, "XPM"), blue[idx])
    lines = base.split(b"\n")
    k = lines.index(b"/* pixels */")
    uneven = b"\n".join(lines[:k + 1] + [lines[k + 1][:-2] + lines[k + 2][1:3] + b'",',
                                         b'"' + lines[k + 2][3:]] + lines[k + 3:])
    assert np.array_equal(_check(tmp_path, uneven, _decode_xpm, "XPM"), pal[idx])


@pytest.mark.parametrize("digits", [3, 9, 12])
def test_b25_x11_colours(tmp_path, digits):
    """Fault B25: PIL takes the low 24 bits of an XPM colour's number, so
    `#F00` is (0, 15, 0) and `#FFFF00000000` black. `read_xpm` reads X11's
    rule (the top 8 bits of each third), PIL's reading of the colours
    rewritten as `#RRGGBB`; the port's `_load_image` equals the JAX
    reader's on that file's `convert("RGB")` written as a PNG."""
    assert xpm.x11_colour(b"#F00") == (240, 0, 0)
    assert xpm.x11_colour(b"#FFFF00000000") == (255, 0, 0)
    assert xpm.x11_colour(b"#123456789") == (0x12, 0x45, 0x78)
    assert xpm.x11_colour(b"#a1B2c3") == (0xA1, 0xB2, 0xC3)
    pal = np.random.default_rng(digits).integers(0, 256, (20, 3), dtype=np.uint8)
    idx = np.random.default_rng(1).integers(0, 20, (9, 13))
    data = xpm.encode_xpm(idx, pal, digits=digits)
    want = pal >> 4 << 4 if digits == 3 else pal
    got = _check(tmp_path, data, _decode_xpm, "XPM", want=want[idx])
    assert np.array_equal(got, _pil(xpm_six_digits(data)))
    assert not np.array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), got)
    path = _write(tmp_path, data, "v.xpm")
    oracle = str(tmp_path / "oracle.png")
    Image.open(io.BytesIO(xpm_six_digits(data))).convert("RGB").save(oracle)
    for resolution in (1, 2):
        a, _ = readers._load_image(path, resolution, None)
        b, _ = jreaders._load_image(oracle, resolution, None)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _xpm_refused():
    pal = np.array([[255, 0, 0], [0, 128, 255]], np.uint8)
    base = xpm.encode_xpm(np.array([[0, 1], [1, 0]]), pal, cpp=1)
    key = base.split(b"\n")[4][1:2]
    base2 = xpm.encode_xpm(np.array([[0, 1], [1, 0]]), pal, cpp=2)
    return {
        "named": (base.replace(b"#FF0000", b"red"), "by name", True),
        "none_used": (base.replace(b"#FF0000", b"None"), "the None (transparent) colour",
                      True),
        "no_c": (base.replace(b" c #FF0000", b" m #FF0000"), "has no c colour", True),
        "empty_number": (base.replace(b'"2 2 2 1"', b'"2  2 2 1"'), "empty number", True),
        "four_digits": (base.replace(b"#FF0000", b"#F000"), "none of X11's", False),
        "not_hex": (base.replace(b"#FF0000", b"#GG0000"), "none of X11's", True),
        "unknown_key": (base.replace(b'"' + key, b'"' + b"~", 3)[:], "no colour of the", True),
        "odd_line": (base2.replace(b'/* pixels */\n"', b'/* pixels */\n"x'), "not keys of 2",
                     True),
        "few_pixels": (base.replace(b'"\n};', b'"\n};')[:base.rfind(b'",')] + b"\n",
                       "not enough image data", True),
        "cpp_0": (b'/* XPM */\n"2 2 1 0",\n" c #FF0000",\n"  ",\n"  "\n', "0 characters a pixel",
                  True),
    }


@pytest.mark.parametrize("case", list(_xpm_refused()))
def test_xpm_refused_forms_raise(tmp_path, case):
    """A named colour, a pixel of the `None` colour or of no key, a colour
    line with no `c`, an empty number in the values line, a `#` colour of
    none of X11's lengths or not hex, a pixel line not cut into whole keys
    and too few pixels raise, naming the cause; PIL raises on each but a
    colour of 4 digits (which it misreads: B25)."""
    data, words, pil_raises = _xpm_refused()[case]
    _both_raise(tmp_path, data, _decode_xpm, words, pil_raises)


def test_xpm_give_way(tmp_path):
    """An XPM with no values line, a `c` with no colour after it, or a size
    of 0 gives way (PIL: cannot identify), naming the cause."""
    base = xpm.encode_xpm(np.array([[0, 1]]), np.array([[1, 2, 3], [4, 5, 6]], np.uint8))
    for data, words in ((b"/* XPM */\nstatic char *a[] = {\n};\n", "no values line"),
                        (base.replace(b" c #010203", b" c"), "c with no colour"),
                        (base.replace(b'"2 1 2 1"', b'"0 1 2 1"'), "0x1 pixels")):
        with pytest.raises(ValueError, match="not a JPEG") as err:
            png.read_image(_write(tmp_path, data))
        assert words in str(err.value)
        assert isinstance(_pil(data), Exception)


# ------------------------------------------------------------------ fixtures
@pytest.mark.parametrize("name", sorted(n for n in DIGESTS if n.endswith((".xbm", ".xpm"))))
def test_text_fixtures_give_their_digests(name):
    """Each XBM and XPM fixture of `tests/data/rle_text/` through
    `read_image` gives its recorded digest and shape, and PIL, with the
    recorded rule applied, gives it again here."""
    check_fixture(name)


# ------------------------------------------------------ an XBM mask folder
def test_xbm_mask_folder_matches_jax_on_pil_conversions(tmp_path):
    """A COLMAP scene whose masks (`masks/<name>.png`, read by content) are
    1-bit XBMs at half the image size: `read_scene` with `is_exist_bg`
    equals, at -r 1 and 2, the JAX reader's on the masks rewritten as PIL's
    `convert("L")` (0 and 255, B16); the JAX reader on the XBMs themselves
    gives masks of 0 and 0.0039."""
    root = _jpeg_colmap_set(tmp_path / "s", w=120, h=40)
    masks = os.path.join(root, "masks")
    for i, name in enumerate(sorted(os.listdir(masks))):
        path = os.path.join(masks, name)
        bits = jpeg.read_jpeg(os.path.join(root, "images", name.replace(".png", ".jpg")))
        bits = (bits if bits.ndim == 2 else bits[..., 1])[::2, ::2] > 100 + 10 * i
        with open(path, "wb") as fh:
            fh.write(xbm.encode_xbm(bits))
    kw = [dict(resolution=r, eval_split=True, is_exist_bg=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    faulty = jreaders.read_scene(root, **kw[0])
    assert max(c.mask.max() for c in faulty.train_cameras) == np.float32(1 / 255)
    for name in os.listdir(masks):
        path = os.path.join(masks, name)
        Image.open(path).convert("L").save(path, "PNG")
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))
    assert max(c.mask.max() for c in got[0].train_cameras) == 1.0
