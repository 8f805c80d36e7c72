"""The port's PNM (`io/pnm.py`) and TGA (`io/tga.py`) readers on the CPU,
against PIL 12 bit for bit: PIL-written files of every mode PIL writes at
1x1 to 257x131, the forms PIL reads and does not write (ASCII samples with
comments, maxvals other than 255, 16-bit pixels and colour maps, every
corner of origin, an ID field, literal packets over rows), TGA's RLE
walked by the C++ and the plain version to the same bytes or the same
error on damaged streams, the refused forms raising with their cause, and
faults B19 (16-bit gray) and B20 (a TGA descriptor with no alpha bits)
held to the JAX `_load_image` of PIL's converted image written as a PNG.
A palette image is held to PIL's `convert("RGB")` (B15), a 1-bit one to
its `convert("L")` (B16)."""

import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import png, pnm, tga

torch.set_num_threads(2)

SIZES = [(1, 1), (17, 9), (131, 257), (257, 131)]          # (width, height)


def _image(w, h, c, seed):
    """Seeded noise with flat patches (runs) and a gradient (small steps)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[: h // 2, : w // 2] = img[0, 0]
    img[h // 2:, w // 2:] = (np.arange(w - w // 2, dtype=np.uint8)[None, :, None] * 3
                             + np.arange(h - h // 2, dtype=np.uint8)[:, None, None])
    return img


def _pil(path):
    """PIL's array of a file with the port's rule (B15, B16, B19) applied,
    or the exception PIL raises."""
    try:
        im = Image.open(path)
        if im.mode == "P":
            return np.asarray(im.convert("RGBA" if im.palette.mode == "RGBA" else "RGB"))
        if im.mode == "1":
            return np.asarray(im.convert("L"))
        if im.mode == "I":
            return (np.asarray(im).astype(np.int64) >> 8).astype(np.uint8)
        return np.asarray(im)
    except Exception as err:          # PIL raises OSError, ValueError, SyntaxError
        return err


def _port(decode, data, path="<file>"):
    try:
        return decode(data, path)
    except ValueError as err:
        return str(err)


def _check(tmp_path, data, plain, name="f", want=None):
    """`read_image` of `data` (C++) = `plain` of it = PIL (or `want`) ->
    the array."""
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    got = png.read_image(path)
    assert got.dtype == np.uint8
    assert np.array_equal(plain(data), got)
    want = _pil(path) if want is None else want
    assert isinstance(want, np.ndarray), want
    assert got.shape == want.shape and np.array_equal(got, want), (got.shape, want.shape)
    return got


def _both_raise(tmp_path, data, plain, words, pil_raises=True):
    """`read_image` and `plain` raise the same ValueError naming `words`;
    PIL raises too."""
    path = str(tmp_path / "bad")
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(ValueError) as err:
        png.read_image(path)
    native = str(err.value).replace(path, "<file>")
    assert words in native, native
    assert _port(plain, data) == native
    if pil_raises:
        assert isinstance(_pil(path), Exception)
    return native


def _pil_bytes(img, fmt, convert=None, **kw):
    im = Image.fromarray(img)
    buf = io.BytesIO()
    (im.convert(convert) if convert else im).save(buf, fmt, **kw)
    return buf.getvalue()


# ------------------------------------------------------------------ PNM
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["1", "L", "I;16", "RGB"])
def test_pnm_equals_pil(tmp_path, mode, size):
    """PIL's P4, P5 (8- and 16-bit: B19's high byte) and P6 files."""
    img = _image(*size, 3, seed=size[0] + 7 * size[1])
    arr = {"1": img[..., 0] > 127, "L": img[..., 0], "RGB": img,
           "I;16": img[..., 0].astype(np.uint16) * 257 + img[..., 1] % 5}[mode]
    data = _pil_bytes(arr, "PPM")
    assert data[:2] == {"1": b"P4", "L": b"P5", "I;16": b"P5", "RGB": b"P6"}[mode]
    _check(tmp_path, data, pnm.decode_pnm)


ASCII = {
    "p1_no_spaces": b"P1\n# c\n4 2\n0110#x\n1\n001",
    "p1_spaces": b"P1 4 2 0 1 1 0 1 0 0 1 ",
    "p2_comments_maxval100": b"P2\n3 2\n# max\n100\n0 50 100\n#mid\n25 75 99\n",
    "p2_token_joined_over_a_comment": b"P2 3 1 255 12#c\n3 4 5",
    "p2_maxval1000_b19": b"P2 3 1 1000 0 500 1000",
    "p2_maxval65535_b19": b"P2 3 1 65535 0 32767 65535",
    "p3_maxval7": b"P3 2 1 7 0 3 7 1 2 4",
    "p3_crlf_tabs": b"P3\r\n2\t1\r\n255\r\n1\t2 3\r\n4 5 6\r\n",
    "p3_extra_samples": b"P3 1 1 255 9 8 7 6 5",
}


@pytest.mark.parametrize("case", list(ASCII))
def test_pnm_ascii_forms_equal_pil(tmp_path, case):
    """ASCII samples: comments anywhere (cut out with their line end, so a
    token split by one joins up, as PIL does), P1 digits without spaces,
    maxvals other than 255 scaled as PIL scales them."""
    _check(tmp_path, ASCII[case], pnm.decode_pnm)


@pytest.mark.parametrize("maxval", [1, 7, 100, 254, 256, 1000, 65534, 65535])
@pytest.mark.parametrize("magic", [b"P5", b"P6"])
def test_pnm_raw_maxvals_equal_pil(tmp_path, magic, maxval):
    """Raw samples of each maxval, samples over it included (PIL clips
    them): round(v / maxval * 255) with Python's rounding; gray over 255 as
    B19's high byte of PIL's 0-65535."""
    c = 3 if magic == b"P6" else 1
    rng = np.random.default_rng(maxval)
    v = rng.integers(0, min(65536, maxval + 3), 5 * 7 * c)
    body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    _check(tmp_path, magic + b" 7 5 %d\n" % maxval + body, pnm.decode_pnm)


def test_pnm_writer_decoded_by_pil(tmp_path):
    """`encode_pnm`'s P1-P6 at 8 and 16 bits read back by PIL."""
    img = _image(13, 6, 3, 3)
    wide = img[..., 0].astype(np.uint16) * 200
    for arr, kw in ((img, {}), (img, {"ascii": True}), (img[..., 0], {}),
                    (img[..., 0], {"ascii": True}), (wide, {"maxval": 60000}),
                    (wide, {"maxval": 60000, "ascii": True}), (img[..., 0] > 99, {}),
                    (img[..., 0] > 99, {"ascii": True})):
        got = _check(tmp_path, pnm.encode_pnm(arr, **kw), pnm.decode_pnm)
        if arr.dtype == np.uint8:
            assert np.array_equal(got, arr)


PNM_REFUSED = {
    "pfm_b21": (b"Pf\n1 1\n-1.0\n" + bytes(4), "fault B21", False),
    "pillow_pyp": (b"PyP 1 1 255 \x00", "PyP", False),
    "pillow_pyrgba": (b"PyRGBA 1 1 255 \x00\x00\x00\x00", "PyRGBA", False),
    "pillow_pycmyk": (b"PyCMYK 1 1 255 \x00\x00\x00\x00", "PyCMYK", False),
    "p0cmyk": (b"P0CMYK 1 1 255 \x00\x00\x00\x00", "P0CMYK", False),
    "pam_p7": (b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n\0\0\0", "PAM", True),
    "p6_cut": (b"P6 2 2 255 " + bytes(11), "cut short", True),
    "p4_cut": (b"P4 9 2 " + bytes(3), "cut short", True),
    "p3_short": (b"P3 2 1 255 1 2 3 4 5", "not enough image data", True),
    "p3_over_maxval": (b"P3 1 1 255 1 2 256", "over maxval", True),
    "p3_letter": (b"P3 1 1 255 1 x 3", "not a sample", True),
    "p1_other_digit": (b"P1 2 1 0 2", "not 0 or 1", True),
    "header_token_too_long": (b"P6 00000000001 1 255 \0\0\0", "too long", True),
    "sample_token_too_long": (b"P3 1 1 255 00000000001 2 3", "too long", True),
    "maxval_0": (b"P2 1 1 0 0", "maxval 0", True),
    "maxval_65536": (b"P5 1 1 65536 \0\0", "maxval 65536", True),
    "header_ends": (b"P6 2 ", "header ends early", True),
}


@pytest.mark.parametrize("case", list(PNM_REFUSED))
def test_pnm_refused_forms_raise(tmp_path, case):
    """PIL's other magics (PFM: fault B21; Pillow's own; CMYK) and PAM's P7,
    which PIL does not read, and damaged files: a ValueError naming the
    cause (PIL raises on the damaged ones too)."""
    data, words, pil_raises = PNM_REFUSED[case]
    _both_raise(tmp_path, data, pnm.decode_pnm, words, pil_raises)


# ------------------------------------------------------------------ TGA
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kw", [{}, {"rle": True}, {"orientation": 1},
                                {"rle": True, "orientation": 1}],
                         ids=["raw", "rle", "top", "rle_top"])
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
def test_tga_equals_pil(tmp_path, mode, kw, size):
    """PIL's TGAs of every mode it writes, raw and RLE, bottom-up and
    top-down (PIL cannot read back its own 1-bit RLE files, and the port
    refuses them with that cause)."""
    img = _image(*size, 4, seed=size[0] * 3 + size[1])
    arr = {"1": img[..., 0] > 127, "L": img[..., 0], "LA": img[..., :2],
           "P": img[..., :3], "RGB": img[..., :3], "RGBA": img}[mode]
    data = _pil_bytes(arr, "TGA", convert="P" if mode == "P" else None, **kw)
    if mode == "1" and kw.get("rle"):
        _both_raise(tmp_path, data, tga.decode_tga_plain, "1-bit RLE TGA")
        return
    _check(tmp_path, data, tga.decode_tga_plain)


def _head(w, h, kind, depth, desc, cmap=b"", first=0, map_depth=0, ident=b"", n=None):
    n = (len(cmap) // (map_depth // 8) if cmap else 0) if n is None else n
    return struct.pack("<BBBHHBHHHHBB", len(ident), int(bool(cmap) or n > 0), kind, first,
                       n, map_depth, 0, 0, w, h, depth, desc) + ident + cmap


def _rle(px: np.ndarray) -> bytes:
    """Pixel rows (H, W, B) -> RLE packets: a literal packet for the first
    half of each row, repeated packets of each pixel for the rest."""
    out = bytearray()
    for row in px:
        half = len(row) // 2
        if half:
            out += bytes([half - 1]) + row[:half].tobytes()
        for p in row[half:]:
            out += bytes([0x80]) + p.tobytes()
    return bytes(out)


@pytest.mark.parametrize("corner", [0x00, 0x10, 0x20, 0x30],
                         ids=["bottom_left", "bottom_right", "top_left", "top_right"])
@pytest.mark.parametrize("form", ["16bit", "16bit_rle", "24bit_id", "32bit_rle",
                                  "gray_rle", "map24_first5", "map16_rle"])
def test_tga_hand_forms_equal_pil(tmp_path, form, corner):
    """The forms PIL reads and does not write, at each corner of origin:
    16-bit 1-5-5-5 pixels (1 alpha bit), an ID field, 32-bit RLE, colour
    maps of 24 bits with a first entry of 5 and of 16 bits with alpha."""
    rng = np.random.default_rng(corner + len(form))
    w, h = 11, 6
    if form.startswith("16bit"):
        px = rng.integers(0, 65536, (h, w)).astype("<u2").view(np.uint8).reshape(h, w, 2)
        kind, depth, extra = 2, 16, dict()
        desc = corner | 1
    elif form == "24bit_id":
        px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        kind, depth, extra, desc = 2, 24, dict(ident=b"camera 7"), corner
    elif form == "32bit_rle":
        px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        kind, depth, extra, desc = 2, 32, dict(), corner | 8
    elif form == "gray_rle":
        px = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        kind, depth, extra, desc = 3, 8, dict(), corner
    elif form == "map24_first5":
        px = rng.integers(0, 60, (h, w, 1), dtype=np.uint8)
        cmap = rng.integers(0, 256, 3 * 50, dtype=np.uint8).tobytes()
        kind, depth, desc = 1, 8, corner
        extra = dict(cmap=cmap, first=5, map_depth=24)
    else:
        px = rng.integers(0, 30, (h, w, 1), dtype=np.uint8)
        cmap = rng.integers(0, 65536, 30).astype("<u2").tobytes()
        kind, depth, desc = 1, 8, corner | 1
        extra = dict(cmap=cmap, map_depth=16)
    rle = "rle" in form
    body = _rle(px) if rle else px.tobytes()
    data = _head(w, h, kind + 8 * rle, depth, desc, **extra) + body
    _check(tmp_path, data, tga.decode_tga_plain)


def test_tga_literal_packets_run_over_rows(tmp_path):
    """A literal packet may run on into the next rows (and past the last
    pixel, the rest read and dropped), as PIL reads it."""
    data = _head(5, 3, 11, 8, 0x20) + bytes([11]) + bytes(range(40, 52)) + bytes(
        [0x80 + 2, 9])
    assert np.array_equal(_check(tmp_path, data, tga.decode_tga_plain),
                          [[40, 41, 42, 43, 44], [45, 46, 47, 48, 49], [50, 51, 9, 9, 9]])
    data = _head(5, 1, 11, 8, 0x20) + bytes([9]) + bytes(range(10))
    _check(tmp_path, data, tga.decode_tga_plain)


def test_tga_writer_decoded_by_pil(tmp_path):
    """`encode_tga`: gray, gray + alpha, RGB, RGBA, 16-bit and colour-mapped,
    raw and RLE, at each corner, read by PIL as written (16-bit: each value's
    top 5 bits, widened)."""
    img = _image(19, 7, 4, 11)
    pal = np.random.default_rng(0).integers(0, 256, (40, 3), dtype=np.uint8)
    idx = (img[..., 0] % 40).astype(np.uint8)
    for rle in (False, True):
        for top, right in ((False, False), (True, True), (False, True), (True, False)):
            kw = dict(rle=rle, top_down=top, right_to_left=right)
            for arr in (img[..., 0], img[..., :2], img[..., :3], img):
                assert np.array_equal(_check(tmp_path, tga.encode_tga(arr, **kw),
                                             tga.decode_tga_plain), arr)
            got = _check(tmp_path, tga.encode_tga(idx, palette=pal, **kw),
                         tga.decode_tga_plain)
            assert np.array_equal(got, pal[idx])
            got = _check(tmp_path, tga.encode_tga(img, bits16=True, **kw),
                         tga.decode_tga_plain)
            assert np.array_equal(got[..., :3], (img[..., :3] >> 3).astype(np.int32)
                                  * 255 // 31)
            assert np.array_equal(got[..., 3], np.where(img[..., 3] < 128, 0, 255))


def _outcome(decode, data):
    try:
        return decode(data)
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("depth", [8, 24, 32])
def test_tga_damaged_rle_as_plain_and_pil(tmp_path, depth):
    """64 damaged RLE streams (bytes changed, or cut) per depth: the C++
    walk gives the plain one's bytes or raises its error, and PIL decodes
    the same array or raises too."""
    rng = np.random.default_rng(depth)
    img = _image(9, 7, 4, depth)
    arr = {8: img[..., 0], 24: img[..., :3], 32: img}[depth]
    data = tga.encode_tga(arr, rle=True)
    path = str(tmp_path / "d.tga")
    for k in range(64):
        b = bytearray(data)
        if k % 3 == 0:
            b = b[:rng.integers(18, len(b))]
        else:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(18, len(b))] = rng.integers(0, 256)
        b = bytes(b)
        native, plain = _outcome(tga.decode_tga, b), _outcome(tga.decode_tga_plain, b)
        assert type(native) is type(plain), k
        assert (native == plain) if isinstance(native, str) else np.array_equal(native, plain)
        with open(path, "wb") as fh:
            fh.write(b)
        want = _pil(path)
        assert isinstance(want, Exception) == isinstance(native, str), (k, native)
        if not isinstance(native, str):
            assert np.array_equal(native, want), k


TGA_REFUSED = {
    "depth15": (_head(2, 2, 2, 15, 0x20) + bytes(8), "not a", True),
    "map15": (_head(2, 1, 1, 8, 0x20, bytes(6), 0, 15) + bytes(2), "not a", True),
    "map32": (_head(2, 1, 1, 8, 0x20, bytes(8), 0, 32) + bytes(2), "32-bit colour map", True),
    "map_past_255": (_head(2, 1, 1, 8, 0x20, bytes(3 * 40), 217, 24) + bytes(2),
                     "past entry 255", True),
    "true_colour_with_map": (_head(2, 1, 2, 24, 0x20, bytes(6), 0, 24) + bytes(6),
                             "with a colour map", True),
    "1bit_with_map": (_head(9, 1, 3, 1, 0x20, bytes(4), 0, 16) + bytes(2),
                      "with a colour map", True),
    "mapped_without_map": (_head(2, 2, 1, 8, 0x20, ident=b"x") + bytes(4),
                           "without a colour map", True),
    "mapped_16bit": (_head(2, 2, 1, 16, 0x20, bytes(6), 0, 24) + bytes(8), "cannot load",
                     True),
    "true_colour_8bit": (_head(2, 2, 2, 8, 0x20) + bytes(4), "cannot load", True),
    "gray_24bit": (_head(2, 2, 3, 24, 0x20) + bytes(12), "cannot load", True),
    "rle_1bit": (_head(16, 1, 11, 1, 0x20) + bytes([0x81, 0xF0]), "1-bit RLE", True),
    "run_over_row_end": (_head(3, 2, 11, 8, 0x20) + bytes([0x84, 7, 0x00, 9]),
                         "crosses the end of its row", True),
    "raw_cut": (_head(3, 2, 3, 8, 0x20) + bytes(5), "cut short", True),
    "rle_cut": (_head(3, 2, 11, 8, 0x20) + bytes([0x82, 7, 0x02, 1]), "cut short", True),
    "map_cut": (_head(2, 1, 1, 8, 0x20, n=40, map_depth=24) + bytes(30), "cut short", True),
}


@pytest.mark.parametrize("case", list(TGA_REFUSED))
def test_tga_refused_forms_raise(tmp_path, case):
    """The TGAs PIL does not identify (15-bit pixels or maps) or cannot load,
    and damaged files: the same ValueError, naming the cause, through both
    routes; PIL raises on each."""
    data, words, pil_raises = TGA_REFUSED[case]
    plain = (lambda d, p: png.read_image(p)) if words == "not a" else tga.decode_tga_plain
    path = str(tmp_path / "bad")
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(ValueError, match=words):
        png.read_image(path)
    if words != "not a":
        _both_raise(tmp_path, data, plain, words, pil_raises)
    assert isinstance(_pil(path), Exception)


def test_tga_dispatch_follows_pil_order(tmp_path):
    """TGA has no magic: a header PCX's check takes (ID length 10, version
    byte 0) goes to PCX as in PIL (which raises "unknown PCX mode"; so does
    the port), unless the file is under the 68 bytes PCX reads (PIL then
    goes on to TGA, and so does the port); one CUR's check takes with no
    cursors goes on to TGA as in PIL; so does one ICO's takes with no
    entries, a colour-mapped TGA without a colour map, which PIL opens as a
    TGA and cannot load, and the port refuses."""
    px = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    for size, pcx in ((4, True), (2, False)):
        data = _head(size, size, 2, 24, 0x20, ident=b"0123456789") + px[:size, :size].tobytes()
        assert tga.tga_header(data) is not None and (len(data) >= 68) == pcx
        if pcx:
            path = str(tmp_path / "a")
            with open(path, "wb") as fh:
                fh.write(data)
            with pytest.raises(ValueError, match="unknown PCX mode"):
                png.read_image(path)
            assert "PCX" in str(_pil(path))
        else:
            got = _check(tmp_path, data, tga.decode_tga_plain)
            assert np.array_equal(got, px[:size, :size, ::-1])
    cur_like = _head(2, 2, 2, 24, 0x20) + px[:2, :2].tobytes()
    assert cur_like[:4] == b"\0\0\2\0"
    assert np.array_equal(_check(tmp_path, cur_like, tga.decode_tga_plain),
                          px[:2, :2, ::-1])
    assert Image.open(str(tmp_path / "f")).format == "TGA"
    ico_like = _head(2, 2, 1, 8, 0x20) + bytes(4)
    assert ico_like[:4] == b"\0\0\1\0"
    path = str(tmp_path / "i")
    with open(path, "wb") as fh:
        fh.write(ico_like)
    with pytest.raises(ValueError, match="colour-mapped TGA without a colour map"):
        png.read_image(path)
    assert Image.open(path).format == "TGA"
    assert isinstance(_pil(path), Exception)


# ------------------------------------------------------------ B19 and B20
def _jax_oracle(tmp_path, arr, resolution):
    """The JAX `_load_image` of `arr` written as a PNG by PIL."""
    oracle = str(tmp_path / "oracle.png")
    Image.fromarray(arr).save(oracle)
    return jreaders._load_image(oracle, resolution, None)


@pytest.mark.parametrize("resolution", [1, 2])
@pytest.mark.parametrize("form", ["p5_65535", "p5_1000", "p2_4095"])
def test_b19_16bit_gray_loads_as_its_high_byte(tmp_path, form, resolution):
    """Fault B19: a PGM of maxval over 255 loads as the high byte of PIL's
    0-65535 value (the JAX reader's `/ 255.0` gives values up to 257),
    equal to the JAX `_load_image` of that byte written as an 8-bit PNG;
    the JAX reader's own image is out of [0, 1]."""
    rng = np.random.default_rng(resolution)
    maxval = {"p5_65535": 65535, "p5_1000": 1000, "p2_4095": 4095}[form]
    v = rng.integers(0, maxval + 1, (12, 18)).astype(np.uint16)
    data = pnm.encode_pnm(v, ascii=form.startswith("p2"), maxval=maxval)
    path = str(tmp_path / "g.pgm")
    with open(path, "wb") as fh:
        fh.write(data)
    high = _pil(path)
    assert np.array_equal(png.read_image(path), high)
    got_img, got_mask = readers._load_image(path, resolution, None)
    want_img, want_mask = _jax_oracle(tmp_path, high, resolution)
    assert got_img.dtype == want_img.dtype and np.array_equal(got_img, want_img)
    assert got_mask is None and want_mask is None
    if resolution == 1:
        assert jreaders._load_image(path, 1, None)[0].max() > 1.0


@pytest.mark.parametrize("resolution", [1, 2])
@pytest.mark.parametrize("form", ["32bit", "32bit_rle", "16bit", "la"])
def test_b20_no_alpha_bits_loads_without_alpha(tmp_path, form, resolution):
    """Fault B20: a TGA whose descriptor counts no alpha bits loads with no
    alpha and no mask (PIL takes the fourth byte, bit 15 or the second
    channel as alpha anyway), equal to the JAX `_load_image` of PIL's array
    with the alpha dropped, written as a PNG; the JAX reader's own load of
    the file has a mask."""
    img = _image(18, 12, 4, resolution)
    img[..., 3] = 0                                    # the fourth byte unused
    if form.startswith("32bit"):
        data = tga.encode_tga(img, rle=form.endswith("rle"), alpha_bits=0)
    elif form == "16bit":
        data = tga.encode_tga(img, bits16=True, alpha_bits=0)
    else:
        data = tga.encode_tga(img[..., :2], alpha_bits=0)
    path = str(tmp_path / "v.tga")
    with open(path, "wb") as fh:
        fh.write(data)
    pil = np.asarray(Image.open(path))
    dropped = np.ascontiguousarray(pil[..., 0] if form == "la" else pil[..., :3])
    assert np.array_equal(png.read_image(path), dropped)
    got_img, got_mask = readers._load_image(path, resolution, None)
    want_img, want_mask = _jax_oracle(tmp_path, dropped, resolution)
    assert got_img.dtype == want_img.dtype and np.array_equal(got_img, want_img)
    assert got_mask is None and want_mask is None
    jax_img, jax_mask = jreaders._load_image(path, resolution, None)
    if form == "la":                               # fault A2 as well
        assert jax_img.shape[0] == 2
    else:
        assert jax_mask is not None and jax_mask.max() == 0.0
