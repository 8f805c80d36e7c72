"""The port's readers of containers of forms it already reads, on the CPU,
against PIL 12 bit for bit: DIB (`io/bmp.py`: a BMP without its file
header), ICO and CUR (`io/ico.py`: BMP or PNG frames in a directory), DCX
(`io/pcx.py`: PCX pages) and ICNS (`io/icns.py`: PNG sub-images and the
run-length `it32` / `ih32` / `il32` / `is32` images with their masks).
PIL-written files of every mode PIL writes, the forms PIL reads and does
not write (the entry choice's ties, CUR's width byte of 0 read as 0, a
32-bit cursor at byte 22, DCX offset tables, ICNS merges), the port's
writers read by PIL, `gm_icns_rle` equal to its plain walk on damaged
streams (the same bytes or the same error, PIL decoding or raising
alike), the refused forms raising with their cause, `read_image`'s order
of formats and its give-way rule, fault B23 (a 32-bit icon frame of zero
fourth bytes) held to the JAX `_load_image` of PIL's RGB and the AND
mask's alpha written as a PNG, the fixtures of `tests/data/containers/`
through both routes against their recorded digests, and a COLMAP scene of
DIB, ICO, CUR and DCX views through `read_scene` against the JAX reader,
exactly (no tolerance: the same arrays, dtypes and masks), with no plain
piece reached. A palette image is held to PIL's `convert("RGB")` (B15), a
1-bit one to its `convert("L")` (B16)."""

import hashlib
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import bmp, icns, ico, jpeg, pcx, png, tga
from tests.test_torch_pnm_tga import _head, _image
from tests.test_torch_readers import _assert_scene_equal, _jpeg_colmap_set

torch.set_num_threads(2)

CONTAINERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "containers")
SIZES = [(1, 1), (17, 9), (131, 200)]                     # (width, height); ICO: <= 256
PLAIN = {".dib": bmp.decode_dib_plain, ".ico": ico.decode_ico_plain,
         ".cur": ico.decode_cur_plain, ".dcx": pcx.decode_dcx_plain,
         ".icns": icns.decode_icns_plain}


def _pil(path):
    """PIL's array of a file with the port's rule (B15, B16) applied, or the
    exception PIL raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # ICO: "Image was not the expected size"
            im = Image.open(path)
            im.load()
        if im.mode == "P":
            rgba = im.palette.mode == "RGBA" or "transparency" in im.info
            return np.asarray(im.convert("RGBA" if rgba else "RGB"))
        if im.mode == "1":
            return np.asarray(im.convert("L"))
        return np.asarray(im)
    except Exception as err:          # PIL raises OSError, ValueError, SyntaxError, KeyError
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


def _check(tmp_path, data, plain, want=None):
    """`read_image` of `data` (C++) = `plain` of it = PIL (or `want`) -> the
    array."""
    path = _write(tmp_path, data)
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
    path = _write(tmp_path, data, "bad")
    with pytest.raises(ValueError) as err:
        png.read_image(path)
    native = str(err.value).replace(path, "<file>")
    assert words in native, native
    assert _outcome(plain, data) == native
    if pil_raises:
        assert isinstance(_pil(path), Exception)
    return native


def _pil_bytes(img, fmt, convert=None, **kw):
    im = Image.fromarray(img)
    buf = io.BytesIO()
    (im.convert(convert) if convert else im).save(buf, fmt, **kw)
    return buf.getvalue()


def _mask(h, w, seed):
    return np.random.default_rng(seed).random((h, w)) < 0.4


def _banded(h, w, c, seed):
    """Steps of 24 and a 5 % speckle: runs and literals for run-length codes."""
    img = _image(w, h, c, seed) // 24 * 24
    spots = np.random.default_rng(seed).random((h, w)) < 0.05
    img[spots] = 7
    return img


# ------------------------------------------------------------------ DIB
@pytest.mark.parametrize("size", SIZES + [(257, 131)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "1"])
def test_dib_equals_pil(tmp_path, mode, size):
    """PIL's DIBs of every mode it writes (RGBA as 32-bit BI_RGB, which PIL
    reads back as RGB; palettes B15 / B16), read by `read_image` as DIBs."""
    img = _image(*size, 4, seed=size[0] + 3 * size[1])
    data = _pil_bytes(img, "DIB", convert=mode)
    assert bmp.dib_accept(data) and data[:2] != b"BM"
    _check(tmp_path, data, bmp.decode_dib_plain)


@pytest.mark.parametrize("size", SIZES + [(257, 131)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_dib_writer_read_by_pil(tmp_path, size):
    """`encode_dib`: 24-bit, 32-bit BI_RGB (PIL: RGB) and 32-bit
    BI_BITFIELDS with an alpha mask (PIL: RGBA), as written."""
    img = _image(*size, 4, seed=size[0])
    assert np.array_equal(_check(tmp_path, bmp.encode_dib(img[..., :3]),
                                 bmp.decode_dib_plain), img[..., :3])
    assert np.array_equal(_check(tmp_path, bmp.encode_dib(img), bmp.decode_dib_plain),
                          img[..., :3])
    assert np.array_equal(_check(tmp_path, bmp.encode_dib(img, bitfields=True),
                                 bmp.decode_dib_plain), img)


def test_dib_rle_and_40_byte_bitfields_equal_pil(tmp_path):
    """A DIB of RLE8 data (the BMP writer's, its file header cut off) and a
    32-bit DIB whose 40-byte BI_BITFIELDS header is followed by its three
    masks: the pixels start after the masks, as PIL finds them."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 9, (12, 19), dtype=np.uint8)
    idx[:, 4:12] = 3
    pal = rng.integers(0, 256, (9, 3), dtype=np.uint8)
    _check(tmp_path, bmp.encode_bmp(idx, pal, 8, rle=True)[14:], bmp.decode_dib_plain)
    img = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    body = np.ascontiguousarray(img[::-1]).tobytes()
    head = struct.pack("<IiiHHIIiiII", 40, 7, 5, 1, 32, 3, len(body), 0, 0, 0, 0)
    masks = struct.pack("<III", 0xFF000000, 0xFF0000, 0xFF00)    # XBGR
    got = _check(tmp_path, head + masks + body, bmp.decode_dib_plain)
    assert np.array_equal(got, img[..., [3, 2, 1]])


# ------------------------------------------------------------------ ICO
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "1"])
@pytest.mark.parametrize("form", ["png", "bmp"])
def test_ico_equals_pil(tmp_path, form, mode, size):
    """PIL's ICOs of PNG frames and of BMP frames (24 bits with an AND mask,
    32 bits, 8 and 1 bits: RGBA, the palette expanded as PIL's
    `convert("RGBA")` expands it)."""
    img = _image(*size, 4, seed=size[0] + 5 * size[1])
    img[0, 0, 3] = 200                # an alpha of 0 everywhere is B23's (its own test)
    kw = dict(bitmap_format="bmp") if form == "bmp" else {}
    data = _pil_bytes(img if mode != "P" else img[..., :3], "ICO", convert=mode,
                      sizes=[size], **kw)
    got = _check(tmp_path, data, ico.decode_ico_plain)
    if form == "bmp":
        assert got.shape == (size[1], size[0], 4)


def test_ico_three_sizes_opens_the_largest(tmp_path):
    """PIL's ICO of 16, 32 and 48 px frames: the 48 px one."""
    img = _image(48, 48, 4, seed=2)
    got = _check(tmp_path, _pil_bytes(img, "ICO", sizes=[(16, 16), (32, 32), (48, 48)]),
                 ico.decode_ico_plain)
    assert got.shape == (48, 48, 4)


def _ico_cases():
    rng = np.random.default_rng(7)
    rgb, rgba = _image(23, 17, 3, 1), _image(23, 17, 4, 2)
    mask = _mask(17, 23, 3)
    pal = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    idx = (rgb[..., 0] % 40).astype(np.uint8)
    two = np.array([[10, 20, 30], [200, 100, 0]], np.uint8)
    return {
        "bmp24_mask": [dict(img=rgb, mask=mask)],
        "bmp32_alpha": [dict(img=rgba)],
        "bmp32_alpha_and_a_mask": [dict(img=rgba, mask=mask)],
        "bmp8_palette_mask": [dict(img=idx, palette=pal, mask=mask)],
        "bmp8_gray_ramp": [dict(img=rgb[..., 0], palette=np.repeat(
            np.arange(256, dtype=np.uint8)[:, None], 3, 1), mask=mask)],
        "bmp8_two_colours": [dict(img=(idx % 2).astype(np.uint8), palette=two, mask=mask)],
        "png_rgb": [dict(img=rgb, form="png")],
        "png_rgba_dir_0x0": [dict(img=rgba, form="png", size=(0, 0))],
        "png_gray": [dict(img=rgb[..., 0], form="png")],
        "bmp_wide_300x9": [dict(img=_image(300, 9, 3, 4), mask=_mask(9, 300, 5))],
        "tie_depth_24_before_32": [dict(img=rgba), dict(img=rgb, mask=mask)],
        "tie_depth_8_before_24": [dict(img=rgb, mask=mask),
                                  dict(img=idx, palette=pal, mask=~mask)],
        "tie_order_first_kept": [dict(img=rgb, mask=mask), dict(img=rgb[::-1], mask=~mask)],
        "largest_area_first": [dict(img=rgb[:5, :5], mask=mask[:5, :5]),
                               dict(img=rgb, mask=mask), dict(img=rgb[:9], mask=mask[:9])],
        "png_beside_bmp_larger_area": [dict(img=rgb[:8], mask=mask[:8]),
                                       dict(img=rgba, form="png")],
        "no_bpp_colour_count_16": [dict(img=rgb, mask=mask),
                                   dict(img=idx, palette=pal, mask=~mask, bpp=0)],
        "no_bpp_colour_count_1": [dict(img=idx, palette=pal, mask=mask, bpp=0),
                                  dict(img=rgb, mask=~mask)],
        "size_field_larger": [dict(img=rgb, mask=mask, size_field=17 * 4 + 40 + 17 * 72)],
        "mask_short_by_its_last_row_padding": [dict(img=rgb, mask=mask,
                                                     size_field=40 + 17 * 72 + 17 * 4 - 3)],
    }


@pytest.mark.parametrize("case", list(_ico_cases()))
def test_ico_hand_forms_equal_pil(tmp_path, case):
    """`encode_ico`'s frames and directories: masks, palettes (a gray ramp
    and black and white too), 32-bit alpha with and without a mask, PNG
    frames at their own size, a 300 px BMP frame, the entry choice (area,
    then depth, then order; no bit count: the colour count's log2, or 256
    for a count of 1), a size field past the frame (the mask found from
    it)."""
    frames = _ico_cases()[case]
    data = bytearray(ico.encode_ico(frames))
    if case.startswith("mask_short"):         # the file ends with the size field's bytes
        data = data[:22 + frames[0]["size_field"]]
    if case.startswith("no_bpp"):             # the colour count byte of the bpp-0 entry
        k = [f.get("bpp") for f in frames].index(0)
        data[6 + 16 * k + 2] = 16 if case.endswith("16") else 1
    _check(tmp_path, bytes(data), ico.decode_ico_plain)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 5, 16, 255])
def test_ico_colour_depth_rule(count):
    """`entries`' depth of an entry with no bit count: PIL's
    `ceil(log(count, 2))`, 256 for 0 and 1."""
    data = ico.ICO_MAGIC + struct.pack("<H", 1) + struct.pack("<BBBBHHII", 4, 4, count, 0,
                                                               1, 0, 40, 22)
    from PIL.IcoImagePlugin import IcoFile
    assert ico.entries(data)[0]["depth"] == IcoFile(io.BytesIO(data)).entry[0].color_depth


# ------------------------------------------------------------------ CUR
def _cur_cases():
    rgb, rgba = _image(23, 17, 3, 11), _image(21, 19, 4, 12)
    mask = _mask(17, 23, 13)
    rng = np.random.default_rng(14)
    pal = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    idx = (rgb[..., 1] % 40).astype(np.uint8)
    zero_width = bytearray(ico.encode_cur([dict(img=rgb[:9, :11]), dict(img=rgb)]))
    zero_width[6 + 16] = 0
    two_32 = ico.encode_cur([dict(img=rgba[:5, :5]), dict(img=rgba)])
    at_zero = bytearray(ico.encode_cur([dict(img=rgb, mask=mask)]))
    at_zero[6 + 12:6 + 16] = bytes(4)          # no offset: the bitmap follows the table
    return {
        "bmp24": ico.encode_cur([dict(img=rgb, mask=mask)]),
        "pick_largest": ico.encode_cur([dict(img=rgb[:9, :11]), dict(img=rgb, mask=mask),
                                        dict(img=rgb[:17, :20])]),
        "pick_needs_both_larger": ico.encode_cur([dict(img=rgb[:9, :11]),
                                                  dict(img=rgb[:9, :20])]),
        "zero_width_byte_is_zero": bytes(zero_width),
        "bmp32_at_22_rgba": ico.encode_cur([dict(img=rgba)]),
        "bmp32_elsewhere_rgb": two_32,
        "bmp8_palette": ico.encode_cur([dict(img=idx, palette=pal, mask=mask)]),
        "offset_zero": bytes(at_zero),
    }


@pytest.mark.parametrize("case", list(_cur_cases()))
def test_cur_forms_equal_pil(tmp_path, case):
    """CUR: PIL's pick of the cursor (a later entry only where both its
    width and height bytes are larger; 0 is 0), the bitmap at half its
    height with no mask (RGB; RGBA for a 32-bit bitmap at byte 22), a
    palette expanded (B15), an offset of 0 (the bitmap read where the
    table ends)."""
    got = _check(tmp_path, _cur_cases()[case], ico.decode_cur_plain)
    if case == "bmp32_at_22_rgba":
        assert got.shape[2] == 4
    if case in ("bmp32_elsewhere_rgb", "bmp24"):
        assert got.shape[2] == 3


# ------------------------------------------------------------------ DCX
def test_dcx_reads_page_0(tmp_path):
    """`encode_dcx` of pages 8 x 3, 8 x 1 gray and 8 x 1 with a palette:
    page 0 as PIL reads it (an 8 x 1 page's palette is the file's last 769
    bytes, as PIL seeks them), a table of 1,024 offsets with no 0."""
    rgb, gray = _image(23, 17, 3, 21), _image(9, 5, 1, 22)[..., 0]
    pal = np.random.default_rng(1).integers(0, 256, (256, 3), dtype=np.uint8)
    for pages in ([rgb, gray], [gray, rgb], [(gray, pal)], [rgb, (gray, pal)]):
        data = pcx.encode_dcx(pages)
        got = _check(tmp_path, data, pcx.decode_dcx_plain)
        assert Image.open(_write(tmp_path, data)).n_frames == len(pages)
        assert got.shape[:2] == (pages[0] if isinstance(pages[0], np.ndarray)
                                 else pages[0][0]).shape[:2]
    page = pcx.encode_pcx(rgb)
    full = pcx.DCX_MAGIC + struct.pack("<I", 4 + 4096) * 1024 + page
    assert np.array_equal(_check(tmp_path, full, pcx.decode_dcx_plain), rgb)


# ------------------------------------------------------------------ ICNS
def _icns_cases():
    it32, t8mk = _banded(128, 128, 3, 31), _banded(128, 128, 1, 32)[..., 0]
    il32, l8mk = _banded(32, 32, 3, 33), _image(32, 32, 1, 34)[..., 0]
    is32, ih32 = _banded(16, 16, 3, 35), _banded(48, 48, 3, 36)
    enc = icns.encode_icns
    return {
        "it32_t8mk": enc({b"it32": it32, b"t8mk": t8mk}),
        "it32_nomask": enc({b"it32": it32}),
        "il32_l8mk": enc({b"il32": il32, b"l8mk": l8mk}),
        "il32_nomask": enc({b"il32": il32}),
        "il32_raw_mask": enc({b"il32": il32, b"l8mk": l8mk}, rle=False),
        "ih32_over_is32": enc({b"is32": is32, b"ih32": ih32, b"s8mk": is32[..., 0]}),
        "is32_s8mk": enc({b"s8mk": is32[..., 1], b"is32": is32}),
        "png_ic07_wins_over_it32": enc({b"it32": it32, b"ic07": _image(128, 128, 4, 37),
                                        b"t8mk": t8mk}),
        "png_ic10_rgb": enc({b"ic10": _banded(512, 512, 3, 38), b"il32": il32}),
        "png_ic12_at_2x": enc({b"ic12": _image(64, 64, 3, 39)}),
        "png_ic10_half_size": enc({b"ic10": _image(512, 512, 4, 40)}),
        "png_icp4_gray": enc({b"icp4": _image(16, 16, 1, 41)[..., 0]}),
        "last_block_of_a_type": b"icns" + struct.pack(">I", 8 + 2 * (8 + len(
            enc({b"il32": il32})) - 16)) + enc({b"il32": il32})[8:]
        + enc({b"il32": il32[::-1]})[8:],
    }


@pytest.mark.parametrize("case", list(_icns_cases()))
def test_icns_forms_equal_pil(tmp_path, case):
    """ICNS: the largest size the file holds, `it32` / `ih32` / `il32` /
    `is32` in RLE or raw with and without their masks (RGBA / RGB), a PNG
    sub-image winning over an `it32` of its size, PNGs at 1x and 2x and at
    a size PIL's setter takes, the last block of a type kept."""
    _check(tmp_path, _icns_cases()[case], icns.decode_icns_plain)


def test_icns_pil_written(tmp_path):
    """PIL's own ICNS of a small image: its 1024 px PNG."""
    img = np.zeros((32, 32, 4), np.uint8)
    img[:16] = (200, 30, 30, 255)
    img[16:] = (30, 30, 200, 90)
    got = _check(tmp_path, _pil_bytes(img, "ICNS"), icns.decode_icns_plain)
    assert got.shape == (1024, 1024, 4)


def _rle_walks(data, sizesq):
    native, plain = icns._rle(data, sizesq), icns._rle_plain(data, sizesq)
    assert native[1:] == plain[1:], (native[1:], plain[1:])
    if native[1] == 0:
        assert np.array_equal(native[0], plain[0])
    return native


@pytest.mark.parametrize("form", [b"it32", b"ih32", b"il32", b"is32"])
def test_icns_rle_damaged_as_plain_and_pil(tmp_path, form):
    """64 damaged files a form (bytes of the run-length planes changed, or
    the file cut): `gm_icns_rle` gives its plain walk's planes or its error
    (the plane, the bytes left), the two decoders the same array or error,
    and PIL the same array, or an error where they raise."""
    side = {b"it32": 128, b"ih32": 48, b"il32": 32, b"is32": 16}[form]
    img = _banded(side, side, 3, side)
    data = icns.encode_icns({form: img})
    start = 16 + (4 if form == b"it32" else 0)
    rng = np.random.default_rng(side)
    for k in range(64):
        b = bytearray(data)
        if k % 3 == 0:
            b = b[:rng.integers(start, len(b))]
        else:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(start, len(b))] = rng.integers(0, 256)
        b = bytes(b)
        _rle_walks(b[start:], side * side)
        native, simple = (_outcome(icns.decode_icns, b), _outcome(icns.decode_icns_plain, b))
        assert type(native) is type(simple), k
        assert (native == simple) if isinstance(native, str) else np.array_equal(native, simple)
        want = _pil(_write(tmp_path, b, "d"))
        assert isinstance(want, Exception) == isinstance(native, str), (k, native, want)
        if not isinstance(native, str):
            assert np.array_equal(native, want), k


@pytest.mark.parametrize("stream, sizesq, want", [
    (b"", 4, (11, 0, 4)),                                   # no data: the count left
    (bytes([0x81, 9, 0x81, 8, 0x81, 7]), 4, (0, 0, 0)),    # runs of 4
    (bytes([0x82, 9]), 4, (11, 0, -1)),                     # a run past the plane
    (bytes([0x03, 1, 2, 3, 4, 0x81, 5, 0x00]), 4, (11, 2, 3)),
    (bytes([0x03, 1, 2]), 4, (1, 0, 0)),                    # a literal the data cuts
    (bytes([0x81]), 4, (1, 0, 0)),                          # a run with no byte
])
def test_icns_rle_walk_edges(stream, sizesq, want):
    """The walk's edges, C++ = plain: a plane's count met exactly, passed
    (negative bytes left), never met, met with the data ended inside a
    run."""
    assert _rle_walks(stream, sizesq)[1:] == want


# ------------------------------------------------------------------ refusals
def _refused():
    rgb = _image(5, 4, 3, 51)
    mask = _mask(4, 5, 52)
    ico24 = ico.encode_ico([dict(img=rgb, mask=mask)])
    ico32 = ico.encode_ico([dict(img=_image(5, 4, 4, 53))])
    il32 = icns.encode_icns({b"il32": _banded(32, 32, 3, 54)})
    jp2 = b"icns" + struct.pack(">I", 28) + b"ic07" + struct.pack(">I", 20) \
        + b"\xff\x4f\xff\x51" + bytes(8)
    it32 = icns.encode_icns({b"it32": _banded(128, 128, 3, 55)})
    bw = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    channel = b"icns" + struct.pack(">I", 32) + b"il32" + struct.pack(">I", 24) \
        + bytes([0xFF, 5]) * 8                 # 8 runs of 130: 16 bytes past the plane
    return {
        "dib_os2": (struct.pack("<IHHHH", 12, 2, 2, 1, 24) + bytes(14), bmp.decode_dib_plain,
                    "OS/2", False),
        "dib_jpeg": (struct.pack("<IiiHHIIiiII", 40, 2, 2, 1, 24, 4, 0, 0, 0, 0, 0) + bytes(8),
                     bmp.decode_dib_plain, "JPEG-compressed", True),
        "dib_cut": (bmp.encode_dib(rgb)[:-5], bmp.decode_dib_plain, "truncated", True),
        "ico_mask_cut": (ico24[:-4], ico.decode_ico_plain, "AND mask cut short", True),
        "ico_mask_before_file": (ico.encode_ico([dict(img=_image(5, 8, 3, 51), size_field=0)]),
                                 ico.decode_ico_plain, "before the file", True),
        "ico_bmp8_black_white": (ico.encode_ico([dict(img=(rgb[..., 0] % 2).astype(np.uint8),
                                                      palette=bw, mask=mask)]),
                                 ico.decode_ico_plain, "black-and-white palette", False),
        "ico_32bit_pixels_cut": (ico32[:-9], ico.decode_ico_plain, "cut short", True),
        "cur_png_frame": (ico.encode_cur([dict(img=rgb, form="png")]), ico.decode_cur_plain,
                          "PNG cursor frame", True),
        "dcx_page_unknown_mode": (pcx.DCX_MAGIC + struct.pack("<II", 12, 0)
                                  + pcx.encode_pcx(rgb)[:3] + b"\x04"
                                  + pcx.encode_pcx(rgb)[4:], pcx.decode_dcx_plain,
                                  "PIL does not read", True),
        "icns_jpeg2000": (jp2, icns.decode_icns_plain, "JPEG 2000", True),
        "icns_other_subimage": (jp2.replace(b"\xff\x4f\xff\x51", b"GIF8"),
                                icns.decode_icns_plain, "another format", True),
        "icns_it32_signature": (it32[:16] + b"\0\0\0\1" + it32[20:], icns.decode_icns_plain,
                                "4 zero bytes", True),
        "icns_mask_only": (icns.encode_icns({b"l8mk": _image(32, 32, 1, 56)[..., 0]}),
                           icns.decode_icns_plain, "mask with no image", True),
        "icns_mask_cut": (icns.encode_icns({b"il32": _banded(32, 32, 3, 57),
                                            b"l8mk": _image(32, 32, 1, 58)[..., 0]})[:-7],
                          icns.decode_icns_plain, "mask cut short", True),
        "icns_channel": (channel, icns.decode_icns_plain,
                         "Error reading channel [-16 left]", True),
        "icns_png_size": (icns.encode_icns({b"ic10": _image(48, 64, 3, 59)}),
                          icns.decode_icns_plain, "allowed sizes", True),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_refused_forms_raise(tmp_path, case):
    """Forms the port refuses, each raising one ValueError that names its
    cause through `read_image` and the plain route alike; PIL raises on
    each but the OS/2 DIB (which it reads: an OS/2 header stays refused)
    and the 8-bit black-and-white icon frame (which it misreads as 1-bit
    pixels, as it does in a BMP)."""
    data, plain, words, pil_raises = _refused()[case]
    _both_raise(tmp_path, data, plain, words, pil_raises)


# ------------------------------------------------------------------ dispatch
def test_dispatch_magics_and_order(tmp_path):
    """Each container by its head: a DIB, ICO, CUR, DCX and ICNS each go to
    their reader (the PIL format equal); an ICO and a CUR whose heads TGA's
    checks pass too (a frame of 65,536 bytes or more makes the TGA's depth
    byte 1) are read as PIL reads them, as the container it tries first."""
    rgb = _image(6, 4, 3, 61)
    files = {"DIB": bmp.encode_dib(rgb), "ICO": ico.encode_ico([dict(img=rgb)]),
             "CUR": ico.encode_cur([dict(img=rgb)]), "DCX": pcx.encode_dcx([rgb]),
             "ICNS": icns.encode_icns({b"is32": _banded(16, 16, 3, 62)})}
    big = _image(150, 150, 3, 64)
    files["ICO as TGA"] = ico.encode_ico([dict(img=big, mask=_mask(150, 150, 65))])
    cur = bytearray(ico.encode_cur([dict(img=big, mask=_mask(150, 150, 66))]))
    cur[12:14] = struct.pack("<H", 5)            # a hotspot y of 5: TGA's width
    files["CUR as TGA"] = bytes(cur)
    for fmt, data in files.items():
        if fmt.endswith("as TGA"):
            assert tga.tga_header(data[:68]) is not None
        path = _write(tmp_path, data, fmt)
        assert Image.open(path).format == fmt[:4].strip()
        assert np.array_equal(png.read_image(path), _pil(path))


def test_give_way_goes_on_as_pil(tmp_path):
    """A container PIL gives way on is handed to the next format: an ICO
    and a CUR of no entries whose heads TGA's checks pass are read as TGAs
    (as PIL opens them); a DCX whose offset table the file cuts, an ICNS
    with a block of length 0, an ICO directory cut short and a DIB of width
    0 are no format at all (PIL: cannot identify), naming the cause."""
    px = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    for kind in (1, 2):                           # ICO, CUR heads: image types 1 and 2
        data = _head(2, 2, 2, 24, 0x20) + px[:2, :2].tobytes()
        data = data[:2] + bytes([kind]) + data[3:]
        path = _write(tmp_path, data, f"k{kind}")
        assert data[:4] == (ico.ICO_MAGIC if kind == 1 else ico.CUR_MAGIC)
        got = _pil(path)
        if isinstance(got, np.ndarray):
            assert Image.open(path).format == "TGA"
            assert np.array_equal(png.read_image(path), got)
        else:
            with pytest.raises(ValueError, match="TGA"):
                png.read_image(path)
    cases = {
        "dcx_cut": (pcx.DCX_MAGIC + struct.pack("<I", 12), "DCX page table cut short"),
        "icns_zero_block": (b"icns" + struct.pack(">I", 24) + b"il32" + bytes(12),
                            "invalid block header"),
        "ico_directory_cut": (ico.ICO_MAGIC + struct.pack("<H", 2) + bytes(20),
                              "ICO directory cut short"),
        "dib_width_0": (struct.pack("<IiiHHIIiiII", 40, 0, 2, 1, 24, 0, 0, 0, 0, 0, 0),
                        "not identified"),
        "icns_no_icons": (icns.encode_icns({b"ic07": _image(4, 4, 3, 1)})
                          .replace(b"ic07", b"zzzz"), "No 32bit icon"),
    }
    for name, (data, words) in cases.items():
        path = _write(tmp_path, data, name)
        with pytest.raises(ValueError, match="not a JPEG") as err:
            png.read_image(path)
        assert words in str(err.value), err.value
        assert isinstance(_pil(path), Exception)


# ------------------------------------------------------------------ B23
def _b23_frame(seed, with_mask=True):
    rgb = _image(18, 12, 3, seed)
    mask = _mask(12, 18, seed + 1)
    zero = np.concatenate([rgb, np.zeros((12, 18, 1), np.uint8)], 2)
    return rgb, mask, ico.encode_ico([dict(img=zero, mask=mask if with_mask else None)])


@pytest.mark.parametrize("resolution", [1, 2])
def test_b23_zero_alpha_frame_takes_the_and_mask(tmp_path, resolution):
    """Fault B23: a 32-bit icon frame whose every fourth byte is 0 loads with
    its AND mask's alpha (PIL gives alpha 0 everywhere, and the JAX reader
    masks the whole view out), equal to the JAX `_load_image` of PIL's RGB
    and the mask's alpha written as a PNG; a frame with any fourth byte
    other than 0 keeps PIL's alpha; with no mask after the pixel rows the
    frame is opaque."""
    rgb, mask, data = _b23_frame(resolution)
    path = _write(tmp_path, data, "v.ico")
    pil = np.asarray(Image.open(path))
    assert pil.shape == (12, 18, 4) and not pil[..., 3].any()
    want = np.concatenate([pil[..., :3], np.where(mask, 0, 255).astype(np.uint8)[..., None]],
                          2)
    assert np.array_equal(pil[..., :3], rgb)
    assert np.array_equal(png.read_image(path), want)
    assert np.array_equal(ico.decode_ico_plain(data), want)
    oracle = str(tmp_path / "oracle.png")
    Image.fromarray(want).save(oracle)
    got_img, got_mask = readers._load_image(path, resolution, None)
    want_img, want_mask = jreaders._load_image(oracle, resolution, None)
    assert got_img.dtype == want_img.dtype and np.array_equal(got_img, want_img)
    assert got_mask.dtype == want_mask.dtype and np.array_equal(got_mask, want_mask)
    assert jreaders._load_image(path, resolution, None)[1].max() == 0.0
    _, _, bare = _b23_frame(resolution, with_mask=False)
    assert (ico.decode_ico(bare)[..., 3] == 255).all()
    kept = bytearray(data)
    kept[22 + 40 + 3] = 1                        # one fourth byte of 1: PIL's alpha
    path = _write(tmp_path, bytes(kept), "k.ico")
    assert np.array_equal(png.read_image(path), _pil(path))


# ------------------------------------------------------------------ fixtures
with open(os.path.join(CONTAINERS, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_container_fixtures_give_their_digests(name):
    """Each fixture of `tests/data/containers/` through `read_image` (C++)
    and the plain route gives its recorded digest and shape, and PIL, with
    the recorded rule applied, gives it again here."""
    path = os.path.join(CONTAINERS, name)
    with open(path, "rb") as fh:
        data = fh.read()
    want = DIGESTS[name]
    for got in (png.read_image(path), PLAIN[os.path.splitext(name)[1]](data)):
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == want["array"]
        assert list(got.shape) == want["shape"]
    from tools.make_container_fixtures_torch import digests
    assert digests(data) == want


# ------------------------------------------------------ a scene of each form
def _container_set(root):
    """`_jpeg_colmap_set` at 120x40 with its six views as a 24-bit DIB, an
    ICO of a 24-bit BMP frame with an AND mask, an ICO of a PNG frame, a
    DCX of two 8 x 3 pages, a CUR and a BI_BITFIELDS RGBA DIB, in turn."""
    root = _jpeg_colmap_set(root, w=120, h=40)
    for i, name in enumerate(sorted(os.listdir(f"{root}/images"))):
        path = f"{root}/images/{name}"
        img = jpeg.read_jpeg(path)
        img = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
        mask = _mask(*img.shape[:2], i)
        data = (bmp.encode_dib(img),
                ico.encode_ico([dict(img=img, mask=mask)]),
                ico.encode_ico([dict(img=img, form="png", size=(0, 0))]),
                pcx.encode_dcx([img, img[::2, ::2]]),
                ico.encode_cur([dict(img=img, mask=mask)]),
                bmp.encode_dib(np.concatenate([img, 255 - img[..., :1]], 2),
                               bitfields=True))[i % 6]
        with open(path, "wb") as fh:
            fh.write(data)
    return root


def test_container_colmap_scene_matches_jax_and_reads_no_plain_piece(tmp_path, monkeypatch):
    """`read_scene` of one COLMAP set of DIB, ICO, CUR and DCX views equals
    the JAX reader's at -r 1 and 2, exactly (images, masks, dtypes); read
    again with every plain piece of these readers made to raise, the same
    scene (and an ICNS of run-length planes through `read_image`)."""
    root = _container_set(tmp_path / "s")
    kw = dict(eval_split=True, is_exist_bg=True)
    scenes = {}
    for resolution in (1, 2):
        scenes[resolution] = readers.read_scene(root, resolution=resolution, **kw)
        _assert_scene_equal(scenes[resolution],
                            jreaders.read_scene(root, resolution=resolution, **kw))
    icns_path = _write(tmp_path, icns.encode_icns({b"it32": _banded(128, 128, 3, 71)}), "i")
    rle_icns = png.read_image(icns_path)

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for mod, name in ((bmp, "_rle_plain"), (pcx, "_rle_plain"), (png, "_unfilter_plain"),
                      (icns, "_rle_plain")):
        monkeypatch.setattr(mod, name, plain)
    for resolution in (1, 2):
        _assert_scene_equal(readers.read_scene(root, resolution=resolution, **kw),
                            scenes[resolution])
    assert np.array_equal(png.read_image(icns_path), rle_icns)


def test_writers_read_by_pil(tmp_path):
    """`encode_ico` (PNG and BMP frames of 8, 24 and 32 bits with masks,
    several to a file), `encode_cur`, `encode_dcx` and `encode_icns` (PNG,
    RLE and raw images with masks) read by PIL as written."""
    rgb, rgba = _image(20, 10, 3, 81), _image(20, 10, 4, 82)
    mask = _mask(10, 20, 83)
    alpha = np.where(mask, 0, 255).astype(np.uint8)[..., None]
    pal = np.random.default_rng(84).integers(0, 256, (30, 3), dtype=np.uint8)
    idx = (rgb[..., 0] % 30).astype(np.uint8)
    cases = [
        (ico.encode_ico([dict(img=rgb[:5, :5]), dict(img=rgb, mask=mask)]),
         np.concatenate([rgb, alpha], 2)),
        (ico.encode_ico([dict(img=rgba)]), rgba),
        (ico.encode_ico([dict(img=idx, palette=pal, mask=mask)]),
         np.concatenate([pal[idx], alpha], 2)),
        (ico.encode_ico([dict(img=rgba, form="png"), dict(img=rgb[:4, :4])]), rgba),
        (ico.encode_cur([dict(img=rgb, mask=mask)]), rgb),
        (pcx.encode_dcx([rgb, idx]), rgb),
        (icns.encode_icns({b"il32": _banded(32, 32, 3, 85), b"l8mk": _image(32, 32, 1, 86)
                           [..., 0]}), np.concatenate([_banded(32, 32, 3, 85),
                                                       _image(32, 32, 1, 86)], 2)),
        (icns.encode_icns({b"ih32": _banded(48, 48, 3, 87)}, rle=False), _banded(48, 48, 3, 87)),
        (icns.encode_icns({b"icp6": rgba[:1, :1].repeat(64, 0).repeat(64, 1)}),
         rgba[:1, :1].repeat(64, 0).repeat(64, 1)),
    ]
    for data, want in cases:
        path = _write(tmp_path, data)
        assert np.array_equal(_pil(path), want)
        assert np.array_equal(png.read_image(path), want)
