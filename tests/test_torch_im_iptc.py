"""The port's IM, IMT and IPTC readers (`io/im.py`, `io/imt.py`,
`io/iptc.py`) against PIL 12, the fixtures of `tests/data/raw_samples/`,
and a COLMAP scene of the slice's five formats against the JAX reader.

PIL's own IM writer in every mode it writes, and the port's writer in the
types it does not (`B2`, `B4`, `X 24`, `RGB3`, `L 8`, `Lut`s), read to PIL's
array under the port's rule (A2, B7, B14, B15, B16; B30 for YCC against
PIL's `convert("RGB")` of the same YCbCr samples); the header rules of
`_open` (fuzzed) give way, open or fail as PIL's; the float and signed
types and the types PIL cannot load are refused. IMT's field loop, fuzzed,
as PIL's. IPTC's gray records, raw and JPEG, as PIL; B31 (PIL reads one
band of a colour record) refused against the samples written as a PNG; the
compressions and field sizes PIL fails on fail. A3: the port's JPEG reader
refuses the markers PIL and libjpeg refuse."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image, ImImagePlugin, ImtImagePlugin, IptcImagePlugin

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import fli, gbr, im, imt, iptc, jpeg, png
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from tests.test_torch_readers import _assert_scene_equal
from tools.make_raw_sample_fixtures_torch import digests, natural, port_array

torch.set_num_threads(2)

RAW_SAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "raw_samples")
SIZES = [(1, 1), (7, 3), (64, 5), (257, 3)]                 # (width, height)


def _pil(data):
    """PIL's array of a file under the port's rule, or PIL's exception."""
    try:
        return port_array(data)[0]
    except Exception as err:           # PIL raises OSError, ValueError, SyntaxError
        return err


def _write(tmp_path, data, name="f"):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _pil_save(img, fmt="IM"):
    buf = io.BytesIO()
    img.save(buf, fmt)
    return buf.getvalue()


def _sample(mode, w, h, seed):
    """A PIL image of `mode` at (w, h), seeded."""
    rng = np.random.default_rng(seed)
    rgb = Image.fromarray(natural(h, w, 3, seed))
    if mode in ("I;16", "I;16B", "I;16L"):
        a = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        return Image.fromarray(a) if mode == "I;16" else Image.fromarray(a).convert(mode)
    if mode == "1":
        return rgb.convert("L").point(lambda v: 255 * (v > 128)).convert("1")
    if mode in ("P", "PA"):
        p = rgb.convert("P", palette=Image.Palette.ADAPTIVE, colors=100)
        return p if mode == "P" else p.convert("PA")
    if mode == "CMYK":
        return Image.fromarray(natural(h, w, 4, seed), "CMYK")
    if mode == "LA":
        return Image.fromarray(natural(h, w, 2, seed), "LA")
    if mode == "RGBA":
        return Image.fromarray(natural(h, w, 4, seed), "RGBA")
    return rgb.convert(mode)


# ------------------------------------------------------------------ IM
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK",
                                  "YCbCr", "I;16", "I;16B", "I;16L"])
def test_im_pil_writer_equals_pil(tmp_path, mode):
    """PIL's IM writer in each mode the port reads, 1x1 to 257x3: rows
    bottom-up, line-interleaved planes; `read_image` = PIL's array under
    the port's rule (1 -> `convert("L")`, B16; P -> `convert("RGB")`,
    B15; LA, PA -> `convert("RGBA")`, A2; CMYK, B14, and YCbCr, B30 ->
    `convert("RGB")`; I;16 -> the high byte, B7)."""
    for k, (w, h) in enumerate(SIZES):
        data = _pil_save(_sample(mode, w, h, k))
        path = _write(tmp_path, data)
        assert Image.open(path).format == "IM"
        got, want = png.read_image(path), _pil(data)
        assert isinstance(want, np.ndarray), want
        assert got.shape == want.shape and np.array_equal(got, want), (mode, w, h)


HAND_IM = {
    "B2": lambda g, p: im.encode_im(g % 4, "B2"),
    "B4": lambda g, p: im.encode_im(g % 16, "B4"),
    "B2_colour_lut": lambda g, p: im.encode_im(g, "B2", lut=p),
    "B4_grey_lut": lambda g, p: im.encode_im(
        g % 16, "B4", lut=np.repeat(np.arange(255, -1, -1, dtype=np.uint8)[:, None], 3, 1)),
    "L_colour_lut": lambda g, p: im.encode_im(g, "L", lut=p),
    "L_grey_inverted_lut_c4": lambda g, p: im.encode_im(
        g, "L", lut=np.repeat(np.arange(255, -1, -1, dtype=np.uint8)[:, None], 3, 1)),
    "L_grey_linear_lut": lambda g, p: im.encode_im(
        g, "L", lut=np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)),
    "LA_colour_lut": lambda g, p: im.encode_im(np.stack([g, 255 - g], -1), "LA", lut=p),
    "X24": lambda g, p: im.encode_im(np.stack([g, g // 2, 255 - g], -1), "X24"),
    "RGB3_c5": lambda g, p: im.encode_im(np.stack([g, g // 2, 255 - g], -1), "RGB3"),
    "L8": lambda g, p: im.encode_im(g, "L8"),
    "RGB_lut": lambda g, p: im.encode_im(np.stack([g, g // 2, 255 - g], -1), "RGB", lut=p),
}


@pytest.mark.parametrize("case", sorted(HAND_IM))
def test_im_hand_types_equal_pil(tmp_path, case):
    """The types PIL's writer does not write, by the port's writer: B2 and
    B4 (PIL's empty palette: black), a colour `Lut` (8-bit indices even
    under `B2`; PA for LA), gray `Lut`s (C4: PIL keeps and never applies a
    non-linear one), `X 24`, `RGB3` (C5: PIL's plane order), `L 8` (mode F
    of bytes), an RGB file's `Lut` (unapplied): each equal to PIL."""
    pal = np.random.default_rng(7).integers(0, 256, (256, 3)).astype(np.uint8)
    for k, (w, h) in enumerate(SIZES):
        gray = natural(h, w, 1, k)[..., 0]
        data = HAND_IM[case](gray, pal)
        want = _pil(data)
        assert isinstance(want, np.ndarray), want
        got = png.read_image(_write(tmp_path, data))
        assert got.shape == want.shape and np.array_equal(got, want), (case, w, h)
    if case == "RGB3_c5":                    # PIL puts the first plane in G
        data = im.encode_im(np.array([[[20, 10, 30]]], np.uint8), "RGB3")
        assert data.endswith(bytes([10, 20, 30]))
        assert im.decode_im(data).tolist() == [[[20, 10, 30]]]


def test_b30_ycc_reads_as_pil_rgb_of_the_samples():
    """B30: an IM `YCC` file opens as YCbCr, whose channels the JAX reader
    trains as R, G, B. `read_im` gives PIL's `convert("RGB")` of the same
    YCbCr samples, made by PIL from an array (not read from the file); and
    `ycc_to_rgb` equals that conversion on all 256**3 (Y, Cb, Cr)."""
    ycc = natural(9, 13, 3, 4)
    want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    data = _pil_save(Image.fromarray(ycc, "YCbCr"))
    assert Image.open(io.BytesIO(data)).mode == "YCbCr"
    got = im.decode_im(data)
    assert np.array_equal(got, want) and not np.array_equal(got, ycc)
    v = np.arange(256 ** 3, dtype=np.uint32)
    every = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096,
                                                                                       4096, 3)
    assert np.array_equal(im.ycc_to_rgb(every),
                          np.asarray(Image.fromarray(every, "YCbCr").convert("RGB")))


IM_REFUSED = {
    "I": (lambda: _pil_save(_sample("L", 5, 3, 0).convert("I")), "fault B21"),
    "F": (lambda: _pil_save(_sample("L", 5, 3, 0).convert("F")), "fault B21"),
    "L 8S": (lambda: im.encode_im(np.zeros((3, 5), np.uint8), "L").replace(
        b"Greyscale image", b"L 8S image"), "fault B21"),
    "L 32": (lambda: im.encode_im(np.zeros((3, 20), np.uint8), "L").replace(
        b"Greyscale image", b"L 32 image").replace(b"20*3", b"5*3"), "fault B21"),
    "L*12": (lambda: im.encode_im(np.zeros((3, 10), np.uint8), "L").replace(
        b"Greyscale image", b"L*12 image"), "fault B21"),
    "RLB": (lambda: im.encode_im(np.zeros((3, 5, 3), np.uint8), "RGB").replace(
        b"RGB image", b"RLB image"), "cannot load"),
    "PA without Lut": (lambda: im.encode_im(np.zeros((3, 5, 2), np.uint8), "LA").replace(
        b"LA image", b"PA image"), "cannot load"),
    "unknown type": (lambda: im.encode_im(np.zeros((3, 5), np.uint8), "L").replace(
        b"Greyscale image", b"Foo image"), "cannot load"),
    "rows cut": (lambda: im.encode_im(np.zeros((3, 5), np.uint8), "L")[:-2], "truncated"),
    "size not a number": (lambda: im.encode_im(np.zeros((3, 5), np.uint8), "L").replace(
        b"5*3", b"5*x"), "not a number"),
}


@pytest.mark.parametrize("case", sorted(IM_REFUSED))
def test_im_refusals(tmp_path, case):
    """The float and signed types (mode F or I: fault B21) are refused, and
    so is every type PIL cannot load, rows the file cuts, and a size that
    is not a number (PIL's ValueError fails `Image.open` itself): each a
    ValueError naming the cause, not a give-way."""
    make, words = IM_REFUSED[case]
    data = make()
    with pytest.raises(ValueError, match=words) as err:
        png.read_image(_write(tmp_path, data))
    assert not isinstance(err.value, GiveWay)
    try:
        pim = Image.open(io.BytesIO(data))
    except ValueError:
        assert case == "size not a number"
        return
    if words == "fault B21":
        assert pim.mode in ("F", "I") and pim.rawmode != "F;8"
    else:
        with pytest.raises((OSError, ValueError)):
            np.asarray(pim)


def _classes(opener, decode, data):
    """(PIL's outcome, the port's): "give way", "fail" (PIL: another error
    at open or load; the port: a ValueError) or the array under the rule."""
    try:
        f = opener(io.BytesIO(data))
    except (SyntaxError, IndexError, TypeError, struct.error):
        f, want = None, "give way"
    except Exception:                   # noqa: BLE001 - PIL's other errors fail the file
        f, want = None, "fail"
    if f is not None:
        try:
            want = (port_array(data)[0] if f.mode not in ("F", "I")
                    or getattr(f, "rawmode", "") == "F;8" else "fail")
        except Exception:               # noqa: BLE001 - PIL cannot load it
            want = "fail"
    try:
        got = decode(data)
    except GiveWay:
        got = "give way"
    except ValueError:
        got = "fail"
    return want, got


def _fuzz(base, tokens, n, seed, head):
    rng = np.random.default_rng(seed)
    for t in range(n):
        d = bytearray(base[t % len(base)])
        end = head(bytes(d))
        for _ in range(rng.integers(1, 4)):
            k = int(rng.integers(0, max(1, end)))
            r = rng.random()
            if r < 0.5:
                d[k:k] = tokens[rng.integers(0, len(tokens))]
            elif r < 0.75:
                del d[k:k + int(rng.integers(1, 4))]
            else:
                d[k:k + 1] = bytes([int(rng.integers(0, 256))])
        if t % 13 == 0:
            d = d[:int(rng.integers(0, len(d) + 1))]
        yield bytes(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_im_header_rules_fuzzed_as_pil(seed):
    """1,000 IM files a seed with tokens of the header language inserted,
    bytes deleted or changed, or cut: `decode_im` gives way, fails or
    reads exactly where PIL's `ImImageFile` does (the 100-byte rules, `\\r`
    skipped, NUL and 0x1A ends, the tags, numbers, the `Lut` read and its
    gray test's IndexError, the data after the next 0x1A)."""
    rng = np.random.default_rng(100 + seed)
    base = [im.encode_im(rng.integers(0, 256, (5, 7), dtype=np.uint8), "L"),
            im.encode_im(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8), "RGB"),
            im.encode_im(rng.integers(0, 256, (5, 7), dtype=np.uint8), "P",
                         lut=rng.integers(0, 256, (256, 3))),
            b"Image type: RGB image\nImage size (x*y): 3*2\n\x1a" + bytes(range(18)),
            b"Lut: 1\r\n\x1a" + bytes(range(256)) * 3 + bytes(512 * 512),
            b"Comment: a\nImage size (x*y): 4*4\nImage type: B2 image\n\0\0\x1a" + bytes(16)]
    tokens = [b"\n", b"\r", b"\r\n", b":", b" ", b"\0", b"\x1a", b"*", b",", b"Image type",
              b"Image size (x*y)", b"Lut", b"L 16 image", b"1.5", b"x", b"Scale (x,y)",
              b"File size (no of images)", b"YCC image", b"Name"]
    seen = set()
    for data in _fuzz(base, tokens, 1000, seed,
                      lambda d: (d.index(b"\x1a") if b"\x1a" in d else 60) + 2):
        want, got = _classes(ImImagePlugin.ImImageFile, im.decode_im, data)
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and np.array_equal(got, want), data[:80]
        else:
            assert got == want, (data[:100], want, got)
        seen.add(want if isinstance(want, str) else "read")
    assert seen == {"give way", "fail", "read"}


# ------------------------------------------------------------------ IMT
def test_imt_equals_pil(tmp_path):
    """IMT files by the port's writer at 1x1 to 257x3, with comments and CR
    LF lines, the keys in another order: `read_image` = PIL."""
    for k, (w, h) in enumerate(SIZES):
        gray = natural(h, w, 1, k)[..., 0]
        plain = imt.encode_imt(gray)
        crlf = b"*image\r\n*x\r\nwidth %d\r\nheight %d\r\npixel n8\r\n\x0c" % (w, h)
        for data in (plain, crlf + gray.tobytes(),
                     b"pixel n8\nheight %d\nwidth %d\n\x0c" % (h, w) + gray.tobytes()):
            path = _write(tmp_path, data)
            assert Image.open(path).format == "IMT"
            got = png.read_image(path)
            assert np.array_equal(got, gray) and np.array_equal(got, _pil(data))


@pytest.mark.parametrize("seed", [0, 1])
def test_imt_header_rules_fuzzed_as_pil(seed):
    """1,000 IMT files a seed, changed as IM's are: `decode_imt` gives way,
    fails (no form feed: "cannot load this image"; a width that is not a
    number: PIL's ValueError) or reads exactly where PIL's does."""
    rng = np.random.default_rng(200 + seed)
    base = [imt.encode_imt(rng.integers(0, 256, (5, 7), dtype=np.uint8)),
            b"width 3\nheight 2\npixel n8\n\x0c" + bytes(6),
            b"*c\r\nwidth 3\r\nheight 2\r\npixel n8\r\n\x0c" + bytes(6)]
    tokens = [b"\n", b"\r", b"\x0c", b" ", b"*", b"width 4", b"height 1", b"pixel n8", b"x",
              b"-1", b"\n\n"]
    seen = set()
    for data in _fuzz(base, tokens, 1000, seed, len):
        want, got = _classes(ImtImagePlugin.ImtImageFile, imt.decode_imt, data)
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and np.array_equal(got, want), data[:80]
        else:
            assert got == want, (data[:80], want, got)
        seen.add(want if isinstance(want, str) else "read")
    assert seen == {"give way", "fail", "read"}


# ------------------------------------------------------------------ IPTC
@pytest.mark.parametrize("compression", ["raw", "jpeg"])
def test_iptc_gray_equals_pil(tmp_path, compression):
    """Gray IPTC records, raw and JPEG, at 1x1 to 257x3, in one (8, 10)
    field or several of 7 bytes: `read_image` = PIL (raw: the samples)."""
    for k, (w, h) in enumerate(SIZES):
        gray = natural(h, w, 1, k)[..., 0]
        for chunk in (iptc._CHUNK, 7):
            data = iptc.encode_iptc(gray, compression, chunk=chunk)
            path = _write(tmp_path, data)
            assert Image.open(path).format == "IPTC"
            got, want = png.read_image(path), _pil(data)
            assert np.array_equal(got, want), (w, h, chunk)
            if compression == "raw":
                assert np.array_equal(got, gray)


def test_b31_colour_records_refused(tmp_path):
    """B31: an RGB raw IPTC record opens in PIL as RGB whose band 0 is the
    first w x h samples and whose other bands are 0, unlike the same
    samples written as an RGB PNG (the independent oracle); the port
    refuses it naming the fault, as it does CMYK and a (3, 65) band."""
    rgb = natural(9, 13, 3, 5)
    data = iptc.encode_iptc(rgb)
    pim = Image.open(_write(tmp_path, data, "rgb.iim"))
    assert pim.format == "IPTC" and pim.mode == "RGB"
    oracle = png.read_image(_write(tmp_path, png.encode_png(rgb), "rgb.png"))
    misread = np.asarray(pim)
    assert not np.array_equal(misread, oracle)
    assert np.array_equal(misread[..., 0], rgb[..., 0]) and not misread[..., 1:].any()
    for d in (data, iptc.encode_iptc(natural(9, 13, 4, 6)),
              iptc.encode_iptc(natural(9, 13, 4, 6), band=2)):
        with pytest.raises(ValueError, match="fault B31"):
            png.read_image(_write(tmp_path, d))


def _field(rec, ds, body):
    return struct.pack(">BBBH", 0x1C, rec, ds, len(body)) + body


def _iptc(records, image=b"", size=(3, 2)):
    head = b"".join(_field(r, d, b) for (r, d), b in records.items())
    return head + _field(8, 10, image) if image is not None else head


_GRAY = {(3, 60): b"\x01\x00", (3, 20): b"\x00\x03", (3, 30): b"\x00\x02", (3, 120): b"\x01"}
IPTC_CASES = {
    "no_first_1c": (b"\x1d" + _iptc(_GRAY, bytes(6))[1:], "give way"),
    "zero_head": (bytes(5) + _iptc(_GRAY, bytes(6)), "give way"),
    "record_11": (_iptc({(11, 1): b"x", **_GRAY}, bytes(6)), "give way"),
    "no_layers": (_iptc({k: v for k, v in _GRAY.items() if k != (3, 60)}, bytes(6)),
                  "give way"),
    "layers_cut": (_iptc({**_GRAY, (3, 60): b"\x01"}, bytes(6)), "give way"),
    "no_width": (_iptc({k: v for k, v in _GRAY.items() if k != (3, 20)}, bytes(6)),
                 "give way"),
    "width_0": (_iptc({**_GRAY, (3, 20): b"\x00\x00"}, bytes(6)), "give way"),
    "no_compression": (_iptc({k: v for k, v in _GRAY.items() if k != (3, 120)}, bytes(6)),
                       "Unknown IPTC image compression"),
    "compression_2": (_iptc({**_GRAY, (3, 120): b"\x02"}, bytes(6)),
                      "Unknown IPTC image compression"),
    "field_size_133": (b"\x1c\x02\x00\x85\x00" + bytes(8), "illegal field length"),
    "no_image_field": (_iptc(_GRAY, None), "cannot load this image"),
    "data_cut": (_iptc(_GRAY, bytes(5)), "truncated"),
    "junk_after_data": (_iptc(_GRAY, bytes(6)) + b"\x01junk", "bad field"),
    "iim_extended_size": (_iptc(_GRAY, None) + b"\x1c\x08\x0a\x80\x04"
                          + struct.pack(">I", 6) + bytes(6), "bad field"),
    "size_129_form": (_iptc(_GRAY, None) + b"\x1c\x08\x0a\x81\x00\x06" + bytes(6), "ok"),
    "repeated_field": (_iptc(_GRAY, bytes(6)).replace(
        b"\x1c\x03\x14", b"\x1c\x02\x05\x00\x01x\x1c\x02\x05\x00\x01y\x1c\x03\x14"), "ok"),
}


@pytest.mark.parametrize("case", sorted(IPTC_CASES))
def test_iptc_rules_as_pil(tmp_path, case):
    """`_open`'s and `load`'s edges: a first byte other than 0x1C, five
    zero bytes, an unknown record, missing or cut records and a width of 0
    give way; no compression or another than 1 and 5, and a field size
    over 132, fail `Image.open` itself (PIL's OSError), not a give-way; no
    image field, cut data, junk after the data and the IIM's standard
    extended size (0x8004, which PIL reads as a size of 0) fail at load;
    PIL's 0x81 form of a size and repeated fields read. Each as PIL."""
    data, pil_says = IPTC_CASES[case]
    path = _write(tmp_path, data)
    want = _pil(data)
    if pil_says == "ok":
        assert np.array_equal(png.read_image(path), want)
        return
    assert isinstance(want, Exception), want
    try:
        got = iptc.decode_iptc(data)
    except GiveWay as err:
        got = ("give way", str(err))
    except ValueError as err:
        got = str(err)
    if pil_says == "give way":
        assert got[0] == "give way", got
        assert type(want).__name__ == "UnidentifiedImageError", want
        return
    assert isinstance(got, str) and pil_says in got, got
    with pytest.raises(ValueError, match=pil_says):
        png.read_image(path)
    try:
        IptcImagePlugin.IptcImageFile(io.BytesIO(data))
        opened = True
    except OSError:
        opened = False
    assert opened == (pil_says not in ("Unknown IPTC image compression",
                                       "illegal field length")), case


def test_iptc_jpeg_other_than_a_gray_one_of_its_size_refused(tmp_path):
    """A colour JPEG in a one-layer record (PIL reads its stored pixels'
    four bytes as gray samples) and a JPEG of another size than the header
    (PIL lays its samples out in rows of the header's width) are refused
    with those causes; a gray JPEG of the header's size equals PIL."""
    rng = np.random.default_rng(8)
    gray = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    base = iptc.encode_iptc(gray, "jpeg")
    at = base.index(b"\x1c\x08\x0a")
    for img, words in ((rng.integers(0, 256, (9, 13, 3), dtype=np.uint8), "colour JPEG"),
                       (gray[:5, :7], "of 7x5 in an image of 13x9")):
        j = jpeg.encode_jpeg(img)
        data = base[:at] + _field(8, 10, j)
        assert isinstance(_pil(data), np.ndarray)        # PIL reads something
        with pytest.raises(ValueError, match=words):
            png.read_image(_write(tmp_path, data))


# ------------------------------------------------------------------ A3
def test_a3_jpeg_markers_pil_refuses(tmp_path):
    """A3: markers 0x02-0xBF anywhere, and TEM (0x01) before the first
    scan, make PIL's JPEG `_open` ("no marker found") or libjpeg
    ("unsupported marker type") refuse the file; the port's JPEG reader
    skipped them and decoded. Now it refuses them; RSTn before the scan
    and TEM between scans still read, as in PIL."""
    img = natural(16, 24, 3, 9)
    data = jpeg.encode_jpeg(img, progressive=True)
    sof = data.index(b"\xff\xc2")
    for marker in (0x01, 0x02, 0x39, 0xBF):
        bad = data[:sof] + bytes((0xFF, marker)) + (b"\x00\x04ab" if marker != 1 else b"") \
            + data[sof:]
        path = _write(tmp_path, bad, f"m{marker}.jpg")
        with pytest.raises(Exception):
            np.asarray(Image.open(path))
        for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
            with pytest.raises(ValueError, match=f"marker 0x{marker:02X}"):
                read(path)
    second = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    for extra in (b"\xff\xd3", b"\xff\x01"):
        at = sof if extra == b"\xff\xd3" else second
        ok = data[:at] + extra + data[at:]
        path = _write(tmp_path, ok, "ok.jpg")
        want = np.asarray(Image.open(path))
        assert np.array_equal(jpeg.read_jpeg(path), want), extra


# ------------------------------------------------------------------ fixtures
def test_raw_sample_fixtures_digests():
    """The fixtures of `tests/data/raw_samples/` (at least 30): each gives
    its recorded digest and shape through `read_image` and through the
    plain route (FLI's plain walk, FTEX's plain BC1; the others have one
    route), or, where the record has no array (SPIDER's floats: B21), both
    raise the same cause; and the fixture tool's `digests` recomputes every
    record from PIL."""
    from gaussianmesh_tpu_torch.io import fits, ftex, mcidas, pixar, spider, xvthumb

    with open(os.path.join(RAW_SAMPLES, "digests.json")) as fh:
        table = json.load(fh)
    assert len(table) >= 30
    plain = {".fli": fli.decode_fli_plain, ".flc": fli.decode_fli_plain,
             ".gbr": gbr.decode_gbr, ".im": im.decode_im, ".imt": imt.decode_imt,
             ".iim": iptc.decode_iptc, ".pxr": pixar.decode_pixar,
             ".mcidas": mcidas.decode_mcidas, ".xv": xvthumb.decode_xvthumb,
             ".fits": fits.decode_fits, ".spi": spider.decode_spider,
             ".ftc": ftex.decode_ftex_plain, ".ftu": ftex.decode_ftex_plain}
    for name, want in sorted(table.items()):
        path = os.path.join(RAW_SAMPLES, name)
        with open(path, "rb") as fh:
            data = fh.read()
        assert digests(data) == want, name
        decode = plain[os.path.splitext(name)[1]]
        if want["array"] is None:
            causes = set()
            for run in (lambda: png.read_image(path), lambda: decode(data, path)):
                with pytest.raises(ValueError) as err:
                    run()
                causes.add(str(err.value))
            assert len(causes) == 1 and "B21" in causes.pop(), name
            continue
        for a in (png.read_image(path), decode(data)):
            assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() == \
                want["array"] and list(a.shape) == want["shape"], name


# ------------------------------------------------------------------ COLMAP
def _raw_sample_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    views rewritten as an FLI of BRUN (B15), an FLC of COPY and 64 levels
    (B15), a raw and a JPEG gray IPTC, an IM of `RGB`, of a colour `Lut`
    (B15), of `YCC` (B30), of `L 16` (B7), of `CMYK` (B14), an IMT, and
    a GBR of each version, in turn. -> (proxy, {image name: PIL's array
    under the port's rule})."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    levels = np.array([8, 8, 4])
    steps = [(np.arange(n) * 255 // (n - 1)) for n in levels]
    pal = np.stack(np.meshgrid(*steps, indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
    oracle = {}
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        gray = img[..., 1]
        q = (img.astype(np.int64) * levels // 256)
        idx = ((q[..., 0] * levels[1] + q[..., 1]) * levels[2] + q[..., 2]).astype(np.uint8)
        ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
        data = (fli.encode_fli(idx, pal),
                fli.encode_fli(idx, pal, chunk="copy", flc=True, levels=64),
                iptc.encode_iptc(gray),
                iptc.encode_iptc(gray, "jpeg"),
                im.encode_im(img, "RGB"),
                im.encode_im(idx, "P", lut=pal),
                im.encode_im(ycc, "YCbCr"),
                im.encode_im(gray.astype(np.uint16) * 257, "I;16"),
                im.encode_im(np.concatenate([255 - img, gray[..., None] // 3], 2), "CMYK"),
                imt.encode_imt(gray),
                gbr.encode_gbr(gray, version=1),
                gbr.encode_gbr(gray))[i % 12]
        with open(path, "wb") as fh:
            fh.write(data)
        oracle[name] = port_array(data)[0]
    return mesh, oracle


def test_raw_sample_colmap_scene_matches_jax_and_trains(tmp_path, monkeypatch):
    """`read_scene` on one COLMAP set of the five formats equals, at -r 1
    and 2, the JAX reader's on the same set with each view replaced by
    PIL's array under the port's rule written as a PNG, exactly; the JAX
    reader on the files themselves differs on the views of a fault. Read
    again with the FLI plain walk made to raise, the same scene; and
    `cli.train_mesh --device cpu` trains 2 iterations on it."""
    root = str(tmp_path / "s")
    mesh, oracle = _raw_sample_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    faulty = jreaders.read_scene(root, **kw[0])

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for mod, name in ((fli, "_frame_plain"), (png, "_unfilter_plain"),
                      (jpeg, "_scan_plain"), (jpeg, "_planes_plain")):
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
    differ = sum(not np.array_equal(wrong[n], a) for n, a in ported.items())
    assert differ >= 5, differ
