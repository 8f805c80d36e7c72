"""The port's FLI / FLC and GBR readers (`io/fli.py`, `io/gbr.py`) against
PIL 12, and `read_image`'s order of formats against `Image.open`'s.

Every FLI frame chunk PIL's `fli` decoder walks (BRUN, COPY, LC, SS2,
BLACK, the stamp, palettes of 256 and 64 levels) decodes through
`gm_fli_frame` and its plain walk to PIL's `convert("RGB")` (B15); on
damaged files of each chunk kind the two walks give the same bytes or the
same error, and PIL's where it loads; the frame's size, its chunks'
advances and the palette search follow PIL's rules; the forms PIL cannot
load raise with its cause. GIMP brushes of both versions, gray and RGBA,
equal PIL; the heads PIL gives way on give way. `png._ORDER` is the order
`Image.open` tries formats in, a TGA head FLI or GBR takes goes to that
reader, and every fixture under `tests/data/` reaches the reader of the
format `Image.open` names (IM, IMT and IPTC, which have no `_accept`,
take no file of a later format)."""

import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu_torch.io import fli, gbr, png, sun, tga
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from tools.make_raw_sample_fixtures_torch import natural, port_array

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SIZES = [(1, 1), (2, 3), (23, 17), (300, 5)]                 # (width, height)
# PIL's format names -> the port's
NAMES = {"WEBP": "WebP", "PPM": "PNM", "XVThumb": "XVTHUMB"}


def _pil(data):
    """PIL's array of a file under the port's rule (the fixture tool's
    `port_array`), or the exception PIL raises."""
    try:
        return port_array(data)[0]
    except Exception as err:           # PIL raises OSError, ValueError, SyntaxError
        return err


def _outcome(decode, data):
    try:
        return decode(data, "<file>")
    except GiveWay as err:
        return ("give way", str(err))
    except ValueError as err:
        return str(err)


def _write(tmp_path, data, name="f"):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _indices(w, h, seed, flat=False):
    """Indices with runs (a column repeated) or noise, uint8 (h, w)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if flat:
        idx = np.repeat(idx[:, :1], w, 1)
        idx[:, w // 2:] = rng.integers(0, 256)
    return idx


def _palette(seed):
    return np.random.default_rng(seed).integers(0, 256, (256, 3)).astype(np.uint8)


# ------------------------------------------------------------------ FLI
@pytest.mark.parametrize("chunk", ["brun", "copy", "lc", "ss2"])
@pytest.mark.parametrize("levels,flc", [(256, False), (64, True)])
def test_fli_chunks_equal_pil(tmp_path, chunk, levels, flc):
    """Each chunk kind the writer writes, at 1x1 to 300x5 (even widths for
    SS2), noise and runs: `read_image` (`gm_fli_frame`) = the plain walk =
    PIL's `convert("RGB")` (B15), 64-level palettes shifted by 2."""
    for k, (w, h) in enumerate(SIZES):
        w += w % 2 if chunk == "ss2" else 0
        for flat in (False, True):
            data = fli.encode_fli(_indices(w, h, k, flat), _palette(k), chunk=chunk, flc=flc,
                                  levels=levels)
            want = _pil(data)
            if isinstance(want, Exception):   # a 1x1 COPY chunk is under 10 bytes
                assert "buffer overrun" in str(want) and (w, h, chunk) == (1, 1, "copy")
                for decode in (fli.decode_fli, fli.decode_fli_plain):
                    with pytest.raises(ValueError, match="buffer overrun"):
                        decode(data)
                continue
            path = _write(tmp_path, data)
            assert Image.open(path).format == "FLI"
            got = png.read_image(path)
            assert got.shape == (h, w, 3) and np.array_equal(got, want), (w, h, flat)
            assert np.array_equal(fli.decode_fli_plain(data), got)


def _damaged(data, rng):
    """One damage: bytes past the header changed, or the file cut."""
    d = bytearray(data)
    if rng.random() < 0.6:
        for _ in range(rng.integers(1, 4)):
            k = int(rng.integers(128, len(d)))
            d[k] = int(rng.integers(0, 256))
    else:
        d = d[:int(rng.integers(128, len(d)))]
    return bytes(d)


@pytest.mark.parametrize("chunk", ["brun", "copy", "lc", "ss2", "black"])
def test_fli_damaged_walks_equal_and_pil(chunk):
    """64 damaged files a chunk kind: `gm_fli_frame` = its plain walk (the
    bytes, or the same error) = PIL (the bytes, or an error where PIL
    fails)."""
    rng = np.random.default_rng({"brun": 1, "copy": 2, "lc": 3, "ss2": 4, "black": 5}[chunk])
    kinds = set()
    for i in range(64):
        w, h = int(rng.integers(2, 40)) * 2, int(rng.integers(1, 12))
        data = _damaged(fli.encode_fli(_indices(w, h, i, i % 2 == 0), _palette(i), chunk=chunk,
                                       levels=(64, 256)[i % 2]), rng)
        got, plain, want = (_outcome(fli.decode_fli, data), _outcome(fli.decode_fli_plain, data),
                            _pil(data))
        if isinstance(got, np.ndarray):
            assert np.array_equal(got, plain), i
            assert isinstance(want, np.ndarray) and np.array_equal(got, want), (i, want)
            kinds.add("decoded")
        else:
            assert got == plain, i
            assert isinstance(want, Exception), (i, got)
            kinds.add("raised")
    assert kinds == {"raised"} if chunk == "black" else kinds == {"decoded", "raised"}


def _frame(subs, w=6, h=2, framesize=None, n_frames=1, magic=0xAF11):
    """An FLI file of one frame of the sub-chunks `subs` (header size and
    frame size as written unless `framesize`)."""
    body = b"".join(subs)
    frame = struct.pack("<IHH8x", 16 + len(body) if framesize is None else framesize,
                        0xF1FA, len(subs)) + body
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 128 + len(frame), magic, n_frames, w, h, 8, 0)
    return bytes(head) + frame


def _sub(kind, body):
    body += b"\0" * (len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


_BRUN_6x2 = _sub(15, bytes([0, 6, 9, 0, 250, 1, 2, 3, 4, 5, 6]))
_STAMP = _sub(18, bytes(10))
_PAL0 = _sub(4, struct.pack("<H", 0))    # ends `_open`'s walk over the chunk sizes
_ODD = struct.pack("<IHH8x", 50, 0xF1FA, 2) + _BRUN_6x2 + struct.pack("<IH", 15, 18) + bytes(9)
FRAME_CASES = {
    # (file, PIL's outcome: "ok", or words of its error, or "give way")
    "brun_then_stamp": (_frame([_BRUN_6x2, _STAMP]), "ok"),
    "lone_black_6_bytes": (_frame([_sub(13, b"")]), "buffer overrun"),
    "black_then_stamp": (_frame([_BRUN_6x2, _sub(13, b""), _STAMP]), "ok"),
    "no_chunks": (_frame([]), "ok"),
    "unknown_chunk": (_frame([_PAL0, _sub(99, bytes(8)), _STAMP]),
                      "unrecognized data stream"),
    "advance_zero": (_frame([_PAL0, struct.pack("<IH", 0, 18) + bytes(8), _STAMP]),
                     "broken data stream"),
    "advance_past_frame": (_frame([_PAL0, struct.pack("<IH", 400, 18) + bytes(8), _STAMP]),
                           "buffer overrun"),
    "advance_negative": (_frame([_PAL0, struct.pack("<IH", 0xFFFFFFF0, 18) + bytes(8),
                                  _STAMP]),
                         "buffer overrun"),
    "framesize_zero": (_frame([_BRUN_6x2], framesize=0), "image file is truncated"),
    "framesize_5": (_frame([_BRUN_6x2], framesize=5), "buffer overrun"),
    "framesize_huge": (_frame([_BRUN_6x2, _STAMP], framesize=0x80000010),
                       "image file is truncated"),
    "framesize_one_pad_byte": (_frame([])[:128] + _ODD, "ok"),
    "framesize_short": (_frame([_BRUN_6x2, _STAMP], framesize=45), "buffer overrun"),
    "advances_past_file_in_open": (_frame([struct.pack("<IH", 400, 18) + bytes(8), _STAMP]),
                                   "give way"),
    "framesize_past_file": (_frame([_BRUN_6x2, _STAMP], framesize=200),
                            "image file is truncated"),
    "copy_cut_at_file_end": (_frame([_sub(16, bytes(12))[:-4]]), "image file is truncated"),
    "lc_lines_past_height": (_frame([_sub(12, struct.pack("<HH", 1, 5) + bytes(5)), _STAMP]),
                             "buffer overrun"),
    "ss2_skip_past_height": (_frame([_sub(7, struct.pack("<HH", 1, 65536 - 3)), _STAMP]),
                             "buffer overrun"),
    "ss2_last_byte_word": (_frame([_sub(7, struct.pack("<HHH", 1, 0x8000 | 77, 0)), _STAMP]),
                           "ok"),
    "zero_frames": (_frame([_BRUN_6x2, _STAMP], n_frames=0), "give way"),
    "zero_width": (_frame([_BRUN_6x2, _STAMP], w=0), "give way"),
    "header_cut": (_frame([_BRUN_6x2])[:127], "give way"),
    "reserved_bytes_set": (_frame([_BRUN_6x2])[:50] + b"\1" + _frame([_BRUN_6x2])[51:],
                           "give way"),
    "frame_cut_to_5_bytes": (_frame([_BRUN_6x2])[:133], "give way"),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_fli_frame_rules_as_pil(tmp_path, case):
    """Hand-made frames at the decoder's and `_open`'s edges: the chunk
    bound of 10 bytes, BLACK and the stamp, unknown chunks, advances of 0,
    past the frame and negative, frame sizes of 0, 5, unsigned past 2**31,
    one pad byte short and past the file, a COPY the file cuts, LC lines
    and an SS2 skip past the height, SS2's last-byte word, 0 frames, a
    width of 0, cut or non-zero headers and chunk sizes `_open` walks past
    the file: both walks as PIL."""
    data, pil_says = FRAME_CASES[case]
    want = _pil(data)
    got, plain = _outcome(fli.decode_fli, data), _outcome(fli.decode_fli_plain, data)
    if pil_says == "ok":
        assert isinstance(want, np.ndarray), want
        assert np.array_equal(got, want) and np.array_equal(plain, want)
        return
    assert isinstance(want, Exception)
    if pil_says == "give way":
        assert got[0] == "give way" and got == plain, got
        assert type(want).__name__ == "UnidentifiedImageError", want
        return
    assert pil_says in str(want), want
    assert isinstance(got, str) and got == plain and pil_says in got, got


def test_fli_palette_search_as_pil(tmp_path):
    """The palette: chunk 11's levels shifted by 2 and wrapped (63 -> 252,
    64 -> 0), packets with skips, a count of 0 meaning 256, the first
    palette chunk found after a stamp, a prefix chunk before the frame
    (PIL finds its palette, and then cannot load the frame: "unrecognized
    data stream contents"), a skip past entry 255 or a cut palette (PIL's
    IndexError: give way)."""
    brun = _sub(15, bytes([0, 250, 0, 1, 2, 3, 4, 5, 0, 250, 6, 7, 8, 9, 10, 11]))
    entries = np.array([[63, 64, 255], [1, 2, 3], [0, 127, 128]] * 4, np.uint8)
    packet = lambda skip, n: bytes((skip, n % 256)) + entries[:n].tobytes()
    cases = {
        "shift_64": _frame([_sub(11, struct.pack("<H", 1) + packet(0, 12)), brun]),
        "skips_256": _frame([_sub(4, struct.pack("<H", 2) + packet(3, 5) + packet(240, 2)),
                             brun]),
        "count_0_is_256": _frame([_sub(4, struct.pack("<H", 1) + bytes((0, 0))
                                       + _palette(3).tobytes()), brun]),
        "after_stamp": _frame([_STAMP, _sub(4, struct.pack("<H", 1) + packet(1, 3)), brun]),
    }
    for name, data in cases.items():
        want = _pil(data)
        assert isinstance(want, np.ndarray), (name, want)
        assert np.array_equal(png.read_image(_write(tmp_path, data)), want), name
    got = fli.decode_fli(cases["shift_64"])
    assert got[0, 0].tolist() == [252, 0, 252] and got[0, 1].tolist() == [4, 8, 12]
    base = _frame([_sub(4, struct.pack("<H", 1) + packet(1, 3)), brun], magic=0xAF12)
    prefixed = base[:128] + _sub(0xF100, bytes(10)) + base[128:]
    assert "unrecognized data stream" in str(_pil(prefixed))
    with pytest.raises(ValueError, match="unrecognized data stream contents"):
        fli.decode_fli(prefixed)
    for data in (_frame([_sub(4, struct.pack("<H", 1) + packet(255, 3)), brun]),
                 _frame([_sub(4, struct.pack("<H", 1) + bytes((0, 10)) + bytes(7))])):
        assert type(_pil(data)).__name__ == "UnidentifiedImageError"
        with pytest.raises(GiveWay):
            fli.decode_fli(data)


# ------------------------------------------------------------------ GBR
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("channels", [1, 4])
def test_gbr_equals_pil(tmp_path, version, channels):
    """Brushes of each version, gray and RGBA (version 1 with 4 bytes a
    pixel too, as PIL reads it), at 1x1 to 300x5, comments of 0 to 40
    bytes: `read_image` = PIL, trailing bytes ignored."""
    for k, (w, h) in enumerate(SIZES):
        img = natural(h, w, channels, k)
        img = img[..., 0] if channels == 1 else img
        for comment in (b"", b"x" * 40):
            data = gbr.encode_gbr(img, version=version, comment=comment) + b"tail"
            path = _write(tmp_path, data)
            assert Image.open(path).format == "GBR"
            got = png.read_image(path)
            assert np.array_equal(got, img) and np.array_equal(got, _pil(data))


def _gbr_head(size=28, version=2, w=3, h=2, depth=1, magic=b"GIMP"):
    return struct.pack(">5I", size, version, w, h, depth) + (magic + bytes(4)
                                                             if version == 2 else b"")


GBR_CASES = {
    "size_under_20": (_gbr_head(size=19) + bytes(6), "give way"),
    "version_3": (_gbr_head(version=3) + bytes(6), "give way"),
    "depth_2": (_gbr_head(depth=2) + bytes(12), "give way"),
    "zero_width": (_gbr_head(w=0) + bytes(6), "give way"),
    "bad_magic": (_gbr_head(magic=b"GIMQ") + bytes(6), "give way"),
    "spacing_cut": (_gbr_head()[:26], "give way"),
    "header_cut": (_gbr_head()[:12], "give way"),
    "v2_header_size_24": (_gbr_head(size=24) + bytes(6), "not enough image data"),
    "pixels_cut": (_gbr_head() + bytes(5), "not enough image data"),
    "v1_header_past_file": (_gbr_head(size=400, version=1) + bytes(6),
                            "not enough image data"),
}


@pytest.mark.parametrize("case", sorted(GBR_CASES))
def test_gbr_refusals_as_pil(case):
    """The heads PIL's `_open` refuses give way; a version-2 header size of
    20-27 (PIL reads the comment to the file's end), cut pixels and a
    header past the file raise PIL's "not enough image data"."""
    data, pil_says = GBR_CASES[case]
    want, got = _pil(data), _outcome(gbr.decode_gbr, data)
    assert isinstance(want, Exception)
    if pil_says == "give way":
        assert got[0] == "give way", got
        assert type(want).__name__ == "UnidentifiedImageError", want
    else:
        assert pil_says in str(want) and pil_says in got, (want, got)


# ------------------------------------------------------------------ dispatch
def test_order_is_pils():
    """`png._ORDER` is the order `Image.open` tries formats in, in a fresh
    process (the plugins `preinit` loads first, then the rest as `init`
    registers them, which `Image.open` calls where those fail), for every
    format the port tries; FORMATS names them all but SPIDER, which is
    tried and read by none; only MPEG is still taken before TGA."""
    code = ("import io, sys; from PIL import Image\n"
            "Image.open(io.BytesIO(b'P5 1 1 255 x')).load()\n"
            "Image.init()\n"
            "print(' '.join(Image.ID))")
    ids = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    ours = [name for name, _, _ in png._ORDER]
    assert [NAMES.get(i, i) for i in ids if NAMES.get(i, i) in ours] == ours
    assert sorted(png.FORMATS) == sorted(set(ours) - {"SPIDER"}) and len(png.FORMATS) == 33
    assert [name for name, _ in png._BEFORE_TGA] == ["MPEG"]


def test_tga_heads_fli_or_gbr_take(tmp_path):
    """A TGA head whose bytes FLI's or GBR's `_accept` takes goes to that
    reader first, as in PIL: an FLI whose head passes TGA's checks (its
    size field's third byte a TGA image type, its flags 3 a height) is read
    as FLI; TGAs FLI or GBR accept and then give way on are read as TGA.
    (GBR's depth word puts a 0 where TGA's depth byte is, so no brush
    passes TGA's checks.)"""
    flic = bytearray(fli.encode_fli(_indices(6, 2, 1), _palette(1)))
    flic[1], flic[2], flic[14], flic[16] = 0, 10, 3, 24   # TGA: no map, type 10, height 3,
    #                                                       depth 24 (FLI's depth 8 the width)
    data = bytes(flic)
    assert tga.tga_header(data[:68]) is not None and fli.fli_accept(data)
    path = _write(tmp_path, data, "flic")
    assert Image.open(path).format == "FLI"
    assert np.array_equal(png.read_image(path), _pil(data))
    img = natural(3, 6, 3, 2)
    for name, patch in (("fli", {4: 0x11, 5: 0xAF}), ("gbr", {7: 1})):
        t = bytearray(tga.encode_tga(img))
        for k, v in patch.items():
            t[k] = v
        data = bytes(t)
        accept = fli.fli_accept if name == "fli" else gbr.gbr_accept
        assert accept(data) and tga.tga_header(data[:68]) is not None, name
        path = _write(tmp_path, data, name)
        assert Image.open(path).format == "TGA"
        assert np.array_equal(png.read_image(path), np.asarray(Image.open(path))), name


def test_sun_raster_pil_takes_for_a_brush_is_read_as_one(tmp_path):
    """A Sun raster of width 1 and length field 1 (GBR version 1 of depth
    1 to PIL) whose header size field sits past the file: both raise PIL's
    "not enough image data"; one whose brush header PIL reads whole is read
    as the brush PIL reads."""
    column = natural(3, 1, 1, 4)[..., 0]
    data = bytearray(sun.encode_sun(column))
    data[16:20] = struct.pack(">I", 1)
    path = _write(tmp_path, bytes(data))
    assert Image.open(path).format == "GBR"
    with pytest.raises(ValueError, match="not enough image data"):
        png.read_image(path)
    brush = gbr.encode_gbr(column, version=1)
    assert Image.open(_write(tmp_path, brush, "b")).format == "GBR"
    assert np.array_equal(png.read_image(str(tmp_path / "b")), column)


def _recording_order(monkeypatch, seen):
    """`png._ORDER` with each reader recording its format's name in `seen`."""
    def wrap(name, read):
        def rec(path):
            seen.append(name)
            return read(path)
        return rec
    monkeypatch.setattr(png, "_ORDER", tuple((name, accept, wrap(name, read))
                                             for name, accept, read in png._ORDER))


@pytest.mark.parametrize("folder", sorted(d for d in os.listdir(DATA)
                                          if os.path.isdir(os.path.join(DATA, d))))
def test_every_fixture_reaches_the_format_pil_names(monkeypatch, folder):
    """Every image file under `tests/data/<folder>` (sub-folders too) is
    last handed to the reader of the format `Image.open` names, whether it
    decodes or raises (a cut WebP): IM, IMT and IPTC, tried on every file
    that reaches them, give way on the others."""
    seen = []
    _recording_order(monkeypatch, seen)
    n = 0
    for root, _, files in os.walk(os.path.join(DATA, folder)):
        for name in sorted(files):
            if name.endswith(".json"):
                continue
            path = os.path.join(root, name)
            fmt = Image.open(path).format
            seen.clear()
            try:
                png.read_image(path)
            except ValueError as err:
                assert "not a JPEG" not in str(err), (path, err)
            assert seen and seen[-1] == NAMES.get(fmt, fmt), (path, fmt, seen)
            n += 1
    assert n >= 10, folder
