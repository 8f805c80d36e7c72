"""The port's LZW, PackBits and RLE readers on the CPU, against PIL 12 and
the JAX reader: LZW and PackBits TIFFs that PIL writes through libtiff (L,
LA, RGB, RGBA, P, predictor 1 and 2) and the port's own in both byte
orders; 16-bit gray (fault B7), RGB and RGBA TIFFs; 1-bit TIFFs, BMPs and
PNGs (fault B16); RLE8, RLE4, 1-, 4- and 16-bit BMPs, the escapes PIL
misreads held to the format (fault B17); GIFs (interlaced, transparent,
local palettes, offset frames, gray); the C++ decoders and encoder
(`gm_lzw_decode`, `gm_lzw_encode`, `gm_packbits_decode`, `gm_bmp_rle`) held
to their plain versions byte for byte on the files and on damaged streams
(the same bytes or the same error); and a COLMAP scene of every new form
through `read_scene` on both packages and `cli.train_mesh` on the CPU."""

import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import bmp, gif, jpeg, lzw, png, tiff
from tests.test_torch_image_formats import _bmp, _tiff
from tests.test_torch_readers import _assert_scene_equal

torch.set_num_threads(2)

VARIANTS = [("tiff", 8), ("gif", 2), ("gif", 4), ("gif", 8)]


def _picture(h, w, c, seed, levels=256):
    """A render-like picture: flat background, a gradient, noise in a box."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 7 + y * 3 + 40 * k) % levels for k in range(c)], -1)
    box = (slice(h // 4, 3 * h // 4 + 1), slice(w // 3, 2 * w // 3 + 1))
    img[box] = rng.integers(0, levels, img[box].shape)
    img[:h // 5] = levels - 1
    return img.astype(np.uint8)


def _outcome(fn, *args):
    """fn(*args) -> its bytes, or the message of the ValueError it raises."""
    try:
        return np.asarray(fn(*args)).tobytes()
    except ValueError as err:
        return f"ValueError: {err}"


def _damaged(data, rng, n_cut=24, n_flip=40):
    """`data` cut at n_cut places and with n_flip single bytes changed."""
    out = [data[:int(f * len(data))] for f in np.linspace(0.0, 0.97, n_cut)]
    for at, value in zip(rng.integers(0, max(1, len(data)), n_flip),
                         rng.integers(0, 256, n_flip)):
        out.append(data[:at] + bytes([value]) + data[at + 1:])
    return out


def _held(native, plain, cases):
    """native and plain on each case: the same bytes or the same error; ->
    the errors seen."""
    errors = set()
    for i, args in enumerate(cases):
        a, b = _outcome(native, *args), _outcome(plain, *args)
        assert a == b, (i, a if isinstance(a, str) else b)
        if isinstance(a, str):
            errors.add(a.split(": ", 2)[-1])
    return errors


# -------------------------------------------------------------------- LZW
@pytest.mark.parametrize("variant,min_bits", VARIANTS, ids=lambda v: str(v))
def test_lzw_encode_decode_native_equals_plain(variant, min_bits):
    """`gm_lzw_encode` == `lzw_encode_plain` byte for byte and both decoders
    return the input, on empty, one-byte, flat (KwKwK codes all through),
    random and picture inputs past several table fills, with a Clear at
    4,094, at 300 and never (the table held full: the deferred clear)."""
    rng = np.random.default_rng(min_bits)
    top = 1 << min_bits
    inputs = [np.zeros(0, np.uint8), np.array([top - 1], np.uint8),
              np.full(9000, top - 1, np.uint8),
              rng.integers(0, top, 20000, dtype=np.uint8),
              (_picture(90, 120, 1, min_bits, top)).ravel()]
    for data in inputs:
        for clear_at in (lzw.CLEAR_AT, 300, lzw.TABLE):
            enc = lzw.lzw_encode(data, variant, min_bits, clear_at)
            assert enc == lzw.lzw_encode_plain(data, variant, min_bits, clear_at)
            for decode in (lzw.lzw_decode, lzw.lzw_decode_plain):
                got = decode(enc, data.size, variant, min_bits)
                assert got.dtype == np.uint8 and np.array_equal(got, data)


@pytest.mark.parametrize("variant,min_bits", VARIANTS, ids=lambda v: str(v))
def test_lzw_damaged_streams_as_plain(variant, min_bits):
    """A picture's stream cut at 24 places, with 40 single bytes changed, 8
    random streams and 4 with a code past the table: the C++ decoder gives
    the plain one's bytes or raises its error, at the strip's size and past
    it; both raise on a code past the table and on output past the size."""
    rng = np.random.default_rng(100 + min_bits)
    data = _picture(40, 50, 1, 3, 1 << min_bits).ravel()
    enc = lzw.lzw_encode(data, variant, min_bits)
    cases = _damaged(enc, rng) + [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                                  for n in (1, 2, 3, 10, 50, 200, 1000, 3000)]
    bad = bytearray(enc)
    for at in (2, 5, len(enc) // 2, len(enc) - 4):
        bad2 = bytearray(bad)
        bad2[at] = bad2[at + 1] = 0xFF
        cases.append(bytes(bad2))
    assert len(cases) >= 64
    args = [(c, data.size, variant, min_bits) for c in cases]
    args += [(c, data.size // 2, variant, min_bits) for c in cases[:30]]
    errors = _held(lzw.lzw_decode, lzw.lzw_decode_plain, args)
    assert any("past the table" in e for e in errors), errors
    assert any("decodes past" in e for e in errors), errors
    short = lzw.lzw_decode(enc[:len(enc) // 2], data.size, variant, min_bits)
    assert 0 < len(short) < data.size


def test_lzw_encode_native_equals_plain_on_random_inputs():
    """`gm_lzw_encode` against `lzw_encode_plain` on 64 seeded inputs of
    random lengths, alphabets and run structures, both variants."""
    rng = np.random.default_rng(7)
    for i in range(64):
        variant, min_bits = VARIANTS[i % 4]
        n = int(rng.integers(0, 6000))
        alphabet = int(rng.integers(1, (1 << min_bits) + 1))
        data = np.repeat(rng.integers(0, alphabet, n, dtype=np.uint8),
                         rng.integers(1, 5, n))[:n]
        clear_at = int(rng.choice([lzw.CLEAR_AT, lzw.TABLE, 1000]))
        enc = lzw.lzw_encode(data, variant, min_bits, clear_at)
        assert enc == lzw.lzw_encode_plain(data, variant, min_bits, clear_at), i
        assert np.array_equal(lzw.lzw_decode(enc, n, variant, min_bits), data), i


def test_lzw_encoder_refuses_bytes_past_its_literals():
    for encode in (lzw.lzw_encode, lzw.lzw_encode_plain):
        with pytest.raises(ValueError, match="past 2-bit literals"):
            encode(np.array([0, 4], np.uint8), "gif", 2)


# --------------------------------------------------------------- PackBits
def test_packbits_native_equals_plain():
    """Hand-made packets (a literal, a run, the -128 no-op), the port's
    writer on pictures and their damaged streams (>= 64): the C++ and the
    plain decoders give the same bytes or the same error."""
    hand = bytes([2, 1, 2, 3, 0x80, 0xFE, 9, 0, 7])
    want = bytes([1, 2, 3, 9, 9, 9, 7])
    for decode in (tiff.packbits_decode, tiff.packbits_decode_plain):
        assert decode(hand, 7).tobytes() == want
        assert decode(hand, 9).tobytes() == want            # the data ends first
    rng = np.random.default_rng(5)
    rows = _picture(30, 200, 1, 4)[..., 0]
    enc = tiff.packbits_encode(rows)
    assert len(enc) < rows.size
    for decode in (tiff.packbits_decode, tiff.packbits_decode_plain):
        assert np.array_equal(decode(enc, rows.size), rows.ravel())
    cases = [(c, rows.size) for c in _damaged(enc, rng)]
    cases += [(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), m)
              for n, m in zip(rng.integers(1, 400, 16), rng.integers(1, 500, 16))]
    assert len(cases) >= 64
    errors = _held(tiff.packbits_decode, tiff.packbits_decode_plain, cases)
    assert any("decodes past" in e for e in errors), errors


# ------------------------------------------------------------------- TIFF
def _same_tiff(data, want):
    got, plain = tiff.decode_tiff(data), tiff.decode_tiff_plain(data)
    assert got.dtype == plain.dtype == np.uint8 and got.shape == plain.shape == want.shape, \
        (got.shape, want.shape)
    assert np.array_equal(got, plain) and np.array_equal(got, want)
    return got


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1"])
def test_pil_lzw_and_packbits_tiffs(tmp_path, mode):
    """TIFFs that PIL writes through libtiff, LZW with predictor 1 and 2 and
    PackBits, one strip and strips of 3 rows: C++ == plain == PIL's array (a
    palette: `convert("RGB")`, B15; mode 1: `convert("L")`, B16)."""
    img = _picture(23, 37, 4, len(mode))
    im = {"L": lambda: Image.fromarray(img[..., 0]),
          "P": lambda: Image.fromarray(img[..., :3]).quantize(40),
          "1": lambda: Image.fromarray(img[..., 0] > 128)}.get(
        mode, lambda: Image.fromarray(img[..., :len(mode)], mode))()
    path = str(tmp_path / "x.tif")
    for kw in ({"compression": "tiff_lzw"}, {"compression": "tiff_lzw", "tiffinfo": {317: 2}},
               {"compression": "tiff_lzw", "tiffinfo": {317: 2, 278: 3}},
               {"compression": "packbits"}, {"compression": "packbits", "tiffinfo": {278: 3}}):
        if mode == "1" and 317 in kw.get("tiffinfo", {}):
            continue                        # libtiff: no predictor on 1-bit samples
        im.save(path, **kw)
        opened = Image.open(path)
        conv = {"P": "RGB", "1": "L"}.get(mode)
        _same_tiff(open(path, "rb").read(),
                   np.asarray(opened.convert(conv) if conv else opened))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression,predictor", [("lzw", 1), ("lzw", 2), ("packbits", 1)])
def test_written_tiffs_both_orders_equal_pil(compression, predictor, order):
    """`encode_tiff`'s 8-bit L, LA, RGB, RGBA and 16-bit L, RGB, RGBA files in
    both byte orders: read back to what was written (16-bit: its high byte)
    by both decoders, and PIL's array equal (16-bit gray: the high byte of
    PIL's I;16 values)."""
    base = _picture(19, 29, 4, 11)
    for dtype in (np.uint8, np.uint16):
        for c in (1, 2, 3, 4):
            if c == 2 and dtype == np.uint16:
                continue
            a = base[..., :c].astype(dtype)
            if dtype == np.uint16:
                a = a * 257 + np.arange(a.size, dtype=np.uint16).reshape(a.shape) % 251
            a = a[..., 0] if c == 1 else a
            data = tiff.encode_tiff(a, compression, predictor, order, rows_per_strip=6)
            want = (a >> 8).astype(np.uint8) if dtype == np.uint16 else a
            _same_tiff(data, want)
            pil = np.asarray(Image.open(io.BytesIO(data)))
            if dtype == np.uint16 and c == 1:
                pil = (pil >> 8).astype(np.uint8)
            assert np.array_equal(pil, want), (dtype, c)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", [1, 8, 5, 32773])
def test_crafted_16_bit_tiffs_equal_pil(order, compression):
    """Hand-made 16-bit gray, RGB, RGBA, RGBA with ExtraSamples 2 and RGB with
    an unspecified fourth sample, predictor 1 and 2, strips of 4 rows: the
    high byte of each sample (predictor 2 summed mod 65,536), equal to PIL's
    RGB;16 arrays and to the high byte of its I;16 gray (fault B7)."""
    rng = np.random.default_rng(compression)
    px = rng.integers(0, 65536, (9, 11, 4), dtype=np.uint16)
    px[2:5] = 40000
    for predictor in (1, 2):
        kw = dict(order=order, compression=compression, predictor=predictor,
                  rows_per_strip=4)
        for data, keep in ((_tiff(px[..., 0], **kw), 1), (_tiff(px[..., :3], **kw), 3),
                           (_tiff(px, **kw), 4), (_tiff(px, extra=[2], **kw), 4),
                           (_tiff(px, extra=[0], **kw), 3)):
            pil = np.asarray(Image.open(io.BytesIO(data)))
            if keep == 1:
                assert Image.open(io.BytesIO(data)).mode in ("I;16", "I;16B")
                pil = (pil >> 8).astype(np.uint8)
            want = (px[..., :keep] >> 8).astype(np.uint8)
            _same_tiff(data, want[..., 0] if keep == 1 else want)
            assert np.array_equal(pil, want[..., 0] if keep == 1 else want)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("compression", [1, 5, 32773])
def test_sub_byte_tiffs_equal_pil(bits, compression):
    """1-, 2- and 4-bit gray (`Photometric` 1 and white-is-zero 0) and
    palette TIFFs, rows padded to a byte: gray as PIL's `convert("L")` (1 bit:
    0 and 255 where the JAX reader takes PIL's bool array / 255, fault B16),
    palettes as `convert("RGB")` (B15)."""
    rng = np.random.default_rng(bits * 10 + compression)
    h, w = 7, 13
    v = rng.integers(0, 1 << bits, (h, w))
    bitsv = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
    packed = np.packbits(bitsv.astype(np.uint8), axis=1)
    cmap = rng.integers(0, 65536, 3 << bits)
    for photometric in (0, 1, 3):
        data = _tiff(packed, compression=compression, photometric=photometric,
                     cmap=cmap if photometric == 3 else None)
        data = data.replace(struct.pack("<HHIHH", 258, 3, 1, 8, 0),
                            struct.pack("<HHIHH", 258, 3, 1, bits, 0))
        data = data.replace(struct.pack("<HHII", 256, 4, 1, packed.shape[1]),
                            struct.pack("<HHII", 256, 4, 1, w))
        im = Image.open(io.BytesIO(data))
        if bits == 1:
            assert im.mode == ("P" if photometric == 3 else "1")
        want = np.asarray(im.convert("RGB" if photometric == 3 else "L"))
        got = _same_tiff(data, want)
        if bits == 1 and photometric == 1:
            assert set(np.unique(got)) <= {0, 255}
            assert np.asarray(im).dtype == bool          # what the JAX reader divides


def test_tiff_damaged_strips_as_plain():
    """An LZW file (predictor 2) and a PackBits file cut at 24 places and with
    40 single bytes of their strips changed: `decode_tiff` ==
    `decode_tiff_plain`, the same array or the same error; a strip cut short
    raises "cut short", one past its size "decodes past"."""
    img = _picture(24, 30, 3, 9)
    errors = set()
    for compression, predictor in (("lzw", 2), ("packbits", 1)):
        data = tiff.encode_tiff(img, compression, predictor, rows_per_strip=8)
        first = tiff._tags(data, "")[273][0]                  # the IFD stays whole
        rng = np.random.default_rng(len(compression))
        cases = [data[:first] + d for d in _damaged(data[first:], rng)]
        errors |= _held(tiff.decode_tiff, tiff.decode_tiff_plain, [(c,) for c in cases])
    assert any("cut short" in e for e in errors), errors


# -------------------------------------------------------------------- BMP
@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 13), (300, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_written_rle_bmps_equal_pil(rle4, size):
    """`encode_bmp(..., rle=True)` on pictures (long runs, noise, runs cut at
    255, absolute runs of every length): decoded by C++ and plain to the
    palette expansion of the indices written, and by PIL to the same
    (`convert("RGB")`); a gray-ramp palette (PIL's mode L) to the indices."""
    w, h = size
    top = 16 if rle4 else 256
    idx = _picture(h, w, 1, w, top)[..., 0]
    rng = np.random.default_rng(w * h)
    pal = rng.integers(0, 256, (top, 3), dtype=np.uint8)
    for palette, want in ((pal, pal[idx]),
                          (np.repeat(np.arange(top, dtype=np.uint8)[:, None], 3, 1), idx)):
        data = bmp.encode_bmp(idx, palette, 4 if rle4 else 8, rle=True)
        got, plain = bmp.decode_bmp(data), bmp.decode_bmp_plain(data)
        assert np.array_equal(got, want) and np.array_equal(plain, want)
        im = Image.open(io.BytesIO(data))
        assert np.array_equal(np.asarray(im.convert("RGB") if im.mode == "P" else im), want)


def _rle_file(codes, w, h, rle4, colors=16, top_down=False):
    pal = np.random.default_rng(w).integers(0, 256, (colors, 4), dtype=np.uint8)
    return _bmp([bytes(codes)], w, h, 4 if rle4 else 8, compression=2 if rle4 else 1,
                palette=pal.tobytes(), colors=colors, top_down=top_down)


def _same_bmp(data, want=None):
    got, plain = bmp.decode_bmp(data), bmp.decode_bmp_plain(data)
    assert np.array_equal(got, plain)
    if want is None:
        im = Image.open(io.BytesIO(data))
        want = np.asarray(im.convert("RGB") if im.mode == "P" else im)
    assert got.shape == want.shape and np.array_equal(got, want)
    return got


def test_rle_escapes_equal_pil():
    """Crafted RLE8 and RLE4 data against PIL: ends of line that leave the
    rest of a row at index 0, an encoded run past the row's end (cut there),
    an absolute run that crosses into the next row (not cut) and the
    encoded run after it in that row (cut to nothing), RLE4's alternating
    nibbles, absolute runs padded to 16 bits, top-down rows, no end of
    bitmap after the last row."""
    cases = [
        (_rle_file([2, 5, 0, 0, 3, 9, 0, 0, 4, 1, 0, 1], 4, 3, False, 256), "eol"),
        (_rle_file([9, 7, 0, 0, 4, 2, 4, 3], 4, 2, False, 256), "cut"),
        (_rle_file([0, 6, 1, 2, 3, 4, 5, 6, 3, 8, 0, 0, 4, 1, 0, 1], 4, 3, False, 256),
         "cross"),
        (_rle_file([0, 3, 1, 2, 3, 0, 1, 4, 0, 0, 4, 5], 4, 2, False, 256, True), "pad"),
        (_rle_file([5, 0x12, 0, 0, 0, 4, 0x34, 0x56, 0, 0, 5, 0xAB, 0, 1], 5, 3, True),
         "rle4"),
        (_rle_file([6, 0xF0, 0, 6, 0x12, 0x34, 0x56, 0, 2, 0x78, 0, 0], 6, 2, True), "rle4 b"),
    ]
    for data, name in cases:
        Image.open(io.BytesIO(data)).load()
        _same_bmp(data)


def test_rle_delta_and_odd_absolute_runs_b17():
    """Fault B17: PIL 12.1's `BmpRleDecoder` reads four bytes after a delta
    escape (its two, and the next code's) and an RLE4 absolute run of odd
    length k as k // 2 bytes (dropping its last pixel). The port reads both
    as the format defines them, held to the same pixels written without
    those escapes (zero runs for the delta, encoded runs for the odd
    pixel), which PIL reads right; PIL's reading of the escapes differs."""
    # delta (2 right, 1 up) from (1, 0) to (3, 1) in a 5 x 3 bitmap
    with_delta = _rle_file([1, 7, 0, 2, 2, 1, 2, 9, 0, 0, 5, 3, 0, 1], 5, 3, False, 256)
    without = _rle_file([1, 7, 4, 0, 0, 0, 3, 0, 2, 9, 0, 0, 5, 3, 0, 1], 5, 3, False, 256)
    oracle = np.asarray(Image.open(io.BytesIO(without)).convert("RGB"))
    _same_bmp(with_delta, oracle)
    try:
        pil = np.asarray(Image.open(io.BytesIO(with_delta)).convert("RGB"))
    except ValueError:
        pil = None
    assert pil is None or not np.array_equal(pil, oracle)
    # RLE4: an absolute run of 5 (3 bytes and a pad byte), then 2 more pixels
    with_odd = _rle_file([0, 5, 0x12, 0x34, 0x50, 0, 2, 0x67, 0, 1], 7, 1, True)
    without = _rle_file([0, 4, 0x12, 0x34, 1, 0x50, 2, 0x67, 0, 1], 7, 1, True)
    oracle = np.asarray(Image.open(io.BytesIO(without)).convert("RGB"))
    _same_bmp(with_odd, oracle)
    try:
        pil = np.asarray(Image.open(io.BytesIO(with_odd)).convert("RGB"))
    except ValueError:
        pil = None
    assert pil is None or not np.array_equal(pil, oracle)


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_rle_damaged_streams_as_plain(rle4):
    """A written RLE picture cut at 24 places and with 40 single bytes of its
    data changed, and 8 random streams: `gm_bmp_rle` and the plain walk give
    the same pixels or the same error ("ends after")."""
    w, h = 40, 20
    idx = _picture(h, w, 1, 2, 16 if rle4 else 256)[..., 0]
    pal = np.random.default_rng(0).integers(0, 256, (16 if rle4 else 256, 3), dtype=np.uint8)
    data = bmp.encode_bmp(idx, pal, 4 if rle4 else 8, rle=True)
    at = struct.unpack_from("<I", data, 10)[0]
    rng = np.random.default_rng(int(rle4))
    body = data[at:]
    cases = [data[:at] + d for d in _damaged(body, rng)]
    cases += [data[:at] + rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(2, 3000, 8)]
    assert len(cases) >= 64
    errors = _held(bmp.decode_bmp, bmp.decode_bmp_plain, [(c,) for c in cases])
    assert any("ends after" in e for e in errors), errors


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("width", [1, 9, 31])
def test_one_and_four_bit_bmps_equal_pil(bits, width):
    """Uncompressed 1- and 4-bit BMPs, rows padded to 4 bytes, bottom-up and
    top-down, full and short palettes: colour palettes as PIL's
    `convert("RGB")` (B15), a black-and-white 1-bit palette (PIL's mode 1)
    as `convert("L")`, 0 and 255 (B16); `encode_bmp`'s files as PIL reads
    them."""
    rng = np.random.default_rng(bits * width)
    h = 6
    for colors in (1 << bits, (1 << bits) // 2 + 1):
        idx = rng.integers(0, colors, (h, width)).astype(np.uint8)
        pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
        data = bmp.encode_bmp(idx, pal, bits)
        assert np.array_equal(_same_bmp(data), pal[idx])
        per = 8 // bits
        padded = np.zeros((h, -(-width // per) * per), np.uint8)
        padded[:, :width] = idx
        rows = [(r.reshape(-1, per) << (np.arange(per - 1, -1, -1) * bits)).sum(
            -1).astype(np.uint8).tobytes() for r in padded]
        palb = np.concatenate([pal[:, ::-1], np.zeros((colors, 1), np.uint8)], 1).tobytes()
        for top_down in (False, True):
            data = _bmp(rows if top_down else rows[::-1], width, h, bits, palette=palb,
                        colors=colors, top_down=top_down)
            assert np.array_equal(_same_bmp(data), pal[idx])
    if bits == 1:
        idx = rng.integers(0, 2, (h, width)).astype(np.uint8)
        data = bmp.encode_bmp(idx, np.array([[0, 0, 0], [255, 255, 255]], np.uint8), 1)
        im = Image.open(io.BytesIO(data))
        assert im.mode == "1" and np.asarray(im).dtype == bool
        got = _same_bmp(data, np.asarray(im.convert("L")))
        assert np.array_equal(got, idx * 255)


@pytest.mark.parametrize("header", [40, 56, 124])
def test_16_bit_bmps_every_pattern_equal_pil(header):
    """Every 16-bit pattern in one row, BI_RGB (5-5-5) and BI_BITFIELDS with
    the 5-6-5 and 5-5-5 masks (after a 40-byte header or inside a longer
    one), against PIL's `BGR;15` / `BGR;16` unpackers."""
    row = [np.arange(65536, dtype="<u2").tobytes()]
    for compression, masks in ((0, None), (3, (0xF800, 0x7E0, 0x1F, 0)),
                               (3, (0x7C00, 0x3E0, 0x1F, 0))):
        _same_bmp(_bmp(row, 65536, 1, 16, header=header, compression=compression,
                       masks=masks))


def test_one_bit_png_b16(tmp_path):
    """A 1-bit gray PNG (PIL's mode 1 as well): `read_image` gives 0 and 255
    as `convert("L")` does, where the JAX reader takes the bool array."""
    path = str(tmp_path / "b.png")
    bits = np.random.default_rng(0).uniform(size=(7, 12)) < 0.5
    Image.fromarray(bits).save(path)
    im = Image.open(path)
    assert im.mode == "1" and np.asarray(im).dtype == bool
    assert np.array_equal(png.read_image(path), np.asarray(im.convert("L")))


# -------------------------------------------------------------------- GIF
def _same_gif(data, want=None):
    got, plain = gif.decode_gif(data), gif.decode_gif_plain(data)
    assert got.dtype == np.uint8 and np.array_equal(got, plain)
    if want is None:
        im = Image.open(io.BytesIO(data))
        want = np.asarray(im if im.mode == "L" else im.convert(
            "RGBA" if "transparency" in im.info else "RGB"))
    assert got.shape == want.shape and np.array_equal(got, want), (got.shape, want.shape)
    return got


@pytest.mark.parametrize("interlace", [False, True], ids=["rows", "interlaced"])
@pytest.mark.parametrize("transparency", [None, 3], ids=["opaque", "transparent"])
def test_gifs_equal_pil(interlace, transparency):
    """PIL's GIFs (quantized RGB, 2- to 256-colour palettes, so LZW minimum
    code sizes 2-8) and `encode_gif`'s: C++ == plain == PIL's
    `convert("RGB")`, or `convert("RGBA")` with a transparent index; the
    port's files decode to the palette expansion of the indices written, at
    odd sizes where the interlace passes are short."""
    rng = np.random.default_rng(int(interlace) + 2 * (transparency or 0))
    img = _picture(29, 41, 3, 6)
    for colors in (2, 5, 16, 120, 256):
        buf = io.BytesIO()
        kw = {} if transparency is None else {"transparency": transparency}
        Image.fromarray(img).quantize(colors).save(buf, "GIF", interlace=interlace, **kw)
        _same_gif(buf.getvalue())
        for h, w in ((1, 1), (3, 7), (9, 17), (29, 41)):
            idx = rng.integers(0, colors, (h, w)).astype(np.uint8)
            idx[:h // 2, :w // 2] = colors - 1
            pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
            data = gif.encode_gif(idx, pal, interlace, transparency if colors > 3 else None)
            got = _same_gif(data)
            want = pal[idx]
            if transparency is not None and colors > 3:
                want = np.concatenate([want, np.where(idx == transparency, 0, 255)[..., None]
                                       .astype(np.uint8)], -1)
            assert np.array_equal(got, want)


def _gif(screen, frame, idx, gpal=None, lpal=None, interlace=False, transparency=None,
         min_bits=8, extensions=b"", clear_at=lzw.CLEAR_AT):
    """A GIF by hand: `screen` (w, h), `frame` (x0, y0), indices (h, w)."""
    def table(p):
        n = max(2, int(len(p) - 1).bit_length())
        t = np.zeros((1 << n, 3), np.uint8)
        t[:len(p)] = p
        return n, t.tobytes()
    flags, out = 0, b""
    if gpal is not None:
        n, t = table(gpal)
        flags, out = 0x80 | (n - 1), t
    head = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0) + out + extensions
    if transparency is not None:
        head += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    h, w = idx.shape
    fflags = 0x40 if interlace else 0
    local = b""
    if lpal is not None:
        n, local = table(lpal)
        fflags |= 0x80 | (n - 1)
    rows = gif._frame_rows(h, interlace)
    stream = lzw.lzw_encode_plain(idx[rows], "gif", min_bits, clear_at)
    blocks = b"".join(bytes([len(stream[i:i + 255])]) + stream[i:i + 255]
                      for i in range(0, len(stream), 255))
    return (head + b"\x2c" + struct.pack("<HHHHB", *frame, w, h, fflags) + local
            + bytes([min_bits]) + blocks + b"\x00\x3b")


def test_gif_screens_palettes_and_extensions():
    """Crafted GIFs against PIL: a local palette over a global one, a frame
    offset on a larger screen (the pixels outside it index 0, or the
    transparent index where there is one), a frame past the screen (PIL
    grows the screen), comment and application extensions skipped, a gray
    palette and no palette at all (PIL's mode L: the indices, (H, W)),
    indices past a short palette (black), a minimum code size above the
    palette's bits, and a frame whose LZW table fills and is held full with
    no Clear (the deferred clear)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (9, 13)).astype(np.uint8)
    gpal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    lpal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    ext = b"\x21\xfe\x03abc\x00" + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    big = rng.integers(0, 16, (90, 120)).astype(np.uint8)
    assert lzw.lzw_encode(big, "gif", 8) != lzw.lzw_encode(big, "gif", 8, lzw.TABLE)
    cases = [
        _gif((13, 9), (0, 0), idx, gpal=gpal, lpal=lpal),
        _gif((30, 20), (5, 7), idx, gpal=gpal),
        _gif((30, 20), (5, 7), idx, gpal=gpal, transparency=4, interlace=True),
        _gif((10, 5), (4, 3), idx, gpal=gpal),
        _gif((13, 9), (0, 0), idx, gpal=gpal, extensions=ext, min_bits=6),
        _gif((20, 12), (2, 1), idx, gpal=ramp),
        _gif((20, 12), (2, 1), idx, gpal=gpal, lpal=ramp, transparency=2),
        _gif((13, 9), (0, 0), idx),
        _gif((13, 9), (0, 0), idx, gpal=gpal[:4]),
        _gif((120, 90), (0, 0), big, gpal=gpal, clear_at=lzw.TABLE),
    ]
    for i, data in enumerate(cases):
        got = _same_gif(data)
        assert got.ndim == (2 if i in (5, 6, 7) else 3), i
    assert _same_gif(cases[3]).shape == (12, 17, 3)             # the screen grown


def test_gif_damaged_as_plain_and_pil():
    """A GIF's image data cut at 24 places and with 40 single bytes changed:
    C++ == plain, the same pixels or the same error. Image data that ends
    before the frame is full (early EOI, an early block terminator, the file
    cut) raises where PIL raises "image file is truncated"; a code past the
    table raises where PIL's decoder reports a broken stream; a full frame
    with no terminator or trailer reads as PIL reads it."""
    rng = np.random.default_rng(11)
    idx = _picture(20, 30, 1, 8)[..., 0]
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    data = gif.encode_gif(idx, pal)
    at = 13 + 3 * 256 + 10 + 1
    cases = [data[:at] + d for d in _damaged(data[at:], rng)]
    assert len(cases) >= 64
    errors = _held(gif.decode_gif, gif.decode_gif_plain, [(c,) for c in cases])
    assert any("ends after" in e for e in errors), errors
    stream = lzw.lzw_encode(idx, "gif", 8)

    def blocks(s):
        return b"".join(bytes([len(s[i:i + 255])]) + s[i:i + 255] for i in range(0, len(s), 255))
    early = data[:at] + blocks(lzw.lzw_encode(idx.ravel()[:200], "gif", 8)) + b"\x00;"
    no_eoi = data[:at] + blocks(lzw.lzw_encode(idx.ravel()[:200], "gif", 8)[:-2]) + b"\x00;"
    cut = data[:at + 150]
    past = bytearray(data)
    past[at + 40:at + 43] = b"\xff\xff\xff"
    for bad, words in ((early, "ends after 200 of 600"), (no_eoi, "ends after"),
                       (cut, "ends after"), (bytes(past), "past the table")):
        for decode in (gif.decode_gif, gif.decode_gif_plain):
            with pytest.raises(ValueError, match=words):
                decode(bad)
        with pytest.raises(OSError):
            Image.open(io.BytesIO(bad)).load()
    _same_gif(data[:at] + blocks(stream))


# ------------------------------------------------------------ the scene
def _quantize(img, colors):
    q = Image.fromarray(img).quantize(colors)
    pal = np.asarray(q.getpalette()[:3 * colors], np.uint8).reshape(-1, 3)
    return np.asarray(q), pal


def _write_views(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its nine
    views rewritten in the new forms, in turn: LZW TIFF (predictor 2, the
    port's writer), PackBits TIFF (PIL), 16-bit gray LZW TIFF (B7), GIF
    (B15), transparent interlaced GIF (B15: its alpha the mask), RLE8 BMP
    (B15), RLE4 BMP (B15), 1-bit BMP (B16), LZW TIFF (PIL). -> (proxy mesh,
    {name: the bytes the JAX reader should see}: the file itself where the
    JAX reader is right, else PIL's conversion of it (`convert("RGB" /
    "RGBA" / "L")`, the high byte of I;16) as a PNG)."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    oracle = {}
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        kind = i % 9
        if kind == 0:
            tiff.write_tiff(path, img, compression="lzw", predictor=2)
        elif kind == 1:
            Image.fromarray(img).save(path, "TIFF", compression="packbits")
        elif kind == 2:
            tiff.write_tiff(path, img[..., 1].astype(np.uint16) * 257 + 100,
                            compression="lzw", predictor=2)
        elif kind in (3, 4):
            idx, pal = _quantize(img, 64)
            gif.write_gif(path, idx, pal, interlace=kind == 4,
                          transparency=int(idx[0, 0]) if kind == 4 else None)
        elif kind in (5, 6):
            idx, pal = _quantize(img, 200 if kind == 5 else 16)
            bmp.write_bmp(path, idx, palette=pal, bits=8 if kind == 5 else 4, rle=True)
        elif kind == 7:
            bmp.write_bmp(path, (img[..., 0] > 180).astype(np.uint8),
                          palette=np.array([[0, 0, 0], [255, 255, 255]], np.uint8), bits=1)
        else:
            Image.fromarray(img).save(path, "TIFF", compression="tiff_lzw",
                                      tiffinfo={317: 2})
        im = Image.open(path)
        buf = io.BytesIO()
        if im.mode == "P":
            im.convert("RGBA" if "transparency" in im.info else "RGB").save(buf, "PNG")
        elif im.mode == "1":
            im.convert("L").save(buf, "PNG")
        elif im.mode == "I;16":
            Image.fromarray((np.asarray(im) >> 8).astype(np.uint8)).save(buf, "PNG")
        else:
            with open(path, "rb") as fh:
                buf.write(fh.read())
        oracle[name] = buf.getvalue()
    return mesh, oracle


def test_mixed_new_formats_scene_matches_jax_and_trains(tmp_path):
    """`read_scene` on one COLMAP set of every new form equals the JAX
    reader's on the same set where the JAX reader is right, and on PIL's
    conversions where it hits B7, B15 or B16 (images, masks and cameras, -r
    1 and 2); the JAX reader on the files themselves differs there; and
    `cli.train_mesh --device cpu` trains 2 iterations on the set."""
    root = str(tmp_path / "s")
    mesh, oracle = _write_views(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    raw = jreaders.read_scene(root, **kw[0])
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
    for name, data in oracle.items():
        with open(os.path.join(root, "images", name), "wb") as fh:
            fh.write(data)
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))
    faulty = {c.image_name: c.image for c in raw.train_cameras + raw.test_cameras}
    ported = {c.image_name: c for c in got[0].train_cameras + got[0].test_cameras}
    assert sum(not np.array_equal(faulty[n], c.image) for n, c in ported.items()) == 6
    assert sum(c.mask is not None for c in ported.values()) == 1
