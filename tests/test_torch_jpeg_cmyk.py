"""CMYK and YCCK JPEGs and CMYK TIFFs in the port's readers (`io/jpeg.py`,
`gm_jpeg_planes`' four-component modes in `csrc/image.cpp`, `io/tiff.py`)
against PIL 12.1's `convert("RGB")` of the CMYK image it opens, byte for
byte, the C++ against the plain version; `cmyk_to_rgb` against Pillow's
`cmyk2rgb` on every (C, K) pair; `write_jpeg`'s CMYK and YCCK files read
by PIL; and fault B14 repaired: `_load_image` gives such a file 3 channels
and no mask, equal to the JAX reader on PIL's `convert("RGB")` of it
written as a PNG, where the JAX reader on the file itself takes K as an
alpha mask."""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, png, tiff

torch.set_num_threads(2)

SIZES = [(1, 1), (17, 9), (53, 37), (64, 48)]        # (width, height)


def _cmyk(w, h, seed, noise=20.0):
    """Smooth gradients plus noise in four channels, seeded."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(4)], -1)
    return np.clip(base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)


def _same(path) -> np.ndarray:
    """read_jpeg (C++) == read_jpeg_plain == PIL's convert("RGB") of its
    CMYK image."""
    im = Image.open(path)
    assert im.mode == "CMYK"
    want = np.asarray(im.convert("RGB"))
    got, plain = jpeg.read_jpeg(path), jpeg.read_jpeg_plain(path)
    assert got.dtype == plain.dtype == np.uint8 and got.shape == plain.shape == want.shape
    assert np.array_equal(got, plain), np.abs(got.astype(int) - plain).max()
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()
    assert np.array_equal(png.read_image(path), got)
    return got


def _segments(data: bytes):
    """A JPEG's marker segments up to the scan: [(marker, body)], the rest."""
    out, p = [], 2
    while data[p + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[p + 2:p + 4])
        out.append((data[p + 1], data[p + 4:p + 2 + n]))
        p += 2 + n
    return out, data[p:]


def _join(segs, rest) -> bytes:
    return b"\xff\xd8" + b"".join(jpeg._segment(m, b) for m, b in segs) + rest


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_cmyk_jpegs_equal_pil(tmp_path, size):
    """PIL's CMYK JPEGs (libjpeg's inverted CMYK, an Adobe marker of
    transform 0) at qualities 50 / 90 / 100, plain, optimized, progressive
    and with restart intervals: equal to PIL's `convert("RGB")`."""
    img = _cmyk(*size, seed=size[0] * size[1])
    path = str(tmp_path / "c.jpg")
    for quality in (50, 90, 100):
        for extra in ({}, {"optimize": True}, {"progressive": True},
                      {"restart_marker_blocks": 3}):
            Image.fromarray(img, "CMYK").save(path, "JPEG", quality=quality, **extra)
            _same(path)


@pytest.mark.parametrize("transform", [None, 0, 1, 2, 7])
def test_adobe_transform_picks_cmyk_or_ycck(tmp_path, transform):
    """The Adobe marker decides, as libjpeg's `default_decompress_parms`:
    none or transform 0 is CMYK (PIL inverts it: `CMYK;I`), 2 is YCCK,
    and any other (1, 7) is taken as YCCK with a warning. The same stream
    read each way equals PIL."""
    img = _cmyk(40, 24, seed=3)
    path = str(tmp_path / "c.jpg")
    Image.fromarray(img, "CMYK").save(path, "JPEG", quality=90)
    segs, rest = _segments(open(path, "rb").read())
    segs = [(m, b) for m, b in segs if m != 0xEE]
    if transform is not None:
        segs.insert(0, (0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform])))
    with open(path, "wb") as fh:
        fh.write(_join(segs, rest))
    got = _same(path)
    if transform in (None, 0):
        assert np.abs(got.astype(int) - jpeg.cmyk_to_rgb(img)).max() < 40


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0"])
def test_written_cmyk_and_ycck_read_by_pil(tmp_path, sampling):
    """`write_jpeg` of a CMYK image: inverted CMYK (transform 0, 4:4:4) and
    YCCK (transform 2, Y and K at full size, Cb and Cr subsampled), baseline
    and progressive (libjpeg's all-purpose script), at 1x1 to 64x48. PIL
    opens each as mode CMYK, its `convert("RGB")` equals the port's read
    (C++ and plain), and at quality 100 on flat 8x8 blocks PIL's CMYK is
    within 1 of the image written."""
    path = str(tmp_path / "w.jpg")
    for w, h in SIZES:
        img = _cmyk(w, h, seed=w + h)
        for ycck in (False, True):
            for progressive in (False, True):
                jpeg.write_jpeg(path, img, quality=90, subsampling=sampling,
                                progressive=progressive, ycck=ycck)
                _same(path)
                info = Image.open(path).info
                assert info["adobe_transform"] == (2 if ycck else 0)
    flat = np.repeat(np.repeat(_cmyk(6, 5, seed=9, noise=60), 8, 0), 8, 1)
    for ycck in (False, True):
        jpeg.write_jpeg(path, flat, quality=100, subsampling="4:4:4", ycck=ycck)
        assert np.abs(np.asarray(Image.open(path)).astype(int) - flat).max() <= 1


def test_cmyk_to_rgb_is_pils_on_every_c_k_pair():
    """`cmyk_to_rgb` against PIL's `convert("RGB")` of mode CMYK: every (C,
    K) pair, M and Y seeded; and the C++ (`gm_jpeg_planes`, modes CMYK,
    inverted CMYK and YCCK) on a 4:4:4 frame of 256 x 256 flat blocks, C the
    block column and K the block row, against the numpy planes and PIL."""
    c, k = np.meshgrid(np.arange(256), np.arange(256))
    rng = np.random.default_rng(0)
    cmyk = np.stack([c, rng.integers(0, 256, c.shape), rng.integers(0, 256, c.shape), k],
                    -1).astype(np.uint8)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    assert np.array_equal(jpeg.cmyk_to_rgb(cmyk), want)
    n = 256
    sof = struct.pack(">BHHB", 8, 8 * n, 8 * n, 4) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(4))
    frame = jpeg._Frame(sof, "<frame>")
    by, bx = np.mgrid[0:n, 0:n]
    for i, value in enumerate((bx, (7 * bx + 13 * by) % 256, (3 * bx + by) % 256, by)):
        frame.coef[i][..., 0] = value - 128
        frame.q[i] = np.full(64, 8, np.int64)
    for mode in (jpeg.CMYK, jpeg.CMYK_INVERTED, jpeg.YCCK):
        got, plain = jpeg._planes_native(frame, mode), jpeg._planes_plain(frame, mode)
        assert got.shape == plain.shape == (8 * n, 8 * n, 3)
        assert np.array_equal(got, plain), (mode, np.argwhere(got != plain)[:5])
        if mode == jpeg.CMYK:
            planes = np.stack([v for v in (bx, (7 * bx + 13 * by) % 256,
                                           (3 * bx + by) % 256, by)], -1).astype(np.uint8)
            pil = np.asarray(Image.fromarray(planes, "CMYK").convert("RGB"))
            assert np.array_equal(got[::8, ::8], pil)


@pytest.mark.parametrize("order", ["<", ">"])
def test_cmyk_tiffs_equal_pil(tmp_path, order):
    """CMYK TIFFs (Photometric 5, InkSet 1) of 8 and 16 bits, uncompressed,
    LZW and Deflate with predictor 2, in strips and tiles, and PIL's own
    (uncompressed and LZW); each equal to PIL's `convert("RGB")` through
    the C++ and the plain route."""
    img = _cmyk(33, 17, seed=4)
    path = str(tmp_path / "c.tif")
    for depth in (8, 16):
        px = img.astype(np.uint16) * 257 if depth == 16 else img
        for comp, pred in (("none", 1), ("lzw", 2), ("deflate", 2)):
            for layout in ({}, {"rows_per_strip": 4}, {"tile": (16, 16)}):
                data = tiff.encode_tiff(px, comp, pred, order, cmyk=True, **layout)
                with open(path, "wb") as fh:
                    fh.write(data)
                want = np.asarray(Image.open(path).convert("RGB"))
                got = tiff.decode_tiff(data)
                assert np.array_equal(got, tiff.decode_tiff_plain(data))
                assert np.array_equal(got, want)
                assert np.array_equal(png.read_image(path), want)
    for kw in ({"compression": "tiff_lzw"}, {}):
        Image.fromarray(img, "CMYK").save(path, **kw)
        want = np.asarray(Image.open(path).convert("RGB"))
        assert np.array_equal(png.read_image(path), want)
        assert np.array_equal(png.read_image(path), jpeg.cmyk_to_rgb(img))


def test_cut_and_damaged_cmyk_jpegs_raise(tmp_path):
    """A CMYK and a YCCK JPEG cut in their entropy-coded data raise through
    both decoders, the same message; one whose frame has a component the
    scan does not code raises."""
    path = str(tmp_path / "c.jpg")
    for ycck in (False, True):
        jpeg.write_jpeg(path, _cmyk(40, 24, seed=5), quality=90, ycck=ycck)
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data[:len(data) * 2 // 3])
        msgs = []
        for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
            with pytest.raises(ValueError, match="truncated|ends early") as err:
                read(path)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    Image.fromarray(_cmyk(16, 16, seed=6), "CMYK").save(path, "JPEG")
    segs, rest = _segments(open(path, "rb").read())
    n = rest[4]
    sos = bytes([n - 1]) + rest[5:5 + 2 * (n - 1)] + rest[5 + 2 * n:5 + 2 * n + 3]
    with open(path, "wb") as fh:
        fh.write(_join(segs, jpeg._segment(0xDA, sos) + rest[2 + 2 + 1 + 2 * n + 3:]))
    for read in (jpeg.read_jpeg, jpeg.read_jpeg_plain):
        with pytest.raises(ValueError):
            read(path)


# ------------------------------------------------------------------ B14
@pytest.mark.parametrize("resolution", [1, 2])
@pytest.mark.parametrize("form", ["cmyk_jpeg", "ycck_jpeg", "cmyk_tiff"])
def test_b14_cmyk_loads_as_pil_rgb(tmp_path, form, resolution):
    """Fault B14: the JAX reader takes a CMYK image's K as an alpha mask. The
    port's `_load_image` gives 3 channels and no mask, equal to the JAX
    `_load_image` of PIL's `convert("RGB")` of the file written as a PNG
    (resized first where `-r` asks, as `Image.resize` of the RGB image),
    with and without a background."""
    img = _cmyk(34, 26, seed=8)
    path, oracle = str(tmp_path / "x"), str(tmp_path / "rgb.png")
    if form == "cmyk_tiff":
        tiff.write_tiff(path, img, compression="lzw", cmyk=True)
    else:
        jpeg.write_jpeg(path, img, quality=90, ycck=form == "ycck_jpeg")
    Image.open(path).convert("RGB").save(oracle)
    for bg in (None, np.array([1.0, 0.5, 0.0])):
        got_img, got_mask = readers._load_image(path, resolution, bg)
        want_img, want_mask = jreaders._load_image(oracle, resolution, bg)
        assert got_mask is None and want_mask is None
        assert got_img.dtype == want_img.dtype and np.array_equal(got_img, want_img)
        assert got_img.shape == (3, 26 // resolution, 34 // resolution)
        _, jax_mask = jreaders._load_image(path, resolution, bg)
        assert jax_mask is not None and jax_mask.shape == (1, 26 // resolution,
                                                           34 // resolution)
