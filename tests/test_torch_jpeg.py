"""The port's JPEG codec (`io/jpeg.py`) against PIL 12 (libjpeg-turbo) on the
CPU: `read_jpeg` decodes PIL's files to PIL's bits across qualities,
subsamplings, gray, optimized Huffman tables, restart intervals and odd
sizes; the files it does not read raise with their cause; `write_jpeg`
writes files PIL decodes, with PIL's quantisation tables, which
`read_jpeg` decodes to PIL's bits too."""

import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu_torch.io import jpeg, png

torch.set_num_threads(2)

SIZES = [(1, 1), (17, 33), (257, 131)]          # (width, height)
SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0", "gray"]


def _image(w, h, c, seed, noise=20.0):
    """Smooth gradients plus noise, seeded."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pil_jpeg(path, img, **kw):
    Image.fromarray(img).save(path, "JPEG", **kw)
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", SUBSAMPLING)
def test_read_jpeg_equals_pil(tmp_path, size, sampling):
    """Qualities 50 / 90 / 100, each plain, with optimized Huffman tables and
    with a restart interval of 3 blocks (PIL writes DRI): the same array as
    PIL's, bit for bit."""
    gray = sampling == "gray"
    img = _image(*size, 1 if gray else 3, seed=size[0] * size[1])
    path = str(tmp_path / "x.jpg")
    n = 0
    for quality in (50, 90, 100):
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 3}):
            kw = dict(quality=quality, **extra)
            if not gray:
                kw["subsampling"] = sampling
            try:
                want = _pil_jpeg(path, img, **kw)
            except OSError:         # PIL's own encoder fails on some optimize cases
                continue
            got = jpeg.read_jpeg(path)
            assert got.dtype == want.dtype and got.shape == want.shape, kw
            assert np.array_equal(got, want), (kw, np.abs(
                got.astype(int) - want.astype(int)).max())
            assert np.array_equal(png.read_image(path), want)
            n += 1
    assert n >= 8


def test_read_jpeg_restart_markers_present(tmp_path):
    """The restart case does write RST markers (so the decoder's interval
    split is exercised), and the file decodes as PIL's."""
    path = str(tmp_path / "r.jpg")
    img = _image(300, 40, 3, seed=1)
    want = _pil_jpeg(path, img, quality=90, restart_marker_blocks=2)
    data = open(path, "rb").read()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert np.array_equal(jpeg.read_jpeg(path), want)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("marker", ["adobe", "ids"])
def test_read_jpeg_rgb_colour_space(tmp_path, marker, quality):
    """PIL's `keep_rgb=True` files hold R, G, B samples, no JFIF marker, an
    Adobe marker with transform 0 and the component ids 'R', 'G', 'B'.
    Decoded as PIL decodes them: with the Adobe marker, and with it cut out
    (the ids alone decide); near the source image, so not taken for YCbCr.
    (libjpeg-turbo writes RGB only at 4:4:4.)"""
    img = _image(37, 29, 3, seed=4)
    path = str(tmp_path / "rgb.jpg")
    Image.fromarray(img).save(path, "JPEG", quality=quality, keep_rgb=True,
                              subsampling="4:4:4")
    data = open(path, "rb").read()
    segs, _ = _segments(data)
    assert [m for m, _ in segs if m in (0xE0, 0xEE)] == [0xEE]
    assert segs[[m for m, _ in segs].index(0xEE)][1][11] == 0
    if marker == "ids":
        at = data.index(b"\xff\xee")
        data = data[:at] + data[at + 2 + int.from_bytes(data[at + 2:at + 4], "big"):]
        assert b"Adobe" not in data
        with open(path, "wb") as fh:
            fh.write(data)
    want = np.asarray(Image.open(path))
    got = jpeg.read_jpeg(path)
    assert got.shape == want.shape == img.shape
    assert np.array_equal(got, want), np.abs(got.astype(int) - want.astype(int)).max()
    assert np.abs(got.astype(int) - img.astype(int)).mean() < 12.0


def _segments(data: bytes):
    """A JPEG's marker segments up to its first scan -> [(marker, body)],
    and that scan's entropy-coded bytes (to the EOI)."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, data[pos + 4:pos + 2 + n]))
        pos += 2 + n
        if marker == 0xDA:
            return out, data[pos:-2]


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


@pytest.mark.parametrize("size", SIZES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
def test_read_jpeg_non_interleaved_scans(tmp_path, size, sampling):
    """A 3-component YCbCr JPEG whose Y, Cb and Cr come in three scans of
    one component each (each scan spans its component's own block grid,
    not the MCU grid). Made from `write_jpeg`'s gray files of the three
    planes, their tables shared; decoded as PIL decodes it."""
    w, h = size
    f = 2 if sampling == "4:2:0" else 1
    cw, ch = -(-w // f), -(-h // f)
    planes = [_image(w, h, 1, seed=5), _image(cw, ch, 1, seed=6, noise=8.0),
              _image(cw, ch, 1, seed=7, noise=8.0)]
    path = str(tmp_path / "ni.jpg")
    scans = []
    for p in planes:
        jpeg.write_jpeg(path, p, quality=90)
        segs, scan = _segments(open(path, "rb").read())
        scans.append(scan)
    tables = [_segment(m, b) for m, b in segs if m in (0xE0, 0xDB, 0xC4)]
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, f << 4 | f, 0, 2, 0x11, 0,
                                                     3, 0x11, 0])
    out = [b"\xff\xd8", *tables, _segment(0xC0, sof)]
    for i, scan in enumerate(scans):
        out += [_segment(0xDA, bytes([1, i + 1, 0x00, 0, 63, 0])), scan]
    with open(path, "wb") as fh:
        fh.write(b"".join(out + [b"\xff\xd9"]))
    im = Image.open(path)
    assert im.mode == "RGB" and im.size == (w, h)
    want = np.asarray(im)
    got = jpeg.read_jpeg(path)
    assert np.array_equal(got, want), np.abs(got.astype(int) - want.astype(int)).max()


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "not_a_jpeg", "truncated"])
def test_unread_jpegs_raise(tmp_path, kind):
    """A lossless (SOF3) file whose scan is Huffman-coded DCT data raises
    naming the cause; so do a file that is no JPEG and a truncated one. A
    Huffman file's SOF0 marker patched to SOF9 (arithmetic-coded) is read
    as PIL reads it: its Huffman bytes decoded as arithmetic-coded data, to
    PIL's array. (CMYK and YCCK files are read:
    tests/test_torch_jpeg_cmyk.py; arithmetic-coded ones:
    tests/test_torch_jpeg_arith.py.)"""
    path = str(tmp_path / "x.jpg")
    img = _image(40, 24, 3, seed=2)
    if kind == "arithmetic":
        Image.fromarray(img).save(path, "JPEG")
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data.replace(b"\xff\xc0", b"\xff\xc9", 1))
        want = np.asarray(Image.open(path))
        assert want.shape == (24, 40, 3)
        assert np.array_equal(jpeg.read_jpeg(path), want)
        assert np.array_equal(jpeg.read_jpeg_plain(path), want)
        return
    if kind == "lossless":
        Image.fromarray(img).save(path, "JPEG")
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data.replace(b"\xff\xc0", b"\xff\xc3", 1))
        match = "lossless"
    elif kind == "not_a_jpeg":
        png.write_png(path, img)
        match = "not a JPEG"
    else:
        Image.fromarray(img).save(path, "JPEG", quality=95)
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data[:len(data) // 2])
        match = "truncated|ends early"
    with pytest.raises(ValueError, match=match):
        jpeg.read_jpeg(path)


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "4:2:2", "4:4:0", "gray"])
def test_write_jpeg_decodes_in_pil(tmp_path, sampling):
    """PIL opens `write_jpeg`'s files at its sizes and sampling factors, and
    `read_jpeg` equals PIL on them (4:2:2 and 4:4:0 exercise the h2v1 and
    h1v2 upsamplers); at quality 90 a smooth image comes back at >= 35 dB."""
    gray = sampling == "gray"
    path = str(tmp_path / "w.jpg")
    for w, h in SIZES + [(64, 48)]:
        img = _image(w, h, 1 if gray else 3, seed=w + h)
        for quality in (50, 90, 100):
            if gray:
                jpeg.write_jpeg(path, img, quality=quality)
            else:
                jpeg.write_jpeg(path, img, quality=quality, subsampling=sampling)
            im = Image.open(path)
            assert im.format == "JPEG" and im.size == (w, h)
            assert im.mode == ("L" if gray else "RGB")
            want = np.asarray(im)
            assert np.array_equal(jpeg.read_jpeg(path), want), (w, h, quality)
    smooth = _image(64, 48, 1 if gray else 3, seed=0, noise=0.0)
    jpeg.write_jpeg(path, smooth, quality=90, **({} if gray else {"subsampling": sampling}))
    mse = np.mean((jpeg.read_jpeg(path).astype(float) - smooth) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) >= 35.0, mse


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
def test_write_jpeg_quant_tables_are_pils(tmp_path, quality):
    """libjpeg's quality scaling of the Annex K tables: PIL writes the same."""
    path = str(tmp_path / "q.jpg")
    img = _image(16, 16, 3, seed=0)
    Image.fromarray(img).save(path, "JPEG", quality=quality)
    want = Image.open(path).quantization
    jpeg.write_jpeg(path, img, quality=quality)
    got = Image.open(path).quantization
    assert [list(t) for t in got.values()] == [list(t) for t in want.values()]
    assert list(want[0]) == list(jpeg._quant_table(jpeg._Q_LUMA, quality))


def test_write_jpeg_stuffs_ff_bytes(tmp_path):
    """Noise at quality 100 makes 0xFF bytes in the entropy-coded data; each
    is followed by a stuffed 0x00, and the file decodes as PIL's."""
    path = str(tmp_path / "n.jpg")
    img = np.random.default_rng(3).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    jpeg.write_jpeg(path, img, quality=100, subsampling="4:4:4")
    data = open(path, "rb").read()
    sos = data.index(b"\xff\xda")
    scan = data[sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big"):-2]
    ff = [i for i in range(len(scan) - 1) if scan[i] == 0xFF]
    assert ff and all(scan[i + 1] == 0 for i in ff)
    assert np.array_equal(jpeg.read_jpeg(path), np.asarray(Image.open(path)))
    assert os.path.getsize(path) > 1000
