"""The port's SPIDER recognition (`io/spider.py`) and FTEX reader with its
BC1 decoder (`io/ftex.py`, `io/bcn.py`, C++ `gm_bc1_decode`) against PIL
12, fault B33, and a COLMAP scene of the slice's formats against the JAX
reader.

SPIDER images, which PIL opens as mode F (float samples the JAX reader
trains as the values / 255: B21's kind), are refused in both byte orders,
single and stack; every header PIL's `_open` gives way on gives way and
every one it fails on fails, by rule and fuzzed. A big-endian SPIDER file
whose first float is 2.0 is taken by DIB first and fails there, as in PIL.
BC1 blocks decode through `gm_bc1_decode` and `_bc1_plain` to PIL's `bcn`
decoder's RGBA (random blocks of both modes, partial edge tiles); FTEX
textures of PIL's DDS writer's DXT1 blocks equal that DDS; FTEX's header
rules give way or fail as PIL's. B33: an SGI or TGA file holding `PCD_` at
byte 2048 is read by its own magic (PIL opens it as a 768 x 512 Photo CD
image)."""

import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import (bcn, fits, ftex, jpeg, mcidas, pixar, png, sgi, spider,
                                      tga, xvthumb)
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from tests.test_torch_readers import _assert_scene_equal
from tools.make_raw_sample_fixtures_torch import natural, port_array

torch.set_num_threads(2)

BC1_SIZES = [(1, 1), (3, 5), (4, 4), (7, 6), (13, 9), (64, 33), (257, 3)]   # (width, height)


def _plugin(fmt):
    """PIL's image class of `fmt`, every plugin registered first in the
    order a fresh process's `Image.open` registers them."""
    Image.preinit()
    Image.init()
    return Image.OPEN[fmt][0]


def _open_fresh(path):
    """`Image.open(path)` in a fresh process (whose order of formats no
    imported plugin has changed) -> "FORMAT W H", or the error it raised."""
    code = ("import sys; from PIL import Image\n"
            "try:\n    im = Image.open(sys.argv[1]); print(im.format, *im.size)\n"
            "except Exception as e:\n    print(type(e).__name__, e)")
    return subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                          check=True).stdout.strip()


def _write(tmp_path, data, name="f"):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _pil_open(cls, path):
    """PIL's plugin `cls` on the file at `path` -> "give way", "fail" or
    the opened image."""
    try:
        return cls(path)
    except SyntaxError:
        return "give way"
    except Exception:
        return "fail"


def _port(decode, data):
    try:
        return decode(data, "<file>")
    except GiveWay:
        return "give way"
    except ValueError as err:
        return "fail", str(err)


# ------------------------------------------------------------------ SPIDER
def _pil_spider(img, big_endian=False):
    """PIL's SPIDER file of a gray image (PIL writes its host's order, little-
    endian here); big-endian: every 4-byte word of it swapped."""
    buf = io.BytesIO()
    Image.fromarray(img).convert("F").save(buf, "SPIDER")
    data = buf.getvalue()
    if big_endian:
        data = np.frombuffer(data, "<f4").astype(">f4").tobytes()
    return data


@pytest.mark.parametrize("big_endian", [False, True], ids=["le", "be"])
@pytest.mark.parametrize("size", [(1, 1), (23, 17), (300, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_spider_images_refused(tmp_path, size, big_endian):
    """PIL's SPIDER files, both byte orders, open in PIL as mode F; the port
    refuses them through `read_image` and `decode_spider` naming B21."""
    img = natural(size[1], size[0], 1, size[0])[..., 0]
    data = _pil_spider(img, big_endian)
    path = _write(tmp_path, data)
    im = Image.open(path)
    assert (im.format, im.mode, im.size) == ("SPIDER", "F", size)
    for run in (lambda: png.read_image(path), lambda: spider.decode_spider(data, path)):
        with pytest.raises(ValueError, match="SPIDER 2D image.*B21"):
            run()


def _header(**words):
    """A valid little-endian SPIDER header of a 3 x 2 image (1-based word:
    value overrides), 1024 bytes of header and the samples."""
    h = [0.0] * 28
    h[1], h[2], h[5], h[12], h[13], h[22], h[23] = 1, 2, 1, 3, 1, 1024, 1024
    for k, v in words.items():
        h[int(k[1:])] = v
    return struct.pack("<27f", *h[1:]) + bytes(1024 - 108) + bytes(4 * 6)


SPIDER_CASES = {
    "image": _header(),
    "stack_first_image": _header(w24=1, w26=3) + bytes(1024 + 24),
    "short_by_one": _header()[:107],
    "iform_3": _header(w5=3),
    "iform_2": _header(w5=2),
    "nslice_not_an_integer": _header(w1=1.5),
    "nrow_nan": _header(w2=float("nan")),
    "nsam_infinite": _header(w12=float("inf")),
    "labbyt_mismatch": _header(w22=1000),
    "labbyt_0": _header(w13=0, w22=0),
    "istack_nan": _header(w24=float("nan")),
    "imgnumber_infinite": _header(w27=float("inf")),
    "stack_count_nan": _header(w24=1, w26=float("nan")),
    "image_within_a_stack": _header(w27=2),
    "inconsistent_stack": _header(w24=-1),
    "width_0": _header(w12=0),
    "height_negative": _header(w2=-2),
}


@pytest.mark.parametrize("case", list(SPIDER_CASES))
def test_spider_rules_as_pil(tmp_path, case):
    """Each SPIDER header gives way where PIL's `_open` gives way (short,
    no valid header in either order, another `iform`, inconsistent stack
    words, a size under 1) and fails where it fails (a NaN or infinite
    stack word, an image within a stack); what PIL opens is refused."""
    data = SPIDER_CASES[case]
    want = _pil_open(_plugin("SPIDER"), _write(tmp_path, data))
    got = _port(spider.decode_spider, data)
    if isinstance(want, str):
        assert (got if got == "give way" else got[0]) == want, (case, got)
    else:
        assert got[0] == "fail" and "B21" in got[1], (case, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_spider_headers_fuzzed_as_pil(tmp_path, seed):
    """500 headers a seed, each a valid one with words replaced by small
    integers, fractions, NaN or infinities, in either byte order: the port
    gives way, fails or refuses wherever PIL's `_open` gives way, fails or
    opens."""
    rng = np.random.default_rng(seed)
    values = [0.0, 1.0, 2.0, 3.0, -1.0, 0.5, 1024.0, 256.0, 4.0, float("nan"), float("inf"),
              -11.0, -21.0, 3e9]
    seen = set()
    for k in range(500):
        h = np.frombuffer(_header()[:108], "<f4").copy()
        for i in rng.choice(27, rng.integers(1, 4), replace=False):
            h[i] = values[rng.integers(len(values))]
        data = h.astype(">f4" if k % 2 else "<f4").tobytes() + bytes(1024)
        want = _pil_open(_plugin("SPIDER"), _write(tmp_path, data))
        got = _port(spider.decode_spider, data)
        kind = want if isinstance(want, str) else "opened"
        seen.add(kind)
        if kind == "give way":
            assert got == "give way", (k, h)
        else:
            assert got[0] == "fail" and ("B21" in got[1]) == (kind == "opened"), (k, h, got)
    assert seen == {"give way", "fail", "opened"}


def test_big_endian_spider_of_first_float_2_fails_in_dib(tmp_path):
    """A big-endian SPIDER header whose first float is 2.0 (`40 00 00 00`)
    is a DIB header size of 64 to DIB's `_accept`, which PIL tries first:
    PIL fails there ("Unsupported BMP pixel depth (0)") and so does the port
    (its DIB reader refuses the 64-byte header)."""
    h = [0.0] * 27
    h[0], h[1], h[4], h[11], h[12], h[21], h[22] = 2, 2, 1, 3, 1, 1024, 1024
    data = struct.pack(">27f", *h) + bytes(1024 - 108) + bytes(24)
    path = _write(tmp_path, data)
    assert _plugin("SPIDER")(path).size == (3, 2)
    assert _open_fresh(path) == "OSError Unsupported BMP pixel depth (0)"
    with pytest.raises(ValueError, match="BMP header of 64 bytes"):
        png.read_image(path)


@pytest.mark.parametrize("fmt", ["sgi", "tga"])
def test_b33_pcd_marker_read_by_the_files_own_magic(tmp_path, fmt):
    """B33: PCD has no `_accept` and comes before SGI and TGA in PIL's
    order, so an SGI or TGA file whose samples put `PCD_` at byte 2048 opens
    in PIL as a 768 x 512 Photo CD image, or 512 x 768 as its samples set
    the rotation (which the JAX reader would train).
    The port reads the file by its own magic, equal to PIL's SGI or TGA
    reader on it."""
    img = natural(40, 40, 3, 7)
    data = bytearray(sgi.encode_sgi(img) if fmt == "sgi" else tga.encode_tga(img))
    data[2048:2052] = b"PCD_"
    path = _write(tmp_path, bytes(data))
    assert _open_fresh(path) in ("PCD 768 512", "PCD 512 768")      # by its rotation byte
    own = _plugin(fmt.upper())(path)
    assert own.size == (40, 40)
    assert np.array_equal(png.read_image(path), np.asarray(own))


# ------------------------------------------------------------------ BC1
@pytest.mark.parametrize("size", BC1_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bc1_random_blocks_equal_pil(size):
    """Random BC1 blocks (every third with equal colour words, the three-
    colour mode) decode through `gm_bc1_decode` and `_bc1_plain` to PIL's
    `bcn` decoder's RGBA, byte for byte, partial edge tiles included."""
    w, h = size
    n = bcn.bc1_blocks(w, h)
    blocks = np.random.default_rng(w * 31 + h).integers(0, 256, (n, 8), dtype=np.uint8)
    blocks[::3, 2:4] = blocks[::3, 0:2]
    data = blocks.tobytes()
    want = np.asarray(Image.frombytes("RGBA", (w, h), data, "bcn", (1,)))
    assert np.array_equal(bcn.decode_bc1(data, w, h), want)
    assert np.array_equal(bcn._bc1_plain(data, w, h), want)
    for decode in (bcn.decode_bc1, bcn._bc1_plain):
        with pytest.raises(ValueError, match="truncated"):
            decode(data[:-1], w, h)


def _texture(w, h, fmt, body, count=1, where=32, length=None):
    return (b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, count, fmt, where)
            + struct.pack("<i", len(body) if length is None else length) + body)


@pytest.mark.parametrize("size", BC1_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ftex_of_pil_dds_blocks_equals_the_dds(tmp_path, size):
    """PIL's DXT1 DDS of an image, its blocks put in an FTEX texture: the
    port's reading of the texture equals PIL's of the texture and of the
    DDS."""
    w, h = size
    buf = io.BytesIO()
    Image.fromarray(natural(h, w, 3, w + h)).save(buf, "DDS", pixel_format="DXT1")
    want = np.asarray(Image.open(buf))
    path = _write(tmp_path, _texture(w, h, ftex.DXT1, buf.getvalue()[128:]))
    assert np.array_equal(np.asarray(Image.open(path)), want)
    assert np.array_equal(png.read_image(path), want)
    assert np.array_equal(ftex.decode_ftex_plain(open(path, "rb").read()), want)


@pytest.mark.parametrize("fmt", [ftex.DXT1, ftex.UNCOMPRESSED], ids=["dxt1", "raw"])
@pytest.mark.parametrize("size", [(1, 1), (23, 17), (300, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_ftex_writer_read_by_pil(tmp_path, size, fmt):
    """`encode_ftex`'s textures: PIL reads what the writer says they decode
    to, and so do `read_image` and the plain route."""
    w, h = size
    img = natural(h, w, 3, w * 3 + h)
    data, want = ftex.encode_ftex(img, fmt)
    path = _write(tmp_path, data)
    im = Image.open(path)
    assert (im.format, im.mode) == ("FTEX", "RGBA" if fmt == ftex.DXT1 else "RGB")
    assert np.array_equal(np.asarray(im), want)
    assert np.array_equal(png.read_image(path), want)
    assert np.array_equal(ftex.decode_ftex_plain(data), want)


_RAW = bytes(range(6))
FTEX_CASES = {
    "raw": _texture(2, 1, 1, _RAW),
    "raw_length_minus_1": _texture(2, 1, 1, _RAW, length=-1),
    "raw_length_minus_2": _texture(2, 1, 1, _RAW, length=-2),
    "raw_short": _texture(2, 1, 1, _RAW[:5]),
    "raw_length_short": _texture(2, 1, 1, _RAW, length=3),
    "two_formats": _texture(2, 1, 1, _RAW, count=2),
    "format_2": _texture(2, 1, 2, _RAW),
    "position_negative": _texture(2, 1, 1, _RAW, where=-4),
    "position_past_the_file": _texture(2, 1, 1, _RAW, where=10000),
    "header_cut": _texture(2, 1, 1, _RAW)[:20],
    "header_cut_at_position": _texture(2, 1, 1, _RAW)[:28],
    "dxt1": _texture(2, 1, 0, bytes(8)),
    "dxt1_short": _texture(2, 1, 0, bytes(7)),
    "dxt1_longer": _texture(5, 5, 0, bytes(40)),
}


@pytest.mark.parametrize("case", list(FTEX_CASES))
def test_ftex_rules_as_pil(tmp_path, case):
    """Each FTEX header gives way where PIL's `_open` does (cut short, a
    mipmap past the file) and fails where it fails (two formats, another
    format, a negative position, a length under -1, a mipmap the image
    outgrows); a length of -1 reads to the end of the file."""
    data = FTEX_CASES[case]
    path = _write(tmp_path, data)
    want = _pil_open(_plugin("FTEX"), path)
    if not isinstance(want, str):
        try:
            want.load()
            want = np.asarray(want)
        except Exception:
            want = "fail"
    for decode in (ftex.decode_ftex, ftex.decode_ftex_plain):
        got = _port(decode, data)
        if isinstance(want, str):
            assert (got if got == "give way" else got[0]) == want, (case, got)
        else:
            assert np.array_equal(got, want), case


def test_ftex_of_no_pixels_fails_as_in_pil(tmp_path):
    """A texture of width 0: PIL's FTEX `_open` has closed the file when
    `ImageFile` gives way on the size, so the next format cannot seek it
    and `Image.open` fails; `read_image` raises too."""
    path = _write(tmp_path, _texture(0, 1, 1, _RAW))
    assert _open_fresh(path) == "ValueError seek of closed file"
    with pytest.raises(ValueError, match="seek of closed file"):
        png.read_image(path)


# ------------------------------------------------------------------ COLMAP
def _slice_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its nine
    views rewritten as PIXAR, McIdas 1-byte (the green), McIdas 2-byte (B7),
    an XV thumbnail (B15), FITS 8-bit, FITS unsigned 16-bit (B32), FITS
    GZIP_1, FTEX DXT1 and FTEX raw, in turn -> (proxy, {image name: the
    oracle: PIL's array under the port's rule, or the samples for B32})."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    oracle = {}
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        green = np.ascontiguousarray(img[..., 1])
        wide = green.astype(np.uint16) << 8 | img[..., 0]
        data = (pixar.encode_pixar(img),
                mcidas.encode_mcidas(green),
                mcidas.encode_mcidas(wide, size=2),
                xvthumb.encode_xvthumb(xvthumb.rgb332(img)),
                fits.encode_fits(green),
                fits.encode_fits(wide),
                fits.encode_fits(green, compress=True),
                ftex.encode_ftex(img)[0],
                ftex.encode_ftex(img, ftex.UNCOMPRESSED)[0])[i % 9]
        with open(path, "wb") as fh:
            fh.write(data)
        oracle[name] = green if i % 9 == 5 else port_array(data)[0]
    return mesh, oracle


def test_slice_colmap_scene_matches_jax(tmp_path, monkeypatch):
    """`read_scene` on one COLMAP set of the slice's formats equals, at -r 1
    and 2, the JAX reader's on the same set with each view replaced by its
    oracle written as a PNG, exactly; the JAX reader on the files
    themselves differs on the views of a fault (B7, B15, B32). Read again
    with the plain BC1 decoder made to raise, the same scene."""
    root = str(tmp_path / "s")
    _, oracle = _slice_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    faulty = jreaders.read_scene(root, **kw[0])

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    monkeypatch.setattr(bcn, "_bc1_plain", plain)
    for g, k in zip(got, kw):
        _assert_scene_equal(readers.read_scene(root, **k), g)
    monkeypatch.undo()
    for name, a in oracle.items():
        Image.fromarray(a).save(os.path.join(root, "images", name), "PNG")
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))
    wrong = {c.image_name: c.image for c in faulty.train_cameras + faulty.test_cameras}
    ported = {c.image_name: c.image for c in got[0].train_cameras + got[0].test_cameras}
    differ = sum(not np.array_equal(wrong[n], a) for n, a in ported.items())
    assert differ >= 3, differ
