"""The port's QOI (`io/qoi.py`), SGI (`io/sgi.py`) and PCX (`io/pcx.py`)
readers on the CPU, against PIL 12 bit for bit: PIL-written files of every
mode PIL writes at 1x1 to 257x131, the port's writers read by PIL (QOI with
every op, RLE SGI at 8 and 16 bits, PCX 8 x 1 and 8 x 3), the forms PIL
reads and does not write (PCX 1 x 2 and 1 x 4 planes, SGI RLE rows at
their edges), the C++ walks (`gm_qoi_decode`, `gm_sgi_rle`, `gm_pcx_rle`)
equal to their plain versions on damaged streams, the same bytes or the
same error, and PIL raising or decoding alike; the refused forms raising
with their cause; fault B22 (PIL's 8 x 3 PCX of width 3). Then the
fixtures of `tests/data/raw/` through both routes against their recorded
digests, and a COLMAP scene of one view in each of the five formats of
this slice through `read_scene` against the JAX reader, and through
`cli.train_mesh --device cpu` for 2 iterations."""

import hashlib
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, pcx, png, pnm, qoi, sgi, tga
from tests.test_torch_pnm_tga import (SIZES, _both_raise, _check, _image, _outcome, _pil,
                                      _pil_bytes)
from tests.test_torch_readers import _assert_scene_equal

torch.set_num_threads(2)

RAW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "raw")


def _damaged(tmp_path, data, decode, plain, header, n, seed):
    """`n` damaged copies of `data` (bytes after `header` changed, or cut):
    the C++ route gives the plain one's bytes or raises its error, and PIL
    decodes the same array or raises."""
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "d")
    for k in range(n):
        b = bytearray(data)
        if k % 3 == 0:
            b = b[:rng.integers(header, len(b))]
        else:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(header, len(b))] = rng.integers(0, 256)
        b = bytes(b)
        native, simple = _outcome(decode, b), _outcome(plain, b)
        assert type(native) is type(simple), k
        assert (native == simple) if isinstance(native, str) else np.array_equal(native, simple)
        with open(path, "wb") as fh:
            fh.write(b)
        want = _pil(path)
        assert isinstance(want, Exception) == isinstance(native, str), (k, native, want)
        if not isinstance(native, str):
            assert np.array_equal(native, want), k


# ------------------------------------------------------------------ QOI
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_equals_pil(tmp_path, mode, size):
    """PIL's QOI files, and `encode_qoi`'s of the same image (read by PIL
    as written)."""
    img = _image(*size, 4, seed=size[0] + size[1])
    arr = img if mode == "RGBA" else img[..., :3]
    _check(tmp_path, _pil_bytes(arr, "QOI"), qoi.decode_qoi_plain)
    assert np.array_equal(_check(tmp_path, qoi.encode_qoi(arr), qoi.decode_qoi_plain), arr)


def _op_counts(data: bytes, pixels: int) -> dict:
    """The ops of a QOI stream by kind (walked to the last pixel)."""
    counts = dict.fromkeys(("RGB", "RGBA", "INDEX", "DIFF", "LUMA", "RUN"), 0)
    i, done = 14, 0
    while done < pixels:
        b = data[i]
        if b in (0xFE, 0xFF):
            counts["RGB" if b == 0xFE else "RGBA"] += 1
            i += 4 if b == 0xFE else 5
        else:
            kind = ("INDEX", "DIFF", "LUMA", "RUN")[b >> 6]
            counts[kind] += 1
            i += 2 if kind == "LUMA" else 1
            done += (b & 63) if kind == "RUN" else 0
        done += 1
    return counts


def test_qoi_writer_uses_every_op(tmp_path):
    """An image of runs (over 62 pixels too), repeats, small and larger
    steps and alpha changes: `encode_qoi` writes every op, PIL and both
    routes read the image back, and its end marker follows the last op."""
    h, w = 40, 90
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 2, y * 3, (x + y), np.full_like(x, 255)], -1).astype(np.uint8)
    img[:5] = 7                                       # runs longer than 62
    img[5:8, :, :3] = x[5:8, :, None] % 50             # steps of 1: DIFF
    img[10:20, ::4] = [[200, 10, 10, 255], [10, 200, 10, 255]][0]
    img[20:30, 1::3] = [250, 250, 0, 128]             # alpha changes
    img[30:] = np.random.default_rng(0).integers(0, 256, (10, w, 4), dtype=np.uint8)
    img[30:, ::5] = img[30:, 1::5]                    # INDEX hits
    data = qoi.encode_qoi(img)
    counts = _op_counts(data, h * w)
    assert all(v > 0 for v in counts.values()), counts
    assert data.endswith(b"\0" * 7 + b"\1")
    assert np.array_equal(_check(tmp_path, data, qoi.decode_qoi_plain), img)


def test_qoi_decoder_edges_equal_pil(tmp_path):
    """A run before any other op (PIL, unlike the format's reference,
    leaves it out of the index), an INDEX of an empty entry, an RGBA op in
    a 3-channel file (its alpha kept for the hash), a run past the last
    pixel, no end marker, a channel count of 7 (PIL: RGBA)."""
    head = b"qoif" + struct.pack(">IIBB", 3, 2, 3, 0)
    cases = [head + bytes([0xC1, 53, 0xFF, 1, 2, 3, 4, 0x37, 0xC5]),
             head + bytes([0x05, 0xFE, 9, 9, 9, 0x80 | 40, 0x8F, 0xC9]),
             b"qoif" + struct.pack(">IIBB", 2, 2, 7, 0) + bytes([0xFF, 1, 2, 3, 4, 0x6A,
                                                                0x00, 0xC0])]
    for data in cases:
        _check(tmp_path, data, qoi.decode_qoi_plain)


def test_qoi_damaged_as_plain_and_pil(tmp_path):
    """64 damaged QOI streams of each kind of image: C++ = plain = PIL
    (bytes, or an error where PIL raises)."""
    img = _image(9, 7, 4, 5)
    img[3] = img[2] + 1
    for arr in (img, img[..., :3]):
        _damaged(tmp_path, qoi.encode_qoi(arr), qoi.decode_qoi, qoi.decode_qoi_plain, 14,
                 64, arr.shape[2])


@pytest.mark.parametrize("cut", [0, 1, 3, 5, 9])
def test_qoi_cut_raises(tmp_path, cut):
    """Data cut before the last pixel: "cut short" through both routes (PIL
    raises too); the end marker alone cut off decodes, as in PIL."""
    img = _image(6, 5, 3, cut)
    data = qoi.encode_qoi(img)[:-8]
    if cut == 0:
        assert np.array_equal(_check(tmp_path, data, qoi.decode_qoi_plain), img)
        return
    _both_raise(tmp_path, data[:-cut], qoi.decode_qoi_plain, "cut short")


# ------------------------------------------------------------------ SGI
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_sgi_equals_pil(tmp_path, mode, bpc, size):
    """PIL's SGI files (verbatim, 1 and 2 bytes a sample: the high byte),
    and `encode_sgi`'s RLE files of the same image (8 and 16 bits, 1 row
    images of dimension 1) read by PIL as written."""
    img = _image(*size, 4, seed=3 * size[0] + size[1] + bpc)
    arr = {"L": img[..., 0], "RGB": img[..., :3], "RGBA": img}[mode]
    _check(tmp_path, _pil_bytes(arr, "SGI", bpc=bpc), sgi.decode_sgi_plain)
    wide = arr.astype(np.uint16) * 256 + 3 if bpc == 2 else arr
    got = _check(tmp_path, sgi.encode_sgi(wide, bpc=bpc, rle=True), sgi.decode_sgi_plain)
    assert np.array_equal(got, arr)


def _sgi_rle(w, h, rows, bpc=1, lengths=None, starts=None, tail=b""):
    n = len(rows)
    off = 512 + 8 * n + np.cumsum([0] + [len(r) for r in rows[:-1]])
    lens = [len(r) for r in rows] if lengths is None else lengths
    head = struct.pack(">hBBHHHH", 474, 1, bpc, 2, w, h, 1).ljust(512, b"\0")
    return (head + struct.pack(f">{n}I", *(off if starts is None else starts))
            + struct.pack(f">{n}I", *lens) + b"".join(rows) + tail)


SGI_EDGES = {
    "short_row_keeps_the_row_before": dict(rows=[bytes([0x83, 1, 2, 3, 0]), bytes([2, 9, 0])]),
    "first_row_short": dict(rows=[bytes([2, 5, 0]), bytes([0x83, 1, 2, 3, 0])]),
    "length_0": dict(rows=[bytes([0x83, 1, 2, 3, 0]), b""], tail=b"\0"),
    "length_past_2_31": dict(rows=[bytes([0x83, 1, 2, 3, 0]), bytes([3, 9, 0])],
                             lengths=[5, 0x90000000]),
    "control_left_on_the_last_count": dict(rows=[bytes([0x83, 1, 2, 3, 0]), bytes([3])],
                                           tail=b"\0"),
    "lengths_short": dict(rows=[bytes([0x83, 1, 2, 3, 0]), bytes([1, 9, 2, 8, 0])],
                          lengths=[5, 3]),
    "lengths_long": dict(rows=[bytes([0x83, 1, 2, 3, 0, 7, 7]), bytes([3, 9, 0])]),
    "16bit_run": dict(rows=[bytes([0, 0x83, 1, 2, 3, 4, 5, 6, 0, 0]),
                            bytes([5, 0x03, 7, 8, 0, 0])], bpc=2),
}


@pytest.mark.parametrize("case", list(SGI_EDGES))
def test_sgi_rle_edges_equal_pil(tmp_path, case):
    """RLE rows at their edges, as PIL's `SgiRleDecode` walks them: samples
    a row does not reach keep the row before's, a length counts packets and
    is a C int, a control byte left at the last count stops the decode (the
    rows after it black), a 16-bit control's high byte is ignored."""
    kw = SGI_EDGES[case]
    _check(tmp_path, _sgi_rle(3, 2, **kw), sgi.decode_sgi_plain)


def test_sgi_damaged_as_plain_and_pil(tmp_path):
    """64 damaged RLE files at 8 and 16 bits, gray and RGBA: C++ = plain =
    PIL (bytes, or an error where PIL raises)."""
    img = _image(7, 6, 4, 9)
    for arr, bpc in ((img[..., 0], 1), (img, 1), (img.astype(np.uint16) * 257, 2)):
        _damaged(tmp_path, sgi.encode_sgi(arr, bpc=bpc, rle=True), sgi.decode_sgi,
                 sgi.decode_sgi_plain, 512, 64, bpc + arr.ndim)


def _sgi_head(compression=0, bpc=1, dim=2, w=2, h=2, z=1):
    return struct.pack(">hBBHHHH", 474, compression, bpc, dim, w, h, z).ljust(512, b"\0")


SGI_REFUSED = {
    "two_channels": (_sgi_head(dim=3, z=2) + bytes(8), "unsupported SGI image mode"),
    "dimension3_one_channel": (_sgi_head(dim=3) + bytes(4), "unsupported SGI image mode"),
    "bpc3": (_sgi_head(bpc=3) + bytes(12), "unsupported SGI image mode"),
    "compression2": (_sgi_head(compression=2) + bytes(4), "compression 2"),
    "verbatim_cut": (_sgi_head() + bytes(3), "cut short"),
    "verbatim16_cut": (_sgi_head(bpc=2) + bytes(7), "cut short"),
    "tables_cut": (_sgi_head(compression=1, h=4) + bytes(20), "tables cut short"),
    "offset_before_header": (_sgi_rle(3, 2, [bytes([3, 9, 0])] * 2, starts=[100, 600]),
                             "buffer overrun"),
    "offset_past_file": (_sgi_rle(3, 2, [bytes([3, 9, 0])] * 2, starts=[9999, 600]),
                         "buffer overrun"),
    "run_past_row": (_sgi_rle(3, 2, [bytes([0x84, 1, 2, 3, 4, 0]), bytes([3, 9, 0])]),
                     "buffer overrun"),
    "no_terminator": (_sgi_rle(3, 2, [bytes([0x83, 1, 2, 3]), bytes([3, 9])]),
                      "buffer overrun"),
    "literal_to_the_last_byte": (_sgi_rle(3, 1, [bytes([0x83, 1, 2, 3])], lengths=[5]),
                                 "buffer overrun"),
}


@pytest.mark.parametrize("case", list(SGI_REFUSED))
def test_sgi_refused_forms_raise(tmp_path, case):
    """The SGI forms PIL refuses or cannot load and the damaged files it
    raises on: the same ValueError, naming the cause, through both routes."""
    data, words = SGI_REFUSED[case]
    _both_raise(tmp_path, data, sgi.decode_sgi_plain, words)


# ------------------------------------------------------------------ PCX
@pytest.mark.parametrize("size", SIZES + [(3, 5), (5, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_pcx_equals_pil(tmp_path, mode, size):
    """PIL's PCX files of every mode it writes (odd widths padded to even
    planes: the padding decoded and dropped), and `encode_pcx`'s 8 x 1 and
    8 x 3 files, read by PIL as written. Fault B22: PIL's 8 x 3 file of
    width 3 is held to the image written (PIL takes a padding byte for a
    sample), and one of width 1 raises, as PIL does."""
    img = _image(*size, 3, seed=size[0] * 5 + size[1])
    arr = {"1": img[..., 0] > 127, "L": img[..., 0], "P": img, "RGB": img}[mode]
    data = _pil_bytes(arr, "PCX", convert="P" if mode == "P" else None)
    if mode == "RGB" and size[0] == 1:
        _both_raise(tmp_path, data, pcx.decode_pcx_plain, "fault B22")
        return
    if mode == "RGB" and size[0] == 3:
        got = _check(tmp_path, data, pcx.decode_pcx_plain, want=img)
        assert not np.array_equal(_pil(str(tmp_path / "f")), img)
        return
    _check(tmp_path, data, pcx.decode_pcx_plain)
    if mode in ("L", "RGB") and size[0] > 1:
        got = _check(tmp_path, pcx.encode_pcx(arr), pcx.decode_pcx_plain)
        assert np.array_equal(got, arr)
    if mode == "P":
        pal = np.random.default_rng(1).integers(0, 256, (256, 3), dtype=np.uint8)
        got = _check(tmp_path, pcx.encode_pcx(img[..., 0], palette=pal), pcx.decode_pcx_plain)
        assert np.array_equal(got, pal[img[..., 0]])


def _pcx(w, h, bits, planes, stride, rows: bytes, version=5, pal16=bytes(48), tail=b""):
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72)
    head += pal16 + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    body = bytearray()
    for b in rows:
        body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return head.ljust(128, b"\0") + bytes(body) + tail


@pytest.mark.parametrize("width", [1, 7, 8, 9, 16, 17, 25])
@pytest.mark.parametrize("planes", [1, 2, 4])
def test_pcx_bit_planes_equal_pil(tmp_path, planes, width):
    """1-bit PCX of 1, 2 and 4 planes (PIL writes only 1), planes at their
    natural stride and padded to even: the index's bit k from plane k, the
    header's palette (B15) or 0 / 255 (B16)."""
    rng = np.random.default_rng(planes * 100 + width)
    pal16 = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    natural = (width + 7) // 8
    for stride in {natural, natural + natural % 2}:
        rows = rng.integers(0, 256, 3 * planes * stride, dtype=np.uint8).tobytes()
        _check(tmp_path, _pcx(width, 3, 1, planes, stride, rows, pal16=pal16),
               pcx.decode_pcx_plain)


def test_pcx_gray_or_palette_by_the_tail(tmp_path):
    """8 x 1: the 256-colour palette after 0x0C at the end of the file makes
    it RGB where it is not the gray ramp (PIL's P), gray where it is or
    where there is none (PIL's L)."""
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 256, 40 * 6, dtype=np.uint8).tobytes()
    gray = np.repeat(np.arange(256, dtype=np.uint8), 3)
    other = gray.copy()
    other[5] = 9
    for tail, channels in ((b"\x0c" + gray.tobytes(), 2), (b"\x0c" + other.tobytes(), 3),
                           (b"\x0b" + other.tobytes(), 2), (bytes(900), 2)):
        got = _check(tmp_path, _pcx(40, 6, 8, 1, 40, rows, tail=tail), pcx.decode_pcx_plain)
        assert got.ndim == channels


def test_pcx_damaged_as_plain_and_pil(tmp_path):
    """64 damaged RLE files, 8 x 1 and 8 x 3: C++ = plain = PIL (bytes, or
    an error where PIL raises)."""
    img = _image(9, 7, 3, 4)
    img[img > 180] = 200
    for arr in (img, img[..., 0]):
        _damaged(tmp_path, pcx.encode_pcx(arr), pcx.decode_pcx, pcx.decode_pcx_plain, 128,
                 64, arr.ndim)


PCX_REFUSED = {
    "2bit_1plane": (_pcx(4, 1, 2, 1, 2, bytes(2)), "unknown PCX mode"),
    "4bit_1plane": (_pcx(4, 1, 4, 1, 2, bytes(2)), "unknown PCX mode"),
    "1bit_3planes": (_pcx(4, 1, 1, 3, 2, bytes(6)), "unknown PCX mode"),
    "8bit_version0": (_pcx(2, 1, 8, 1, 2, bytes(2), version=0, tail=bytes(769)),
                      "unknown PCX mode"),
    "run_past_row": (_pcx(2, 2, 8, 3, 2, b"") + bytes([0xC7, 5]) + bytes(12),
                     "crosses the end of its row"),
    "cut": (_pcx(4, 2, 8, 3, 4, bytes(20)), "cut short"),
    "8x1_under_769_bytes": (_pcx(2, 2, 8, 1, 2, bytes(4)), "769 bytes"),
}


@pytest.mark.parametrize("case", list(PCX_REFUSED))
def test_pcx_refused_forms_raise(tmp_path, case):
    """The PCX layouts PIL does not read and the damaged files it raises on,
    and an 8 x 1 file under 769 bytes (PIL seeks 769 bytes back from its end
    and fails on a file that short): the same ValueError, naming the cause,
    through both routes."""
    data, words = PCX_REFUSED[case]
    _both_raise(tmp_path, data, pcx.decode_pcx_plain, words)


# ------------------------------------------------------------------ fixtures
with open(os.path.join(RAW, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)

_PLAIN = {".tga": tga.decode_tga_plain, ".qoi": qoi.decode_qoi_plain,
          ".sgi": sgi.decode_sgi_plain, ".pcx": pcx.decode_pcx_plain}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_raw_fixtures_give_their_digests(name):
    """Each fixture of `tests/data/raw/` through `read_image` (C++) and the
    plain route gives its recorded digest and shape, and PIL, with the
    recorded rule applied, gives it again here."""
    path = os.path.join(RAW, name)
    with open(path, "rb") as fh:
        data = fh.read()
    want = DIGESTS[name]
    plain = _PLAIN.get(os.path.splitext(name)[1], pnm.decode_pnm)
    for got in (png.read_image(path), plain(data)):
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == want["array"]
        assert list(got.shape) == want["shape"]
    from tools.make_raw_fixtures_torch import digests
    assert digests(data) == want


# ------------------------------------------------------ a scene of each form
def _raw_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    nine views rewritten by PIL as PPM, TGA (RLE), QOI, SGI and PCX, in turn.
    -> proxy."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = Image.fromarray(jpeg.read_jpeg(path))
        fmt = ("PPM", "TGA", "QOI", "SGI", "PCX")[i % 5]
        img.save(path, fmt, **({"rle": True} if fmt == "TGA" else {}))
    return mesh


def test_raw_colmap_scene_matches_jax_and_trains(tmp_path):
    """`read_scene` on one COLMAP set of PPM, TGA, QOI, SGI and PCX views
    equals the JAX reader's at -r 1 and 2, and `cli.train_mesh --device
    cpu` trains 2 iterations on it."""
    root = str(tmp_path / "s")
    mesh = _raw_scene(root)
    for resolution in (1, 2):
        kw = dict(resolution=resolution, eval_split=True)
        _assert_scene_equal(readers.read_scene(root, **kw), jreaders.read_scene(root, **kw))
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
