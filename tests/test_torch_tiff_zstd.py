"""Zstandard TIFFs (compression 50000) in the port's readers against libzstd
1.5.7 and PIL 12.1 (libtiff 4.7.1) on the CPU: the port's Zstandard decoder
(`io/zstd.py`: the C++ `gm_zstd_decode` and the plain `decode_plain`) equal
to each other and to libzstd read as libtiff's `ZSTDDecode` reads a strip,
on libzstd's frames across levels, window logs and checksums with every
block, literal and table mode reached, and on damaged frames (the same bytes,
or raising where libzstd raises); `gm_xxh64` against libzstd's checksums;
the port's encoder (`gm_zstd_encode`) read back by libzstd through each of
its branches; the fixtures of `tests/data/tiff_zstd/`; libtiff's probed
rules held to PIL; `encode_tiff(compression="zstd")` read by PIL; and a
COLMAP scene of Zstandard TIFF views through `read_scene` against the JAX
reader, with no plain piece reached, and into `cli.train_mesh`.

The libzstd cases need `zstandard` or PIL's bundled libzstd, and skip where
neither is here."""

from __future__ import annotations

import collections
import io
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
from gaussianmesh_tpu_torch.io import jpeg, png, tiff, zstd
from tests.test_torch_readers import _assert_scene_equal
from tools.make_tiff_zstd_fixtures_torch import (SKIPPABLE, available, compress, container,
                                                 digest, libtiff_decode, sha, smooth,
                                                 with_window)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "tiff_zstd")
LEVELS = (-7, -5, -1, 1, 3, 6, 9, 12, 15, 19, 22)


@pytest.fixture
def need_libzstd():
    if not available():
        pytest.skip("neither zstandard nor PIL's libzstd is here")


def _skewed(n: int, seed: int) -> bytes:
    return bytes(np.minimum(np.random.default_rng(seed).geometric(0.08, n), 255)
                 .astype(np.uint8))


def _copies(n: int, prefix: bytes, length: int) -> bytes:
    """A skewed source, then n copies of its pieces each after `prefix`."""
    src = _skewed(20000, 1)
    rng = np.random.default_rng(2)
    starts = rng.integers(0, len(src) - length, n)
    return src + b"".join(prefix + src[p:p + length] for p in starts.tolist())


def _period16(n: int) -> bytes:
    """Noise whose 16-byte rows repeat the row above but for the first byte."""
    x = np.random.default_rng(11).integers(0, 256, n, dtype=np.uint8).reshape(-1, 16)
    x[1:, 1:] = x[0, 1:]
    return x.tobytes()


def _rows64() -> bytes:
    """128 KiB of noise (no byte 5), then 192 KiB of it again with every
    64th byte a 5: one literal and a repeat-offset match a row."""
    src = np.random.default_rng(12).integers(6, 256, 1 << 17, dtype=np.uint8)
    again = np.concatenate([src, src[:1 << 16]])
    again[::64] = 5
    return (src.tobytes() + again.tobytes())


def _counter_rows(n: int) -> bytes:
    """n 16-byte rows: the row's index (4 bytes, big-endian), then 12 bytes
    that every row repeats: 3 literals and a repeat-offset match a row."""
    rows = np.zeros((n, 16), np.uint8)
    rows[:, :4] = np.arange(n, dtype=">u4").view(np.uint8).reshape(n, 4)
    rows[:, 4:] = np.arange(40, 52, dtype=np.uint8)
    return rows.tobytes()


def corpus() -> dict[str, bytes]:
    """Data whose libzstd frames reach every block, literal and table mode
    at levels -7, 1 and 19 (`test_every_mode_is_reached`)."""
    rng = np.random.default_rng(0)
    return {
        "rle_literals": _copies(20000, b"\x01", 16),
        "treeless": _copies(6000, b"", 24) + _skewed(100, 3),
        "trits": bytes(rng.integers(0, 3, 30000, dtype=np.uint8)),
        "zeros": bytes(150000),
        "noise": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "skewed": _skewed(200, 9),
        "period16": _period16(160000),
        "image": smooth(60, 80, 3, 4, noise=3.0).tobytes(),
    }


def _outcome(decode, frame: bytes, size: int):
    try:
        return decode(frame, size).tobytes()
    except zstd.ZstdError as err:
        return ("raises", err.code, str(err))


def _three_ways(frame: bytes, data: bytes) -> None:
    """The C++, the plain walk and libzstd (libtiff's loop) give `data`."""
    n = len(data)
    assert zstd.decode(frame, n).tobytes() == data
    assert zstd.decode_plain(frame, n).tobytes() == data
    assert libtiff_decode(frame, n) == (data, True)


# ------------------------------------------------------------------ decoder
@pytest.mark.parametrize("level", LEVELS)
def test_libzstd_frames_three_ways(need_libzstd, level):
    """libzstd's frames of the corpus at `level`, with and without a
    checksum and a content size: C++ = plain = libzstd."""
    for i, (name, data) in enumerate(corpus().items()):
        frame = compress(data, level, checksum=bool(i & 1), content_size=bool(i & 2))
        _three_ways(frame, data)


@pytest.mark.parametrize("log", range(10, 28))
def test_window_logs(need_libzstd, log):
    """A frame without its content size at each window log libzstd's
    default limit allows (its descriptor set on libzstd's frame), with a
    checksum: C++ = plain = libzstd; past the limit all three raise."""
    data = smooth(16, 64, 1, log, noise=6.0).tobytes()
    frame = with_window(compress(data, 3, checksum=True, content_size=False), log, 0)
    _three_ways(frame, data)
    if log == 27:
        for mantissa in (1, 7):
            over = with_window(frame, 27, mantissa)
            with pytest.raises(ValueError):
                libtiff_decode(over, len(data))
            for decode in (zstd.decode, zstd.decode_plain):
                with pytest.raises(zstd.ZstdError, match="over libzstd's default limit"):
                    decode(over, len(data))


def _record(monkeypatch) -> collections.Counter:
    """Counts, by name, each block, literal and table mode the plain walk
    takes from here on."""
    seen = collections.Counter()
    lit, huf, seq = zstd._literals, zstd._huffman_table, zstd._seq_table
    fast, exact, block = zstd._huffman_fast, zstd._huffman_stream, zstd._block

    def on_literals(b, st, limit):
        kind, fmt = b[0] & 3, b[0] >> 2 & 3
        seen[f"literals{kind}" + ("" if kind < 2 else "_1stream" if fmt == 0 else
                                  "_4streams")] += 1
        return lit(b, st, limit)

    def on_huffman(d, pos, end):
        seen["weights_direct" if d[pos] >= 128 else "weights_fse"] += 1
        return huf(d, pos, end)

    def on_table(b, pos, end, mode, which, st):
        seen[f"{('LL', 'OF', 'ML')[which]}_mode{mode}"] += 1
        if mode == 1 and which == 1 and pos < end:
            seen[f"OF_rle_code{b[pos]}"] += 1        # code 0: the first repeat offset
        return seq(b, pos, end, mode, which, st)

    def on_fast(*a):
        seen["huffman_fast"] += 1
        return fast(*a)

    def on_exact(*a):
        seen["huffman_exact"] += 1
        return exact(*a)

    def on_block(*a):
        seen["block2"] += 1
        return block(*a)

    for name, f in (("_literals", on_literals), ("_huffman_table", on_huffman),
                     ("_seq_table", on_table), ("_huffman_fast", on_fast),
                     ("_huffman_stream", on_exact), ("_block", on_block)):
        monkeypatch.setattr(zstd, name, f)
    return seen


def _block_kinds(frame: bytes) -> set:
    fhd = frame[4]
    single = fhd >> 5 & 1
    pos = 5 + (1 - single) + (0, 1, 2, 4)[fhd & 3] + (single, 2, 4, 8)[fhd >> 6]
    kinds = set()
    while True:
        h = int.from_bytes(frame[pos:pos + 3], "little")
        kinds.add(f"block{h >> 1 & 3}")
        pos += 3 + (1 if h >> 1 & 3 == 1 else h >> 3)
        if h & 1:
            return kinds


MODES = ({f"block{k}" for k in range(3)} | {"literals0", "literals1", "literals2_1stream",
                                             "literals2_4streams", "literals3_1stream",
                                             "literals3_4streams", "weights_direct",
                                             "weights_fse", "huffman_fast", "huffman_exact"}
         | {f"{t}_mode{m}" for t in ("LL", "OF", "ML") for m in range(4)})


def test_every_mode_is_reached(need_libzstd, monkeypatch):
    """The corpus's libzstd frames at levels -7, 1 and 19 reach raw, RLE and
    compressed blocks; raw, RLE, Huffman (1 and 4 streams, weights direct
    and FSE-coded, libzstd's fast and exact 4-stream rules) and treeless
    literals (1 and 4 streams); and each sequence table predefined, RLE,
    FSE-coded and repeated."""
    seen = _record(monkeypatch)
    kinds = set()
    for data in corpus().values():
        for level in (-7, 1, 19):
            frame = compress(data, level)
            kinds |= _block_kinds(frame)
            assert zstd.decode_plain(frame, len(data)).tobytes() == data
    assert MODES <= set(seen) | kinds, sorted(MODES - set(seen) - kinds)


def _damaged(seed: int) -> list[tuple[bytes, int]]:
    """Ten damaged frames of the corpus: a bit flipped, a byte replaced, the
    frame cut, three bits flipped, bytes appended or the magic's first byte
    changed; each with the size of its data, or a few bytes off."""
    rng = np.random.default_rng(seed)
    data = list(corpus().values())
    out = []
    for _ in range(10):
        d = data[int(rng.integers(len(data)))][:int(rng.integers(100, 20000))]
        f = bytearray(compress(d, int(rng.choice([-3, 1, 5, 19])),
                               checksum=bool(rng.integers(2)),
                               content_size=bool(rng.integers(2))))
        k = int(rng.integers(6))
        if k == 0:
            f[rng.integers(len(f))] ^= 1 << int(rng.integers(8))
        elif k == 1:
            f[rng.integers(len(f))] = int(rng.integers(256))
        elif k == 2:
            f = f[:int(rng.integers(len(f)))]
        elif k == 3:
            for _ in range(3):
                f[rng.integers(len(f))] ^= 1 << int(rng.integers(8))
        elif k == 4:
            f += rng.integers(0, 256, int(rng.integers(1, 10)), dtype=np.uint8).tobytes()
        else:
            f[0] = int(rng.choice([0x26, 0x27, 0x29, 0x50]))
        size = max(1, len(d) + int(rng.integers(-3, 4)) * int(rng.integers(2)))
        out.append((bytes(f), size))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_damaged_frames(need_libzstd, seed):
    """80 damaged frames over the 8 seeds: the C++ and the plain walk give
    the same bytes or raise the same error; where libzstd (libtiff's loop)
    raises, or stops short of the strip waiting for more input, both raise;
    where it gives the strip, both give its bytes. A legacy frame (format
    0.6 or 0.7), which libzstd reads, raises naming it."""
    kinds = collections.Counter()
    for frame, size in _damaged(seed):
        cpp, plain = _outcome(zstd.decode, frame, size), _outcome(zstd.decode_plain, frame,
                                                                  size)
        assert cpp == plain
        try:
            got, ended = libtiff_decode(frame, size)
        except ValueError:
            assert isinstance(cpp, tuple)
            kinds["libzstd raises"] += 1
            continue
        if int.from_bytes(frame[:4], "little") in (0xFD2FB526, 0xFD2FB527):
            assert isinstance(cpp, tuple) and "legacy" in cpp[2]
            kinds["legacy"] += 1
        elif not ended and len(got) < size:
            assert isinstance(cpp, tuple)
            kinds["libzstd waits"] += 1
        else:
            assert cpp == got
            kinds["libzstd decodes"] += 1
    assert kinds["libzstd raises"] + kinds["libzstd waits"] and kinds["libzstd decodes"], kinds


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000, 65537])
def test_xxh64_is_libzstd_checksum(need_libzstd, n):
    """`gm_xxh64` and `xxh64_plain` of n bytes: their low 32 bits are the
    checksum libzstd writes at the end of the frame."""
    data = _skewed(n, n)
    frame = compress(data, 3, checksum=True)
    want = int.from_bytes(frame[-4:], "little")
    assert zstd.xxh64(data) == zstd.xxh64_plain(data)
    assert zstd.xxh64(data) & 0xFFFFFFFF == want


def test_decode_stops_as_libtiff_does():
    """The port's own frames: the output stops at `size` (what a frame gives
    past it is dropped), bytes after the frame are not read, a skippable
    frame gives nothing, a frame cut short raises, both ways."""
    data = _copies(300, b"\x02", 12)
    frame = zstd.encode(data, checksum=True)
    for decode in (zstd.decode, zstd.decode_plain):
        assert decode(frame, len(data) - 7).tobytes() == data[:-7]
        assert decode(frame + b"trailing", len(data) + 9).tobytes() == data
        assert decode(struct.pack("<II", SKIPPABLE, 1) + b"x" + frame, 10).size == 0
        with pytest.raises(zstd.ZstdError, match="cut short"):
            decode(frame[:-20], len(data))


# ------------------------------------------------------------------ encoder
def _encoder_data() -> dict[str, bytes]:
    rng = np.random.default_rng(3)
    return {
        "empty": b"",
        "one": b"z",
        "noise_raw_block": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        "flat_rle_block": bytes([9]) * 5000,
        "one_stream": _skewed(200, 5),
        "skewed": _skewed(600, 4),
        "sixteen_symbols_direct_weights": bytes(rng.integers(0, 16, 3000, dtype=np.uint8)),
        "image_fse_weights": smooth(100, 200, 3, 5, noise=4.0).tobytes(),
        "rows64_rle_literals_and_tables": _rows64(),
        "period16": _period16(40000),
        "counter_rows_rle_tables_repeat_offsets": _counter_rows(10000),
        "three_blocks": _copies(20000, b"\x03", 20),
    }


@pytest.mark.parametrize("name", sorted(_encoder_data()))
@pytest.mark.parametrize("checksum", [False, True])
def test_port_encoder_read_by_libzstd(need_libzstd, name, checksum):
    """`encode` (gm_zstd_encode) of each kind of data: libzstd reads it back
    as libtiff would, and so do the C++ and the plain walk."""
    data = _encoder_data()[name]
    frame = zstd.encode(data, checksum=checksum)
    assert bool(frame[4] & 4) == checksum
    _three_ways(frame, data)


def test_port_encoder_reaches_each_branch(monkeypatch):
    """The encoder's frames of `_encoder_data` hold raw, RLE and compressed
    blocks; raw, RLE and Huffman literals in 1 and 4 streams, weights
    direct and FSE-coded; each sequence table predefined, RLE and
    FSE-coded; a block whose every match takes the first repeat offset."""
    seen = _record(monkeypatch)
    kinds = set()
    for data in _encoder_data().values():
        frame = zstd.encode(data)
        kinds |= _block_kinds(frame)
        assert zstd.decode_plain(frame, len(data)).tobytes() == data
    want = ({"block0", "block1", "block2", "literals0", "literals1", "literals2_1stream",
             "literals2_4streams", "weights_direct", "weights_fse"}
            | {f"{t}_mode{m}" for t in ("LL", "OF", "ML") for m in range(3)} | {"OF_rle_code0"})
    assert want <= set(seen) | kinds, sorted(want - set(seen) - kinds)


# ------------------------------------------------------------------ fixtures
def test_fixture_digests_are_pil():
    """digests.json is what PIL gives on each fixture today (the fixtures
    cannot drift), and they fit in 100 KB."""
    table = json.load(open(os.path.join(FIXTURES, "digests.json")))
    names = {n for n in os.listdir(FIXTURES) if n != "digests.json"}
    assert len(table) >= 40 and set(table) == names
    total = os.path.getsize(os.path.join(FIXTURES, "digests.json"))
    for name, want in table.items():
        data = open(os.path.join(FIXTURES, name), "rb").read()
        total += len(data)
        assert digest(data, None if want["array"] else "refused") == want, name
    assert total <= 100 * 1024


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES,
                                                                    "digests.json")))))
def test_fixture_decodes_to_its_digest(name):
    """Each fixture through `read_image` and through the plain route gives its
    recorded digest and shape; each one PIL fails on raises a ValueError
    naming the strip both ways."""
    want = json.load(open(os.path.join(FIXTURES, "digests.json")))[name]
    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    if want["array"] is None:
        for read in (png.read_image, lambda p: tiff.decode_tiff_plain(data, p)):
            with pytest.raises(ValueError, match="TIFF strip 0"):
                read(path)
        return
    for a in (png.read_image(path), tiff.decode_tiff_plain(data, path)):
        assert sha(a) == want["array"] and list(a.shape) == want["shape"], name


def _pil_load(data: bytes):
    try:
        im = Image.open(io.BytesIO(data))
        im.load()
        return np.asarray(im)
    except OSError:
        return None


PROBES = ("two_frames", "skippable_first", "cut", "bad_checksum", "trailing", "over_long",
          "dictionary", "window_over_limit", "window_over_limit_one_pass", "empty_strip")


@pytest.mark.parametrize("probe", PROBES)
def test_libtiff_rules_held_to_pil(need_libzstd, probe, tmp_path):
    """Each probed `ZSTDDecode` rule on a 40x24 gray strip: where PIL reads
    the file, the port's two routes give its array; where PIL fails, both
    raise a ValueError naming the strip."""
    img = smooth(24, 40, 1, 7, noise=8.0)[..., 0]
    raw = img.tobytes()
    half = len(raw) // 2
    streaming = compress(raw, 3, content_size=False)
    strip = {
        "two_frames": lambda: compress(raw[:half]) + compress(raw[half:]),
        "skippable_first": lambda: struct.pack("<II", SKIPPABLE, 3) + b"abc" + compress(raw),
        "cut": lambda: compress(raw)[:-3],
        "bad_checksum": lambda: compress(raw, checksum=True)[:-1] + bytes(
            [compress(raw, checksum=True)[-1] ^ 0xFF]),
        "trailing": lambda: compress(raw) + b"\xff" * 5,
        "over_long": lambda: compress(raw + bytes(300), 3),
        "dictionary": lambda: streaming[:4] + bytes([streaming[4] | 2]) + streaming[5:6]
        + b"\x01\x00" + streaming[6:],
        "window_over_limit": lambda: with_window(streaming, 28),
        "window_over_limit_one_pass": lambda: (streaming[:4] + bytes([0x40, (28 - 10) << 3])
                                               + struct.pack("<H", len(raw) - 256)
                                               + streaming[6:]),
        "empty_strip": lambda: b"",
    }[probe]()
    data = container([strip], 40, 24)
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as fh:
        fh.write(data)
    want = _pil_load(data)
    if want is None:
        for read in (png.read_image, lambda p: tiff.decode_tiff_plain(data, p)):
            with pytest.raises(ValueError, match="TIFF strip 0"):
                read(path)
    else:
        for got in (png.read_image(path), tiff.decode_tiff_plain(data, path)):
            assert np.array_equal(got, want)


# ------------------------------------------------------------------ writer
WRITES = {
    "strips_ii": dict(),
    "strips_mm_predictor2": dict(byteorder=">", predictor=2),
    "tiles_predictor2": dict(tile=(32, 16), predictor=2),
    "tiles_mm": dict(tile=(16, 32), byteorder=">"),
    "planar_predictor2": dict(planar=True, predictor=2, rows_per_strip=7),
    "planar_mm": dict(planar=True, byteorder=">"),
    "rgb16_predictor2": dict(predictor=2, depth=16),
    "rgb16_tiles_mm": dict(tile=(16, 16), byteorder=">", depth=16),
    "gray16_planar": dict(gray=True, depth=16, planar=True),
    "rgba_strips5": dict(alpha=True, rows_per_strip=5),
    "gray_alpha_predictor2": dict(gray=True, alpha=True, predictor=2),
}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_encode_tiff_zstd_read_by_pil(tmp_path, name):
    """`encode_tiff(compression="zstd")` in both byte orders, in strips,
    tiles and planes, 8 and 16 bits, with predictor 1 or 2: PIL reads the
    samples written (16-bit RGB as its high bytes, 16-bit gray as I;16),
    and so do both of the port's routes (the high byte of 16-bit samples)."""
    kw = dict(WRITES[name])
    depth, gray, alpha = kw.pop("depth", 8), kw.pop("gray", False), kw.pop("alpha", False)
    img = smooth(29, 45, 1 if gray else 3, 11, noise=9.0)
    if alpha:
        img = np.dstack([img, img[..., :1] // 2 + 60])
    img = img[..., 0] if img.shape[2] == 1 else img
    samples = img.astype(np.uint16) * 256 + 7 if depth == 16 else img
    data = tiff.encode_tiff(samples, compression="zstd", **kw)
    pil = _pil_load(data)
    assert pil is not None
    assert np.array_equal(pil, samples if depth == 16 and gray else img)
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as fh:
        fh.write(data)
    for got in (png.read_image(path), tiff.decode_tiff_plain(data, path)):
        assert np.array_equal(got, img)


# ------------------------------------------------------------------ scene
def _zstd_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its views
    rewritten in turn as Zstandard TIFFs: PIL's, PIL's with predictor 2 in
    strips of 16 rows, the port's writer's in strips with predictor 2, in
    tiles, planar and big-endian. -> proxy."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        form = i % 6
        if form < 2:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "TIFF", compression="zstd",
                                      **({} if form == 0 else dict(tiffinfo={317: 2},
                                                                    strip_size=64 * 3 * 16)))
            data = buf.getvalue()
        else:
            data = tiff.encode_tiff(img, "zstd", **(
                dict(predictor=2), dict(tile=(32, 16)), dict(planar=True, predictor=2),
                dict(byteorder=">"))[form - 2])
        with open(path, "wb") as fh:
            fh.write(data)
    return mesh


def test_zstd_scene_matches_jax_and_trains(tmp_path, monkeypatch):
    """`read_scene` on a COLMAP set of Zstandard TIFF views equals the JAX
    reader's (PIL, libtiff) at -r 1 and 2 with every plain piece of the
    codec made to raise, and `cli.train_mesh --device cpu` trains 2
    iterations on it."""
    root = str(tmp_path / "s")
    mesh = _zstd_scene(root)

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for kw in (dict(resolution=1, eval_split=True), dict(resolution=2, eval_split=True)):
        want = jreaders.read_scene(root, **kw)
        with monkeypatch.context() as m:
            for name in ("decode_plain", "xxh64_plain", "_block", "_literals", "_header",
                         "_huffman_table", "_fse_weights", "_huffman_stream",
                         "_huffman_fast", "_ncount", "_seq_table", "_Back"):
                m.setattr(zstd, name, plain)
            got = readers.read_scene(root, **kw)
        _assert_scene_equal(got, want)
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
