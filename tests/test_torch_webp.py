"""Lossy WebP in the port's readers (`io/webp.py`, `csrc/vp8.cpp`) against
PIL 12.1 / libwebp 1.6 and the JAX reader: PIL-written files at every size,
quality and method read as `Image.open(p).convert("RGB")`, the decoder's
planes equal libwebp's `WebPDecodeYUV` (PIL's bundled library through
ctypes, test side only), the constant tables found in that library's bytes,
the writer's files decoded by PIL, the C++ and the plain version equal on
damaged and cut streams, the refusals (and the forms once refused, read),
the fixtures of `tests/data/webp/`
and a COLMAP scene of WebP views through `read_scene` and `train_mesh`."""

from __future__ import annotations

import importlib.util
import io
import json
import os
import re
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, png, vp8_tables, webp
from gaussianmesh_tpu_torch.ops import _cuda
from tests.test_torch_readers import _assert_scene_equal

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "webp")
_spec = importlib.util.spec_from_file_location(
    "make_webp_fixtures_torch", os.path.join(ROOT, "tools", "make_webp_fixtures_torch.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)
LIBWEBP = fx.libwebp_library()


def _outcome(fn, *args):
    """fn(*args), or the ValueError's message (minus the path) it raises."""
    try:
        return fn(*args)
    except ValueError as err:
        return str(err).split(": ", 1)[1]


def _same_outcome(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _check(data: bytes, plain: bool):
    """read_image == PIL; the C++ planes == libwebp's; (`plain`) the plain
    version's planes, statistics and RGB == the C++'s. -> the statistics."""
    want = fx.pil_rgb(data)
    frame = webp.frame_of(data)
    y, u, v, info = webp.decode_vp8(frame)
    got = webp.yuv_to_rgb(y, u, v)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    lib = fx.libwebp_yuv(data, LIBWEBP)
    assert all(np.array_equal(a, b) for a, b in zip((y, u, v), lib))
    if plain:
        py, pu, pv, pinfo = webp.vp8_decode_plain(frame)
        assert all(np.array_equal(a, b) for a, b in zip((y, u, v, info), (py, pu, pv, pinfo)))
        assert np.array_equal(webp.yuv_to_rgb_plain(y, u, v), got)
    return dict(zip(webp.STATS, info.tolist()))


# ------------------------------------------------------ PIL-written files
SIZES = [(1, 1), (15, 17), (16, 16), (17, 33), (93, 67), (255, 129), (1920, 1080)]


@pytest.mark.parametrize("quality", [0, 30, 75, 95, 100])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_pil_lossy_webp_equals_pil(tmp_path, size, quality):
    """PIL's lossy files of gradients, noise and sharp edges, methods 0, 4
    and 6, L and RGB sources: `read_image` gives PIL's bytes and the planes
    are libwebp's; up to 128 px the plain version gives the same bytes.
    (1920x1080: method 4 RGB and method 0 L, the C++ alone.)"""
    w, h = size
    big = w > 256
    img = fx.natural(h, w, quality % 7)
    stats = []
    for method, mode in ([(4, "RGB"), (0, "L")] if big else
                         [(m, md) for m in (0, 4, 6) for md in ("RGB", "L")]):
        src = img if mode == "RGB" else img[..., 1]
        data = fx.pil_webp(src, quality=quality, method=method)
        path = str(tmp_path / f"{method}{mode}.webp")
        with open(path, "wb") as f:
            f.write(data)
        stats.append(_check(data, plain=max(w, h) <= 128))
        assert np.array_equal(png.read_image(path), fx.pil_rgb(data))
    if w * h >= 64 * 64:
        assert any(s["i4x4"] for s in stats)                 # B_PRED is met


@pytest.mark.parametrize("extra", ["icc", "exif", "both"])
def test_extended_files_equal_pil(tmp_path, extra):
    """`VP8X` files (an ICC profile, EXIF or both: PIL writes them extended)
    read as PIL reads them; their extra chunks are skipped."""
    kw = {"icc_profile": b"\x01" * 57} if extra != "exif" else {}
    if extra != "icc":
        kw["exif"] = b"Exif\x00\x00II*\x00" + bytes(9)
    data = fx.pil_webp(fx.natural(29, 45, 3), quality=70, **kw)
    assert data[12:16] == b"VP8X"
    _check(data, plain=True)


# ------------------------------------------------------ constant tables
def _cpp_table(name: str) -> bytes:
    """The bytes of table `name` as csrc/vp8.cpp types it."""
    src = open(os.path.join(ROOT, "gaussianmesh_tpu_torch", "csrc", "vp8.cpp")).read()
    m = re.search(r"(uint8_t|uint16_t|int8_t) " + name + r"(?:\[\w*\])+ = \{(.*?)\};", src, re.S)
    vals = [int(t) for t in re.findall(r"-?\w+", m.group(2).replace("B_", "").replace(
        "DC_PRED", "0").replace("TM_PRED", "1").replace("VE_PRED", "2").replace(
        "HE_PRED", "3").replace("RD_PRED", "4").replace("VR_PRED", "5").replace(
        "LD_PRED", "6").replace("VL_PRED", "7").replace("HD_PRED", "8").replace(
        "HU_PRED", "9"))]
    dtype = {"uint8_t": np.uint8, "uint16_t": "<u2", "int8_t": np.int8}[m.group(1)]
    return np.array(vals, dtype).tobytes()


TABLES = {
    "kDcTable": vp8_tables.DC_TABLE, "kAcTable": vp8_tables.AC_TABLE.astype("<u2"),
    "kCoeffsUpdateProba": vp8_tables.COEFFS_UPDATE_PROBA,
    "kBmodesProba": vp8_tables.BMODES_PROBA, "kCoeffsProba0": vp8_tables.COEFFS_PROBA0,
    "kZigzag": vp8_tables.ZIGZAG, "kBands": vp8_tables.BANDS,
    "kYModesIntra4": vp8_tables.YMODES_INTRA4,
    "kCat3": np.append(vp8_tables.CAT3456[0], 0).astype(np.uint8),
    "kCat4": np.append(vp8_tables.CAT3456[1], 0).astype(np.uint8),
    "kCat5": np.append(vp8_tables.CAT3456[2], 0).astype(np.uint8),
    "kCat6": np.append(vp8_tables.CAT3456[3], 0).astype(np.uint8),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_are_libwebps(name):
    """Each constant table of the C++ and its copy in `io/vp8_tables.py` are
    the same bytes, found verbatim in PIL's bundled libwebp."""
    so = open(fx.libwebp_path(), "rb").read()
    cpp, plain = _cpp_table(name), np.ascontiguousarray(TABLES[name]).tobytes()
    assert cpp == plain
    assert len(cpp) >= 4 and so.find(cpp) >= 0, name


# ------------------------------------------------------ the writer
WRITER = {
    "4seg_delta_normal24_q30": dict(quality_index=30, segments=4, level=24),
    "simple32_2parts_q40": dict(quality_index=40, filter="simple", level=32, partitions=2),
    "4seg_sharp5_deltas_8parts_q4": dict(quality_index=4, segments=4, level=22, sharpness=5,
                                         ref_lf_delta=(3, 1, 0, -1),
                                         mode_lf_delta=(2, 0, 1, 0), partitions=8),
    "nofilter_q110": dict(quality_index=110, filter="none"),
    "4seg_absolute_normal16_4parts_vp8x": dict(quality_index=20, segments=4, absolute=True,
                                               level=16, partitions=4, icc=b"\x02" * 33,
                                               exif=b"Exif\x00\x00MM"),
    "simple_sharp7_8parts_q0": dict(quality_index=0, filter="simple", level=63, sharpness=7,
                                    partitions=8),
    "normal_hev_1part_q60": dict(quality_index=60, level=45, sharpness=2),
    "4seg_delta_deltas_4parts_q90": dict(quality_index=90, segments=4, level=10,
                                         ref_lf_delta=(-6, 0, 0, 0),
                                         mode_lf_delta=(0, 0, 0, 0), partitions=4),
}


@pytest.mark.parametrize("case", list(WRITER))
def test_writer_decodes_in_pil_to_the_ports_bytes(tmp_path, case):
    """Every setting of the smoke's table and 1/2/4/8 partitions: PIL decodes
    `write_webp`'s file to the port's RGB, the decoder's planes are the
    writer's reconstruction, libwebp's too, and the plain version agrees;
    the header says what was asked for."""
    kw = WRITER[case]
    img = fx.natural(54, 70, len(case))
    if kw["quality_index"] >= 100:            # flat past the top-left: skipped macroblocks
        img[20:] = img[:, 30:] = 90
    path = str(tmp_path / "w.webp")
    ry, ru, rv = webp.write_webp(path, img, **kw)
    data = open(path, "rb").read()
    stats = _check(data, plain=True)
    y, u, v, _ = webp.decode_vp8(webp.frame_of(data))
    assert all(np.array_equal(a, b) for a, b in zip((y, u, v), (ry, ru, rv)))
    assert np.array_equal(png.read_image(path), fx.pil_rgb(data))
    filt = {"none": 0, "simple": 1, "normal": 2}[kw.get("filter", "normal")]
    assert (stats["filter"], stats["partitions"], stats["segments"], stats["base_q"]) == \
        (filt, kw.get("partitions", 1), int(kw.get("segments", 1) == 4), kw["quality_index"])
    assert stats["sharpness"] == kw.get("sharpness", 0)
    assert stats["lf_delta"] == int("ref_lf_delta" in kw)
    assert (data[12:16] == b"VP8X") == ("icc" in kw)
    if kw["quality_index"] >= 100:
        assert stats["skip"] > 0
    if kw["quality_index"] <= 4:
        assert stats["token10"] > 0                         # DCT_CAT6


def test_writer_gray_and_odd_sizes(tmp_path):
    """Gray sources and sizes from 1x1 to 33x17 through the writer."""
    for h, w in [(1, 1), (17, 33), (16, 16), (9, 40)]:
        for img in (fx.natural(h, w, 1), fx.natural(h, w, 2)[..., 0]):
            data, planes = webp.encode_webp(img, quality_index=25, segments=4)
            _check(data, plain=True)
            assert all(np.array_equal(a, b)
                       for a, b in zip(webp.decode_vp8(webp.frame_of(data))[:3], planes))


# ------------------------------------------------------ damaged streams
def _partitions(frame: bytes):
    """(first partition's (start, end), token data's (start, end)) in a frame."""
    first = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
    return (10, 10 + first), (10 + first, len(frame))


@pytest.mark.parametrize("part", ["first", "tokens"])
@pytest.mark.parametrize("source", ["pil_q80", "writer_4parts"])
def test_damaged_streams_cpp_equals_plain(source, part):
    """64 seeded random byte changes in the first partition or in the token
    partitions: the C++ and the plain version give the same bytes or the same
    ValueError."""
    img = fx.natural(37, 45, 11)
    if source == "pil_q80":
        frame = webp.frame_of(fx.pil_webp(img, quality=80))
    else:
        frame = webp.frame_of(webp.encode_webp(img, quality_index=8, segments=4,
                                               partitions=4, sharpness=3)[0])
    lo, hi = _partitions(frame)[part == "tokens"]
    rng = np.random.default_rng(sum(map(ord, source + part)))
    raised = 0
    for _ in range(64):
        bad = bytearray(frame)
        for pos in rng.integers(lo, hi, rng.integers(1, 4)):
            bad[pos] ^= int(rng.integers(1, 256))
        a = _outcome(webp.decode_vp8, bytes(bad))
        b = _outcome(webp.vp8_decode_plain, bytes(bad))
        assert _same_outcome(a, b), (a if isinstance(a, str) else "pixels",
                                     b if isinstance(b, str) else "pixels")
        raised += isinstance(a, str)
    assert raised < 64


@pytest.mark.parametrize("part", ["first", "tokens"])
def test_damaged_streams_raise_where_libwebp_raises(part):
    """100 seeded random byte changes in one partition kind of a PIL file:
    the port raises exactly where libwebp's `WebPDecodeYUV` fails. (Their
    pixels may differ where a change makes coefficients far past any
    encoder's range: libwebp's SSE2 inverse transform wraps 16-bit
    intermediates there, the port follows libwebp's C transform.)"""
    frame = webp.frame_of(fx.pil_webp(fx.natural(48, 64, 2), quality=80))
    lo, hi = _partitions(frame)[part == "tokens"]
    rng = np.random.default_rng(len(part))
    raised = 0
    for _ in range(100):
        bad = bytearray(frame)
        for pos in rng.integers(lo, hi, rng.integers(1, 4)):
            bad[pos] ^= int(rng.integers(1, 256))
        body = b"VP8 " + struct.pack("<I", len(bad)) + bytes(bad) + b"\x00" * (len(bad) & 1)
        data = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
        port = _outcome(webp.decode_webp, data)
        assert isinstance(port, str) == (fx.libwebp_yuv(data, LIBWEBP) is None), port
        raised += isinstance(port, str)
    assert 0 < raised < 100


@pytest.mark.parametrize("quality", [30, 95])
def test_cut_last_partition_as_pil(quality):
    """k = 0-64 bytes cut from the last token partition, the sizes repaired:
    PIL and the port both raise or give equal pixels, and the plain version
    agrees with the C++."""
    data = fx.pil_webp(fx.natural(48, 64, quality), quality=quality)
    seen = set()
    for k in range(65):
        cut = fx.cut(data, k)
        want = fx.pil_rgb(cut)
        got = _outcome(webp.decode_webp, cut)
        if want is None:
            assert isinstance(got, str) and "cut short" in got, k
        else:
            assert not isinstance(got, str) and np.array_equal(got, want), k
        assert _same_outcome(got, _outcome(webp.decode_webp_plain, cut)), k
        seen.add(want is None)
    assert seen == {True, False}


def test_cut_by_2_raises_and_by_3_decodes():
    """The 80x64 quality-80 fixture: cut by 2 bytes it raises "cut short"
    through both decoders (as PIL raises), cut by 3 it decodes to PIL's other
    pixels (the pad byte the repaired chunk gains ends the partition)."""
    base = open(os.path.join(FIXTURES, "pil_q80_natural_80x64.webp"), "rb").read()
    cut2, cut3 = fx.cut(base, 2), fx.cut(base, 3)
    assert fx.pil_rgb(cut2) is None
    for fn in (webp.decode_webp, webp.decode_webp_plain):
        with pytest.raises(ValueError, match="cut short"):
            fn(cut2)
        assert np.array_equal(fn(cut3), fx.pil_rgb(cut3))
    assert not np.array_equal(fx.pil_rgb(cut3), fx.pil_rgb(base))


# ------------------------------------------------------ forms once refused, and refusals
def _refused(kind: str) -> tuple[bytes, str]:
    img = fx.natural(20, 24, 1)
    lossy = fx.pil_webp(img, quality=80)
    if kind == "lossless":
        return fx.pil_webp(img, lossless=True), r"lossless WebP \(VP8L\)"
    if kind == "alpha":
        rgba = np.concatenate([img, np.arange(480, dtype=np.uint8).reshape(20, 24, 1)], -1)
        return fx.pil_webp(rgba, quality=80), r"WebP with alpha \(ALPH\)"
    if kind == "animated":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", save_all=True, quality=80,
                                  append_images=[Image.fromarray(img[::-1].copy())])
        return buf.getvalue(), "animated WebP"
    if kind == "alpha_flag":                  # VP8X saying alpha, no ALPH chunk
        data = fx.pil_webp(img, quality=80, exif=b"Exif\x00\x00MM")
        return data[:20] + bytes([data[20] | 0x10]) + data[21:], r"WebP with alpha \(ALPH\)"
    if kind == "canvas":                      # VP8X canvas other than the frame
        data = fx.pil_webp(img, quality=80, exif=b"Exif\x00\x00MM")
        return data[:24] + bytes([data[24] + 1]) + data[25:], "canvas"
    if kind == "riff_size":                   # the file shorter than its RIFF size
        return lossy[:-6], "cut short"
    if kind == "inter_frame":                 # a frame tag that is not a key frame
        return lossy[:20] + bytes([lossy[20] | 1]) + lossy[21:], "not a key frame"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["lossless", "alpha", "animated", "alpha_flag", "canvas",
                                  "riff_size", "inter_frame"])
def test_refused_files_name_their_cause(tmp_path, kind):
    """VP8L, ALPH (and the alpha flag with no ALPH) and animated files, once
    refused, read as `np.asarray(Image.open(p))` through `read_image` and
    the plain version (`tests/test_torch_webp_alpha.py` holds them to PIL
    at every setting); damaged containers raise naming their cause, as PIL
    raises."""
    data, words = _refused(kind)
    path = str(tmp_path / "x.webp")
    with open(path, "wb") as f:
        f.write(data)
    if kind in ("lossless", "alpha", "animated", "alpha_flag"):
        want = fx.pil_array(data)
        assert want is not None and want.shape[2] == (4 if "alpha" in kind else 3)
        assert np.array_equal(png.read_image(path), want)
        assert np.array_equal(webp.decode_webp_plain(data), want)
        return
    with pytest.raises(ValueError, match=words):
        png.read_image(path)
    with pytest.raises(ValueError, match=words):
        webp.decode_webp_plain(data)
    assert fx.pil_rgb(data) is None


# ------------------------------------------------------ the fixtures
def test_fixture_digests_are_pil_and_libwebp():
    """digests.json is what PIL and libwebp give on each fixture today (the
    fixtures cannot drift), the fixtures fit in 96 KB, and between them they
    use B_PRED with all ten sub-modes, 4 segments, both filters, 8
    partitions, skipped macroblocks and DCT_CAT6."""
    table = json.load(open(os.path.join(FIXTURES, "digests.json")))
    files = {n for n in os.listdir(FIXTURES) if os.path.isfile(os.path.join(FIXTURES, n))}
    assert len(table) >= 12 and set(table) == files - {"digests.json"}
    total = os.path.getsize(os.path.join(FIXTURES, "digests.json"))
    bmodes, seen = np.zeros(10, np.int64), set()
    for name, want in table.items():
        data = open(os.path.join(FIXTURES, name), "rb").read()
        total += len(data)
        assert fx.digests(data, LIBWEBP) == want, name
        if want["rgb"] != "raises":
            info = webp.decode_vp8(webp.frame_of(data))[3]
            s = dict(zip(webp.STATS, info.tolist()))
            bmodes += info[8:18]
            seen |= {f"filter{s['filter']}", f"parts{s['partitions']}"}
            seen |= {k for k in ("segments", "skip", "token10") if s[k]}
    assert total <= 96 * 1024
    assert (bmodes > 0).all()
    assert {"filter1", "filter2", "parts8", "segments", "skip", "token10"} <= seen


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES,
                                                                    "digests.json")))))
def test_fixture_decodes_to_its_digest(name):
    """Each fixture through `read_image`, the C++ planes and the plain version
    gives its recorded digests, or raises "cut short" where PIL raised."""
    want = json.load(open(os.path.join(FIXTURES, "digests.json")))[name]
    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    if want["rgb"] == "raises":
        for fn in (webp.decode_webp, webp.decode_webp_plain):
            with pytest.raises(ValueError, match="cut short"):
                fn(data)
        return
    assert fx.sha(png.read_image(path)) == want["rgb"]
    assert fx.sha(*webp.decode_vp8(webp.frame_of(data))[:3]) == want["yuv"]
    assert fx.sha(*webp.vp8_decode_plain(webp.frame_of(data))[:3]) == want["yuv"]
    assert fx.sha(webp.decode_webp_plain(data)) == want["rgb"]


def test_a_broken_vp8_source_raises(tmp_path, monkeypatch):
    """A broken `vp8.cpp` raises with the compiler's output: nothing falls
    back to the plain version."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    (tmp_path / "vp8.cpp").write_text("int gm_vp8_decode( {")
    _cuda.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for vp8"):
            webp.decode_webp(open(os.path.join(FIXTURES, "pil_q90_exif_1x1.webp"), "rb").read())
    finally:
        _cuda.host_library.cache_clear()


# ------------------------------------------------------ a scene
def test_webp_colmap_scene_matches_jax_and_trains(tmp_path):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its views
    rewritten as lossy WebPs (PIL at qualities 50-95 and methods 0-6, two by
    `write_webp`): `read_scene` equals the JAX reader's at -r 1 and 2 (images,
    no masks, cameras), and `cli.train_mesh --device cpu` trains 2 iterations
    on it."""
    from tests.test_torch_cli_eval import _make_scene

    root = str(tmp_path / "s")
    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        if i < 2:
            webp.write_webp(path, img, quality_index=10 + 20 * i, segments=4,
                            filter=("simple", "normal")[i], level=20, partitions=2)
        else:
            Image.fromarray(img).save(path, "WEBP", quality=50 + 5 * i, method=i % 7)
        assert open(path, "rb").read(4) == b"RIFF"
    for resolution in (1, 2):
        kw = dict(resolution=resolution, eval_split=True)
        got = readers.read_scene(root, **kw)
        _assert_scene_equal(got, jreaders.read_scene(root, **kw))
        assert all(c.mask is None for c in got.train_cameras + got.test_cameras)
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
