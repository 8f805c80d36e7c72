"""Lossless JPEGs (SOF3) in the port's reader (`io/jpeg.py`: `_lossless_plain`
and C++ `gm_jpeg_lossless`) against PIL 12 (libjpeg-turbo 3).

Every fixture of `tests/data/jpeg_lossless/` reads through `read_image` and
`read_jpeg_plain` to its digest, PIL's array under the port's rule
(recomputed here), or raises through both where PIL cannot load it. The
C++ walk equals the plain one on random images at every predictor, point
transform, restart interval and scan layout, and on damaged streams (the
same bytes or the same error). The frame and scan rules PIL's
libjpeg-turbo applies are held one by one, and a COLMAP scene of lossless
views loads through the port's `read_scene` as through the JAX reader."""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import jpeg, png
from tests.test_torch_readers import _assert_scene_equal
from tools.make_jpeg_lossless_fixtures_torch import frame, per_scan
from tools.make_raw_sample_fixtures_torch import natural, port_array, sha

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data", "jpeg_lossless")
DIGESTS = json.load(open(os.path.join(DATA, "digests.json")))
CAUSES = {"jfif": "JFIF.*libjpeg-turbo converts no colour", "adobe1": "Adobe transform 1",
          "adobe2": "Adobe transform 2.*YCCK", "cut": "truncated",
          "restart5": "restart interval of 5 MCUs"}


def _pil(data):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert("RGB") if im.mode == "CMYK" else im)


def _both(data, path="<bytes>"):
    """decode_jpeg through the C++ and the plain route: the same array, or
    the same error."""
    out = []
    for native in (True, False):
        try:
            out.append(jpeg.decode_jpeg(data, path, native=native))
        except ValueError as err:
            out.append(str(err))
    if isinstance(out[0], str):
        assert out[0] == out[1]
    else:
        assert np.array_equal(out[0], out[1])
    return out[0]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_lossless_fixture_equals_pil(name):
    """Each fixture: PIL's format and mode as recorded; `read_image` and
    `read_jpeg_plain` give the recorded digest, PIL's array under the port's
    rule (computed again here), or both raise naming the cause where PIL
    fails to load the file."""
    path = os.path.join(DATA, name)
    data = open(path, "rb").read()
    want = DIGESTS[name]
    im = Image.open(path)
    assert (im.format, im.mode) == (want["pil_format"], want["pil_mode"])
    if want["array"] is None:
        with pytest.raises(OSError):
            im.load()
        cause = CAUSES[name.split("_")[2] if name.split("_")[2] in CAUSES else
                       name.split("_")[1]]
        for run in (lambda: png.read_image(path), lambda: jpeg.read_jpeg_plain(path)):
            with pytest.raises(ValueError, match=cause):
                run()
        return
    assert sha(port_array(data)[0]) == want["array"]
    for got in (png.read_image(path), jpeg.read_jpeg_plain(path)):
        assert sha(got) == want["array"] and list(got.shape) == want["shape"], name


def test_lossless_fixtures_cover_the_forms():
    """Predictors 1-7, point transforms 0 and 2, restart intervals, gray,
    RGB, CMYK, one scan a component, subsampled components, the refusals."""
    names = " ".join(DIGESTS)
    for part in [f"_p{p}_" for p in range(1, 8)] + ["pt2", "restart", "gray", "rgb", "cmyk",
                                                    "noninterleaved", "h2v2", "category16",
                                                    "jfif", "adobe1", "adobe2", "cut"]:
        assert part in names, part


@pytest.mark.parametrize("predictor", range(1, 8))
def test_native_walk_equals_plain_and_pil(predictor):
    """`gm_jpeg_lossless` = `_lossless_plain` = PIL on random images (the
    widest differences) at the predictor, point transforms 0 and 3, with and
    without a restart interval of two MCU rows, in one scan and one scan a
    component, gray, RGB and CMYK, at 1x1 to 37x11."""
    rng = np.random.default_rng(predictor)
    for shape in ((1, 1), (11, 37, 3), (5, 3, 4), (9, 6)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        w = shape[1]
        for pt in (0, 3):
            for restart in (0, 2 * w):
                for interleave in (True, False):
                    data = jpeg.encode_jpeg_lossless(img, predictor, pt, restart, interleave)
                    got = _both(data)
                    assert np.array_equal(got, _pil(data)), (shape, pt, restart, interleave)
                    if img.ndim == 2 or img.shape[2] == 3:
                        assert np.array_equal(got, (img >> pt) << pt)


@pytest.mark.parametrize("sampling", [[(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                      [(1, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 2)]],
                         ids=lambda s: "".join(f"{h}{v}" for h, v in s))
def test_subsampled_components_replicated_as_pil(sampling):
    """Components sampled at half the largest, in one scan and one scan a
    component: libjpeg-turbo replicates their samples (no fancy upsampling
    in lossless mode), and so do both routes, at odd sizes."""
    img = np.random.default_rng(7).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    for interleave in (True, False):
        data = jpeg.encode_jpeg_lossless(img, 4, 1, 0, interleave, sampling=sampling)
        assert np.array_equal(_both(data), _pil(data))


def test_scans_of_their_own_predictor_and_point_transform():
    """Three scans, each with its predictor and point transform, in any
    order and two components interleaved beside one alone: each component
    comes out shifted up by its own scan's transform."""
    img = natural(17, 23, 3, 5)
    for preds, pts in (((1, 4, 7), (0, 1, 2)), ((2, 5, 6), (3, 3, 3))):
        data = per_scan(img, preds, pts)
        want = np.stack([(img[..., c] >> pts[c]) << pts[c] for c in range(3)], -1)
        assert np.array_equal(_both(data), want)
        assert np.array_equal(_pil(data), want)
    planes = [img[..., k] for k in range(3)]
    out = frame(17, 23, [(1, 1)] * 3)
    out += jpeg._lossless_scan(planes, [(1, 1)] * 3, [2], 3, 0, 0, [0, 1, 2])
    out += jpeg._lossless_scan(planes, [(1, 1)] * 3, [0, 1], 6, 0, 0, [0, 1, 2])
    data = b"".join(out + [b"\xff\xd9"])
    assert np.array_equal(_both(data), img) and np.array_equal(_pil(data), img)


@pytest.mark.parametrize("pt", [0, 5])
def test_differences_wrap_mod_2_16(pt):
    """Differences of every category, 16 (32768, no bits) among them, and
    samples far past 8 bits: mod 2^16, then the low 8 bits of the sample
    shifted up, as PIL's 8-bit libjpeg-turbo keeps them; predictor 7 on the
    rows after the first."""
    rng = np.random.default_rng(pt)
    diffs = rng.integers(-32768, 32769, (9 * 11, 1))
    diffs[::5] = 32768
    out = frame(9, 11, [(1, 1)]) + jpeg.lossless_entropy(diffs, [0], [0], 7, pt)
    data = b"".join(out + [b"\xff\xd9"])
    got = _both(data)
    assert np.array_equal(got, _pil(data)) and len(np.unique(got)) > min(30, (256 >> pt) - 1)


@pytest.mark.parametrize("case", ["jfif", "adobe1", "adobe2", "cut", "restart5"])
def test_refused_through_both_routes_as_pil_fails(tmp_path, case):
    """Three components under JFIF or Adobe transform 1 and four under
    Adobe transform 2 (libjpeg-turbo converts no colour in lossless mode),
    a stream cut short and a restart interval that is not whole MCU rows:
    PIL opens the file and fails to load it; `read_image` and the plain
    route raise naming the cause."""
    rgb, cmyk = natural(9, 10, 3, 1), natural(9, 10, 4, 2)
    if case == "restart5":
        diffs = np.zeros((90, 3), np.int64)
        data = b"".join(frame(9, 10, [(1, 1)] * 3, restart=5) + jpeg.lossless_entropy(
            diffs, [0, 1, 2], [0, 1, 2], 1, 0, restart=5) + [b"\xff\xd9"])
    elif case == "cut":
        data = jpeg.encode_jpeg_lossless(rgb, 2)[:-60]
    else:
        data = jpeg.encode_jpeg_lossless(cmyk if case == "adobe2" else rgb, 1, marker=case)
    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG"
    with pytest.raises(OSError):
        im.load()
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as fh:
        fh.write(data)
    for run in (lambda: png.read_image(path), lambda: jpeg.read_jpeg_plain(path)):
        with pytest.raises(ValueError, match=CAUSES[case]):
            run()


@pytest.mark.parametrize("params", [(0, 0, 0, 0), (8, 0, 0, 0), (1, 1, 0, 0), (1, 0, 1, 0),
                                    (1, 0, 0, 8)], ids=lambda p: "ss{}_se{}_ah{}_al{}".format(*p))
def test_scan_parameters_checked(params):
    """A scan under SOF3 with Ss outside 1-7, Se or Ah not 0, or Al of 8 or
    more raises through both routes naming lossless and the parameters;
    PIL fails to load it."""
    ss, se, ah, al = params
    data = bytearray(jpeg.encode_jpeg_lossless(natural(5, 6, 3, 3), 1))
    sos = data.index(b"\xff\xda")
    ns = data[sos + 4]
    data[sos + 5 + 2 * ns:sos + 8 + 2 * ns] = bytes([ss, se, ah << 4 | al])
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(data))).load()
    for native in (True, False):
        with pytest.raises(ValueError, match=f"lossless JPEG scan of Ss {ss}, Se {se}, "
                                             f"Ah {ah}, Al {al}"):
            jpeg.decode_jpeg(bytes(data), native=native)


@pytest.mark.parametrize("marker", [0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF],
                         ids=lambda m: f"sof{m - 0xC0}")
def test_arithmetic_and_hierarchical_still_refused(marker):
    """SOF5-SOF7, SOF11 and SOF13-SOF15 (hierarchical and lossless
    arithmetic-coded) are still refused, naming their kind, on a lossless
    file's frame patched to them. SOF9 and SOF10 (sequential and progressive
    arithmetic-coded) are read, and this file, whose frame names
    quantisation table 0 and defines none, is refused as PIL fails to load
    it."""
    data = jpeg.encode_jpeg_lossless(natural(5, 6, 3, 4), 1).replace(
        b"\xff\xc3", bytes([0xFF, marker]), 1)
    if marker in (0xC9, 0xCA):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        match = "quantisation table 0 not defined"
    else:
        match = "SOF11.*libjpeg-turbo cannot decode" if marker == 0xCB else jpeg._SOF_KINDS[
            marker]
    for native in (True, False):
        with pytest.raises(ValueError, match=match):
            jpeg.decode_jpeg(data, native=native)


def test_damaged_streams_native_equals_plain():
    """64 damaged streams (bytes of the entropy-coded data changed, cut, or a
    table's counts changed): the C++ and plain walks give the same array or
    the same error."""
    rng = np.random.default_rng(64)
    img = natural(11, 13, 3, 6)
    base = jpeg.encode_jpeg_lossless(img, 6, 1, 26)
    start = base.rindex(b"\xff\xda") + 14
    kinds = set()
    for k in range(64):
        data = bytearray(base)
        if k % 3 == 0:
            for _ in range(3):
                data[int(rng.integers(start, len(data) - 2))] = int(rng.integers(0, 256))
        elif k % 3 == 1:
            data = data[:int(rng.integers(start, len(data)))]
        else:
            dht = data.index(b"\xff\xc4")
            data[dht + 5 + int(rng.integers(0, 16))] = int(rng.integers(0, 4))
        got = _both(bytes(data))
        kinds.add("error" if isinstance(got, str) else "image")
    assert kinds == {"error", "image"}


def _lossless_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    views rewritten as lossless JPEGs of every predictor, gray and RGB, one
    scan and one a component, with restarts and point transforms."""
    from tests.test_torch_cli_eval import _make_scene

    _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        img = img[..., 1] if i % 4 == 3 else img
        with open(path, "wb") as fh:
            fh.write(jpeg.encode_jpeg_lossless(img, 1 + i % 7, i % 3, 64 * (i % 2),
                                               interleave=i % 5 != 2))


def test_lossless_colmap_scene_matches_jax(tmp_path, monkeypatch):
    """`read_scene` of a COLMAP set of lossless JPEG views at -r 1 and 2
    equals the JAX reader's on the same files, exactly; read again with the
    plain pieces made to raise, the same scene."""
    root = str(tmp_path / "s")
    _lossless_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for name in ("_lossless_plain", "_undifference", "_scan_plain", "_planes_plain",
                 "_decode_tables", "_peek_table"):
        monkeypatch.setattr(jpeg, name, plain)
    for g, k in zip(got, kw):
        _assert_scene_equal(readers.read_scene(root, **k), g)


def test_sof3_frame_header_in_struct():
    """The writer's frame: SOF3 of 8-bit samples, the components' ids 1..n
    and their sampling factors, table 0."""
    data = jpeg.encode_jpeg_lossless(natural(4, 5, 3, 1), 2, sampling=[(2, 1), (1, 1),
                                                                      (1, 1)])
    at = data.index(b"\xff\xc3") + 4
    assert struct.unpack(">BHHB", data[at:at + 6]) == (8, 4, 5, 3)
    assert data[at + 6:at + 15] == bytes([1, 0x21, 0, 2, 0x11, 0, 3, 0x11, 0])
