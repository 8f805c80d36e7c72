"""Arithmetic-coded JPEGs (SOF9 sequential, SOF10 progressive) in the port's
reader (`io/jpeg.py`: `_arith_plain` and C++ `gm_jpeg_arith_scan`) against
PIL 12 (libjpeg-turbo 3), and the port's QM encoder (`gm_jpeg_arith_encode`).

Every fixture of `tests/data/jpeg_arith/` reads through `read_image` and
`read_jpeg_plain` to its digest, PIL's array under the port's rule
(recomputed here), or raises through both where PIL cannot load it, or
where libjpeg only warns of a bad arithmetic code. Files the writer codes
from the same coefficients as a Huffman baseline or progressive file
decode to that file's bytes, and to PIL's; the coefficients themselves
come back exactly, at every magnitude. Damaged streams give the same bytes
or the same error through both routes. A COLMAP scene of arithmetic views
loads through the port's `read_scene` as through the JAX reader and
trains."""

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
from gaussianmesh_tpu_torch.io import jpeg, png
from tests.test_torch_readers import _assert_scene_equal
from tools.make_jpeg_arith_fixtures_torch import (DAC_ALL, bad_code, deep_refinement,
                                                  one_a_component, sof11_flat)
from tools.make_raw_sample_fixtures_torch import natural, port_array, sha

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data", "jpeg_arith")
DIGESTS = json.load(open(os.path.join(DATA, "digests.json")))
CAUSES = {"cut": "truncated", "sof11": "SOF11.*libjpeg-turbo cannot decode it either",
          "badcode": "bad arithmetic code \\(a magnitude past 2\\^15"}


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


def _cause(name):
    return next(CAUSES[k] for k in CAUSES if f"_{k}_" in name)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_arith_fixture_equals_pil(name):
    """Each fixture: PIL's format and mode as recorded; `read_image` and
    `read_jpeg_plain` give the recorded digest, PIL's array under the port's
    rule (computed again here), or both raise naming the cause: where PIL
    fails to load the file, or where it gives the recorded picture after
    libjpeg's warning of a bad arithmetic code."""
    path = os.path.join(DATA, name)
    data = open(path, "rb").read()
    want = DIGESTS[name]
    im = Image.open(path)
    assert (im.format, im.mode) == (want["pil_format"], want["pil_mode"])
    if want["array"] is None:
        if want["rule"] == "refused":
            with pytest.raises(OSError):
                im.load()
        else:
            got = np.asarray(im)
            assert sha(got) == want["pil_array"] and list(got.shape) == want["pil_shape"]
        for run in (lambda: png.read_image(path), lambda: jpeg.read_jpeg_plain(path)):
            with pytest.raises(ValueError, match=_cause(name)):
                run()
        return
    assert sha(port_array(data)[0]) == want["array"]
    for got in (png.read_image(path), jpeg.read_jpeg_plain(path)):
        assert sha(got) == want["array"] and list(got.shape) == want["shape"], name


def test_arith_fixtures_cover_the_forms():
    """Gray, the four samplings, Adobe-0 RGB, CMYK and YCCK, quality 100,
    1x1 and odd sizes, restarts, DAC tables 0-3, one scan a component, both
    progressions, and the refusals."""
    names = " ".join(DIGESTS)
    for part in ("gray", "ycc444", "ycc422", "ycc420", "ycc440", "rgb_adobe0", "cmyk", "ycck",
                 "q100", "1x1", "3x5", "restart5", "dac", "tables0123", "noninterleaved",
                 "_seq_", "_prog_", "prog_deep", "badcode", "cut", "sof11"):
        assert part in names, part
    assert all(os.path.getsize(os.path.join(DATA, n)) < 65536 for n in DIGESTS)


SAMPLINGS = [("4:4:4", 3), ("4:2:2", 3), ("4:2:0", 3), ("4:4:0", 3), ("4:2:0", 1),
             ("4:4:4", 4), ("4:2:0", "ycck")]


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("sampling", SAMPLINGS, ids=lambda s: f"{s[0]}_{s[1]}".replace(":", ""))
def test_same_coefficients_as_huffman_file(sampling, progressive):
    """Random images at 1x1 to 45x29, with and without a restart interval
    (not whole MCU rows) and a DAC of every table: the SOF9 or SOF10 file
    decodes through both routes to exactly the bytes of the Huffman
    baseline or progressive file of the same coefficients, and PIL reads
    it to the same bytes."""
    sub, kind = sampling
    rng = np.random.default_rng(2 * SAMPLINGS.index(sampling) + progressive)
    for shape in ((1, 1), (29, 45), (8, 16), (13, 7)):
        channels = 4 if kind == "ycck" else kind
        img = rng.integers(0, 256, shape + ((channels,) if channels > 1 else ()),
                           dtype=np.uint8)
        img = (img // 32 * 32 + natural(*shape, max(1, channels), 3)
               .reshape(img.shape) // 8).astype(np.uint8)
        color = "ycck" if kind == "ycck" else "auto"
        huff = jpeg.encode_jpeg(img, 85, sub, progressive, color=color)
        want = _pil(huff)
        assert np.array_equal(jpeg.decode_jpeg(huff), want)
        for restart, dac in ((0, None), (3, DAC_ALL)):
            data = jpeg.encode_jpeg(img, 85, sub, progressive, color=color, arithmetic=True,
                                    restart=restart, dac=dac)
            assert bytes([0xFF, 0xCA if progressive else 0xC9]) in data
            assert np.array_equal(_both(data), want), (shape, restart, dac)
            assert np.array_equal(_pil(data), want), (shape, restart, dac)


def _frame_of(data, native):
    """The frame decode_jpeg builds for `data` (its coefficients)."""
    frames = []
    jpeg.decode_jpeg(data, native=native, on_frame=frames.append)
    return frames[0]


@pytest.mark.parametrize("kind", ["sof9", "sof9_noninterleaved", "sof10", "sof10_deep"])
def test_coefficients_come_back_exactly(kind):
    """Random coefficients of every magnitude up to 2^15 - 1 (the DC
    differences and AC values whose magnitude chains run longest), sparse
    and dense blocks, restart intervals, DAC conditioning: decoded through
    both routes they are the ones coded, and PIL reads the file to the
    port's bytes."""
    rng = np.random.default_rng(len(kind))
    samp, h, w = [(2, 2), (1, 1), (1, 1)], 32, 48
    grids = []
    for sh, sv in samp:
        g = np.zeros((2 * sv, 3 * sh, 64), np.int64)
        mag = rng.integers(0, 16, g.shape)
        g[...] = np.where(rng.random(g.shape) < 0.3, rng.integers(-1, 2, g.shape)
                          << mag, 0).clip(-32767, 32767)
        g[..., 0] = rng.integers(-16000, 16000, g.shape[:2])
        g[0, 0, 1:] = 0                                  # an empty block
        g[-1, -1, 1:] = rng.integers(-3, 4, 63)          # a full one
        g[-1, 0, 63] = 32767
        grids.append(g)
    qs = [np.ones(64, np.int64)] * 2
    nc = len(samp)
    every = tuple(range(nc))
    script = {"sof9": [(every, 0, 63, 0, 0)],
              "sof9_noninterleaved": one_a_component(nc),
              "sof10": jpeg.simple_progression(nc), "sof10_deep": deep_refinement(nc)}[kind]
    sof = 0xC9 if kind.startswith("sof9") else 0xCA

    def coded(gs):
        out = jpeg._headers(h, w, qs, samp, [0, 1, 1], sof)
        out.append(jpeg._segment(0xDD, struct.pack(">H", 4)))
        out += jpeg.arith_scans(h, w, samp, gs, script, [0, 1, 2], 4, DAC_ALL)
        return b"".join(out + [b"\xff\xd9"])
    data = coded(grids)
    for native in (True, False):
        frame = _frame_of(data, native)
        for c, g in enumerate(grids):
            assert np.array_equal(frame.coef[c], g), (kind, native, c)
    # PIL's IDCT, past the coefficients an 8-bit encoder writes, is not the
    # port's: the pixels are compared at magnitudes up to 2^10
    data = coded([g.clip(-1023, 1023) for g in grids])
    assert np.array_equal(_pil(data), _both(data))


def test_damaged_streams_native_equals_plain():
    """64 damaged streams (bytes of the entropy-coded data changed, cut, a
    marker in the data, a DAC changed): the C++ and plain walks give the same
    array or the same error, on sequential and progressive files."""
    rng = np.random.default_rng(64)
    img = natural(19, 27, 3, 6)
    bases = [jpeg.encode_jpeg(img, 90, "4:2:0", p, arithmetic=True, restart=r, dac=DAC_ALL)
             for p, r in ((False, 4), (True, 0))]
    kinds = set()
    for k in range(64):
        data = bytearray(bases[k % 2])
        start = data.index(b"\xff\xda") + 12
        if k % 4 < 2:
            for _ in range(1 + k % 3):
                data[int(rng.integers(start, len(data) - 2))] = int(rng.integers(0, 256))
        elif k % 4 == 2:
            data = data[:int(rng.integers(start, len(data)))]
        else:
            at = int(rng.integers(start, len(data) - 2))
            data[at:at + 2] = bytes([0xFF, int(rng.integers(0xD0, 0xD8))])
        got = _both(bytes(data))
        kinds.add("image" if not isinstance(got, str) else "bad code" if "arithmetic" in got
                  else "error")
    assert kinds == {"image", "bad code", "error"}, kinds


@pytest.mark.parametrize("shape", [(8, 8, 1), (3, 5, 3), (16, 2, 4)], ids=lambda s: "x".join(
    map(str, s)))
def test_sof11_refused_as_pil_fails(tmp_path, shape):
    """A lossless arithmetic-coded file (SOF11) written by the port's QM
    encoder: PIL opens it and fails to load it (libjpeg-turbo does not
    decode lossless arithmetic files), and the port raises through both
    routes naming that cause."""
    h, w, nc = shape
    data = sof11_flat(h, w, nc)
    assert data[2:4] == b"\xff\xcb"
    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG" and im.size == (w, h)
    with pytest.raises(OSError):
        im.load()
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as fh:
        fh.write(data)
    for run in (lambda: png.read_image(path), lambda: jpeg.read_jpeg_plain(path)):
        with pytest.raises(ValueError, match=CAUSES["sof11"]):
            run()


def test_bad_arithmetic_code_raises_where_pil_warns():
    """A DC difference past 2^15 and a run of zeros past the band's end:
    libjpeg warns and PIL gives a picture; both routes raise naming the bad
    arithmetic code."""
    data = bad_code()
    assert _pil(data).shape == (8, 24)
    for native in (True, False):
        with pytest.raises(ValueError, match="bad arithmetic code \\(a magnitude past 2\\^15"):
            jpeg.decode_jpeg(data, native=native)
    # a run past Se: an AC first scan of band 1-1 whose coefficient is at 2,
    # coded as band 1-2 and relabelled
    g = np.zeros((1, 1, 64), np.int64)
    g[0, 0, 2] = 5
    qs, h, w = [np.ones(64, np.int64)], 8, 8
    scans = jpeg.arith_scans(h, w, [(1, 1)], [g], [((0,), 0, 0, 0, 0), ((0,), 1, 2, 0, 0)], [0])
    scans[2] = scans[2][:-3] + bytes([1, 1, 0])
    data = b"".join(jpeg._headers(h, w, qs, [(1, 1)], [0], 0xCA) + scans
                    + jpeg.arith_scans(h, w, [(1, 1)], [g], [((0,), 2, 63, 0, 0)], [0])
                    + [b"\xff\xd9"])
    assert _pil(data).shape == (8, 8)
    for native in (True, False):
        with pytest.raises(ValueError, match="bad arithmetic code \\(a run of zeros past"):
            jpeg.decode_jpeg(data, native=native)


def test_dac_values_checked():
    """A DAC segment of L over U, Kx 0 or 64, Tc 2, Tb 4 or an odd length
    raises naming the bad index or value (libjpeg's "Bogus DAC ..."); L
    equal to U and Kx 1 and 63 are read, to PIL's bytes."""
    img = natural(9, 12, 1, 2)[..., 0]
    base = jpeg.encode_jpeg(img, 90, "4:4:4", arithmetic=True, dac=((3,) * 4, (3,) * 4,
                                                                    (1,) * 4))
    assert np.array_equal(_both(base), _pil(base))
    dac = base.index(b"\xff\xcc")
    for body, match in ((b"\x00\x34", "bogus DAC value 0x34 for DC table 0: L 4 over U 3"),
                        (b"\x10\x00", "bogus DAC value 0 for AC table 0"),
                        (b"\x10\x40", "bogus DAC value 64 for AC table 0"),
                        (b"\x20\x05", "bogus DAC index 0x20"),
                        (b"\x04\x11", "bogus DAC index 0x04"),
                        (b"\x00\x11\x10", "not pairs")):
        data = base[:dac] + jpeg._segment(0xCC, body) + base[dac + 6:]
        for native in (True, False):
            with pytest.raises(ValueError, match=match):
                jpeg.decode_jpeg(data, native=native)
    high = jpeg.encode_jpeg(img, 90, "4:4:4", arithmetic=True, dac=((0,) * 4, (15,) * 4,
                                                                    (63,) * 4))
    assert np.array_equal(_both(high), _pil(high))


def test_dac_between_scans_conditions_the_later_ones():
    """One scan a component, each after a DAC of its own values for the same
    table: each scan is decoded under the DAC before it (libjpeg reads the
    conditioning at each scan); and the defaults come back at the next
    file's SOI."""
    img = natural(17, 23, 3, 5)
    h, w = img.shape[:2]
    qs, samp, qsel, grids = jpeg._coefficients(img, 100, "4:4:4")
    out = jpeg._headers(h, w, qs, samp, qsel, 0xC9)
    for c, dac in enumerate((((2,) * 4, (6,) * 4, (2,) * 4), DAC_ALL,
                             ((0,) * 4, (0,) * 4, (40,) * 4))):
        out += jpeg.arith_scans(h, w, samp, grids, [((c,), 0, 63, 0, 0)], [0, 0, 0], 0, dac)
    data = b"".join(out + [b"\xff\xd9"])
    want = jpeg.decode_jpeg(jpeg.encode_jpeg(img, 100, "4:4:4"))
    assert np.array_equal(_both(data), want) and np.array_equal(_pil(data), want)
    plain = jpeg.encode_jpeg(img, 100, "4:4:4", arithmetic=True)
    assert np.array_equal(_both(plain), want)


def test_past_pil_read_block_b39(tmp_path):
    """B39: past PIL's 65,536-byte read block an arithmetic-coded file no
    longer loads in PIL ("broken data stream": libjpeg-turbo's arithmetic
    decoder cannot suspend for PIL's next block). The port reads it by the
    definition: to the bytes PIL gives for the Huffman file of the same
    coefficients, through both routes."""
    img = natural(220, 330, 3, 7)
    data = jpeg.encode_jpeg(img, 100, "4:4:4", arithmetic=True)
    assert len(data) > 65536
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(data)).load()
    want = _pil(jpeg.encode_jpeg(img, 100, "4:4:4"))
    assert np.array_equal(_both(data), want)
    small = jpeg.encode_jpeg(img[:60, :80], 100, "4:4:4", arithmetic=True)
    assert np.array_equal(_pil(small), _both(small))


def test_scan_rules():
    """Conditioning tables past 3, an SOF9 scan of Ss / Se / Ah / Al other
    than 0 / 63 / 0 / 0 (libjpeg warns), and an SOF10 scan out of
    `start_pass`'s rules raise through both routes."""
    img = natural(9, 12, 3, 4)
    seq = bytearray(jpeg.encode_jpeg(img, 90, "4:4:4", arithmetic=True))
    sos = seq.index(b"\xff\xda")
    bad = bytearray(seq)
    bad[sos + 6] = 0x44
    for native in (True, False):
        with pytest.raises(ValueError, match="conditioning tables 4 / 4; T.81 has 0-3"):
            jpeg.decode_jpeg(bytes(bad), native=native)
    bad = bytearray(seq)
    bad[sos + 11:sos + 13] = b"\x3f\x10"
    for native in (True, False):
        with pytest.raises(ValueError, match="a progressive scan"):
            jpeg.decode_jpeg(bytes(bad), native=native)
    prog = bytearray(jpeg.encode_jpeg(img, 90, "4:4:4", True, arithmetic=True))
    sos = prog.index(b"\xff\xda")
    prog[sos + 10:sos + 13] = b"\x00\x05\x01"
    for native in (True, False):
        with pytest.raises(ValueError, match="invalid progressive scan"):
            jpeg.decode_jpeg(bytes(prog), native=native)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(prog))).load()


def test_writer_headers_and_refusals():
    """The writer's SOF9 / SOF10 frame, its DRI, its DAC of the tables each
    scan uses (DC and AC of a sequential scan, one kind a progressive one),
    no DHT; a coefficient past 16 bits and the Huffman writer's options it
    lacks raise."""
    img = natural(16, 16, 3, 1)
    data = jpeg.encode_jpeg(img, 90, "4:2:0", arithmetic=True, restart=2, dac=DAC_ALL)
    assert b"\xff\xc9" in data and b"\xff\xc4" not in data
    at = data.index(b"\xff\xdd")
    assert data[at:at + 6] == b"\xff\xdd\x00\x04\x00\x02"
    at = data.index(b"\xff\xcc")
    assert data[at:at + 12] == b"\xff\xcc\x00\x0a" + bytes([0, 0x10, 0x10, 1, 1, 0x52, 0x11,
                                                           20])
    prog = jpeg.encode_jpeg(img, 90, "4:2:0", True, arithmetic=True, dac=DAC_ALL)
    assert b"\xff\xca" in prog and prog.count(b"\xff\xcc") == 9   # none for DC refinement
    at = prog.index(b"\xff\xcc")
    assert prog[at:at + 8] == b"\xff\xcc\x00\x06" + bytes([0, 0x10, 1, 0x52])
    g = np.zeros((1, 1, 64), np.int64)
    g[0, 0, 5] = 40000
    with pytest.raises(ValueError, match="outside \\+-32767"):
        jpeg.arith_scans(8, 8, [(1, 1)], [g], [((0,), 0, 63, 0, 0)], [0])
    for kw in (dict(restart=4), dict(dac=DAC_ALL)):
        with pytest.raises(ValueError, match="arithmetic-coded files only"):
            jpeg.encode_jpeg(img, **kw)
    with pytest.raises(ValueError, match="abbreviated"):
        jpeg.encode_jpeg(img, arithmetic=True, tables=False)


def _arith_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    views rewritten as arithmetic-coded JPEGs: SOF9 and SOF10, 4:2:0, 4:4:4
    and gray, restarts and DAC tables."""
    from tests.test_torch_cli_eval import _make_scene

    mesh = _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        img = img[..., 1] if i % 4 == 3 else img
        with open(path, "wb") as fh:
            fh.write(jpeg.encode_jpeg(img, 90, ("4:2:0", "4:4:4")[i % 2], i % 3 == 1,
                                      arithmetic=True, restart=5 * (i % 2),
                                      dac=DAC_ALL if i % 5 == 2 else None))
    return mesh


def test_arith_colmap_scene_matches_jax_and_trains(tmp_path, monkeypatch):
    """`read_scene` of a COLMAP set of arithmetic-coded views at -r 1 and 2
    equals the JAX reader's on the same files, exactly; read again with the
    plain pieces made to raise, the same scene; `cli.train_mesh --device
    cpu` trains 2 iterations on it."""
    root = str(tmp_path / "s")
    mesh = _arith_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for name in ("_arith_plain", "_qm_decoder", "_arith_dc", "_arith_ac_band",
                 "_arith_ac_refine", "_scan_plain", "_planes_plain", "_decode_tables",
                 "_peek_table"):
        monkeypatch.setattr(jpeg, name, plain)
    for g, k in zip(got, kw):
        _assert_scene_equal(readers.read_scene(root, **k), g)
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name
