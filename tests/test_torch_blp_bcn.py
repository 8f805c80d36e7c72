"""The port's BLP reader (`io/blp.py`) and BLP's own DXT rules in its BCn
decoder (`io/bcn.py` with `shift565`, C++ `gm_bcn_decode`) against PIL 12,
faults B35-B37, and a COLMAP scene of DDS and BLP views against the JAX
reader.

BLP2's DXT1, DXT3 and DXT5 blocks decode through `gm_bcn_decode` and
`decode_plain` to BLP's own Python decoders (`BlpImagePlugin.decode_dxt1`
/ `3` / `5`: 565 shifted, not replicated) on random blocks at sizes with
partial edge tiles. Every BLP fixture of `tests/data/textures/` equals PIL
through `read_image` and the plain route, or its B rule's oracle, or is
refused through both (raw BGRA, which PIL cannot load). BLP headers give
way where PIL's `_open` gives way, and what PIL's decoders fail on fails.
B35: a four-component BLP1 JPEG reads as the components B, G, R, A (PIL
converts them as CMYK); B36: a DXT3 / DXT5 texture of alpha depth 0 reads
its RGB (PIL shifts every pixel); B37: a DXT texture of a width that is not
a multiple of 4 reads each pixel's own block (PIL fills the rows in
turn)."""

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
from gaussianmesh_tpu_torch.io import bcn, blp, dds, jpeg, png
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from tests.test_torch_readers import _assert_scene_equal
from tools.make_raw_sample_fixtures_torch import natural, port_array, sha
from tools.make_texture_fixtures_torch import blp1_jpeg, blp2_head

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data", "textures")
DIGESTS = json.load(open(os.path.join(DATA, "digests.json")))
BLP_FIXTURES = sorted(n for n in DIGESTS if n.endswith(".blp"))
SIZES = [(1, 1), (2, 3), (7, 6), (13, 9), (75, 66)]     # (width, height); 75x66: 323 blocks


def _blp_plugin():
    """PIL's BLP plugin module, imported once every plugin is registered in
    `Image.open`'s own order (importing it first would put BLP first)."""
    Image.init()
    from PIL import BlpImagePlugin
    return BlpImagePlugin


def _blp_python(kind, data, w, h):
    """BLP's own Python decoders on the blocks, row of blocks by row, the
    4 ceil(w / 4)-wide rows cropped to w x h -> RGBA."""
    plugin = _blp_plugin()
    decode = {1: lambda d: plugin.decode_dxt1(d, True), 2: plugin.decode_dxt3,
              3: plugin.decode_dxt5}[kind]
    bw, size = (w + 3) // 4, bcn.BLOCK_BYTES[kind]
    rows = []
    for yb in range((h + 3) // 4):
        rows += [np.frombuffer(bytes(r), np.uint8).reshape(4 * bw, 4)
                 for r in decode(data[yb * bw * size:(yb + 1) * bw * size])]
    return np.stack(rows)[:h, :w]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", [1, 2, 3], ids=["dxt1", "dxt3", "dxt5"])
def test_blp_dxt_blocks_equal_blps_decoders(size, kind):
    """Random blocks (every third with equal colour words, the DXT1 three-
    colour mode, and DXT5's six-level alpha mode) decode with `shift565`
    through `gm_bcn_decode` and `decode_plain` to BLP's own Python
    decoders, byte for byte; they differ from the `bcn` rule (DDS's)."""
    w, h = size
    n = bcn.bc1_blocks(w, h)
    blocks = np.random.default_rng(7 * w + h + kind).integers(
        0, 256, (n, bcn.BLOCK_BYTES[kind]), dtype=np.uint8)
    c = 0 if kind == 1 else 8
    blocks[::3, c + 2:c + 4] = blocks[::3, c:c + 2]
    blocks[1::3, 1] = 255
    data = blocks.tobytes()
    want = _blp_python(kind, data, w, h)
    got = bcn.decode(kind, data, w, h, shift565=True)
    assert np.array_equal(got, want)
    assert np.array_equal(bcn.decode_plain(kind, data, w, h, shift565=True), want)
    if n >= 100:
        assert not np.array_equal(bcn.decode(kind, data, w, h), want)


@pytest.mark.parametrize("name", BLP_FIXTURES)
def test_blp_fixture_equals_pil(name):
    """Each BLP fixture: PIL's format and mode as recorded; `read_image` and
    `decode_blp_plain` give the recorded digest (PIL's array, computed again
    here where no B rule applies, or the rule's oracle), or both refuse it
    naming its cause."""
    path = os.path.join(DATA, name)
    data = open(path, "rb").read()
    want = DIGESTS[name]
    im = Image.open(path)
    assert (im.format, im.mode) == (want["pil_format"], want["pil_mode"])
    if want["array"] is None:
        for run in (lambda: png.read_image(path), lambda: blp.decode_blp_plain(data, path)):
            with pytest.raises(ValueError, match="raw BGRA"):
                run()
        return
    if not want["rule"]:
        assert sha(port_array(data)[0]) == want["array"]
    for got in (png.read_image(path), blp.decode_blp_plain(data, path)):
        assert sha(got) == want["array"] and list(got.shape) == want["shape"], name


def _blp1(compression=0, alpha=0, w=4, h=4, encoding=5, tail=b""):
    return b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h, encoding, 0) + tail


def _offsets(first, length):
    return struct.pack("<16I", first, *[0] * 15) + struct.pack("<16I", length, *[0] * 15)


_PAL = bytes(np.random.default_rng(1).integers(0, 256, 1024, dtype=np.uint8))
_IDX = bytes(range(40, 60))
_JPEG = jpeg.encode_jpeg(natural(4, 4, 3, 2), subsampling="4:4:4")
_SOS = _JPEG.index(b"\xff\xda")
_J = 28 + 128 + 4
BLP_CASES = {
    "blp2_palette": blp2_head(4, 4, 1, 0, 0, _IDX[:16], _PAL),
    "blp2_palette_alpha": blp2_head(4, 4, 1, 8, 0, _IDX[:16], _PAL),
    "blp2_palette_more_indices": blp2_head(4, 4, 1, 0, 0, _IDX, _PAL),
    "blp2_palette_fewer_indices": blp2_head(4, 4, 1, 0, 0, _IDX[:15], _PAL),
    "blp2_palette_cut": blp2_head(4, 4, 1, 0, 0, _IDX[:16], _PAL)[:-1],
    "blp2_palette_itself_cut": blp2_head(4, 4, 1, 0, 0, b"", _PAL[:500]),
    "blp2_offsets_cut": blp2_head(4, 4, 1, 0, 0, b"")[:100],
    "blp2_header_cut": b"BLP2" + struct.pack("<i", 1) + b"\1",
    "blp2_width_0": blp2_head(0, 4, 1, 0, 0, _IDX[:16], _PAL),
    "blp2_raw_bgra": blp2_head(4, 4, 3, 0, 0, bytes(64)),
    "blp2_encoding_9": blp2_head(4, 4, 9, 0, 0, bytes(64)),
    "blp2_compression_0": b"BLP2" + struct.pack("<i", 0) + blp2_head(4, 4, 1, 0, 0, _IDX)[8:],
    "blp2_alpha_encoding_3": blp2_head(4, 4, 2, 0, 3, bytes(16)),
    "blp2_dxt1": blp2_head(4, 4, 2, 0, 0, bytes(range(8))),
    "blp2_dxt1_cut": blp2_head(4, 4, 2, 0, 0, bytes(7)),
    "blp2_dxt5_8x8_alpha1": blp2_head(8, 8, 2, 1, 7, bytes(range(64))),
    "blp1_palette": _blp1(1, 0, tail=_offsets(0, 16) + _PAL + _IDX[:16]),
    "blp1_palette_encoding_4_alpha": _blp1(1, 8, encoding=4,
                                           tail=_offsets(0, 16) + _PAL + _IDX[:16]),
    "blp1_palette_encoding_3": _blp1(1, 0, encoding=3, tail=_offsets(0, 16) + _PAL + _IDX),
    "blp1_compression_2": _blp1(2, 0, tail=_offsets(0, 16) + _PAL + _IDX),
    "blp1_header_cut": _blp1()[:18],
    "blp1_jpeg": _blp1(0, 0, tail=_offsets(_J + _SOS, len(_JPEG) - _SOS)
                       + struct.pack("<I", _SOS) + _JPEG),
    "blp1_jpeg_alpha": _blp1(0, 1, tail=_offsets(_J + _SOS, len(_JPEG) - _SOS)
                             + struct.pack("<I", _SOS) + _JPEG),
    "blp1_jpeg_mipmap_ahead": _blp1(0, 0, tail=_offsets(_J + _SOS + 5, len(_JPEG) - _SOS)
                                    + struct.pack("<I", _SOS) + _JPEG[:_SOS] + b"xxxxx"
                                    + _JPEG[_SOS:]),
    "blp1_jpeg_mipmap_behind": _blp1(0, 0, tail=_offsets(0, len(_JPEG) - _SOS)
                                     + struct.pack("<I", _SOS) + _JPEG),
    "blp1_jpeg_cut": _blp1(0, 0, tail=_offsets(_J + _SOS, len(_JPEG) - _SOS)
                           + struct.pack("<I", _SOS) + _JPEG[:-3]),
    "blp1_jpeg_header_past_the_file": _blp1(0, 0, tail=_offsets(0, 0)
                                            + struct.pack("<I", 10 ** 6) + _JPEG),
    "blp1_jpeg_not_a_jpeg": _blp1(0, 0, tail=_offsets(_J + 4, 4) + struct.pack("<I", 4)
                                  + b"abcdefgh"),
}


@pytest.mark.parametrize("case", list(BLP_CASES))
def test_blp_rules_as_pil(tmp_path, case):
    """Each BLP gives way where PIL's `_open` does (a header cut short, a
    size of 0), fails where its decoder fails (the offsets, palette, data
    or JPEG header cut short, fewer indices than pixels, encodings,
    compressions and alpha encodings it does not know, a stream that is not
    a JPEG), and otherwise reads as PIL reads it, through both routes: a
    BLP1 JPEG's mipmap read on from its offset where that lies ahead, at
    once where it lies behind."""
    data = BLP_CASES[case]
    try:
        want = port_array(data)[0]
    except Exception as err:                 # noqa: BLE001  (PIL's own failures)
        want = "give way" if type(err).__name__ == "UnidentifiedImageError" else "fail"
    for decode in (blp.decode_blp, blp.decode_blp_plain):
        try:
            got = decode(data, "<file>")
        except GiveWay:
            got = "give way"
        except ValueError:
            got = "fail"
        if isinstance(want, str):
            assert got == want, (case, got)
        else:
            assert np.array_equal(got, want), case


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "gray", "progressive"])
def test_blp1_jpeg_of_three_components_equals_pil(tmp_path, sampling):
    """BLP1 JPEGs of PIL's own JPEG streams (each sampling, gray,
    progressive), at alpha depth 0 and 8: the port reads PIL's array, the
    RGB its JPEG plugin gives taken as B, G, R (an alpha of 255 where the
    header has one)."""
    img = natural(19, 26, 3, 4)
    buf = io.BytesIO()
    kw = ({"progressive": True} if sampling == "progressive" else
          {} if sampling == "gray" else {"subsampling": sampling})
    Image.fromarray(img[..., 0] if sampling == "gray" else img).save(buf, "JPEG", quality=90,
                                                                      **kw)
    for alpha in (0, 8):
        data = blp1_jpeg(26, 19, alpha, buf.getvalue())
        want = np.asarray(Image.open(io.BytesIO(data)))
        assert want.shape == (19, 26, 4 if alpha else 3)
        assert np.array_equal(blp.decode_blp(data), want)
        assert np.array_equal(blp.decode_blp_plain(data), want)


def _jax_oracle(tmp_path, arr, resolution, name="oracle.png"):
    path = str(tmp_path / name)
    Image.fromarray(arr).save(path, "PNG")
    return jreaders._load_image(path, resolution, None)


@pytest.mark.parametrize("alpha", [8, 0])
def test_b35_four_component_jpeg_reads_bgra(tmp_path, alpha):
    """Fault B35: a BLP1 JPEG of four components (B, G, R, A) opens in PIL
    darkened by its alpha (decoded as non-inverted CMYK and converted),
    with no alpha (255). The port reads the components as B, G, R and A
    (the alpha dropped at alpha depth 0), equal to the JAX `_load_image` of
    the components as stored (255 minus PIL's samples of the JPEG alone)
    written as an RGBA (RGB) PNG."""
    rgba = natural(16, 24, 4, 6)
    rgba[..., 3] = np.linspace(0, 255, 24, dtype=np.uint8)[None]
    four = jpeg.encode_jpeg(np.ascontiguousarray(rgba[..., [2, 1, 0, 3]]),
                            subsampling="4:4:4", color="as_is")
    stored = 255 - np.asarray(Image.open(io.BytesIO(four)))
    oracle = np.ascontiguousarray(stored[..., [2, 1, 0, 3]][..., :4 if alpha else 3])
    data = blp1_jpeg(24, 16, alpha, four)
    path = str(tmp_path / "v.blp")
    with open(path, "wb") as fh:
        fh.write(data)
    pil = np.asarray(Image.open(path))
    assert pil.shape[2] == (4 if alpha else 3) and (pil[..., 3:] == 255).all()
    assert np.abs(pil[..., :3].astype(int) - oracle[..., :3]).max() > 60
    assert np.array_equal(png.read_image(path), oracle)
    assert np.array_equal(blp.decode_blp_plain(data), oracle)
    got_img, got_mask = readers._load_image(path, 1, None)
    want_img, want_mask = _jax_oracle(tmp_path, oracle, 1)
    assert np.array_equal(got_img, want_img)
    assert (got_mask is None) == (want_mask is None) == (alpha == 0)
    if alpha:
        assert np.array_equal(got_mask, want_mask) and want_mask.min() < 0.01


@pytest.mark.parametrize("enc", [1, 7], ids=["dxt3", "dxt5"])
def test_b36_dxt3_dxt5_of_alpha_depth_0_read_their_rgb(enc):
    """Fault B36: a DXT3 or DXT5 BLP2 of alpha depth 0 opens in PIL as RGB
    from four bytes a pixel, every pixel after the first shifted. The port
    reads the blocks' RGB: PIL's reading of the same file at alpha depth 8,
    the alpha dropped."""
    blocks = np.random.default_rng(enc).integers(0, 256, (bcn.bc1_blocks(16, 8), 16),
                                                 dtype=np.uint8).tobytes()
    pil0 = np.asarray(Image.open(io.BytesIO(blp2_head(16, 8, 2, 0, enc, blocks))))
    pil8 = np.asarray(Image.open(io.BytesIO(blp2_head(16, 8, 2, 8, enc, blocks))))
    oracle = np.ascontiguousarray(pil8[..., :3])
    assert np.array_equal(pil0.reshape(-1)[:3], oracle.reshape(-1)[:3])
    assert not np.array_equal(pil0, oracle)
    data = blp2_head(16, 8, 2, 0, enc, blocks)
    assert np.array_equal(blp.decode_blp(data), oracle)
    assert np.array_equal(blp.decode_blp_plain(data), oracle)


@pytest.mark.parametrize("w", [1, 2, 3, 6])
def test_b37_width_not_a_multiple_of_4_reads_its_blocks(w):
    """Fault B37: a BLP2 DXT1 texture of width 1, 2 (powers of two, which
    BLP allows), 3 or 6 opens in PIL with its rows filled in turn from the
    decoded tiles' 4 ceil(w / 4)-wide rows. The port reads each pixel from
    its own block: PIL's reading of the same blocks at the width rounded up
    to 4, cropped."""
    h = 8
    body = bcn.encode_bc1(natural(h, w, 3, w))[0]
    wide = 4 * ((w + 3) // 4)
    oracle = np.asarray(Image.open(io.BytesIO(blp2_head(wide, h, 2, 0, 0, body))))[:, :w]
    pil = np.asarray(Image.open(io.BytesIO(blp2_head(w, h, 2, 0, 0, body))))
    assert not np.array_equal(pil, oracle)
    data = blp2_head(w, h, 2, 0, 0, body)
    assert np.array_equal(blp.decode_blp(data), oracle)
    assert np.array_equal(blp.decode_blp_plain(data), oracle)


@pytest.mark.parametrize("form", blp.FORMS)
@pytest.mark.parametrize("size", [(4, 4), (24, 16), (300, 8)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_blp_writer_read_by_pil(tmp_path, size, form):
    """`encode_blp`'s textures (widths a multiple of 4): PIL reads what the
    writer says they decode to, and so do `read_image` and the plain
    route."""
    w, h = size
    img = natural(h, w, 3, w + h)
    pal = np.random.default_rng(w).integers(0, 256, (256, 3), dtype=np.uint8)
    data, want = blp.encode_blp(img[..., 0] if form == "BLP2_PALETTE" else img, form,
                                palette=pal)
    path = str(tmp_path / "w.blp")
    with open(path, "wb") as fh:
        fh.write(data)
    assert np.array_equal(np.asarray(Image.open(path)), want)
    assert np.array_equal(png.read_image(path), want)
    assert np.array_equal(blp.decode_blp_plain(data), want)


# ------------------------------------------------------------------ COLMAP
def _texture_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its
    nine views rewritten as DDS DXT5 (an alpha), BC4, BC5, DX10 BC7 and 565
    masks, BLP1 JPEG, BLP2 palette, a BLP1 JPEG of four components (B35)
    and a BLP2 DXT5 of alpha depth 0 (B36) -> {image name: the oracle:
    PIL's array, or the B rule's}."""
    from tests.test_torch_cli_eval import _make_scene

    _make_scene(root)
    images = os.path.join(root, "images")
    oracle = {}
    pal = np.random.default_rng(2).integers(0, 256, (256, 3), dtype=np.uint8)
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        h, w = img.shape[:2]
        rgba = np.dstack([img, np.linspace(40, 255, w, dtype=np.uint8)[None].repeat(h, 0)])
        k = i % 9
        if k < 5:                           # DDS DXT5 (an alpha), BC4, BC5, DX10 BC7, 565
            form = ("DXT5", "BC4", "BC5", "BC7", "RGB565")[k]
            data = dds.encode_dds((rgba, img[..., 1], img, rgba, img)[k], form)[0]
            want = port_array(data)[0]
        elif k < 7:                         # BLP1 JPEG, BLP2 palette
            data = blp.encode_blp(img[..., 0] if k == 6 else img, blp.FORMS[k - 5],
                                  palette=pal)[0]
            want = port_array(data)[0]
        elif k == 7:                        # B35: the components as stored, as B, G, R, A
            four = jpeg.encode_jpeg(np.ascontiguousarray(rgba[..., [2, 1, 0, 3]]),
                                    subsampling="4:4:4", color="as_is")
            data = blp1_jpeg(w, h, 8, four)
            stored = 255 - np.asarray(Image.open(io.BytesIO(four)))
            want = np.ascontiguousarray(stored[..., [2, 1, 0, 3]])
        else:                               # B36: PIL's reading at alpha depth 8, RGB
            body = bcn.encode_bc3(rgba)[0]
            data = blp2_head(w, h, 2, 0, 7, body)
            want = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(
                blp2_head(w, h, 2, 8, 7, body))))[..., :3])
        with open(path, "wb") as fh:
            fh.write(data)
        oracle[name] = want
    return oracle


def test_texture_colmap_scene_matches_jax(tmp_path, monkeypatch):
    """`read_scene` on one COLMAP set of DDS and BLP views equals, at -r 1
    and 2, the JAX reader's on the same set with each view replaced by its
    oracle written as a PNG, exactly; the JAX reader on the files
    themselves differs on the views of a fault (B35, B36). Read again with
    every plain piece of the slice made to raise, the same scene."""
    root = str(tmp_path / "s")
    oracle = _texture_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    faulty = jreaders.read_scene(root, **kw[0])

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for mod, names in ((bcn, ("decode_plain", "_bc1_plain", "_bc7", "_bc4", "_colour")),
                       (dds, ("decode_dds_plain",)), (blp, ("decode_blp_plain",)),
                       (jpeg, ("_scan_plain", "_planes_plain", "_idct"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
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
    assert differ >= 2, differ
