"""The port's DDS reader (`io/dds.py`) and its BCn decoders (`io/bcn.py`,
C++ `gm_bcn_decode`) against PIL 12, and fault B34.

BC2, BC3, BC4, BC5 and BC5S blocks decode through `gm_bcn_decode` and
`bcn.decode_plain` to PIL's `bcn` decoder's arrays on random blocks at
sizes with partial edge tiles; BC7 mode by mode (random bytes reach mode 7
once in 256 blocks), the reserved mode included; the port's BCn writers
decode as they claim. Every DDS fixture of `tests/data/textures/` equals
PIL through `read_image` and the plain route, with the port's rule where
one applies (A2, B15, B38's oracle), or is refused through both with its
cause (B34); BC6H, unsigned and signed, is read (`tests/test_torch_bc6h.py`
holds its blocks). DDS headers give way where PIL's `_open` gives way and
fail where it fails. B34: a texture of masks cut short, which PIL reads with zeros past
the end of the file, raises, where the complete file reads as PIL reads
it."""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu_torch.io import bcn, dds, png
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from tools.make_raw_sample_fixtures_torch import natural, port_array, sha
from tools.make_texture_fixtures_torch import b38_oracle, random_bc6h

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data", "textures")
DIGESTS = json.load(open(os.path.join(DATA, "digests.json")))
MODES = {bcn.BC1: "RGBA", bcn.BC2: "RGBA", bcn.BC3: "RGBA", bcn.BC4: "L", bcn.BC5: "RGB",
         bcn.BC7: "RGBA"}
SIZES = [(1, 1), (3, 5), (7, 6), (13, 9), (75, 66)]     # (width, height); 75x66: 323 blocks


def _pil_bcn(kind, data, w, h, signed=False):
    fmt = {1: "DXT1", 2: "DXT3", 3: "DXT5", 4: "BC4", 5: "BC5S" if signed else "BC5",
           7: "BC7"}[kind]
    return np.asarray(Image.frombytes(MODES[kind], (w, h), data, "bcn", (kind, fmt)))


def _both(kind, data, w, h, **kw):
    got = bcn.decode(kind, data, w, h, **kw)
    assert np.array_equal(got, bcn.decode_plain(kind, data, w, h, **kw))
    return got


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["bc2", "bc3", "bc4", "bc5", "bc5s"])
def test_bcn_random_blocks_equal_pil(size, kind):
    """Random blocks (every third with its ends or colour words equal: the
    six-level BC4 mode, the equal-colour BC1 block) decode through
    `gm_bcn_decode` and `decode_plain` to PIL's `bcn` decoder's array, byte
    for byte; a block short raises "truncated" through both."""
    w, h = size
    k = {"bc2": 2, "bc3": 3, "bc4": 4, "bc5": 5, "bc5s": 5}[kind]
    signed = kind == "bc5s"
    n = bcn.bc1_blocks(w, h)
    blocks = np.random.default_rng(w * 31 + h + k).integers(
        0, 256, (n, bcn.BLOCK_BYTES[k]), dtype=np.uint8)
    blocks[::3, 1] = blocks[::3, 0]
    blocks[1::3, 0] = blocks[1::3, 1] // 2
    if k in (2, 3):
        blocks[::3, 10:12] = blocks[::3, 8:10]
    data = blocks.tobytes()
    assert np.array_equal(_both(k, data, w, h, signed=signed), _pil_bcn(k, data, w, h, signed))
    for decode in (bcn.decode, bcn.decode_plain):
        with pytest.raises(ValueError, match="truncated"):
            decode(k, data[:-1], w, h, signed=signed)


@pytest.mark.parametrize("mode", list(range(8)) + ["reserved"])
def test_bc7_each_mode_equals_pil(mode):
    """320 random BC7 blocks forced into one mode (its first set bit; the
    reserved mode a first byte of 0), at 78 x 61 (partial edge tiles):
    `gm_bcn_decode`, `decode_plain` and PIL's `bcn` decoder agree byte for
    byte, over the mode's partitions, rotations, index selections and
    p-bits."""
    w, h = 78, 61
    n = bcn.bc1_blocks(w, h)
    assert n == 320
    seed = 8 if mode == "reserved" else mode
    blocks = np.random.default_rng(seed).integers(0, 256, (n, 16), dtype=np.uint8)
    if mode == "reserved":
        blocks[:, 0] = 0
    else:
        blocks[:, 0] = (blocks[:, 0].astype(int) << (mode + 1) | 1 << mode) & 255
    data = blocks.tobytes()
    got = _both(bcn.BC7, data, w, h)
    assert np.array_equal(got, _pil_bcn(bcn.BC7, data, w, h))
    if mode == "reserved":
        assert (got[..., :3] == 0).all() and (got[..., 3] == 255).all()


@pytest.mark.parametrize("size", [(1, 1), (7, 6), (23, 17), (64, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bcn_writers_decode_as_claimed(size):
    """`encode_bc1` to `encode_bc7`'s blocks: PIL decodes what each writer
    says they decode to, and the port's C++ does too."""
    w, h = size
    rgba = natural(h, w, 4, w + 5 * h)
    rgb, gray = rgba[..., :3], rgba[..., 0]
    for kind, encode, img in ((1, bcn.encode_bc1, rgb), (2, bcn.encode_bc2, rgba),
                              (3, bcn.encode_bc3, rgba), (4, bcn.encode_bc4, gray),
                              (5, bcn.encode_bc5, rgb), (7, bcn.encode_bc7, rgba)):
        data, want = encode(img)
        assert np.array_equal(_pil_bcn(kind, data, w, h), want), kind
        assert np.array_equal(bcn.decode(kind, data, w, h), want), kind
    close = bcn.encode_bc7(rgba)[1].astype(int) - rgba
    assert np.abs(close).max() <= 128 and np.abs(close).mean() < 24


def test_bcn_argument_checks():
    """Kinds the port does not decode (BC6H is read since it has a decoder:
    kind 8 stands for them), a signed form other than BC5 and BC6H, and the
    shifted 565 rule outside BC1-BC3 are refused by both routes."""
    for decode in (bcn.decode, bcn.decode_plain):
        for kw, match in (({"kind": 8}, "BC8"), ({"kind": 4, "signed": True}, "signed"),
                          ({"kind": 7, "shift565": True}, "565")):
            k = kw.pop("kind")
            with pytest.raises(ValueError, match=match):
                decode(k, bytes(64), 4, 4, **kw)


# ------------------------------------------------------------------ fixtures
DDS_FIXTURES = sorted(n for n in DIGESTS if n.endswith(".dds"))


@pytest.mark.parametrize("name", DDS_FIXTURES)
def test_dds_fixture_equals_pil(name):
    """Each DDS fixture: PIL's format and mode as recorded; `read_image` and
    `decode_dds_plain` give the recorded digest, which is PIL's array under
    the port's rule (computed again here: B38's through PIL's reading of
    mode-0x0F blocks), or both refuse it naming its cause (B34's cut
    data)."""
    path = os.path.join(DATA, name)
    data = open(path, "rb").read()
    want = DIGESTS[name]
    im = Image.open(path)
    assert (im.format, im.mode) == (want["pil_format"], want["pil_mode"])
    if want["array"] is None:
        for run in (lambda: png.read_image(path), lambda: dds.decode_dds_plain(data, path)):
            with pytest.raises(ValueError, match="B34"):
                run()
        return
    if want["rule"] == "B38":
        w, h = im.size
        blocks = np.frombuffer(data, np.uint8, offset=148).reshape(-1, 16)
        assert sha(b38_oracle(blocks, w, h)) == want["array"]
    else:
        assert sha(port_array(data)[0]) == want["array"]
    for got in (png.read_image(path), dds.decode_dds_plain(data, path)):
        assert sha(got) == want["array"] and list(got.shape) == want["shape"], name


def test_dds_fixtures_cover_every_form():
    """The fixtures hold every form the reader takes: each FourCC, each
    DXGI format class, masks with and without alpha, L, LA, P, BC6H of
    both signs."""
    forms = set()
    for name in DDS_FIXTURES:
        _, _, form, _, args = dds.header(open(os.path.join(DATA, name), "rb").read())
        forms.add((form,) + (tuple(args) if form == "bcn" else
                             (len(args[1]),) if form == "masks" else ()))
    want = {("bcn", k, False) for k in (1, 2, 3, 4, 5, 6, 7)} | {("bcn", 5, True),
                                                                ("bcn", 6, True)}
    assert want | {("L",), ("LA",), ("P",), ("raw",), ("masks", 3), ("masks", 4)} <= forms


# ------------------------------------------------------------------ headers
def _dds(w=4, h=4, pfflags=dds.FOURCC, fourcc=b"DXT1", bitcount=0, masks=(0, 0, 0, 0),
         dxgi=None, body=bytes(8)):
    return dds.dds_head(w, h, pfflags, fourcc, bitcount, masks, dxgi) + body


_L = dds.LUMINANCE
DDS_CASES = {
    "dxt1": _dds(),
    "magic_only": b"DDS ",
    "size_cut": b"DDS \x7c\0",
    "header_size_100": _dds()[:4] + struct.pack("<I", 100) + _dds()[8:],
    "header_cut": _dds()[:100],
    "width_0": _dds(w=0),
    "height_0_unknown_fourcc": _dds(h=0, fourcc=b"XXXX"),
    "no_flags": _dds(pfflags=0),
    "unknown_fourcc": _dds(fourcc=b"XXXX"),
    "dx10_cut": _dds(fourcc=b"DX10", body=b"\x47\0"),
    "dx10_bc1_srgb": _dds(fourcc=b"DX10", dxgi=72),
    "dx10_bc4_snorm": _dds(fourcc=b"DX10", dxgi=81),
    "dx10_bc3": _dds(fourcc=b"DX10", dxgi=77, body=bytes(range(16))),
    "dx10_rgba8_cut": _dds(fourcc=b"DX10", dxgi=29, body=bytes(63)),
    "dx10_rgba8": _dds(fourcc=b"DX10", dxgi=27, body=bytes(range(64))),
    "dx10_bc6h_typeless": _dds(fourcc=b"DX10", dxgi=94, body=bytes(16)),
    "dx10_bc6h_sf16_cut": _dds(fourcc=b"DX10", dxgi=96, body=bytes(15)),
    "dxt1_cut": _dds(body=bytes(7)),
    "dxt1_longer": _dds(w=5, h=5, body=bytes(40)),
    "l": _dds(pfflags=_L, bitcount=8, body=bytes(range(16))),
    "l_cut": _dds(pfflags=_L, bitcount=8, body=bytes(15)),
    "l_16bit": _dds(pfflags=_L, bitcount=16, body=bytes(32)),
    "la_no_alpha_flag_8bit": _dds(pfflags=_L | dds.ALPHAPIXELS, bitcount=8,
                                  body=bytes(range(16))),
    "la": _dds(pfflags=_L | dds.ALPHAPIXELS, bitcount=16, body=bytes(range(32))),
    "palette": _dds(pfflags=dds.PALETTEINDEXED8, bitcount=8,
                    body=bytes(range(256)) * 4 + bytes(range(16))),
    "palette_cut": _dds(pfflags=dds.PALETTEINDEXED8, bitcount=8, body=bytes(1000)),
    "masks_0_bits": _dds(pfflags=dds.RGB, bitcount=0, masks=(0xFF0000, 0xFF00, 0xFF, 0),
                         body=b""),
    "masks_8_bits_565": _dds(pfflags=dds.RGB, bitcount=8, masks=(0xF800, 0x7E0, 0x1F, 0),
                             body=bytes(range(16))),
    "masks_64_bits": _dds(pfflags=dds.RGB | dds.ALPHAPIXELS, bitcount=64,
                          masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                          body=bytes(range(128))),
    "rgb_flag_beats_fourcc": _dds(pfflags=dds.RGB | dds.FOURCC, bitcount=16,
                                  masks=(0xF800, 0x7E0, 0x1F, 0), body=bytes(range(32))),
}


@pytest.mark.parametrize("case", list(DDS_CASES))
def test_dds_rules_as_pil(tmp_path, case):
    """Each DDS gives way where PIL's `_open` does (cut before the header
    size, a size of 0 once `_open` has read a format it knows, a DX10
    header cut short), fails where `_open` or `load` fails (another header
    size, a header cut inside, unknown flags, FourCCs and DXGI formats, a
    16-bit L without alpha, data cut short), and otherwise reads as PIL
    reads it, through both routes."""
    data = DDS_CASES[case]
    path = str(tmp_path / "t.dds")
    with open(path, "wb") as fh:
        fh.write(data)
    try:
        want = port_array(data)[0]
    except SyntaxError:
        want = "give way"
    except Exception as err:                 # noqa: BLE001  (PIL's own failures)
        want = "give way" if type(err).__name__ == "UnidentifiedImageError" else "fail"
    for decode in (dds.decode_dds, dds.decode_dds_plain):
        try:
            got = decode(data, path)
        except GiveWay:
            got = "give way"
        except ValueError:
            got = "fail"
        if isinstance(want, str):
            assert got == want, (case, got)
        else:
            assert np.array_equal(got, want), case


def test_b34_masks_cut_short_raise(tmp_path):
    """Fault B34: a 565 texture cut inside its data. PIL's `DdsRgbDecoder`
    reads zeros past the end of the file (the JAX reader trains them): its
    reading of the cut file agrees with that of the complete file up to the
    cut and is 0 after it. The port raises naming the bytes found and
    needed, and reads the complete file as PIL does."""
    img = natural(17, 23, 3, 9)
    full, want = dds.encode_dds(img, "RGB565")
    cut = full[:-101]
    whole = np.asarray(Image.open(io.BytesIO(full)))
    assert np.array_equal(whole, want)
    short = np.asarray(Image.open(io.BytesIO(cut))).reshape(-1, 3)
    kept = (len(cut) - 128) // 2
    assert np.array_equal(short[:kept], whole.reshape(-1, 3)[:kept])
    assert (short[kept + 1:] == 0).all() and whole.reshape(-1, 3)[kept + 1:].any()
    path = str(tmp_path / "cut.dds")
    with open(path, "wb") as fh:
        fh.write(cut)
    for run in (lambda: png.read_image(path), lambda: dds.decode_dds_plain(cut, path)):
        with pytest.raises(ValueError, match=f"holds {len(cut) - 128} of the {2 * 23 * 17} "
                                             "bytes.*B34"):
            run()
    with open(path, "wb") as fh:
        fh.write(full)
    assert np.array_equal(png.read_image(path), whole)


@pytest.mark.parametrize("dxgi", [95, 96], ids=["uf16", "sf16"])
def test_bc6h_refused_naming_it(tmp_path, dxgi):
    """DX10 BC6H, which PIL opens (mode RGB, its half floats brought down to
    8 bits), was refused before the port had a BC6H decoder (hence the
    name); both DXGI codes are now read through `read_image` and the plain
    route as PIL reads them, blocks of every mode (an 8 x 12 texture, the
    signed transformed modes with no negative endpoint: B38 is
    `tests/test_torch_bc6h.py`'s). Of width 0 it gives way, as in PIL."""
    body = random_bc6h(6, dxgi, dxgi == 96, first=dxgi % 18).tobytes()
    data = _dds(8, 12, fourcc=b"DX10", dxgi=dxgi, body=body)
    want = np.asarray(Image.open(io.BytesIO(data)))
    assert want.shape == (12, 8, 3) and len(np.unique(want)) > 8
    path = str(tmp_path / "h.dds")
    with open(path, "wb") as fh:
        fh.write(data)
    assert np.array_equal(png.read_image(path), want)
    assert np.array_equal(dds.decode_dds_plain(data, path), want)
    with pytest.raises(GiveWay):
        dds.decode_dds(_dds(0, 8, fourcc=b"DX10", dxgi=dxgi, body=bytes(64)))


@pytest.mark.parametrize("form", dds.FORMS)
@pytest.mark.parametrize("size", [(1, 1), (23, 17), (300, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_dds_writer_read_by_pil(tmp_path, size, form):
    """`encode_dds`'s textures: PIL reads what the writer says they decode
    to, and so do `read_image` and the plain route."""
    w, h = size
    rgba = natural(h, w, 4, w * 3 + h)
    img = {"DXT1": rgba[..., :3], "DXT5": rgba, "BC4": rgba[..., 0], "BC5": rgba[..., :3],
           "BC7": rgba, "BC6H": rgba[..., :3], "BC6HS": rgba[..., :3],
           "RGB565": rgba[..., :3]}[form]
    data, want = dds.encode_dds(img, form)
    path = str(tmp_path / "w.dds")
    with open(path, "wb") as fh:
        fh.write(data)
    assert np.array_equal(np.asarray(Image.open(path)), want)
    assert np.array_equal(png.read_image(path), want)
    assert np.array_equal(dds.decode_dds_plain(data, path), want)
