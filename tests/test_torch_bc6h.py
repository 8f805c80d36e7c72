"""The port's BC6H decoder (`io/bcn.py`'s `_bc6h`, C++ `gm_bcn_decode` kind 6)
and DDS's DX10 BC6H textures (`io/dds.py`) against PIL 12's `bcn` decoder.

Random blocks forced into each of the 14 modes and the 4 reserved ones,
unsigned and signed, at sizes with partial edge tiles, decode through
`gm_bcn_decode` and `decode_plain` to PIL's array byte for byte (the signed
blocks of a transformed mode are made so that no endpoint is negative:
there PIL departs from the definition, fault B38, held here against an
oracle PIL reads right). PIL's half -> 8-bit rule is probed on every half of
both signs, its blend held to no + 32 (C11), `encode_bc6h`'s textures read
by PIL as the writer says, and a COLMAP scene of BC6H views loads through
the port's `read_scene` as through the JAX reader."""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import bcn, dds, jpeg, png
from tests.test_torch_readers import _assert_scene_equal
from tools.make_raw_sample_fixtures_torch import natural
from tools.make_texture_fixtures_torch import b38_blocks, b38_oracle, random_bc6h

torch.set_num_threads(2)

PATTERNS = bcn.BC6H_MODES + bcn.BC6H_RESERVED
TRANSFORMED = [m[0] for m in bcn._BC6H_MODES if m[3] and m[4] < 16]
W, H = 78, 61                                   # 20 x 16 = 320 blocks, partial edge tiles


def _pil(data, w, h, signed):
    return np.asarray(Image.frombytes("RGB", (w, h), data, "bcn",
                                      (6, "BC6HS" if signed else "BC6H")))


def _both(data, w, h, signed):
    got = bcn.decode(bcn.BC6H, data, w, h, signed=signed)
    assert np.array_equal(got, bcn.decode_plain(bcn.BC6H, data, w, h, signed=signed))
    return got


def _forced(pattern: int, n: int, seed: int, signed: bool) -> np.ndarray:
    """n blocks of one mode pattern (`random_bc6h` cycles them)."""
    return random_bc6h(len(PATTERNS) * n, seed, signed, PATTERNS.index(pattern))[::len(PATTERNS)]


@pytest.mark.parametrize("signed", [False, True], ids=["bc6h", "bc6hs"])
@pytest.mark.parametrize("pattern", PATTERNS, ids=hex)
def test_each_mode_random_blocks_equal_pil(pattern, signed):
    """320 random blocks of one mode (a reserved one reads black): the C++
    and the plain decoder agree with PIL byte for byte at 78 x 61; a block
    short raises "truncated" through both."""
    n = bcn.bc1_blocks(W, H)
    data = _forced(pattern, n, pattern + 97 * signed, signed).tobytes()
    got = _both(data, W, H, signed)
    assert np.array_equal(got, _pil(data, W, H, signed))
    if pattern in bcn.BC6H_RESERVED:
        assert not got.any()
    else:
        assert len(np.unique(got)) > 16
    for decode in (bcn.decode, bcn.decode_plain):
        with pytest.raises(ValueError, match="truncated"):
            decode(bcn.BC6H, data[:-1], W, H, signed=signed)


@pytest.mark.parametrize("signed", [False, True], ids=["bc6h", "bc6hs"])
def test_half_to_8_bits_is_pils_rule(signed):
    """The probe that settled PIL's rule: mode 0x0F blocks whose two 16-bit
    endpoints are equal (they unquantize as they are, so every half the
    definition can end on is reached) over all 65,536 endpoint values. PIL
    gives floor(255 h) in float32, h clamped to [0, 1]: halves under 0x1C05
    read 0, 0x3C00 (1.0) and over 255, a negative half 0. `_half_to_8` and
    the C++ give the same."""
    u = np.arange(1 << 16, dtype=np.int64)
    fields = np.zeros((len(u), 12), np.int64)
    fields[:, :3] = u[:, None]                  # w = u, the deltas 0
    data = bcn.bc6h_block(0x0F, fields, 0, np.zeros((len(u), 16), np.int64)).tobytes()
    got = _pil(data, 4 * len(u), 4, signed)[0, ::4, 0].astype(np.int64)
    v = np.where(u >= 1 << 15, u - (1 << 16), u) if signed else u
    half = np.where(v < 0, 0x8000 | (-v * 31) >> 5, (v * 31) >> 5) if signed else (v * 31) >> 6
    f = half.astype(np.uint16).view(np.float16).astype(np.float32)
    assert np.array_equal(got, np.floor(np.clip(f, 0, 1) * np.float32(255)))
    assert np.array_equal(got, bcn._half_to_8(v, signed))
    assert got[half < 0x1C05].max() == 0 and got[half == 0x1C05].min() == 1
    assert (got[(half >= 0x3C00) & (half < 0x8000)] == 255).all()
    if signed:
        assert (got[v < 0] == 0).all()
    assert np.array_equal(bcn.decode(bcn.BC6H, data, 4 * len(u), 4, signed=signed)[0, ::4, 0],
                          got)


def test_c11_blend_without_rounding():
    """C11: PIL blends the endpoints as (e0 (64 - w) + e1 w) >> 6, where the
    definition adds 32 before the shift. On random one-region blocks the
    two differ by one 8-bit level on a few pixels; PIL is the first."""
    n = bcn.bc1_blocks(W, H)
    blocks = _forced(0x07, n, 11, False)
    data = blocks.tobytes()
    want = _pil(data, W, H, False)
    assert np.array_equal(_both(data, W, H, False), want)
    ends = bcn._bc6h_unquantize(bcn.bc6h_endpoints(blocks, 0x07, False), 11, False)
    raw = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
    widths = 4 - bcn._anchor(1, np.zeros(n, np.int64))
    idx = bcn._read(raw, 65 + np.cumsum(widths, 1) - widths, widths)
    w = np.array(bcn.BC7_WEIGHTS[4])[idx][..., None]
    rounded = bcn._half_to_8((ends[:, None, :3] * (64 - w) + ends[:, None, 3:6] * w + 32) >> 6,
                             False)
    tiles = rounded.reshape(H // 4 + 1, W // 4 + 1, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    rounded = tiles.reshape(4 * (H // 4 + 1), 4 * (W // 4 + 1), 3)[:H, :W]
    diff = np.abs(rounded - want.astype(np.int64))
    assert diff.max() == 1 and 0 < (diff > 0).sum() < diff.size // 20


@pytest.mark.parametrize("pattern", TRANSFORMED, ids=hex)
def test_b38_signed_transformed_endpoints_read_by_the_definition(pattern):
    """B38: under BC6HS PIL sign-extends a block's first endpoint but reads
    the transformed ones (the first plus a delta, modulo the endpoint bits)
    unsigned, so a negative one reads 255 where the definition gives 0.
    Random signed blocks of the mode, each index made 0 or the largest
    (each pixel one endpoint): the port equals the oracle, PIL's reading of
    signed mode-0x0F blocks that hold each endpoint as the definition
    unquantizes it (16-bit endpoints, which PIL sign-extends right), where
    PIL's reading of the blocks themselves differs."""
    n = bcn.bc1_blocks(W, H)
    raw = np.random.default_rng(pattern).integers(0, 256, (n, 16), dtype=np.uint8)
    raw[:, 0] = (raw[:, 0] & (0xFC if pattern < 2 else 0xE0)) | pattern
    blocks = b38_blocks(raw)
    data = blocks.tobytes()
    want = b38_oracle(blocks, W, H)
    assert np.array_equal(_both(data, W, H, True), want)
    wrong = _pil(data, W, H, True)
    assert (wrong != want).any(-1).mean() > 0.05
    assert (want[(wrong != want).any(-1)] == 0).any() and (wrong[(wrong != want)] == 255).any()
    # unsigned, PIL reads the same blocks as the definition
    assert np.array_equal(_both(data, W, H, False), _pil(data, W, H, False))


@pytest.mark.parametrize("signed", [False, True], ids=["bc6h", "bc6hs"])
@pytest.mark.parametrize("size", [(1, 1), (7, 6), (23, 17), (64, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_bc6h_read_by_pil(size, signed):
    """`encode_bc6h`'s blocks (mode 0x03) and its DX10 textures: PIL, the
    C++ and the plain route read what the writer says; a smooth image comes
    back close, a flat one exactly where an endpoint reads its value."""
    w, h = size
    rgb = natural(h, w, 3, w + 3 * h)
    data, want = bcn.encode_bc6h(rgb, signed)
    assert np.array_equal(_pil(data, w, h, signed), want)
    assert np.array_equal(_both(data, w, h, signed), want)
    tex, want2 = dds.encode_dds(rgb, "BC6HS" if signed else "BC6H")
    assert np.array_equal(want2, want)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(tex))), want)
    assert np.array_equal(dds.decode_dds(tex), want)
    assert np.abs(want.astype(int) - rgb).mean() < 20          # noise of sigma 20 in it
    flat = np.zeros((8, 8, 3), np.uint8)
    flat[...] = (0, 128, 255)
    assert np.array_equal(bcn.encode_bc6h(flat, signed)[1], flat)


def _bc6h_scene(root):
    """The 64x48 COLMAP scene of `tests/test_torch_cli_eval.py` with its views
    rewritten as DX10 BC6H textures: `encode_bc6h` unsigned and signed, and
    random blocks of every mode (signed ones with no negative endpoint)."""
    from tests.test_torch_cli_eval import _make_scene

    _make_scene(root)
    images = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(images))):
        path = os.path.join(images, name)
        img = jpeg.read_jpeg(path)
        h, w = img.shape[:2]
        if i % 3 < 2:
            dds.write_dds(path, img, ("BC6H", "BC6HS")[i % 3])
        else:
            body = random_bc6h(bcn.bc1_blocks(w, h), i, i % 2 == 1).tobytes()
            with open(path, "wb") as fh:
                fh.write(dds.dds_head(w, h, dds.FOURCC, b"DX10", dxgi=95 + i % 2) + body)


def test_bc6h_colmap_scene_matches_jax(tmp_path, monkeypatch):
    """`read_scene` of a COLMAP set of BC6H views at -r 1 and 2 equals the
    JAX reader's on the same files, exactly; read again with the plain
    pieces made to raise, the same scene."""
    root = str(tmp_path / "s")
    _bc6h_scene(root)
    kw = [dict(resolution=r, eval_split=True) for r in (1, 2)]
    got = [readers.read_scene(root, **k) for k in kw]
    for g, k in zip(got, kw):
        _assert_scene_equal(g, jreaders.read_scene(root, **k))

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for name in ("decode_plain", "_bc6h", "_half_to_8", "bc6h_endpoints"):
        monkeypatch.setattr(bcn, name, plain)
    monkeypatch.setattr(dds, "decode_dds_plain", plain)
    for g, k in zip(got, kw):
        _assert_scene_equal(readers.read_scene(root, **k), g)
    assert png.read_image(os.path.join(root, "images",
                                       sorted(os.listdir(f"{root}/images"))[0])).ndim == 3
