"""Lossless WebP (VP8L), the alpha plane (ALPH) and the first frame of
animated WebP in the port's readers (`io/vp8l.py`, `csrc/vp8l.cpp`,
`io/webp.py`) against PIL 12.1 / libwebp 1.6 and the JAX reader:
PIL-written VP8L files (methods, qualities, `exact`, RGB / RGBA / L / LA /
P, palettes, 1x1 to over 1,000 px) and lossy files with alpha read as
`np.asarray(Image.open(p))`, the C++ RGBA equal to libwebp's
`WebPDecodeRGBA` (PIL's bundled library through ctypes, test side only),
the plain versions equal to the C++ byte for byte on those files and on
damaged and cut streams (every cut of 0-24 bytes of a `VP8L` and an `ALPH`
chunk as PIL decides it), the writer's every branch decoded by PIL, the
format's tables found in libwebp's bytes, the mode rules of crafted
containers, the fixtures of `tests/data/webp/rgba/`, and a Blender set of
RGBA WebP views through `read_scene` and `train_mesh`."""

from __future__ import annotations

import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu_torch.cli import train_mesh
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.io import png, vp8l, webp
from gaussianmesh_tpu_torch.ops import _cuda
from tests.test_torch_readers import _assert_scene_equal

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "webp", "rgba")
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


def _same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return a.shape == b.shape and np.array_equal(a, b)


def _check(data: bytes, plain: bool, tmp_path=None, libwebp: bool = True):
    """read_image == PIL's array (shape and bytes); the C++ RGBA == libwebp's
    `WebPDecodeRGBA` (for a still image, where `libwebp`: its simple API
    applies an ALPH that the demuxer PIL reads through drops); (`plain`) the
    plain version's image and statistics == the C++'s. -> the frame's
    statistics (VP8L or ALPH), or None."""
    want = fx.pil_array(data)
    assert want is not None
    got = webp.decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)
    if tmp_path is not None:
        path = str(tmp_path / "x.webp")
        with open(path, "wb") as f:
            f.write(data)
        assert np.array_equal(png.read_image(path), want)
    f = webp.parse(data)
    info = None
    if f.codec == b"VP8L":
        argb, info = vp8l.decode_vp8l(f.data)
        rgba = vp8l.argb_to_rgba(argb)
        if plain:
            pa, pinfo = vp8l.vp8l_decode_plain(f.data)
            assert np.array_equal(pa, argb) and np.array_equal(pinfo, info)
    else:
        y, u, v, _ = webp.decode_vp8(f.data)
        a = np.full(y.shape, 255, np.uint8)
        if f.alpha is not None:
            a, info = vp8l.decode_alpha(f.alpha, *f.size)
            if plain:
                pa, pinfo = vp8l.alpha_decode_plain(f.alpha, *f.size)
                assert np.array_equal(pa, a) and np.array_equal(pinfo, info)
        rgba = np.concatenate([webp.yuv_to_rgb(y, u, v), a[..., None]], -1)
    if libwebp and b"ANMF" not in dict(fx.chunks_of(data)):
        assert np.array_equal(rgba, fx.libwebp_rgba(data, LIBWEBP))
    if plain:
        assert np.array_equal(webp.decode_webp_plain(data), got)
    return None if info is None else dict(zip(vp8l.STATS, info.tolist()))


def _rgba(h, w, seed):
    return np.concatenate([fx.natural(h, w, seed), fx.soft_alpha(h, w)[..., None]], -1)


# ------------------------------------------------------ PIL's lossless files
LOSSLESS = [(mode, m, q) for mode in ("RGB", "RGBA") for m in (0, 4, 6) for q in (0, 50, 100)]


@pytest.mark.parametrize("mode,method,quality", LOSSLESS,
                         ids=[f"{a}-m{b}-q{c}" for a, b, c in LOSSLESS])
def test_pil_lossless_equals_pil(tmp_path, mode, method, quality):
    """PIL's VP8L files of a natural picture (RGB) and with a soft alpha
    (RGBA) at methods 0 / 4 / 6 and qualities 0 / 50 / 100 read as PIL
    reads them, the C++ equal to libwebp and to the plain version."""
    img = _rgba(47, 61, method + quality % 7)
    src = img if mode == "RGBA" else img[..., :3]
    _check(fx.pil_webp(src, lossless=True, method=method, quality=quality), True, tmp_path)


SOURCES = ["exact", "vp8x", "L", "LA", "Pmode", "P2", "P3", "P4", "P16", "P17", "P256",
           "1x1", "odd", "wide"]


@pytest.mark.parametrize("kind", SOURCES)
def test_pil_lossless_sources_equal_pil(tmp_path, kind):
    """`exact` RGBA with colour under alpha 0, `VP8X` + `VP8L` (ICC and EXIF),
    L, LA and P, palettes of 2, 3,
    4, 16, 17 and 256 colours (bundled where 16 or fewer), 1x1, 17x9 and
    1031x7 (the plain version up to 128 px)."""
    rng = np.random.default_rng(SOURCES.index(kind))
    img = _rgba(23, 29, 3)
    kw = dict(lossless=True)
    if kind == "exact":
        img[:6, :, 3] = 0
        src, kw["exact"] = img, True
    elif kind == "vp8x":                         # PIL wraps VP8L in VP8X for ICC / EXIF
        src, kw["icc_profile"], kw["exif"] = img, b"\x02" * 40, b"Exif\x00\x00MM\x00*"
    elif kind == "L":
        src = img[..., 1]
    elif kind == "LA":
        src = Image.fromarray(img[..., [1, 3]], "LA")
    elif kind == "Pmode":
        src = Image.fromarray(rng.integers(0, 12, (23, 29), dtype=np.uint8), "P")
        src.putpalette(rng.integers(0, 256, 36, dtype=np.uint8).tolist())
    elif kind.startswith("P"):
        n = int(kind[1:])
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        src = pal[rng.integers(0, n, (23, 29))]
    else:
        h, w = {"1x1": (1, 1), "odd": (9, 17), "wide": (7, 1031)}[kind]
        src = _rgba(h, w, 5)
    buf = io.BytesIO()
    (src if isinstance(src, Image.Image) else Image.fromarray(src)).save(buf, "WEBP", **kw)
    if kind == "vp8x":
        assert [t for t, _ in fx.chunks_of(buf.getvalue())][:3] == [b"VP8X", b"ICCP", b"VP8L"]
    stats = _check(buf.getvalue(), kind != "wide", tmp_path)
    if kind[1:].isdigit() and int(kind[1:]) <= 16:
        assert stats["palette"] == int(kind[1:]) and stats["palette_bits"] > 0


# ------------------------------------------------------ PIL's lossy files with alpha
ALPHAS = [(m, kw) for m in ("hard", "soft", "noise") for kw in (
    "q80", "m0", "m6", "aq50")] + [("LA", "q80")]


@pytest.mark.parametrize("mask,setting", ALPHAS, ids=[f"{a}-{b}" for a, b in ALPHAS])
def test_pil_lossy_alpha_equals_pil(tmp_path, mask, setting):
    """PIL's lossy RGBA files (a hard mask, a soft one, noise; methods 0 and
    6, `alpha_quality` 50) and an LA file: `VP8X` + `ALPH` + `VP8 ` read as
    PIL reads them; the alpha's C++ equals the plain version."""
    h, w = 40, 48
    soft = fx.soft_alpha(h, w)
    a = {"hard": (soft > 128).astype(np.uint8) * 255, "soft": soft,
         "noise": fx.noise(h, w, 3)[..., 0], "LA": soft}[mask]
    kw = {"q80": dict(quality=80), "m0": dict(quality=80, method=0),
          "m6": dict(quality=80, method=6), "aq50": dict(quality=70, alpha_quality=50)}[setting]
    rgb = fx.natural(h, w, 4)
    src = (Image.fromarray(np.stack([rgb[..., 1], a], -1), "LA") if mask == "LA" else
           Image.fromarray(np.concatenate([rgb, a[..., None]], -1)))
    buf = io.BytesIO()
    src.save(buf, "WEBP", **kw)
    data = buf.getvalue()
    assert [t for t, _ in fx.chunks_of(data)][:2] == [b"VP8X", b"ALPH"]
    stats = _check(data, True, tmp_path)
    if setting == "aq50":
        assert stats["alpha_pre"] == 1


# ------------------------------------------------------ the writer's files
WRITER = {
    "predictor_14_modes": dict(transforms=("predictor",), predictor_bits=2),
    "predictor_modes_14_15": dict(transforms=("predictor",), predictor_modes=[14, 15, 0, 1]),
    "cross_color_seeded": dict(transforms=("cross_color",), cross_color="seeded",
                               cross_bits=2),
    "subtract_green": dict(transforms=("subtract_green",)),
    "all_four": dict(transforms=("subtract_green", "predictor", "cross_color")),
    "palette_then_predictor": dict(transforms=("palette", "predictor"), palette_n=16),
    "palette_2": dict(transforms=("palette",), palette_n=2),
    "palette_4": dict(transforms=("palette",), palette_n=4),
    "palette_16": dict(transforms=("palette",), palette_n=16),
    "palette_256": dict(transforms=("palette",), palette_n=256),
    "palette_past_its_end": dict(transforms=("palette",), palette_n=4, palette_entries=3),
    **{f"cache_{b}": dict(cache_bits=b, lz77=False) for b in range(1, 12)},
    "no_lz77": dict(lz77=False),
    "meta_3_groups": dict(meta_bits=2, meta_groups=3),
    "meta_per_tile": dict(meta_bits=3, meta_groups="tiles"),
    "max_symbol": dict(max_symbol=True),
    "normal_codes_only": dict(simple=False, palette_n=2),
    "alpha_bit_cleared": dict(alpha_used=False),
    "alpha_bit_set_opaque": dict(alpha_used=True, opaque=True),
}


def _writer_image(kw):
    rng = np.random.default_rng(7)
    img = _rgba(37, 53, 6)
    img[20:30, 5:45] = img[4:14, 5:45]                  # a long distance copy (16 rows up)
    img[30:37, :] = img[29:30, :]                       # rows of copies
    img[:3, :40] = (9, 99, 199, 255)                    # a flat run
    if "palette_n" in kw:
        n = kw.pop("palette_n")
        pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        img = pal[(np.arange(37 * 53).reshape(37, 53) * 7 // 5) % n]
    if kw.pop("opaque", False):
        img[..., 3] = 255
    if kw.get("meta_groups") == "tiles":
        kw["meta_groups"] = np.arange(vp8l._sub(53, 3) * vp8l._sub(37, 3)) % 5
    return img, kw


@pytest.mark.parametrize("case", list(WRITER))
def test_writer_branches_decode_in_pil(tmp_path, case):
    """`encode_vp8l` with each branch chosen by argument: PIL decodes its
    file to exactly the image written (RGB where the alpha bit is cleared),
    the C++ and the plain version agree, and the decoder's statistics show
    the branch."""
    img, kw = _writer_image(dict(WRITER[case]))
    data, written = webp.encode_webp(img, lossless=True, vp8l_options=kw)
    want = written if kw.get("alpha_used", True) else written[..., :3]
    if "palette_entries" in kw:                  # indices past the palette: transparent black
        argb = vp8l.rgba_to_argb(written)
        want = np.where((argb >= np.unique(argb)[kw["palette_entries"]])[..., None], 0, want)
    assert np.array_equal(fx.pil_array(data), want)
    s = _check(data, True, tmp_path)
    if case == "predictor_14_modes":
        assert s["predictor_modes"] == (1 << 14) - 1
    if case == "predictor_modes_14_15":
        assert s["predictor_modes"] >> 14 == 3
    if case.startswith("palette_"):
        assert s["palette"] == kw.get("palette_entries", len(np.unique(vp8l.rgba_to_argb(img))))
    if case == "palette_past_its_end":
        assert (fx.pil_array(data)[..., 3] == 0).any()
    if case.startswith("cache_"):
        assert s["cache_bits"] == int(case[6:]) and s["cache_hits"] > 0
    if case == "all_four":
        assert s["transforms"] == 3 and s["plane_copies"] and s["long_copies"]
        assert s["simple1"] and s["normal"] and s["rep16"] and s["rep17"] and s["rep18"]
    if case.startswith("meta"):
        assert s["groups"] >= 3
    if case == "max_symbol":
        assert s["max_symbol"] > 0
    if case == "normal_codes_only":
        assert s["simple1"] == s["simple2"] == 0
    if case == "no_lz77":
        assert s["copies"] == 0
    if case == "subtract_green":
        assert s["order"] == vp8l.TRANSFORMS["subtract_green"]


def test_writer_simple_two_symbol_codes(tmp_path):
    """A two-colour image writes simple codes of two symbols (the first 1 or
    8 bits wide) and of one; PIL reads it."""
    img = np.zeros((9, 13, 4), np.uint8)
    img[..., 3] = 255
    img[::2, :, 1] = 200                          # green {0, 200}: the first symbol 1 bit wide
    img[..., 0] = 5
    img[:, ::3, 0] = 9                            # red {5, 9}: 8 bits wide
    data, _ = webp.encode_webp(img, lossless=True, vp8l_options=dict(lz77=False))
    s = _check(data, True, tmp_path)
    assert s["simple2"] >= 2 and s["simple1"] >= 1


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_writer_alpha_filters_and_compressions(tmp_path, compression, filt):
    """Lossy + `ALPH` of each compression and filter (PIL writes only none and
    horizontal): PIL gives the writer's RGB and exactly the alpha written;
    a predictor-coded alpha takes the 32-bit path, a palette the 8-bit one."""
    img = _rgba(38, 45, filt)
    img[..., 3] = (img[..., 3].astype(int) * 7 + np.arange(45)) % 256
    for options in ({}, dict(transforms=("predictor",), cache_bits=3)):
        data, (y, u, v, a) = webp.encode_webp(img, alpha_compression=compression,
                                              alpha_filter=filt, alpha_options=options)
        want = fx.pil_array(data)
        assert np.array_equal(want[..., 3], img[..., 3]) and np.array_equal(a, img[..., 3])
        assert np.array_equal(want[..., :3], webp.yuv_to_rgb(y, u, v))
        s = _check(data, True, tmp_path)
        assert (s["alpha_method"], s["alpha_filter"]) == (compression, filt)
        if compression:
            assert s["alpha_8b"] == (not options)


@pytest.mark.parametrize("flags", [0, 3])
@pytest.mark.parametrize("lossless", [False, True])
def test_writer_animation_first_frame_at_an_offset(tmp_path, lossless, flags):
    """A 2-frame animation whose first frame (20x16) sits at (8, 6) of a 40x30
    canvas, `ANIM` background ignored: PIL's first frame, through the C++
    and the plain version; with the alpha flag cleared it opens as RGB. The
    first frame's dispose and no-blend bits (`flags` 3) change nothing: it
    is drawn onto a cleared canvas."""
    frames = [_rgba(16, 20, 1), _rgba(30, 40, 2)]
    for alpha in (True, False):
        data, decoded = webp.encode_animation(frames, (40, 30), offsets=[(8, 6), (0, 0)],
                                              alpha=alpha, lossless=lossless,
                                              background=(50, 100, 200, 255),
                                              frame_flags=[flags, flags])
        assert fx.chunks_of(data)[2][1][15] == flags
        want = fx.pil_array(data)
        assert want.shape == (30, 40, 4 if alpha else 3)
        first = decoded[0] if lossless else np.concatenate(
            [webp.yuv_to_rgb(*decoded[0][:3]), decoded[0][3][..., None]], -1)
        assert np.array_equal(want[6:22, 8:28], first[..., :want.shape[2]])
        assert not want[:6].any()
        _check(data, True, tmp_path)


def test_pil_animations_first_frame(tmp_path):
    """PIL's `save_all` files (lossy with alpha, lossless, RGB): the first
    frame as PIL opens it."""
    rgba, other = _rgba(30, 40, 3), _rgba(30, 40, 4)
    for src, kw in ((rgba, dict(quality=80)), (rgba, dict(lossless=True)),
                    (rgba[..., :3], dict(quality=60))):
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "WEBP", save_all=True,
                                  append_images=[Image.fromarray(other[..., :src.shape[2]])],
                                  **kw)
        assert [t for t, _ in fx.chunks_of(buf.getvalue())][:4] == [b"VP8X", b"ANIM", b"ANMF",
                                                                  b"ANMF"]
        _check(buf.getvalue(), True, tmp_path)


# ------------------------------------------------------ the mode rules
def _crafted(case: str) -> bytes:
    rgba = _rgba(16, 20, 5)
    ll = fx.chunks_of(fx.pil_webp(rgba, lossless=True))[0][1]
    vp8x = lambda flags: (b"VP8X", bytes([flags, 0, 0, 0]) + (19).to_bytes(3, "little")  # noqa
                          + (15).to_bytes(3, "little"))
    if case == "vp8l_alpha_bit_cleared":
        cleared = bytearray(ll)
        cleared[4] &= ~0x10
        return fx.from_chunks([(b"VP8L", bytes(cleared))])
    if case == "vp8x_without_flag_vp8l_alpha":
        return fx.from_chunks([vp8x(0), (b"VP8L", ll)])
    lossy = fx.chunks_of(fx.pil_webp(rgba, quality=80))
    alph, frame = dict(lossy)[b"ALPH"], dict(lossy)[b"VP8 "]
    if case == "vp8x_without_flag_alph":
        return fx.from_chunks([vp8x(0), (b"ALPH", alph), (b"VP8 ", frame)])
    if case == "vp8x_flag_no_alph":
        return fx.from_chunks([vp8x(0x10), (b"VP8 ", frame)])
    if case == "animation_without_flag":
        return webp.encode_animation([rgba, rgba[::-1].copy()], (20, 16), alpha=False)[0]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["vp8l_alpha_bit_cleared", "vp8x_without_flag_vp8l_alpha",
                                  "vp8x_without_flag_alph", "vp8x_flag_no_alph",
                                  "animation_without_flag"])
def test_mode_rules_of_crafted_files(tmp_path, case):
    """The five crafted containers open with PIL's mode and bytes: a VP8L
    whose alpha bit is cleared is RGB; `VP8X` without the alpha flag
    holding an alpha VP8L is RGBA; `VP8X` without the flag with an `ALPH`
    is RGBA with alpha 255 (the ALPH ignored); the flag with no `ALPH` is
    RGBA with alpha 255; an animation without the flag is RGB."""
    data = _crafted(case)
    want = fx.pil_array(data)
    _check(data, True, tmp_path, libwebp=case != "vp8x_without_flag_alph")
    if case in ("vp8x_without_flag_alph", "vp8x_flag_no_alph"):
        assert want.shape[2] == 4 and (want[..., 3] == 255).all()
    assert want.shape[2] == (3 if case in ("vp8l_alpha_bit_cleared",
                                           "animation_without_flag") else 4)


@pytest.mark.parametrize("case", ["alph_before_vp8l", "frame_past_canvas", "canvas",
                                  "alpha_header", "raw_alpha_short", "anmf_before_anim"])
def test_refused_containers_raise_where_pil_raises(case):
    """Containers and alpha headers libwebp refuses raise, naming the cause,
    through both decoders: an `ALPH` before a `VP8L`, an animation frame
    past the canvas, a canvas other than the frame, reserved or unknown
    alpha header bits, raw alpha short of the canvas, `ANMF` before
    `ANIM`."""
    rgba = _rgba(16, 20, 5)
    ll = fx.chunks_of(fx.pil_webp(rgba, lossless=True))[0][1]
    lossy = dict(fx.chunks_of(fx.pil_webp(rgba, quality=80)))
    head = (b"VP8X", bytes([0x10, 0, 0, 0]) + (19).to_bytes(3, "little")
            + (15).to_bytes(3, "little"))
    data, words = {
        "alph_before_vp8l": (fx.from_chunks([head, (b"ALPH", lossy[b"ALPH"]), (b"VP8L", ll)]),
                             "ALPH chunk before a VP8L"),
        "frame_past_canvas": (webp.encode_animation([rgba], (20, 16), offsets=[(2, 0)])[0],
                              "does not fit"),
        "canvas": (fx.from_chunks([(b"VP8X", head[1][:4] + (20).to_bytes(3, "little")
                                    + (15).to_bytes(3, "little")), (b"VP8L", ll)]), "canvas"),
        "alpha_header": (fx.from_chunks([head, (b"ALPH", bytes([lossy[b"ALPH"][0] | 0x40])
                                                + lossy[b"ALPH"][1:]),
                                         (b"VP8 ", lossy[b"VP8 "])]), "reserved"),
        "raw_alpha_short": (fx.from_chunks([head, (b"ALPH", bytes(1 + 20 * 16 - 1)),
                                            (b"VP8 ", lossy[b"VP8 "])]), "fewer bytes"),
        "anmf_before_anim": (fx.from_chunks([
            c for c in fx.chunks_of(webp.encode_animation([rgba], (20, 16))[0])
            if c[0] != b"ANIM"]), "before the ANIM"),
    }[case]
    assert fx.pil_array(data) is None
    for fn in (webp.decode_webp, webp.decode_webp_plain):
        with pytest.raises(ValueError, match=words):
            fn(data)


# ------------------------------------------------------ damaged and cut streams
@pytest.mark.parametrize("kind", ["vp8l", "alpha"])
def test_damaged_streams_cpp_equals_plain(kind):
    """48 files with 1-3 bits flipped in their `VP8L` chunk (a PIL file with
    a cache, the writer's 4-transform, meta-coded one) or `ALPH` chunk (on
    each alpha path): the C++ and the plain version give the same bytes or
    the same error, and PIL the same bytes or an error."""
    img = _rgba(21, 27, 8)
    if kind == "vp8l":
        tag, sources = b"VP8L", [fx.pil_webp(img, lossless=True, quality=50),
                                 webp.encode_webp(img, lossless=True, vp8l_options=dict(
                                     transforms=("subtract_green", "predictor", "cross_color"),
                                     meta_bits=2, meta_groups=3, cache_bits=4))[0]]
    else:
        tag, sources = b"ALPH", [webp.encode_webp(img, alpha_filter=f, alpha_options=o)[0]
                                 for f, o in ((1, {}), (3, dict(transforms=("predictor",))))]
    n_fail = 0
    for k in range(48):
        rng = np.random.default_rng(k)
        chunks = []
        for t, body in fx.chunks_of(sources[k % 2]):
            if t == tag:
                body = bytearray(body)
                for _ in range(1 + k % 3):
                    body[int(rng.integers(5 if kind == "vp8l" else 1, len(body)))] ^= \
                        1 << int(rng.integers(0, 8))
                body = bytes(body)
            chunks.append((t, body))
        bad = fx.from_chunks(chunks)
        cpp, plain = _outcome(webp.decode_webp, bad), _outcome(webp.decode_webp_plain, bad)
        assert _same(cpp, plain), (k, cpp if isinstance(cpp, str) else "pixels", plain)
        want = fx.pil_array(bad)
        assert isinstance(cpp, str) if want is None else _same(cpp, want), k
        n_fail += isinstance(cpp, str)
    assert 0 < n_fail < 48


def _cut_outcomes(data: bytes, tag: bytes):
    out = []
    for k in range(25):
        cut = fx.cut_chunk(data, tag, k)
        want = fx.pil_array(cut)
        got = _outcome(webp.decode_webp, cut)
        plain = _outcome(webp.decode_webp_plain, cut)
        assert _same(got, plain), k
        if want is None:
            assert isinstance(got, str) and "cut short" in got, (k, got)
            out.append("raises")
        else:
            assert _same(got, want), k
            out.append("same" if np.array_equal(want, fx.pil_array(data)) else "other")
    return out


def test_cut_vp8l_chunk_as_pil():
    """Every cut of 0-24 bytes of an 80x64 lossless file: C++ = plain = PIL,
    "cut short" where PIL raises, other pixels where PIL gives other pixels
    (a cut by 2: the zeros read past the end, within the pad byte, still
    complete the image)."""
    out = _cut_outcomes(fx.pil_webp(fx.natural(64, 80, 2), lossless=True), b"VP8L")
    assert out[0] == "same" and out[1] == "raises" and out[2] == "other"
    assert out[3:] == ["raises"] * 22


@pytest.mark.parametrize("path", ["32bit", "8bit"])
def test_cut_alph_chunk_as_pil(path):
    """Every cut of 0-24 bytes of an 80x64 lossy file's `ALPH`: a failed
    alpha plane fails the whole decode, as in PIL; on libwebp's 8-bit alpha
    path the last pixels' reads may run past the end and decode to other
    pixels, as PIL does (there the alpha's last 4 rows repeat those 16 rows
    up: the stream ends in a long copy)."""
    img = _rgba(64, 80, 3)
    if path == "8bit":
        img[-4:, :, 3] = img[-20:-16, :, 3]
    data = (fx.pil_webp(img, quality=80) if path == "32bit" else
            webp.encode_webp(img, alpha_filter=1)[0])
    out = _cut_outcomes(data, b"ALPH")
    assert out[0] == "same" and out.count("raises") >= 20
    if path == "8bit":
        assert "other" in out


# ------------------------------------------------------ tables and fixtures
def _cpp_table(name: str) -> bytes:
    src = open(os.path.join(ROOT, "gaussianmesh_tpu_torch", "csrc", "vp8l.cpp")).read()
    m = re.search(r"(uint8_t|uint16_t) " + name + r"\[\w*\] = \{(.*?)\};", src, re.S)
    body = m.group(2).replace("NUM_LITERAL_CODES + NUM_LENGTH_CODES", "280").replace(
        "NUM_DISTANCE_CODES", "40")
    vals = [int(t, 0) for t in re.findall(r"0x[0-9a-f]+|\d+", body)]
    return np.array(vals, {"uint8_t": np.uint8, "uint16_t": "<u2"}[m.group(1)]).tobytes()


TABLES = {"kCodeLengthCodeOrder": vp8l.CODE_LENGTH_ORDER,
          "kCodeLengthExtraBits": vp8l.CODE_LENGTH_EXTRA_BITS,
          "kCodeLengthRepeatOffsets": vp8l.CODE_LENGTH_REPEAT_OFFSETS,
          "kAlphabetSize": vp8l.ALPHABET_SIZE, "kCodeToPlane": vp8l.CODE_TO_PLANE}


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_are_libwebps(name):
    """Each table of `csrc/vp8l.cpp` equals `io/vp8l.py`'s and is found in
    libwebp's binary."""
    blob = open(fx.libwebp_path(), "rb").read()
    cpp = _cpp_table(name)
    py = np.array(TABLES[name], "<u2" if name == "kAlphabetSize" else np.uint8).tobytes()
    assert cpp == py and cpp in blob


def test_rgba_fixture_digests_are_pil_and_libwebp():
    """rgba/digests.json is what PIL and libwebp give on each fixture today,
    every fixture is listed, and between them they hold VP8L, ALPH (both
    alpha paths, raw and filtered) and animations, and cuts that raise and
    that decode to other pixels."""
    table = json.load(open(os.path.join(FIXTURES, "digests.json")))
    assert set(table) == set(os.listdir(FIXTURES)) - {"digests.json"} and len(table) >= 15
    total = 0
    for name, want in table.items():
        data = open(os.path.join(FIXTURES, name), "rb").read()
        total += len(data)
        assert fx.rgba_digests(data, LIBWEBP) == want, name
    assert total <= 96 * 1024
    cuts = [v["array"] for k, v in table.items() if k.startswith("cut")]
    assert "raises" in cuts and any(c != "raises" for c in cuts)


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES,
                                                                    "digests.json")))))
def test_rgba_fixture_decodes_to_its_digest(name):
    """Each fixture through `read_image` and the plain version gives PIL's
    recorded digest and shape, or raises "cut short" where PIL raised."""
    want = json.load(open(os.path.join(FIXTURES, "digests.json")))[name]
    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    if want["array"] == "raises":
        for fn in (webp.decode_webp, webp.decode_webp_plain):
            with pytest.raises(ValueError, match="cut short"):
                fn(data)
        return
    for got in (png.read_image(path), webp.decode_webp_plain(data)):
        assert list(got.shape) == want["shape"] and fx.sha(got) == want["array"]


def test_a_broken_vp8l_source_raises(tmp_path, monkeypatch):
    """A broken `vp8l.cpp` raises with the compiler's output: nothing falls
    back to the plain version."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    (tmp_path / "vp8l.cpp").write_text("int gm_vp8l_decode( {")
    _cuda.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for vp8l"):
            webp.decode_webp(open(os.path.join(FIXTURES, "pil_lossless_rgb_80x64.webp"),
                                  "rb").read())
    finally:
        _cuda.host_library.cache_clear()


# ------------------------------------------------------ a scene
def _webp_blender_set(root):
    """`tests/test_torch_cli_train.py`'s 64 px Blender set with its RGBA views
    rewritten as WebPs: lossless by PIL and by the writer, lossy + ALPH by
    PIL and by the writer (each filter), a 2-frame animation; the frames'
    file paths name the `.webp` files. -> the proxy mesh's path."""
    from tests.test_torch_cli_train import _make_dataset

    mesh = _make_dataset(root)
    for split in ("train", "test"):
        tf = os.path.join(root, f"transforms_{split}.json")
        meta = json.load(open(tf))
        for fr in meta["frames"]:
            i = int(fr["file_path"].rsplit("_", 1)[1])
            src = os.path.join(root, fr["file_path"] + ".png")
            dst = os.path.join(root, fr["file_path"] + ".webp")
            if not os.path.exists(dst):
                img = np.asarray(Image.open(src))
                if i % 5 == 0:
                    Image.fromarray(img).save(dst, "WEBP", lossless=True)
                elif i % 5 == 1:
                    webp.write_webp(dst, img, lossless=True, vp8l_options=dict(
                        transforms=("subtract_green", "predictor", "cross_color"),
                        cache_bits=8))
                elif i % 5 == 2:
                    Image.fromarray(img).save(dst, "WEBP", quality=85)
                elif i % 5 == 3:
                    webp.write_webp(dst, img, alpha_filter=i % 4, quality_index=20)
                else:
                    webp.write_webp_animation(dst, [img, img[::-1].copy()], (64, 64))
            fr["file_path"] += ".webp"
        json.dump(meta, open(tf, "w"))
    for name in os.listdir(os.path.join(root, "train")):
        if name.endswith(".png"):
            os.remove(os.path.join(root, "train", name))
    return mesh


def test_webp_blender_scene_matches_jax_and_trains(tmp_path):
    """A Blender set of RGBA WebP views goes through `read_scene` with and
    without a white background as the JAX reader reads it (images and
    masks), and `cli.train_mesh --device cpu` trains 2 iterations on it."""
    root = str(tmp_path / "s")
    mesh = _webp_blender_set(root)
    for white in (True, False):
        for resolution in (1, 2):
            kw = dict(resolution=resolution, white_background=white, eval_split=True)
            got = readers.read_scene(root, **kw)
            _assert_scene_equal(got, jreaders.read_scene(root, **kw))
            assert all(c.mask is not None for c in got.train_cameras)
    tr = train_mesh.main(["-s", root, "-m", str(tmp_path / "m"), "--input_mesh", mesh,
                          "--eval", "--iterations", "2", "--device", "cpu",
                          "--init_target", "300", "--sh_degree", "1",
                          "--max_per_tile", "256", "--save_iterations", "2"])
    assert tr.global_it == 2
    for name, p in tr.model.params().items():
        assert torch.isfinite(p).all(), name


def test_webp_scene_never_calls_a_plain_version(tmp_path, monkeypatch):
    """`read_scene` of the WebP Blender set with every plain piece of
    `io/vp8l.py` and `io/webp.py` made to raise: the same scene as before."""
    root = str(tmp_path / "s")
    _webp_blender_set(root)
    before = readers.read_scene(root, resolution=2, eval_split=True)

    def plain(*_a, **_k):
        raise AssertionError("a plain version was called")
    for mod, names in ((vp8l, ("vp8l_decode_plain", "alpha_decode_plain", "_Plain", "_Reader",
                               "_read_symbol", "_build_code", "_unfilter_plain")),
                       (webp, ("vp8_decode_plain", "yuv_to_rgb_plain", "decode_webp_plain",
                               "_Bits"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    after = readers.read_scene(root, resolution=2, eval_split=True)
    for a, b in zip(before.train_cameras + before.test_cameras,
                    after.train_cameras + after.test_cameras):
        assert np.array_equal(a.image, b.image) and np.array_equal(a.mask, b.mask)
