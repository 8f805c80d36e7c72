"""Writes the WebP fixtures of `tests/data/webp/` and their digests, for
the tests and `chip_smoke.py`'s phases 9d and 9e (the card's machine has no PIL
and no libwebp to check the port's decoder against).

    python tools/make_webp_fixtures_torch.py [--out tests/data/webp]

Runs only where PIL is installed: the files are PIL-written (libwebp's
encoder: B_PRED with all ten sub-modes, 4 segments, the normal filter,
DCT_CAT6, skipped macroblocks, odd sizes, `VP8X` with ICC and EXIF) or `io/webp.py::write_webp`
(the simple filter on 8 token partitions, sharpness with filter-level
deltas), plus one PIL file cut by 2 and by 3 bytes in its last partition
with the RIFF and `VP8 ` sizes repaired. `digests.json` holds, per file,
the SHA-256 of PIL's `convert("RGB")` bytes and of libwebp's
`WebPDecodeYUV` planes (Y, then U, then V), or "raises". `rgba/` holds
lossless (VP8L), lossy-with-alpha (ALPH) and animated files, PIL's and
`io/webp.py`'s writer's (all four VP8L transforms, a colour cache, meta
codes, a gradient-filtered alpha, an animation's frame at an offset), and
cuts in a `VP8L` and an `ALPH` chunk; its `digests.json` holds, per file,
the SHA-256 of PIL's `np.asarray(Image.open(...))` and its shape, and of
libwebp's `WebPDecodeRGBA`, or "raises". libwebp is PIL's bundled copy,
loaded with ctypes; nothing of this runs in the port.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "webp")


def libwebp_library() -> ctypes.CDLL:
    """PIL's bundled libwebp (its libsharpyuv loaded first, globally)."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    lib.WebPDecodeYUV.restype = ctypes.c_void_p
    lib.WebPDecodeYUV.argtypes = ([ctypes.c_char_p, ctypes.c_size_t]
                                  + [ctypes.POINTER(ctypes.c_int)] * 2
                                  + [ctypes.POINTER(ctypes.c_void_p)] * 2
                                  + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    return lib


def libwebp_rgba(data: bytes, lib: ctypes.CDLL | None = None):
    """libwebp's `WebPDecodeRGBA` of a file -> (H, W, 4) uint8, or None where
    it fails."""
    lib = lib or libwebp_library()
    lib.WebPDecodeRGBA.restype = ctypes.c_void_p
    lib.WebPDecodeRGBA.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    w, h = ctypes.c_int(), ctypes.c_int()
    p = lib.WebPDecodeRGBA(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if not p:
        return None
    buf = (ctypes.c_uint8 * (4 * w.value * h.value)).from_address(p)
    out = np.ctypeslib.as_array(buf).reshape(h.value, w.value, 4).copy()
    lib.WebPFree(p)
    return out


def libwebp_path() -> str:
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    return glob.glob(os.path.join(libs, "libwebp-*.so*"))[0]


def libwebp_yuv(data: bytes, lib: ctypes.CDLL | None = None):
    """libwebp's `WebPDecodeYUV` of a file -> (Y, U, V) uint8, or None where
    it fails."""
    lib = lib or libwebp_library()
    w, h, st, uvst = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.c_void_p(), ctypes.c_void_p()
    yp = lib.WebPDecodeYUV(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(u),
                           ctypes.byref(v), ctypes.byref(st), ctypes.byref(uvst))
    if not yp:
        return None
    W, H = w.value, h.value
    uw, uh = (W + 1) // 2, (H + 1) // 2

    def plane(addr, stride, rows, cols):
        buf = (ctypes.c_uint8 * (stride * rows)).from_address(addr)
        return np.ctypeslib.as_array(buf).reshape(rows, stride)[:, :cols].copy()
    out = (plane(yp, st.value, H, W), plane(u.value, uvst.value, uh, uw),
           plane(v.value, uvst.value, uh, uw))
    lib.WebPFree(yp)
    return out


def pil_rgb(data: bytes):
    """PIL's `Image.open(...).convert("RGB")` of a file, or None where it raises."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def pil_array(data: bytes):
    """`np.asarray(Image.open(...))` of a file (what the JAX reader reads), or
    None where PIL raises."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)))
    except Exception:
        return None


def pil_webp(img: np.ndarray, **kwargs) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kwargs)
    return buf.getvalue()


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def digests(data: bytes, lib: ctypes.CDLL | None = None) -> dict:
    """{"rgb": PIL's digest, "yuv": libwebp's planes' digest}, "raises" where
    either fails."""
    rgb, yuv = pil_rgb(data), libwebp_yuv(data, lib)
    return {"rgb": "raises" if rgb is None else sha(rgb),
            "yuv": "raises" if yuv is None else sha(*yuv)}


def cut(data: bytes, k: int) -> bytes:
    """A simple lossy file with `k` bytes cut from its frame's end (the last
    token partition), the `VP8 ` and RIFF sizes repaired (an odd frame gets
    its pad byte)."""
    assert data[12:16] == b"VP8 "
    return cut_chunk(data, b"VP8 ", k)


def natural(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded picture: smooth waves, noise, a flat block and hard edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    a = np.stack([128 + 90 * np.sin(xx / (5 + seed)), 128 + 90 * np.cos(yy / 7 + xx / 11),
                  128 + 60 * np.sin(xx * yy / 97)], -1)
    a += rng.normal(0, 12, a.shape)
    a[h // 4:h // 2, w // 3:w // 2] = (240, 30, 30)
    a[(xx.astype(int) // 9 + yy.astype(int) // 6) % 5 == 0] = (10, 200, 40)
    return np.clip(a, 0, 255).astype(np.uint8)


def noise(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def files() -> dict[str, bytes]:
    """name -> bytes of every fixture."""
    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import webp

    # a picture whose cut by 2 bytes raises and by 3 decodes to other pixels
    base = pil_webp(np.clip(natural(64, 80, 3).astype(int) + noise(64, 80, 44) // 8, 0, 255)
                    .astype(np.uint8), quality=80)
    flat = np.full((64, 96, 3), 120, np.uint8)
    flat[10:20, 10:30] = (200, 50, 50)
    out = {
        "pil_q100_noise_61x47.webp": pil_webp(noise(47, 61, 1), quality=100),
        "pil_q80_natural_93x67.webp": pil_webp(natural(67, 93, 2), quality=80),
        "pil_q30_m6_natural_77x45.webp": pil_webp(natural(45, 77, 4), quality=30, method=6),
        "pil_q0_m0_natural_33x17.webp": pil_webp(natural(17, 33, 5), quality=0, method=0),
        "pil_q95_gray_40x31.webp": pil_webp(natural(31, 40, 6)[..., 1], quality=95),
        "pil_q75_icc_50x41.webp": pil_webp(natural(41, 50, 7), quality=75,
                                           icc_profile=b"\x00" * 131),
        "pil_q90_exif_1x1.webp": pil_webp(natural(1, 1, 8), quality=90, exif=b"Exif\x00\x00MM"),
        "pil_q50_m0_flat_96x64.webp": pil_webp(flat, quality=50, method=0),
        "pil_q80_natural_80x64.webp": base,
        "writer_simple_8parts_70x54.webp": webp.encode_webp(
            natural(54, 70, 9), quality_index=40, filter="simple", level=32, partitions=8)[0],
        "writer_sharp_lfdelta_4seg_66x38.webp": webp.encode_webp(
            natural(38, 66, 10), quality_index=12, segments=4, filter="normal", level=30,
            sharpness=5, ref_lf_delta=(4, -2, 0, 1), mode_lf_delta=(-3, 1, 2, 0),
            partitions=2)[0],
        "cut2_pil_q80_natural_80x64.webp": cut(base, 2),
        "cut3_pil_q80_natural_80x64.webp": cut(base, 3),
    }
    return out


def chunks_of(data: bytes) -> list:
    """A WebP's top-level chunks -> [(tag, payload)]."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def from_chunks(chunks) -> bytes:
    """[(tag, payload)] -> a WebP, each chunk padded to an even size."""
    body = b"".join(t + struct.pack("<I", len(b)) + b + b"\x00" * (len(b) & 1)
                    for t, b in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def cut_chunk(data: bytes, tag: bytes, k: int) -> bytes:
    """A WebP with `k` bytes cut from the end of its chunk `tag`, the chunk
    and RIFF sizes repaired."""
    return from_chunks([(t, b[:len(b) - k] if t == tag else b) for t, b in chunks_of(data)])


def soft_alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    return np.clip(255 - np.hypot(xx - w / 2, yy - h / 2) * 300 / max(h, w), 0,
                   255).astype(np.uint8)


def rgba_digests(data: bytes, lib: ctypes.CDLL | None = None) -> dict:
    """{"array": the digest of PIL's `np.asarray(Image.open(...))`, "shape":
    its shape, "rgba": libwebp's `WebPDecodeRGBA`'s}, "raises" where either
    fails."""
    arr, rgba = pil_array(data), libwebp_rgba(data, lib)
    return {"array": "raises" if arr is None else sha(arr),
            "shape": None if arr is None else list(arr.shape),
            "rgba": "raises" if rgba is None else sha(rgba)}


def rgba_files() -> dict[str, bytes]:
    """name -> bytes of every fixture of `rgba/`: lossless (VP8L), lossy with
    alpha (ALPH) and animated files, PIL's and the port's writer's, and cut
    ones."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import webp

    def rgba(h, w, seed):
        return np.concatenate([natural(h, w, seed), soft_alpha(h, w)[..., None]], -1)
    hard = (soft_alpha(41, 50) > 128).astype(np.uint8) * 255
    lossless = pil_webp(natural(64, 80, 2), lossless=True)
    soft = pil_webp(rgba(64, 80, 3), quality=80)
    hard8 = pil_webp(np.concatenate([natural(41, 50, 4), hard[..., None]], -1), quality=80)
    pal = natural(31, 40, 5) // 64 * 64
    anim = io.BytesIO()
    Image.fromarray(rgba(30, 40, 6)).save(anim, "WEBP", save_all=True, quality=80,
                                          append_images=[Image.fromarray(rgba(30, 40, 7))])
    frames = [rgba(16, 20, 8), rgba(30, 40, 9)]
    # libwebp's 8-bit alpha path; the alpha's last 4 rows repeat those 16 rows
    # up, so the stream ends in a long copy whose cut reads decode
    last_copy = rgba(64, 80, 17)
    last_copy[-4:, :, 3] = last_copy[-20:-16, :, 3]
    paletted = webp.encode_webp(last_copy, alpha_filter=1)[0]
    return {
        "pil_lossless_rgb_80x64.webp": lossless,
        "pil_lossless_rgba_m6_61x47.webp": pil_webp(rgba(47, 61, 10), lossless=True, method=6),
        "pil_lossless_exact_q100_33x17.webp": pil_webp(rgba(17, 33, 11), lossless=True,
                                                       quality=100, exact=True),
        "pil_lossless_palette_40x31.webp": pil_webp(pal, lossless=True),
        "pil_lossy_soft_alpha_80x64.webp": soft,
        "pil_lossy_hard_alpha_50x41.webp": hard8,
        "pil_lossy_noise_alpha_45x31.webp": pil_webp(np.concatenate(
            [natural(31, 45, 12), noise(31, 45, 13)[..., :1]], -1), quality=80),
        "pil_lossy_alpha_q50_48x40.webp": pil_webp(rgba(40, 48, 14), quality=70,
                                                   alpha_quality=50),
        "pil_anim_2frames_40x30.webp": anim.getvalue(),
        "writer_lossless_transforms_cache_meta_70x54.webp": webp.encode_webp(
            rgba(54, 70, 15), lossless=True, vp8l_options=dict(
                transforms=("subtract_green", "predictor", "cross_color"), cache_bits=6,
                meta_bits=3, meta_groups=3, cross_color="seeded", max_symbol=True))[0],
        "writer_alpha_gradient_66x38.webp": webp.encode_webp(
            rgba(38, 66, 16), quality_index=40, alpha_filter=3,
            alpha_options=dict(transforms=("predictor",)))[0],
        "writer_anim_offset_40x30.webp": webp.encode_animation(
            frames, (40, 30), offsets=[(8, 6), (0, 0)], lossless=True)[0],
        "cut1_pil_lossless_rgb_80x64.webp": cut_chunk(lossless, b"VP8L", 1),
        "cut2_pil_lossless_rgb_80x64.webp": cut_chunk(lossless, b"VP8L", 2),
        "cut5_pil_lossy_soft_alpha_80x64.webp": cut_chunk(soft, b"ALPH", 5),
        "cut1_writer_alpha_palette_80x64.webp": cut_chunk(paletted, b"ALPH", 1),
        "cut3_writer_alpha_palette_80x64.webp": cut_chunk(paletted, b"ALPH", 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    lib = libwebp_library()
    table = {}
    for name, data in files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table[name] = digests(data, lib)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    sub = os.path.join(args.out, "rgba")
    os.makedirs(sub, exist_ok=True)
    rgba_table = {}
    for name, data in rgba_files().items():
        with open(os.path.join(sub, name), "wb") as f:
            f.write(data)
        rgba_table[name] = rgba_digests(data, lib)
    with open(os.path.join(sub, "digests.json"), "w") as f:
        json.dump(rgba_table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"files": len(table) + len(rgba_table), "bytes": sum(
        os.path.getsize(os.path.join(d, n)) for d, t in ((args.out, table), (sub, rgba_table))
        for n in t)}))


if __name__ == "__main__":
    main()
