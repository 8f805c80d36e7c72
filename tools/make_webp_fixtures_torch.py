"""Writes the lossy WebP fixtures of `tests/data/webp/` and their digests,
for the tests and `chip_smoke.py`'s phase 9d (the card's machine has no PIL
and no libwebp to check the port's decoder against).

    python tools/make_webp_fixtures_torch.py [--out tests/data/webp]

Runs only where PIL is installed: the files are PIL-written (libwebp's
encoder: B_PRED with all ten sub-modes, 4 segments, the normal filter,
DCT_CAT6, skipped macroblocks, odd sizes, `VP8X` with ICC and EXIF) or `io/webp.py::write_webp`
(the simple filter on 8 token partitions, sharpness with filter-level
deltas), plus one PIL file cut by 2 and by 3 bytes in its last partition
with the RIFF and `VP8 ` sizes repaired. `digests.json` holds, per file,
the SHA-256 of PIL's `convert("RGB")` bytes and of libwebp's
`WebPDecodeYUV` planes (Y, then U, then V), or "raises". libwebp is PIL's
bundled copy, loaded with ctypes; nothing of this runs in the port.
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
    size = struct.unpack_from("<I", data, 16)[0]
    frame = data[20:20 + size - k]
    body = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\x00" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


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
    print(json.dumps({"files": len(table),
                      "bytes": sum(os.path.getsize(os.path.join(args.out, n)) for n in table)}))


if __name__ == "__main__":
    main()
