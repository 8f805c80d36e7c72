"""Writes the Zstandard TIFF (compression 50000) fixtures of
`tests/data/tiff_zstd/` and their digests, for the tests and
`chip_smoke.py`'s phase 9f (the card's machine has no PIL, no libtiff and
no libzstd to check the port's reader against).

    python tools/make_tiff_zstd_fixtures_torch.py [--out tests/data/tiff_zstd]

Runs only where PIL is installed. The files are PIL-written (libtiff at
libzstd's default level: modes L, LA, RGB, RGBA, P, 1, I;16 and CMYK,
Predictor 2, strips of 16 rows, 1x1 and 257x131, one strip of more than
128 KiB, a noise image and a flat one) or one-strip containers built here
around libzstd frames (levels -5, 1, 19 and 22, a checksum, no content
size, window logs 10-27), and the forms libtiff's `ZSTDDecode` was probed
with: two frames of half a strip each, a skippable frame first, a frame cut
by 3 bytes, a bad checksum, a window past libzstd's limit, a dictionary ID
and the reserved bit (PIL fails on each), trailing bytes and a frame that
gives more than the strip (PIL reads both).

`digests.json` holds, per file, PIL's mode, the rule the port applies
(none; B7: I;16 -> its high byte; B14: CMYK and B15: P -> PIL's
`convert("RGB")`; B16: mode 1 -> 0 / 255) and the SHA-256 and shape of the
array it gives, or, where PIL fails, no array and PIL's error.

libzstd is `zstandard`'s where importable, else PIL's bundled copy loaded
with ctypes; `libtiff_decode` replays libtiff's `ZSTDDecode` loop on PIL's
libzstd (the tests' oracle). Nothing of this runs in the port.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import glob
import hashlib
import io
import json
import os
import struct

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "tiff_zstd")
SKIPPABLE = 0x184D2A50


# ------------------------------------------------------------------ libzstd
@functools.cache
def libzstd() -> ctypes.CDLL | None:
    """PIL's bundled libzstd, or None where it cannot be loaded."""
    try:
        import PIL
    except ImportError:
        return None
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                   "libzstd-*.so*"))
    if not found:
        return None
    lib = ctypes.CDLL(found[0])
    p, s = ctypes.c_void_p, ctypes.c_size_t
    for name, res, args in (
            ("ZSTD_createDStream", p, []), ("ZSTD_initDStream", s, [p]),
            ("ZSTD_freeDStream", s, [p]), ("ZSTD_isError", ctypes.c_uint, [s]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [s]),
            ("ZSTD_decompressStream", s, [p, p, p]), ("ZSTD_createCCtx", p, []),
            ("ZSTD_freeCCtx", s, [p]), ("ZSTD_CCtx_setParameter", s, [p, ctypes.c_int,
                                                                      ctypes.c_int]),
            ("ZSTD_compress2", s, [p, p, s, p, s]), ("ZSTD_compressBound", s, [s])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    return lib


def available() -> bool:
    """Whether a libzstd is here (`zstandard` or PIL's)."""
    try:
        import zstandard  # noqa: F401
        return True
    except ImportError:
        return libzstd() is not None


def compress(data: bytes, level: int = 3, checksum: bool = False, content_size: bool = True,
             window_log: int = 0) -> bytes:
    """One libzstd frame of `data`."""
    try:
        import zstandard
    except ImportError:
        zstandard = None
    if zstandard is not None:
        params = zstandard.ZstdCompressionParameters.from_level(
            level, window_log=window_log, write_checksum=checksum,
            write_content_size=content_size)
        return zstandard.ZstdCompressor(compression_params=params).compress(data)
    lib = libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:       # ZSTD_c_compressionLevel, windowLog, contentSizeFlag, checksumFlag
        for param, value in ((100, level), (101, window_log), (200, int(content_size)),
                             (201, int(checksum))):
            lib.ZSTD_CCtx_setParameter(cctx, param, value)
        cap = lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, dst, cap, data, len(data))
        if lib.ZSTD_isError(n):
            raise ValueError(lib.ZSTD_getErrorName(n).decode())
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


class _Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def libtiff_decode(data: bytes, size: int) -> tuple[bytes, bool]:
    """libtiff's `ZSTDDecode` of one strip: `ZSTD_decompressStream` into a
    `size`-byte buffer, the strip as its input, until the frame ends, the
    buffer is full or the input runs out -> (the bytes, whether the frame
    ended); raises ValueError with libzstd's error. Without PIL's libzstd,
    `zstandard`'s streaming decoder stands in (it reads the whole frame)."""
    lib = libzstd()
    if lib is None:
        import zstandard
        dobj = zstandard.ZstdDecompressor().decompressobj()
        try:
            out = dobj.decompress(data)
        except zstandard.ZstdError as err:
            raise ValueError(str(err)) from None
        return out[:size], dobj.eof
    ds = lib.ZSTD_createDStream()
    lib.ZSTD_initDStream(ds)
    src = ctypes.create_string_buffer(bytes(data), max(len(data), 1))
    dst = ctypes.create_string_buffer(max(size, 1))
    inp = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    out = _Buffer(ctypes.cast(dst, ctypes.c_void_p), size, 0)
    try:
        while True:
            r = lib.ZSTD_decompressStream(ds, ctypes.byref(out), ctypes.byref(inp))
            if lib.ZSTD_isError(r):
                raise ValueError(lib.ZSTD_getErrorName(r).decode())
            if r == 0 or inp.pos >= inp.size or out.pos >= out.size:
                return dst.raw[:out.pos], r == 0
    finally:
        lib.ZSTD_freeDStream(ds)


# ------------------------------------------------------------------ containers
def container(strips: list, width: int, height: int, rows_per_strip: int | None = None,
              spp: int = 1, predictor: int = 1) -> bytes:
    """A little-endian 8-bit gray (spp 1) or RGB (spp 3) TIFF of
    compression 50000 whose strips are the given bytes."""
    rps = rows_per_strip or height
    tags = [(256, 4, [width]), (257, 4, [height]), (258, 3, [8] * spp), (259, 3, [50000]),
            (262, 3, [1 if spp == 1 else 2]), (273, 4, [0] * len(strips)), (277, 3, [spp]),
            (278, 4, [rps]), (279, 4, [len(s) for s in strips])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    tags.sort()
    blob_at = 8 + 2 + 12 * len(tags) + 4
    sizes = [(2 if t == 3 else 4) * len(v) for _, t, v in tags]
    data_at = blob_at + sum(s for s in sizes if s > 4)
    offsets = list(np.cumsum([0] + [len(s) for s in strips])[:-1] + data_at)
    entries, blob = [], b""
    for (tag, typ, vals), size in zip(tags, sizes):
        vals = offsets if tag == 273 else vals
        packed = struct.pack("<" + ("H" if typ == 3 else "I") * len(vals), *map(int, vals))
        if size > 4:
            entries.append(struct.pack("<HHII", tag, typ, len(vals), blob_at + len(blob)))
            blob += packed
        else:
            entries.append(struct.pack("<HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0"))
    return (b"II*\x00" + struct.pack("<IH", 8, len(tags)) + b"".join(entries) + bytes(4)
            + blob + b"".join(strips))


def smooth(h: int, w: int, c: int, seed: int, noise: float = 2.0, step: int = 1) -> np.ndarray:
    """Smooth gradients plus a little seeded noise, in steps of `step`,
    (h, w, c) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 23.0 + k) * np.cos(y / 31.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)
    return img // step * step


def with_window(frame: bytes, log: int, mantissa: int = 0) -> bytes:
    """A frame written without its content size (header byte 0x00 or 0x04:
    a window descriptor, no dictionary) with its window descriptor set."""
    if frame[4] & 0xE3:
        raise ValueError("with_window takes a frame without content size or dictionary")
    return frame[:5] + bytes([(log - 10) << 3 | mantissa]) + frame[6:]


# ------------------------------------------------------------------ fixtures
def pil_tiff(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(img) if mode is None else Image.fromarray(img).convert(mode)
    b = io.BytesIO()
    im.save(b, "TIFF", compression="zstd", **kw)
    return b.getvalue()


def files() -> dict[str, bytes]:
    from PIL import Image

    rgb = smooth(23, 37, 3, 1, noise=12.0)
    gray = rgb[..., 0]
    i16 = Image.fromarray(gray.astype(np.uint16) * 257)
    b = io.BytesIO()
    i16.save(b, "TIFF", compression="zstd")
    out = {
        "pil_l_37x23.tif": pil_tiff(gray),
        "pil_la_37x23.tif": pil_tiff(np.dstack([gray, rgb[..., 1]])),
        "pil_rgb_37x23.tif": pil_tiff(rgb),
        "pil_rgba_37x23.tif": pil_tiff(np.dstack([rgb, gray])),
        "pil_p_b15_37x23.tif": pil_tiff(rgb, "P"),
        "pil_1_b16_37x23.tif": pil_tiff(gray, "1"),
        "pil_i16_b7_37x23.tif": b.getvalue(),
        "pil_cmyk_b14_37x23.tif": pil_tiff(rgb, "CMYK"),
        "pil_rgb_predictor2_37x23.tif": pil_tiff(rgb, tiffinfo={317: 2}),
        "pil_rgb_strips16_64x48.tif": pil_tiff(smooth(48, 64, 3, 2), strip_size=64 * 3 * 16),
        "pil_rgb_1x1.tif": pil_tiff(rgb[:1, :1]),
        "pil_rgb_257x131.tif": pil_tiff(smooth(131, 257, 3, 3, noise=0.0, step=32)),
        "pil_rgb_one_strip_260x180.tif": pil_tiff(smooth(180, 260, 3, 4, noise=0.0, step=64),
                                                  strip_size=1 << 20),
        "pil_rgb_noise_32x32.tif": pil_tiff(np.random.default_rng(5).integers(
            0, 256, (32, 32, 3), dtype=np.uint8)),
        "pil_l_flat_64x64.tif": pil_tiff(np.full((64, 64), 77, np.uint8)),
    }
    g = smooth(16, 24, 1, 6, noise=6.0)[..., 0]
    raw = g.tobytes()
    one = lambda frame: container([frame], 24, 16)           # noqa: E731
    for level in (-5, 1, 19, 22):
        out[f"libzstd_level{level}_24x16.tif"] = one(compress(raw, level))
    out["libzstd_checksum_24x16.tif"] = one(compress(raw, 3, checksum=True))
    streaming = compress(raw, 3, content_size=False)
    out["libzstd_no_content_size_24x16.tif"] = one(streaming)
    for log in range(10, 28):
        out[f"libzstd_window{log}_24x16.tif"] = one(with_window(streaming, log))
    half = len(raw) // 2
    checked = compress(raw, 3, checksum=True)
    refused = {
        "refused_window27_mantissa1_24x16.tif": one(with_window(streaming, 27, 1)),
        "refused_two_frames_24x16.tif": one(compress(raw[:half]) + compress(raw[half:])),
        "refused_skippable_first_24x16.tif": one(struct.pack("<II", SKIPPABLE, 4) + b"skip"
                                                 + compress(raw)),
        "refused_cut3_24x16.tif": one(compress(raw)[:-3]),
        "refused_bad_checksum_24x16.tif": one(checked[:-4] + bytes(b ^ 0xFF for b in
                                                                   checked[-4:])),
        "refused_dictionary_24x16.tif": one(streaming[:4] + bytes([streaming[4] | 1])
                                            + streaming[5:6] + b"\x07" + streaming[6:]),
        "refused_reserved_bit_24x16.tif": one(streaming[:4] + bytes([streaming[4] | 8])
                                              + streaming[5:]),
    }
    out["libzstd_trailing_bytes_24x16.tif"] = one(compress(raw) + b"\x01\x02\x03 trailing")
    out["libzstd_over_long_24x16.tif"] = one(compress(raw + bytes(range(200))))
    return {**{k: (v, None) for k, v in out.items()}, **{k: (v, "refused")
                                                        for k, v in refused.items()}}


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def port_array(data: bytes) -> tuple[np.ndarray, str, str | None]:
    """PIL's array of a TIFF under the port's rule -> (array, PIL's mode,
    the rule)."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    im.load()
    if im.mode.startswith("I;16"):
        return (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8), im.mode, "B7"
    rule = {"CMYK": "B14", "P": "B15"}.get(im.mode)
    if rule:
        return np.asarray(im.convert("RGB")), im.mode, rule
    if im.mode == "1":
        return np.asarray(im.convert("L")), im.mode, "B16"
    return np.asarray(im), im.mode, None


def digest(data: bytes, rule: str | None) -> dict:
    if rule is None:
        a, mode, rule = port_array(data)
        return {"array": sha(a), "shape": list(a.shape), "pil_mode": mode, "rule": rule}
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    try:
        im.load()
    except OSError as err:
        return {"array": None, "shape": None, "pil_mode": im.mode, "rule": "refused",
                "pil_error": str(err)}
    raise AssertionError("PIL loads a file recorded as refused")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    table = {}
    for name, (data, rule) in files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table[name] = digest(data, rule)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"files": len(table), "bytes": sum(
        os.path.getsize(os.path.join(args.out, n)) for n in table)}))


if __name__ == "__main__":
    main()
