"""WebP images, to the array PIL 12 gives (the JAX reader opens dataset
images with PIL, which reaches libwebp 1.6; the machines the port runs on
have neither): lossy (VP8), lossless (VP8L), lossy with an alpha plane
(ALPH), and the first frame of an animation.

`read_webp` / `decode_webp` read a simple (`VP8 ` / `VP8L`) or extended
(`VP8X`) file as `np.asarray(Image.open(p))` gives it. `parse` follows
libwebp's demuxer: the RIFF size must agree with the file (bytes past it
are ignored, as PIL ignores them), chunks are padded to even sizes (the pad
byte of an odd `VP8 ` or `VP8L` chunk ends its data, as the demuxer hands
the chunk on), `ICCP`, `EXIF`, `XMP ` and unknown chunks are skipped, a
still `VP8X` canvas must be the frame's size, an `ALPH` applies only under
the alpha flag (and refuses to precede a `VP8L`), and an animation's first
`ANMF` is drawn at its offset on a canvas cleared to (0, 0, 0, 0) (the
`ANIM` background is ignored; later frames' chunks are only sized). The
mode is PIL's: RGB for a simple lossy file, the alpha-is-used bit for
VP8L, the alpha flag or an `ALPH` chunk for an extended lossy file, the
alpha flag for an animation.

A lossy frame decodes in the port's C++ (`gm_vp8_decode` of
`csrc/vp8.cpp`, built by `ops/_cuda.py::host_library` at first use; a failed
build raises) to its Y, U and V planes, exactly libwebp's, and `gm_vp8_rgb`
makes RGB of them with libwebp's fancy upsampler. Past a partition's end
the decoder reads zeros and sets an end-of-file flag, checked where libwebp
checks it (after each macroblock's tokens, after each row's modes): a set
flag raises "cut short", so a file cut in its last partition raises, or
decodes to other pixels, exactly where PIL does. VP8L and ALPH decode in
`io/vp8l.py` (`csrc/vp8l.cpp`); a failed alpha plane fails the decode.
`vp8_decode_plain` / `yuv_to_rgb_plain` (and `decode_webp_plain` on them
and on `io/vp8l.py`'s plain versions) are the same steps as a Python loop
over the bits, the reconstruction and the loop filter in numpy per
macroblock: the versions the C++ is held to byte for byte, which the
training path never calls.

`encode_vp8` writes a lossy key frame (`gm_vp8_encode`): 16x16 and chroma
modes chosen by SSE, 1 segment or 4 by the quartile of each macroblock's
luma variance, any filter, 1-8 token partitions, the default coefficient
probabilities. `encode_webp` / `write_webp` wrap it, or a lossless frame
(`vp8l.encode_vp8l`), with an `ALPH` (raw or VP8L, any filter) for a lossy
RGBA image, optionally inside `VP8X` with `ICCP` and `EXIF` chunks;
`encode_animation` writes frames in `ANMF` chunks at offsets; for the
tests and `chip_smoke.py` (no PIL there).
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

from gaussianmesh_tpu_torch.io import vp8_tables as T
from gaussianmesh_tpu_torch.io import vp8l
from gaussianmesh_tpu_torch.ops import _cuda

_CUT_MODES, _CUT_TOKENS, _BAD_FIRST, _BAD_PARTS = 1, 2, 3, 4   # csrc/vp8.cpp's codes
# slots of a decode's statistics (csrc/vp8.cpp's kStat*)
STATS = ("fail_x", "fail_y", "filter", "segments", "map", "partitions", "i4x4", "skip",
         *(f"bmode{i}" for i in range(10)), *(f"token{i}" for i in range(11)),
         "sharpness", "lf_delta", "base_q")
_FILTERS = {"none": 0, "simple": 1, "normal": 2}
# the writer's 4 segments, by luma variance quartile (lowest first): offsets of
# the quantizer index and of the filter level
_SEGMENT_QUANT = (-8, -3, 3, 8)
_SEGMENT_FILTER = (-4, 0, 4, 8)
# ------------------------------------------------------------ the container

class Frame(NamedTuple):
    """A WebP's image as libwebp's demuxer hands it to the decoder."""
    codec: bytes                       # b"VP8 " or b"VP8L"
    data: bytes                        # the chunk's payload and its pad byte
    alpha: bytes | None                # the ALPH payload applied to a VP8 frame
    size: tuple[int, int]              # the frame's (width, height)
    canvas: tuple[int, int]
    offset: tuple[int, int]            # the frame's place on the canvas
    rgba: bool                         # PIL opens the file as RGBA (else RGB)


def _frame_size(codec: bytes, data: bytes, path: str) -> tuple[int, int]:
    if codec == b"VP8L":
        return vp8l.vp8l_size(data, path)[:2]
    return frame_size(data, path)


def _image_chunks(data: bytes, pos: int, end: int, path: str, where: str):
    """The ALPH (first, unpadded) and image chunk (its pad byte included, as
    libwebp's demuxer hands it on) from `pos` on -> (alpha, codec, payload,
    position after the image chunk)."""
    alpha = None
    while True:
        if pos + 8 > end:
            raise ValueError(f"{path}: WebP cut short: no image chunk{where}")
        tag, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        if body + size > end:
            raise ValueError(f"{path}: WebP cut short: chunk {tag!r} of {size} bytes "
                             f"runs past its end{where}")
        nxt = body + size + (size & 1)
        if tag == b"ALPH" and alpha is None:
            alpha = data[body:body + size]
        elif tag in (b"VP8 ", b"VP8L"):
            if tag == b"VP8L" and alpha is not None:
                raise ValueError(f"{path}: WebP ALPH chunk before a VP8L frame{where}")
            return alpha, tag, data[body:min(nxt, end)], nxt
        elif tag in (b"ANIM", b"ANMF", b"VP8X"):
            raise ValueError(f"{path}: WebP chunk {tag!r} where an image chunk belongs{where}")
        pos = nxt                     # ICCP, EXIF, XMP and unknown chunks


def parse(data: bytes, path: str = "<bytes>") -> Frame:
    """A WebP's bytes -> its (first) frame, by libwebp's demuxer's rules: a
    simple `VP8 ` / `VP8L` file, or `VP8X` with its canvas, an `ALPH` applied
    only under the alpha flag, or an animation's first `ANMF` (later frames'
    chunks are only sized). PIL's mode: RGB for a simple lossy file, the
    alpha-is-used bit for VP8L, the alpha flag or an ALPH chunk for an
    extended lossy file, the alpha flag for an animation."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{path}: not a WebP (RIFF ... WEBP)")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 12:
        raise ValueError(f"{path}: WebP RIFF size {riff} holds no chunk")
    if riff + 8 > len(data):
        raise ValueError(f"{path}: WebP cut short: the RIFF size says {riff + 8} bytes, "
                         f"the file has {len(data)}")
    end = riff + 8
    if end < 20:
        raise ValueError(f"{path}: WebP cut short: no image chunk")
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):
        _, codec, frame, _ = _image_chunks(data, 12, end, path, "")
        w, h = _frame_size(codec, frame, path)
        rgba = codec == b"VP8L" and bool(vp8l.vp8l_size(frame, path)[2])
        return Frame(codec, frame, None, (w, h), (w, h), (0, 0), rgba)
    if first != b"VP8X":
        raise ValueError(f"{path}: WebP whose first chunk is {first!r}")
    size = struct.unpack_from("<I", data, 16)[0]
    if size < 10 or 20 + size > end:
        raise ValueError(f"{path}: WebP VP8X chunk of {size} bytes")
    flags = data[20]
    canvas = (int.from_bytes(data[24:27], "little") + 1,
              int.from_bytes(data[27:30], "little") + 1)
    pos = 20 + size + (size & 1)
    if not flags & 0x02:
        alpha, codec, frame, _ = _image_chunks(data, pos, end, path, "")
        w, h = _frame_size(codec, frame, path)
        if canvas != (w, h):
            raise ValueError(f"{path}: WebP canvas {canvas[0]}x{canvas[1]} is not the "
                             f"frame's {w}x{h}")
        if codec == b"VP8L":
            rgba = bool(vp8l.vp8l_size(frame, path)[2])
        else:
            rgba = bool(flags & 0x10) or alpha is not None
        return Frame(codec, frame, alpha if flags & 0x10 else None, (w, h), canvas, (0, 0),
                     rgba)
    anim, found = False, None
    while pos + 8 <= end:
        tag, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        if body + size > end:
            raise ValueError(f"{path}: WebP cut short: chunk {tag!r} of {size} bytes runs "
                             f"past the RIFF's end")
        if tag == b"ANIM":
            if size < 6:
                raise ValueError(f"{path}: WebP ANIM chunk of {size} bytes")
            anim = True
        elif tag == b"ANMF":
            if not anim:
                raise ValueError(f"{path}: WebP ANMF chunk before the ANIM chunk")
            if size < 16:
                raise ValueError(f"{path}: WebP ANMF chunk of {size} bytes")
            if found is None:
                x, y = (2 * int.from_bytes(data[body + k:body + k + 3], "little")
                        for k in (0, 3))
                alpha, codec, frame, _ = _image_chunks(data, body + 16, body + size, path,
                                                       " in the first animation frame")
                w, h = _frame_size(codec, frame, path)
                if x + w > canvas[0] or y + h > canvas[1]:
                    raise ValueError(f"{path}: WebP animation frame of {w}x{h} at ({x}, {y}) "
                                     f"does not fit the {canvas[0]}x{canvas[1]} canvas")
                found = Frame(codec, frame, alpha if codec == b"VP8 " else None, (w, h),
                              canvas, (x, y), bool(flags & 0x10))
        elif tag in (b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError(f"{path}: WebP animation with an image outside its frames")
        pos = body + size + (size & 1)
    if found is None:
        raise ValueError(f"{path}: WebP animation with no frame")
    return found


def frame_of(data: bytes, path: str = "<bytes>") -> bytes:
    """A lossy WebP's bytes -> its VP8 frame (the `VP8 ` chunk's payload and
    its pad byte)."""
    f = parse(data, path)
    if f.codec != b"VP8 ":
        raise ValueError(f"{path}: a lossless WebP (VP8L) has no VP8 frame")
    return f.data


def frame_size(frame: bytes, path: str = "<bytes>") -> tuple[int, int]:
    """A VP8 frame's tag and start code checked as libwebp checks them ->
    (width, height)."""
    if len(frame) < 10:
        raise ValueError(f"{path}: VP8 frame of {len(frame)} bytes, cut short")
    bits = frame[0] | frame[1] << 8 | frame[2] << 16
    if bits & 1:
        raise ValueError(f"{path}: VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"{path}: VP8 version {(bits >> 1) & 7}; 0-3 are defined")
    if not (bits >> 4) & 1:
        raise ValueError(f"{path}: VP8 frame is not shown")
    if bits >> 5 >= len(frame):
        raise ValueError(f"{path}: VP8 first partition of {bits >> 5} bytes in a frame of "
                         f"{len(frame)}")
    if frame[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: VP8 start code missing")
    w = (frame[6] | frame[7] << 8) & 0x3FFF     # the 2-bit scales are ignored, as libwebp does
    h = (frame[8] | frame[9] << 8) & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError(f"{path}: VP8 frame of {w}x{h} pixels")
    return w, h


def _status_error(status: int, info, path: str) -> ValueError:
    x, y = int(info[0]), int(info[1])
    return ValueError(f"{path}: " + {
        _CUT_MODES: f"VP8 first partition cut short (macroblock row {y})",
        _CUT_TOKENS: f"VP8 token partition cut short at macroblock ({x}, {y})",
        _BAD_FIRST: "VP8 first partition cut short: it runs past the frame",
        _BAD_PARTS: "VP8 token partitions cut short: no room for their sizes or the last",
    }.get(status, f"gm_vp8_decode returned {status}"))


# ------------------------------------------------------------ C++ entry points

def decode_vp8(frame: bytes, path: str = "<bytes>"):
    """A VP8 frame -> (Y (H, W), U, V ((H + 1) // 2, (W + 1) // 2) uint8,
    the decode's statistics: int64 by `STATS`)."""
    w, h = frame_size(frame, path)
    src = np.frombuffer(frame, np.uint8)
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    info = np.zeros(len(STATS), np.int64)
    status = _cuda.host_library("vp8").gm_vp8_decode(
        src.ctypes.data, len(src), y.ctypes.data, u.ctypes.data, v.ctypes.data,
        info.ctypes.data)
    if status:
        raise _status_error(status, info, path)
    return y, u, v, info


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planes -> (H, W, 3) uint8 RGB: libwebp's fancy upsampling and its
    fixed-point conversion."""
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    status = _cuda.host_library("vp8").gm_vp8_rgb(
        y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_vp8_rgb returned {status}")
    return out


def _decode(data: bytes, path: str, plain: bool) -> np.ndarray:
    f = parse(data, path)
    w, h = f.size
    if f.codec == b"VP8L":
        argb = (vp8l.vp8l_decode_plain if plain else vp8l.decode_vp8l)(f.data, path)[0]
        img = vp8l.argb_to_rgba(argb)
    else:
        if plain:
            y, u, v, _ = vp8_decode_plain(f.data, path)
            rgb = yuv_to_rgb_plain(y, u, v)
        else:
            y, u, v, _ = decode_vp8(f.data, path)
            rgb = yuv_to_rgb(y, u, v)
        a = np.full((h, w), 255, np.uint8)
        if f.alpha is not None:        # a failed alpha plane fails the decode, as in libwebp
            a = (vp8l.alpha_decode_plain if plain else vp8l.decode_alpha)(f.alpha, w, h,
                                                                          path)[0]
        img = np.concatenate([rgb, a[..., None]], -1)
    if f.size != f.canvas:             # an animation's first frame on a cleared canvas
        canvas = np.zeros((f.canvas[1], f.canvas[0], 4), np.uint8)
        x, y0 = f.offset
        canvas[y0:y0 + h, x:x + w] = img
        img = canvas
    return np.ascontiguousarray(img if f.rgba else img[..., :3])


def decode_webp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_webp` of a WebP's bytes (`path` names it in errors)."""
    return _decode(data, path, False)


def read_webp(path: str) -> np.ndarray:
    """A WebP -> uint8 (H, W, 3) RGB or (H, W, 4) RGBA, what
    `np.asarray(Image.open(path))` gives."""
    with open(path, "rb") as f:
        return decode_webp(f.read(), path)


def decode_webp_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_webp` through the plain versions."""
    return _decode(data, path, True)


# ------------------------------------------------------------ the writer

def _rgb_to_yuv(img: np.ndarray):
    """(H, W, 3) RGB or (H, W) gray uint8 -> Y, U, V planes (libwebp's
    fixed-point BT.601 conversion, chroma from each 2x2 block's sum)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, 2)
    h, w = img.shape[:2]
    rgb = img.astype(np.int32)
    y = (16839 * rgb[..., 0] + 33059 * rgb[..., 1] + 6420 * rgb[..., 2]
         + (16 << 16) + (1 << 15)) >> 16
    even = np.pad(rgb, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge")
    s = even[0::2, 0::2] + even[1::2, 0::2] + even[0::2, 1::2] + even[1::2, 1::2]
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    u = (-9719 * r - 19081 * g + 28800 * b + (128 << 18) + (1 << 17)) >> 18
    v = (28800 * r - 24116 * g - 4684 * b + (128 << 18) + (1 << 17)) >> 18
    return tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))


def _segment_map(y: np.ndarray, segments: int) -> np.ndarray:
    """Each macroblock's segment: 0 for one segment, else the quartile of
    its luma variance (stable ranks), (mb_h, mb_w) uint8."""
    h, w = y.shape
    mh, mw = -(-h // 16), -(-w // 16)
    if segments == 1:
        return np.zeros((mh, mw), np.uint8)
    pad = np.pad(y, ((0, 16 * mh - h), (0, 16 * mw - w)), mode="edge").astype(np.float64)
    var = pad.reshape(mh, 16, mw, 16).var(axis=(1, 3)).ravel()
    seg = np.empty(var.size, np.uint8)
    seg[np.argsort(var, kind="stable")] = np.arange(var.size) * 4 // var.size
    return seg.reshape(mh, mw)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)


def encode_vp8(img: np.ndarray, quality_index: int = 30, segments: int = 1,
               absolute: bool = False, filter: str = "normal", level: int = 24,
               sharpness: int = 0, ref_lf_delta=None, mode_lf_delta=None,
               partitions: int = 1):
    """(H, W, 3) RGB or (H, W) gray uint8 -> (a lossy key frame's bytes, its
    decoded (Y, U, V) planes). `quality_index` is the frame's quantizer
    index (0-127); with 4 `segments` (by luma variance quartile) each
    segment's index is it plus -8, -3, 3 or 8 and its filter level `level`
    plus -4, 0, 4 or 8, written as deltas or, `absolute`, as the sums.
    `filter` is "none", "simple" or "normal"; `ref_lf_delta` /
    `mode_lf_delta` (4 each) turn the filter-level deltas on; `partitions`
    is 1, 2, 4 or 8."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                           and img.shape[2] != 3):
        raise ValueError("encode_webp takes (H, W) or (H, W, 3) uint8")
    h, w = img.shape[:2]
    if not (0 < w < 16384 and 0 < h < 16384):
        raise ValueError(f"VP8 frames are 1-16383 pixels a side, not {w}x{h}")
    if segments not in (1, 4) or partitions not in (1, 2, 4, 8) or filter not in _FILTERS:
        raise ValueError("encode_webp takes 1 or 4 segments, 1/2/4/8 partitions and a "
                         "filter of none / simple / normal")
    y, u, v = _rgb_to_yuv(img)
    mh, mw = -(-h // 16), -(-w // 16)
    py = np.pad(y, ((0, 16 * mh - h), (0, 16 * mw - w)), mode="edge")
    pu, pv = (np.pad(p, ((0, 8 * mh - p.shape[0]), (0, 8 * mw - p.shape[1])), mode="edge")
              for p in (u, v))
    seg = _segment_map(y, segments)
    quant = [quality_index + d for d in _SEGMENT_QUANT]
    filt = [level + d for d in _SEGMENT_FILTER]
    if absolute:
        quant = [min(max(q, 0), 127) for q in quant]
        filt = [min(max(f, 0), 63) for f in filt]
    else:
        quant, filt = list(_SEGMENT_QUANT), list(_SEGMENT_FILTER)
    use_delta = ref_lf_delta is not None or mode_lf_delta is not None
    params = np.array([segments, int(absolute), quality_index, *quant, *filt,
                       _FILTERS[filter], level, sharpness, int(use_delta),
                       *(ref_lf_delta or (0,) * 4), *(mode_lf_delta or (0,) * 4),
                       partitions.bit_length() - 1], np.int32)
    cap = 64 * 1024 + 8 * py.size
    out = np.empty(cap, np.uint8)
    n_out = np.zeros(1, np.int64)
    ry = np.empty((h, w), np.uint8)
    ru = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    rv = np.empty_like(ru)
    py, pu, pv, seg = (np.ascontiguousarray(p) for p in (py, pu, pv, seg))
    status = _cuda.host_library("vp8").gm_vp8_encode(
        py.ctypes.data, pu.ctypes.data, pv.ctypes.data, w, h, seg.ctypes.data,
        params.ctypes.data, out.ctypes.data, cap, n_out.ctypes.data, ry.ctypes.data,
        ru.ctypes.data, rv.ctypes.data)
    if status:
        raise RuntimeError(f"gm_vp8_encode returned {status} ({int(n_out[0])} bytes)")
    return out[:int(n_out[0])].tobytes(), (ry, ru, rv)


def frame_chunks(img: np.ndarray, lossless: bool = False, vp8l_options=None,
                 alpha_compression: int = 1, alpha_filter: int = 0, alpha_options=None,
                 **vp8_options):
    """One image's chunks -> (their bytes, what they decode to). Lossless:
    a `VP8L` chunk of `vp8l.encode_vp8l(img, **vp8l_options)`, decoding to
    the RGB or RGBA written (gray is written as RGB). Lossy: an (H, W, 4)
    image gets an `ALPH` chunk (`vp8l.encode_alpha` with
    `alpha_compression` 0 / 1, `alpha_filter` 0-3 and `alpha_options`)
    before its `VP8 ` chunk (`encode_vp8(**vp8_options)`); it decodes to
    the planes (Y, U, V), and the alpha written after them."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise ValueError("a WebP image is (H, W), (H, W, 3) or (H, W, 4) uint8")
    if lossless:
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, 2)
        stream = vp8l.encode_vp8l(img, **(vp8l_options or {}))[0]
        return _chunk(b"VP8L", stream), img
    rgb = img[..., :3] if img.ndim == 3 else img
    frame, planes = encode_vp8(np.ascontiguousarray(rgb), **vp8_options)
    if img.ndim == 3 and img.shape[2] == 4:
        alph = vp8l.encode_alpha(img[..., 3], alpha_compression, alpha_filter,
                                 **(alpha_options or {}))
        return _chunk(b"ALPH", alph) + _chunk(b"VP8 ", frame), (*planes, img[..., 3].copy())
    return _chunk(b"VP8 ", frame), planes


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


def encode_webp(img: np.ndarray, lossless: bool = False, icc: bytes | None = None,
                exif: bytes | None = None, **options):
    """An image -> (the bytes of a WebP, what it decodes to: `frame_chunks`'
    second value). A lossy RGB or gray image is a simple `VP8 ` file, a
    lossless one a simple `VP8L` file; an alpha plane (lossy) or an `icc` or
    `exif` payload wraps the frame in `VP8X` (the alpha flag set for a lossy
    RGBA image) with those chunks. `options` go to `frame_chunks`."""
    chunks, decoded = frame_chunks(img, lossless, **options)
    img = np.asarray(img)
    h, w = img.shape[:2]
    has_alpha = not lossless and img.ndim == 3 and img.shape[2] == 4
    if has_alpha or icc is not None or exif is not None:
        flags = ((0x20 if icc is not None else 0) | (0x08 if exif is not None else 0)
                 | (0x10 if has_alpha else 0))
        body = (_vp8x(flags, w, h) + (_chunk(b"ICCP", icc) if icc is not None else b"")
                + chunks + (_chunk(b"EXIF", exif) if exif is not None else b""))
    else:
        body = chunks
    return _riff(body), decoded


def encode_animation(frames, canvas: tuple[int, int], offsets=None, alpha: bool | None = None,
                     background=(255, 255, 255, 255), frame_flags=None, **options):
    """Images -> (the bytes of an animated WebP, what each frame's chunks
    decode to). Each frame is `frame_chunks(img, **options)` in an `ANMF`
    at its `offsets` entry (even numbers; default (0, 0)) on a `canvas`
    (width, height); `alpha` is the `VP8X` alpha flag (default: any frame is
    RGBA); `background` (RGBA) goes into `ANIM`, with loop count 0; each
    `ANMF` lasts 100 ms and holds its `frame_flags` entry (bit 0 dispose,
    bit 1 no blending; default 0)."""
    if alpha is None:
        alpha = any(np.ndim(f) == 3 and np.shape(f)[2] == 4 for f in frames)
    body = _vp8x(0x02 | (0x10 if alpha else 0), *canvas)
    r, g, b, a = background
    body += _chunk(b"ANIM", bytes([b, g, r, a, 0, 0]))
    decoded = []
    for k, img in enumerate(frames):
        x, y = offsets[k] if offsets is not None else (0, 0)
        if x % 2 or y % 2:
            raise ValueError("animation frames sit at even offsets")
        h, w = np.shape(img)[:2]
        chunks, dec = frame_chunks(img, **options)
        decoded.append(dec)
        head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
        body += _chunk(b"ANMF", head + bytes([frame_flags[k] if frame_flags else 0]) + chunks)
    return _riff(body), decoded


def _written(path: str, data: bytes):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def write_webp(path: str, img: np.ndarray, **kwargs):
    """`encode_webp(img, **kwargs)`'s file written to `path` (its directory
    made if needed) -> what it decodes to (lossy: the (Y, U, V) planes, and
    the alpha written; lossless: the image)."""
    data, decoded = encode_webp(img, **kwargs)
    _written(path, data)
    return decoded


def write_webp_animation(path: str, frames, canvas, **kwargs):
    """`encode_animation(frames, canvas, **kwargs)`'s file written to
    `path` -> what each frame decodes to."""
    data, decoded = encode_animation(frames, canvas, **kwargs)
    _written(path, data)
    return decoded


# ------------------------------------------------------------ plain versions

_BPS = 32                                      # the work buffer of csrc/vp8.cpp
_ZIGZAG = [int(z) for z in T.ZIGZAG]
_BANDS = [int(b) for b in T.BANDS]
_TREE = [int(t) for t in T.YMODES_INTRA4]
_CATS = [[int(p) for p in c] for c in T.CAT3456]
_UPDATE = T.COEFFS_UPDATE_PROBA.tolist()
_PROBA0 = T.COEFFS_PROBA0.tolist()
_BMODES = T.BMODES_PROBA.tolist()
_DC_PRED, _TM_PRED, _V_PRED, _H_PRED = 0, 1, 2, 3
_NOTOP, _NOLEFT, _NOTOPLEFT = 4, 5, 6


class _Bits:
    """libwebp's boolean decoder, a byte at a time (csrc/vp8.cpp's BitReader)."""

    __slots__ = ("data", "pos", "end", "value", "bits", "range", "eof")

    def __init__(self, data: bytes, start: int, size: int):
        self.data, self.pos, self.end = data, start, start + size
        self.value, self.bits, self.range, self.eof = 0, -8, 254, 0
        self._load()

    def _load(self):
        if self.pos < self.end:
            self.bits += 8
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = 1
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.range = (rng << shift) - 1
        self.bits -= shift
        return bit

    def value_of(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.bit(0x80) << i
        return v

    def signed(self, n: int) -> int:
        v = self.value_of(n)
        return -v if self.bit(0x80) else v


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


def _i16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _header_plain(br: _Bits) -> dict:
    """csrc/vp8.cpp's parse_header (up to the partition count)."""
    hd = dict(use_segment=0, update_map=0, absolute_delta=1, quantizer=[0] * 4,
              filter_strength=[0] * 4, seg_proba=[255] * 3, ref_lf_delta=[0] * 4,
              mode_lf_delta=[0] * 4)
    br.value_of(1)
    br.value_of(1)
    hd["use_segment"] = br.value_of(1)
    if hd["use_segment"]:
        hd["update_map"] = br.value_of(1)
        if br.value_of(1):
            hd["absolute_delta"] = br.value_of(1)
            hd["quantizer"] = [br.signed(7) if br.value_of(1) else 0 for _ in range(4)]
            hd["filter_strength"] = [br.signed(6) if br.value_of(1) else 0 for _ in range(4)]
        if hd["update_map"]:
            hd["seg_proba"] = [br.value_of(8) if br.value_of(1) else 255 for _ in range(3)]
    if br.eof:
        return None
    hd["simple"] = br.value_of(1)
    hd["level"] = br.value_of(6)
    hd["sharpness"] = br.value_of(3)
    hd["use_lf_delta"] = br.value_of(1)
    if hd["use_lf_delta"] and br.value_of(1):
        for key in ("ref_lf_delta", "mode_lf_delta"):
            for i in range(4):
                if br.value_of(1):
                    hd[key][i] = br.signed(6)
    hd["filter_type"] = 0 if hd["level"] == 0 else 1 if hd["simple"] else 2
    if br.eof:
        return None
    hd["log2_parts"] = br.value_of(2)
    return hd


def _quant_plain(hd: dict) -> list:
    """csrc/vp8.cpp's make_quant -> per segment (y1, y2, uv), each (dc, ac)."""
    dq, out = hd["dq"], []
    for i in range(4):
        if hd["use_segment"]:
            q = hd["quantizer"][i] + (0 if hd["absolute_delta"] else hd["base_q"])
        elif i > 0:
            out.append(out[0])
            continue
        else:
            q = hd["base_q"]
        y2ac = max(int(T.AC_TABLE[_clip(q + dq[2], 127)]) * 155 // 100, 8)
        out.append(((int(T.DC_TABLE[_clip(q + dq[0], 127)]), int(T.AC_TABLE[_clip(q, 127)])),
                    (int(T.DC_TABLE[_clip(q + dq[1], 127)]) * 2, y2ac),
                    (int(T.DC_TABLE[_clip(q + dq[3], 117)]),
                     int(T.AC_TABLE[_clip(q + dq[4], 127)]))))
    return out


def _fstrengths_plain(hd: dict) -> list:
    """csrc/vp8.cpp's make_fstrengths -> [segment][is_i4x4] (limit, ilevel,
    inner, hev)."""
    out = []
    for s in range(4):
        base = hd["level"]
        if hd["use_segment"]:
            base = hd["filter_strength"][s] + (0 if hd["absolute_delta"] else hd["level"])
        row = []
        for i4 in (0, 1):
            level = base
            if hd["use_lf_delta"]:
                level += hd["ref_lf_delta"][0] + (hd["mode_lf_delta"][0] if i4 else 0)
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if hd["sharpness"] > 0:
                    ilevel >>= 2 if hd["sharpness"] > 4 else 1
                    ilevel = min(ilevel, 9 - hd["sharpness"])
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel, i4,
                            2 if level >= 40 else 1 if level >= 15 else 0))
            else:
                row.append((0, 0, i4, 0))
        out.append(row)
    return out


def _token_of(v: int) -> int:
    return (v if v <= 4 else 5 if v <= 6 else 6 if v <= 10 else 7 if v <= 18
            else 8 if v <= 34 else 9 if v <= 66 else 10)


def _large_value(br: _Bits, p) -> int:
    bit = br.bit
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        v = 7 + 2 * bit(165)
        return v + bit(145)
    bit1 = bit(p[8])
    cat = 2 * bit1 + bit(p[9 + bit1])
    v = 0
    for prob in _CATS[cat]:
        v += v + bit(prob)
    return v + 3 + (8 << cat)


def _coeffs_plain(br: _Bits, bands, ctx: int, dq, n: int, out: list, tokens) -> int:
    """csrc/vp8.cpp's get_coeffs: tokens into `out` (16 ints, natural order)."""
    bit = br.bit
    p = bands[_BANDS[n]][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            tokens[0] += 1
            n += 1
            p = bands[_BANDS[n]][0]
            if n == 16:
                return 16
        p_ctx = bands[_BANDS[n + 1]]
        if not bit(p[2]):
            v, p = 1, p_ctx[1]
        else:
            v, p = _large_value(br, p), p_ctx[2]
        tokens[_token_of(v)] += 1
        out[_ZIGZAG[n]] = _i16((-v if bit(0x80) else v) * dq[n > 0])
        n += 1
    return 16


def _wht_plain(dc: list) -> list:
    """csrc/vp8.cpp's transform_wht -> each luma block's DC (16)."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = [_i16((a0 + a1) >> 3), _i16((a3 + a2) >> 3),
                                _i16((a0 - a1) >> 3), _i16((a3 - a2) >> 3)]
    return out


def _residuals_plain(br, hd, q, mb, top, left, tokens):
    """csrc/vp8.cpp's parse_residuals -> (24 blocks of 16 coefficients,
    whether libwebp counts the macroblock as having none)."""
    blocks = [[0] * 16 for _ in range(24)]
    proba = hd["proba"]
    if not mb["i4"]:
        dc = [0] * 16
        nz = _coeffs_plain(br, proba[1], top[1] + left[1], q[1], 0, dc, tokens)
        top[1] = left[1] = int(nz > 0)
        for n, d in enumerate(_wht_plain(dc)):
            blocks[n][0] = d
        first, ac = 1, proba[0]
    else:
        first, ac = 0, proba[3]
    non_zero = False
    tnz, lnz = top[0], left[0]
    for yy in range(4):
        lf = (lnz >> yy) & 1
        for xx in range(4):
            blk = blocks[4 * yy + xx]
            nz = _coeffs_plain(br, ac, lf + ((tnz >> xx) & 1), q[0], first, blk, tokens)
            lf = int(nz > first)
            tnz = (tnz & ~(1 << xx)) | (lf << xx)
            non_zero |= nz > 1 or blk[0] != 0
        lnz = (lnz & ~(1 << yy)) | (lf << yy)
    for ch in range(2):
        for yy in range(2):
            lb = 4 + 2 * ch + yy
            lf = (lnz >> lb) & 1
            for xx in range(2):
                tb = 4 + 2 * ch + xx
                blk = blocks[16 + 4 * ch + 2 * yy + xx]
                nz = _coeffs_plain(br, proba[2], lf + ((tnz >> tb) & 1), q[2], 0, blk, tokens)
                lf = int(nz > 0)
                tnz = (tnz & ~(1 << tb)) | (lf << tb)
                non_zero |= nz > 1 or blk[0] != 0
            lnz = (lnz & ~(1 << lb)) | (lf << lb)
    top[0], left[0] = tnz, lnz
    return blocks, not non_zero


def _intra_plain(br, hd, top: list, left: list, stats) -> dict:
    """csrc/vp8.cpp's parse_intra_mode; `top` / `left` the 4 mode contexts."""
    bit = br.bit
    mb = {}
    if hd["update_map"]:
        sp = hd["seg_proba"]
        mb["segment"] = bit(sp[1]) if not bit(sp[0]) else bit(sp[2]) + 2
    else:
        mb["segment"] = 0
    mb["skip"] = bit(hd["skip_p"]) if hd["use_skip"] else 0
    mb["i4"] = not bit(145)
    if not mb["i4"]:
        if bit(156):
            ymode = _TM_PRED if bit(128) else _H_PRED
        else:
            ymode = _V_PRED if bit(163) else _DC_PRED
        mb["ymode"] = ymode
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
    else:
        modes = []
        for yy in range(4):
            ymode = left[yy]
            for xx in range(4):
                prob = _BMODES[top[xx]][ymode]
                i = _TREE[bit(prob[0])]
                while i > 0:
                    i = _TREE[2 * i + bit(prob[i])]
                ymode = -i
                top[xx] = ymode
                stats[8 + ymode] += 1
            modes += top
            left[yy] = ymode
        mb["imodes"] = modes
    mb["uvmode"] = (_DC_PRED if not bit(142) else _V_PRED if not bit(114)
                    else _TM_PRED if bit(183) else _H_PRED)
    return mb


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4_plain(mode: int, wb: np.ndarray, r: int, c: int):
    """csrc/vp8.cpp's pred4 into the 4x4 block at (r, c) of the work buffer."""
    top = [int(t) for t in wb[r - 1, c - 1:c + 8]]
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = (int(t) for t in wb[r:r + 4, c - 1])
    if mode == 0:                               # B_DC_PRED
        out = np.full((4, 4), (4 + A + B + C + D + I + J + K + L) >> 3)
    elif mode == 1:                             # B_TM_PRED
        out = np.clip(np.array(top[1:5])[None, :] + np.array([I, J, K, L])[:, None] - X, 0, 255)
    elif mode == 2:                             # B_VE_PRED
        out = np.tile([_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)], (4, 1))
    elif mode == 3:                             # B_HE_PRED
        out = np.repeat([[_avg3(X, I, J)], [_avg3(I, J, K)], [_avg3(J, K, L)],
                         [_avg3(K, L, L)]], 4, 1)
    else:
        d = {}                                  # (x, y) -> value, as the DST macro
        if mode == 4:                           # B_RD_PRED: one value per x - y
            vals = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
                    _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
            for x in range(4):
                for y in range(4):
                    d[(x, y)] = vals[x - y + 3]
        elif mode == 5:                         # B_VR_PRED
            for key, val in ((((0, 0), (1, 2)), _avg2(X, A)), (((1, 0), (2, 2)), _avg2(A, B)),
                             (((2, 0), (3, 2)), _avg2(B, C)), (((3, 0),), _avg2(C, D)),
                             (((0, 3),), _avg3(K, J, I)), (((0, 2),), _avg3(J, I, X)),
                             (((0, 1), (1, 3)), _avg3(I, X, A)),
                             (((1, 1), (2, 3)), _avg3(X, A, B)),
                             (((2, 1), (3, 3)), _avg3(A, B, C)), (((3, 1),), _avg3(B, C, D))):
                for k in key:
                    d[k] = val
        elif mode == 6:                         # B_LD_PRED: one value per x + y
            vals = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                    _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
            for x in range(4):
                for y in range(4):
                    d[(x, y)] = vals[x + y]
        elif mode == 7:                         # B_VL_PRED
            for key, val in ((((0, 0),), _avg2(A, B)), (((1, 0), (0, 2)), _avg2(B, C)),
                             (((2, 0), (1, 2)), _avg2(C, D)), (((3, 0), (2, 2)), _avg2(D, E)),
                             (((0, 1),), _avg3(A, B, C)), (((1, 1), (0, 3)), _avg3(B, C, D)),
                             (((2, 1), (1, 3)), _avg3(C, D, E)),
                             (((3, 1), (2, 3)), _avg3(D, E, F)),
                             (((3, 2),), _avg3(E, F, G)), (((3, 3),), _avg3(F, G, H))):
                for k in key:
                    d[k] = val
        elif mode == 8:                         # B_HD_PRED
            for key, val in ((((0, 0), (2, 1)), _avg2(I, X)), (((0, 1), (2, 2)), _avg2(J, I)),
                             (((0, 2), (2, 3)), _avg2(K, J)), (((0, 3),), _avg2(L, K)),
                             (((3, 0),), _avg3(A, B, C)), (((2, 0),), _avg3(X, A, B)),
                             (((1, 0), (3, 1)), _avg3(I, X, A)),
                             (((1, 1), (3, 2)), _avg3(J, I, X)),
                             (((1, 2), (3, 3)), _avg3(K, J, I)), (((1, 3),), _avg3(L, K, J))):
                for k in key:
                    d[k] = val
        else:                                   # B_HU_PRED
            for key, val in ((((0, 0),), _avg2(I, J)), (((2, 0), (0, 1)), _avg2(J, K)),
                             (((2, 1), (0, 2)), _avg2(K, L)), (((1, 0),), _avg3(I, J, K)),
                             (((3, 0), (1, 1)), _avg3(J, K, L)),
                             (((3, 1), (1, 2)), _avg3(K, L, L)),
                             (((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)), L)):
                for k in key:
                    d[k] = val
        out = np.array([[d[(x, y)] for x in range(4)] for y in range(4)])
    wb[r:r + 4, c:c + 4] = out


def _pred_block_plain(mode: int, wb: np.ndarray, r: int, c: int, size: int):
    """csrc/vp8.cpp's pred16 / pred8 (mode after check_mode)."""
    top = wb[r - 1, c:c + size]
    left = wb[r:r + size, c - 1]
    shift = 5 if size == 16 else 4
    if mode == _DC_PRED:
        val = (int(top.sum()) + int(left.sum()) + size) >> shift
    elif mode == _TM_PRED:
        wb[r:r + size, c:c + size] = np.clip(top[None, :] + left[:, None] - wb[r - 1, c - 1],
                                             0, 255)
        return
    elif mode == _V_PRED:
        wb[r:r + size, c:c + size] = top[None, :]
        return
    elif mode == _H_PRED:
        wb[r:r + size, c:c + size] = left[:, None]
        return
    elif mode == _NOTOP:
        val = (int(left.sum()) + size // 2) >> (shift - 1)
    elif mode == _NOLEFT:
        val = (int(top.sum()) + size // 2) >> (shift - 1)
    else:
        val = 0x80
    wb[r:r + size, c:c + size] = val


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct_add_plain(coeffs: list, wb: np.ndarray, r: int, c: int):
    """csrc/vp8.cpp's transform_add, int32 wrapping as -fwrapv does."""
    if not any(coeffs):
        return
    m = np.array(coeffs, np.int32).reshape(4, 4)            # [row][column]
    a, b = m[0] + m[2], m[0] - m[2]
    cc = _mul2(m[1]) - _mul1(m[3])
    dd = _mul1(m[1]) + _mul2(m[3])
    v = np.stack([a + dd, b + cc, b - cc, a - dd])          # [output row][column]
    dc = v[:, 0] + 4
    a, b = dc + v[:, 2], dc - v[:, 2]
    cc = _mul2(v[:, 1]) - _mul1(v[:, 3])
    dd = _mul1(v[:, 1]) + _mul2(v[:, 3])
    res = np.stack([a + dd, b + cc, b - cc, a - dd], 1) >> 3
    wb[r:r + 4, c:c + 4] = np.clip(wb[r:r + 4, c:c + 4] + res, 0, 255)


def _check_mode(mb_x: int, mb_y: int, mode: int) -> int:
    if mode == _DC_PRED:
        if mb_x == 0:
            return _NOTOPLEFT if mb_y == 0 else _NOLEFT
        return _NOTOP if mb_y == 0 else _DC_PRED
    return mode


# work-buffer origins (row, column) of Y, U and V, as csrc/vp8.cpp's offsets
_YO, _UO, _VO = (1, 8), (18, 8), (18, 24)


def _reconstruct_plain(wb, tops, planes, mb, blocks, mb_x, mb_y, mb_w, mb_h):
    """csrc/vp8.cpp's begin_mb, predict_add and end_mb for one macroblock."""
    (yr, yc), (ur, uc), (vr, vc) = _YO, _UO, _VO
    if mb_x > 0:
        wb[yr - 1:yr + 16, yc - 4:yc] = wb[yr - 1:yr + 16, yc + 12:yc + 16]
        for r0, c0 in (_UO, _VO):
            wb[r0 - 1:r0 + 8, c0 - 4:c0] = wb[r0 - 1:r0 + 8, c0 + 4:c0 + 8]
    ty, tu, tv = tops
    if mb_y > 0:
        wb[yr - 1, yc:yc + 16] = ty[16 * mb_x:16 * mb_x + 16]
        wb[ur - 1, uc:uc + 8] = tu[8 * mb_x:8 * mb_x + 8]
        wb[vr - 1, vc:vc + 8] = tv[8 * mb_x:8 * mb_x + 8]
    if mb["i4"]:
        if mb_y > 0:
            wb[yr - 1, yc + 16:yc + 20] = (ty[16 * mb_x + 15] if mb_x >= mb_w - 1
                                           else ty[16 * mb_x + 16:16 * mb_x + 20])
        for k in (1, 2, 3):
            wb[yr - 1 + 4 * k, yc + 16:yc + 20] = wb[yr - 1, yc + 16:yc + 20]
        for n in range(16):
            r, c = yr + 4 * (n >> 2), yc + 4 * (n & 3)
            _pred4_plain(mb["imodes"][n], wb, r, c)
            _idct_add_plain(blocks[n], wb, r, c)
    else:
        _pred_block_plain(_check_mode(mb_x, mb_y, mb["ymode"]), wb, yr, yc, 16)
        for n in range(16):
            _idct_add_plain(blocks[n], wb, yr + 4 * (n >> 2), yc + 4 * (n & 3))
    uvmode = _check_mode(mb_x, mb_y, mb["uvmode"])
    for (r0, c0), first in ((_UO, 16), (_VO, 20)):
        _pred_block_plain(uvmode, wb, r0, c0, 8)
        for n in range(4):
            _idct_add_plain(blocks[first + n], wb, r0 + 4 * (n >> 1), c0 + 4 * (n & 1))
    if mb_y < mb_h - 1:
        ty[16 * mb_x:16 * mb_x + 16] = wb[yr + 15, yc:yc + 16]
        tu[8 * mb_x:8 * mb_x + 8] = wb[ur + 7, uc:uc + 8]
        tv[8 * mb_x:8 * mb_x + 8] = wb[vr + 7, vc:vc + 8]
    py, pu, pv = planes
    py[16 * mb_y:16 * mb_y + 16, 16 * mb_x:16 * mb_x + 16] = wb[yr:yr + 16, yc:yc + 16]
    pu[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8] = wb[ur:ur + 8, uc:uc + 8]
    pv[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8] = wb[vr:vr + 8, vc:vc + 8]


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _edge_plain(e: np.ndarray, kind: str, thresh: int, ithresh: int = 0, hev_t: int = 0):
    """One edge of csrc/vp8.cpp's loop filter, every position along it at
    once: `e` (8, n) is the taps p3..q3 across the edge (a view of the
    plane, written in place); `kind` "simple", "mb" (6 taps) or "inner"."""
    p3, p2, p1, p0, q0, q1, q2, q3 = e.astype(np.int32)
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    # the 2-tap filter (the simple filter, and high edge variance)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    f2_p0 = np.clip(p0 + _sclip2((a + 3) >> 3), 0, 255)
    f2_q0 = np.clip(q0 - _sclip2((a + 4) >> 3), 0, 255)
    if kind == "simple":
        e[3] = np.where(mask, f2_p0, p0)
        e[4] = np.where(mask, f2_q0, q0)
        return
    mask &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
             & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
             & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    m2, mo = mask & hev, mask & ~hev
    new = [p2, p1, np.where(m2, f2_p0, p0), np.where(m2, f2_q0, q0), q1, q2]
    if kind == "inner":
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        outer = [p2, np.clip(p1 + a3, 0, 255), np.clip(p0 + a2, 0, 255),
                 np.clip(q0 - a1, 0, 255), np.clip(q1 - a3, 0, 255), q2]
    else:
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        outer = [np.clip(p2 + a3, 0, 255), np.clip(p1 + a2, 0, 255), np.clip(p0 + a1, 0, 255),
                 np.clip(q0 - a1, 0, 255), np.clip(q1 - a2, 0, 255), np.clip(q2 - a3, 0, 255)]
    for k in range(6):
        e[1 + k] = np.where(mo, outer[k], new[k])


def _vert(p: np.ndarray, r: int, c: int, n: int) -> np.ndarray:
    """The taps p3..q3 of a vertical edge (between columns c - 1 and c) on
    rows r..r + n - 1: a (8, n) view."""
    return p[r:r + n, c - 4:c + 4].T


def _horz(p: np.ndarray, r: int, c: int, n: int) -> np.ndarray:
    """The taps of a horizontal edge (between rows r - 1 and r): (8, n)."""
    return p[r - 4:r + 4, c:c + n]


def _filter_plain(planes, filter_type: int, finfo: list, mb_w: int, mb_h: int):
    """csrc/vp8.cpp's loop_filter over the padded planes (int32), in place."""
    if filter_type == 0:
        return
    py, pu, pv = planes
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            limit, il, inner, hv = finfo[mb_y * mb_w + mb_x]
            if limit == 0:
                continue
            y0, x0 = 16 * mb_y, 16 * mb_x
            if filter_type == 1:
                if mb_x > 0:
                    _edge_plain(_vert(py, y0, x0, 16), "simple", limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _edge_plain(_vert(py, y0, x0 + k, 16), "simple", limit)
                if mb_y > 0:
                    _edge_plain(_horz(py, y0, x0, 16), "simple", limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _edge_plain(_horz(py, y0 + k, x0, 16), "simple", limit)
                continue
            u0, c0 = 8 * mb_y, 8 * mb_x
            if mb_x > 0:
                _edge_plain(_vert(py, y0, x0, 16), "mb", limit + 4, il, hv)
                for p in (pu, pv):
                    _edge_plain(_vert(p, u0, c0, 8), "mb", limit + 4, il, hv)
            if inner:
                for k in (4, 8, 12):
                    _edge_plain(_vert(py, y0, x0 + k, 16), "inner", limit, il, hv)
                for p in (pu, pv):
                    _edge_plain(_vert(p, u0, c0 + 4, 8), "inner", limit, il, hv)
            if mb_y > 0:
                _edge_plain(_horz(py, y0, x0, 16), "mb", limit + 4, il, hv)
                for p in (pu, pv):
                    _edge_plain(_horz(p, u0, c0, 8), "mb", limit + 4, il, hv)
            if inner:
                for k in (4, 8, 12):
                    _edge_plain(_horz(py, y0 + k, x0, 16), "inner", limit, il, hv)
                for p in (pu, pv):
                    _edge_plain(_horz(p, u0 + 4, c0, 8), "inner", limit, il, hv)


def vp8_decode_plain(frame: bytes, path: str = "<bytes>"):
    """`decode_vp8` as a Python loop over the bits, the reconstruction and
    the loop filter in numpy per macroblock (the plain version)."""
    w, h = frame_size(frame, path)
    stats = [0] * len(STATS)

    def fail(status, x=0, y=0):
        stats[0], stats[1] = x, y
        return _status_error(status, stats, path)
    first_size = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
    n = len(frame)
    if first_size > n - 10:
        raise fail(_BAD_FIRST)
    br = _Bits(frame, 10, first_size)
    hd = _header_plain(br)
    if hd is None:
        raise fail(_CUT_MODES)
    start = 10 + first_size
    size = n - start
    last = (1 << hd["log2_parts"]) - 1
    if size < 3 * last:
        raise fail(_BAD_PARTS)
    part_start, left = start + 3 * last, size - 3 * last
    parts = []
    for p in range(last):
        psize = min(int.from_bytes(frame[start + 3 * p:start + 3 * p + 3], "little"), left)
        parts.append(_Bits(frame, part_start, psize))
        part_start += psize
        left -= psize
    parts.append(_Bits(frame, part_start, left))
    if part_start >= n:
        raise fail(_BAD_PARTS)
    hd["base_q"] = br.value_of(7)
    hd["dq"] = [br.signed(4) if br.value_of(1) else 0 for _ in range(5)]
    br.value_of(1)
    proba = [[[[br.value_of(8) if br.bit(_UPDATE[t][b][c][p]) else _PROBA0[t][b][c][p]
                for p in range(11)] for c in range(3)] for b in range(8)] for t in range(4)]
    hd["proba"] = proba
    hd["use_skip"] = br.value_of(1)
    hd["skip_p"] = br.value_of(8) if hd["use_skip"] else 0
    dqm = _quant_plain(hd)
    fstr = _fstrengths_plain(hd)
    stats[2:6] = [hd["filter_type"], hd["use_segment"], hd["update_map"], last + 1]
    stats[-3:] = [hd["sharpness"], hd["use_lf_delta"], hd["base_q"]]
    tokens = [0] * 11
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    planes = (np.zeros((16 * mb_h, 16 * mb_w), np.int32),
              np.zeros((8 * mb_h, 8 * mb_w), np.int32), np.zeros((8 * mb_h, 8 * mb_w), np.int32))
    tops = (np.zeros(16 * mb_w, np.int32), np.zeros(8 * mb_w, np.int32),
            np.zeros(8 * mb_w, np.int32))
    wb = np.zeros((26, _BPS), np.int32)
    intra_t = [[0] * 4 for _ in range(mb_w)]
    nz_top = [[0, 0] for _ in range(mb_w)]
    finfo = []
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        row = [_intra_plain(br, hd, intra_t[x], intra_l, stats) for x in range(mb_w)]
        if br.eof:
            raise fail(_CUT_MODES, 0, mb_y)
        tbr = parts[mb_y & last]
        nz_left = [0, 0]
        blocks_row = []
        for mb_x, mb in enumerate(row):
            skip = mb["skip"] if hd["use_skip"] else 0
            if not skip:
                blocks, skip = _residuals_plain(tbr, hd, dqm[mb["segment"]], mb,
                                                nz_top[mb_x], nz_left, tokens)
            else:
                blocks = [[0] * 16 for _ in range(24)]
                nz_left[0] = nz_top[mb_x][0] = 0
                if not mb["i4"]:
                    nz_left[1] = nz_top[mb_x][1] = 0
            stats[7] += mb["skip"]
            stats[6] += int(mb["i4"])
            limit, il, inner, hv = fstr[mb["segment"]][int(mb["i4"])]
            finfo.append((limit, il, inner or not skip, hv))
            blocks_row.append(blocks)
            if tbr.eof:
                raise fail(_CUT_TOKENS, mb_x, mb_y)
        (yr, yc), (ur, uc), (vr, vc) = _YO, _UO, _VO
        wb[yr:yr + 16, yc - 1] = 129
        wb[ur:ur + 8, uc - 1] = 129
        wb[vr:vr + 8, vc - 1] = 129
        if mb_y > 0:
            wb[yr - 1, yc - 1] = wb[ur - 1, uc - 1] = wb[vr - 1, vc - 1] = 129
        else:
            wb[yr - 1, yc - 1:yc + 20] = 127
            wb[ur - 1, uc - 1:uc + 8] = 127
            wb[vr - 1, vc - 1:vc + 8] = 127
        for mb_x, mb in enumerate(row):
            _reconstruct_plain(wb, tops, planes, mb, blocks_row[mb_x], mb_x, mb_y, mb_w, mb_h)
    _filter_plain(planes, hd["filter_type"], finfo, mb_w, mb_h)
    stats[18:29] = tokens
    py, pu, pv = planes
    uh, uw = (h + 1) // 2, (w + 1) // 2
    return (py[:h, :w].astype(np.uint8), pu[:uh, :uw].astype(np.uint8),
            pv[:uh, :uw].astype(np.uint8), np.array(stats, np.int64))


def _mult_hi(v, c):
    return (v * c) >> 8


def _clip_yuv(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255)).astype(np.uint8)


def yuv_to_rgb_plain(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """`yuv_to_rgb` in numpy: each output row's chroma rows (top, current)
    and side of the pair, then libwebp's diagonal weights per pixel pair."""
    h, w = y.shape
    uh, uw = u.shape
    rows = np.arange(h)
    k = (rows + 1) >> 1
    top = np.maximum(k - 1, 0)
    cur = np.where(rows == 0, 0, np.where(k < uh, k, k - 1))
    bottom = ((rows & 1) == 0) & (rows > 0)
    out_uv = []
    for plane in (u.astype(np.int32), v.astype(np.int32)):
        t, c = plane[top], plane[cur]
        full = np.empty((h, w), np.int32)
        b = bottom[:, None]
        full[:, 0] = np.where(bottom, (3 * c[:, 0] + t[:, 0] + 2) >> 2,
                              (3 * t[:, 0] + c[:, 0] + 2) >> 2)
        npair = (w - 1) >> 1
        if npair:
            tl, tt, ll, cc = t[:, :npair], t[:, 1:npair + 1], c[:, :npair], c[:, 1:npair + 1]
            avg = tl + tt + ll + cc + 8
            d12 = (avg + 2 * (tt + ll)) >> 3
            d03 = (avg + 2 * (tl + cc)) >> 3
            full[:, 1:2 * npair:2] = np.where(b, (d03 + ll) >> 1, (d12 + tl) >> 1)
            full[:, 2:2 * npair + 1:2] = np.where(b, (d12 + cc) >> 1, (d03 + tt) >> 1)
        if not w & 1:
            full[:, w - 1] = np.where(bottom, (3 * c[:, uw - 1] + t[:, uw - 1] + 2) >> 2,
                                      (3 * t[:, uw - 1] + c[:, uw - 1] + 2) >> 2)
        out_uv.append(full)
    uu, vv = out_uv
    yy = _mult_hi(y.astype(np.int32), 19077)
    return np.stack([_clip_yuv(yy + _mult_hi(vv, 26149) - 14234),
                     _clip_yuv(yy - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708),
                     _clip_yuv(yy + _mult_hi(uu, 33050) - 17685)], -1)
