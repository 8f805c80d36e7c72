"""Lossless WebP (VP8L) and WebP's alpha plane (ALPH), to the bytes PIL 12
gives (the JAX reader opens dataset images with PIL, which reaches libwebp
1.6; the machines the port runs on have neither).

`decode_vp8l` reads a VP8L bitstream (a `VP8L` chunk's payload) to ARGB
pixels and `decode_alpha` an `ALPH` chunk's payload to an alpha plane, in
the port's C++ (`gm_vp8l_decode` / `gm_alpha_decode` of `csrc/vp8l.cpp`,
built by `ops/_cuda.py::host_library` at first use; a failed build raises):
the prefix codes (simple, normal with repeat codes and `max_symbol`), the
meta codes, the colour cache, LZ77 with plane-coded distances, the
predictor (modes 0-13; 14 and 15 predict black, as libwebp's sentinels
do), cross-colour, subtract-green and colour-indexing transforms, and the
alpha filters. Past the last byte the reader reads zeros and sets its
end-of-stream flag where libwebp sets it; a failure while past the end
raises "cut short", so a cut file raises, or decodes to other pixels,
exactly where PIL does. An alpha stream of one colour-indexing transform
takes libwebp's 8-bit path, which lets the last pixels' reads run past the
end. `vp8l_decode_plain` / `alpha_decode_plain` are the same steps as a
Python loop over the bits and pixels: the versions the C++ is held to byte
for byte, which the training path never calls.

`encode_vp8l` writes a VP8L stream whose every branch is chosen by
argument: the four transforms in any order (predictor modes cycled or
given, cross-colour multipliers fixed or per tile), palettes of 1-256
colours (bundled at 16 or fewer), a colour cache of 1-11 bits, backward
references, meta codes of several groups, `max_symbol`; `encode_alpha` an
`ALPH` payload (raw or VP8L, any filter). The entropy coding runs in
`gm_vp8l_encode_image`; for the tests and `chip_smoke.py` (no PIL there).
"""

from __future__ import annotations

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

# csrc/vp8l.cpp's status codes
_CUT, _BAD_HEADER, _BAD_TRANSFORM, _BAD_CACHE, _BAD_CODE, _BAD_COPY = 1, 2, 3, 4, 5, 6
_BAD_ALPHA_HEADER, _SHORT_ALPHA = 7, 8
# slots of a decode's statistics (csrc/vp8l.cpp's S_*)
STATS = ("pixel", "transforms", "order", "predictor_bits", "predictor_modes", "cross_bits",
         "palette", "palette_bits", "cache_bits", "meta_bits", "groups", "literals",
         "cache_hits", "copies", "plane_copies", "long_copies", "simple1", "simple2",
         "normal", "rep16", "rep17", "rep18", "max_symbol", "max_len", "alpha_method",
         "alpha_filter", "alpha_pre", "alpha_8b")
_S = {name: i for i, name in enumerate(STATS)}
TRANSFORMS = {"predictor": 0, "cross_color": 1, "subtract_green": 2, "palette": 3}

# the format's tables (libwebp's kCodeLengthCodeOrder, kCodeLengthExtraBits,
# kCodeLengthRepeatOffsets, kAlphabetSize, kCodeToPlane)
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
CODE_LENGTH_EXTRA_BITS = (2, 3, 7)
CODE_LENGTH_REPEAT_OFFSETS = (3, 3, 11)
ALPHABET_SIZE = (256 + 24, 256, 256, 256, 40)
CODE_TO_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05,
    0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c,
    0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59,
    0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02,
    0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74,
    0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)
_HASH_MUL = 0x1E35A7BD
_BLACK = 0xFF000000


def vp8l_size(stream: bytes, path: str = "<bytes>") -> tuple[int, int, int]:
    """A VP8L stream's signature and version checked as libwebp checks them
    -> (width, height, the alpha-is-used bit)."""
    if len(stream) < 5 or stream[0] != 0x2F or stream[4] >> 5:
        raise ValueError(f"{path}: not a VP8L stream (signature 0x2f, version 0)")
    bits = int.from_bytes(stream[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _status_error(status: int, what: str, path: str) -> ValueError:
    return ValueError(f"{path}: " + {
        _CUT: f"{what} cut short",
        _BAD_HEADER: f"{what}: bad signature or version",
        _BAD_TRANSFORM: f"{what}: a transform used twice",
        _BAD_CACHE: f"{what}: a colour cache of 0 or more than 11 bits",
        _BAD_CODE: f"{what}: a prefix code that is empty, incomplete or over-subscribed",
        _BAD_COPY: f"{what}: a backward reference before the image's start or past its end",
        _BAD_ALPHA_HEADER: "WebP alpha (ALPH): an unknown compression, pre-processing "
                           "or reserved bits",
        _SHORT_ALPHA: "WebP alpha (ALPH) cut short: fewer bytes than the canvas",
    }.get(status, f"{what}: decoder status {status}"))


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB -> (H, W, 4) uint8 RGBA."""
    argb = np.asarray(argb, np.uint32)
    return np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF, argb >> 24],
                    -1).astype(np.uint8)


def rgba_to_argb(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) RGBA, (H, W, 3) RGB (alpha 255) or (H, W) uint8 (green,
    alpha 255) -> (H, W) uint32 ARGB."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("VP8L images are uint8")
    if img.ndim == 2:
        return (np.uint32(_BLACK) | img.astype(np.uint32) << 8).astype(np.uint32)
    c = img.astype(np.uint32)
    a = c[..., 3] if img.shape[2] == 4 else np.uint32(255)
    return (a << 24 | c[..., 0] << 16 | c[..., 1] << 8 | c[..., 2]).astype(np.uint32)


# ------------------------------------------------------------ C++ entry points

def decode_vp8l(stream: bytes, path: str = "<bytes>"):
    """A VP8L stream -> ((H, W) uint32 ARGB, the decode's statistics: int64
    by `STATS`)."""
    w, h, _ = vp8l_size(stream, path)
    src = np.frombuffer(stream, np.uint8)
    out = np.empty((h, w), np.uint32)
    info = np.zeros(len(STATS), np.int64)
    status = _cuda.host_library("vp8l").gm_vp8l_decode(src.ctypes.data, len(src),
                                                        out.ctypes.data, info.ctypes.data)
    if status:
        raise _status_error(status, "VP8L data", path)
    return out, info


def decode_alpha(payload: bytes, width: int, height: int, path: str = "<bytes>"):
    """An `ALPH` chunk's payload and its canvas -> ((H, W) uint8 alpha, the
    decode's statistics)."""
    src = np.frombuffer(payload, np.uint8)
    out = np.empty((height, width), np.uint8)
    info = np.zeros(len(STATS), np.int64)
    status = _cuda.host_library("vp8l").gm_alpha_decode(
        src.ctypes.data, len(src), width, height, out.ctypes.data, info.ctypes.data)
    if status:
        raise _status_error(status, "WebP alpha (ALPH) data", path)
    return out, info


# ------------------------------------------------------------ the writer

def _put(buf: np.ndarray, pos: int, value: int, n: int) -> int:
    for i in range(n):
        if (value >> i) & 1:
            buf[(pos + i) >> 3] |= 1 << ((pos + i) & 7)
    return pos + n


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _average2(a, b):
    return (((a ^ b) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (a & b)


def _channels(p):
    return [((p >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32) for s in (24, 16, 8, 0)]


def _join(ch):
    a, r, g, b = (np.asarray(c, np.int64) & 0xFF for c in ch)
    return (a << 24 | r << 16 | g << 8 | b).astype(np.uint32)


def _predictions(flat: np.ndarray, w: int) -> list:
    """The 16 predictor modes' predictions for every pixel with x, y >= 1
    (ARGB uint32, flat index i: L i - 1, T i - w, TL i - w - 1, TR i - w + 1)."""
    n = flat.size
    i = np.arange(n)
    L, T, TL = flat[np.maximum(i - 1, 0)], flat[np.maximum(i - w, 0)], \
        flat[np.maximum(i - w - 1, 0)]
    TR = flat[np.clip(i - w + 1, 0, n - 1)]
    cl, ct, ctl = _channels(L), _channels(T), _channels(TL)
    sel = sum(np.abs(b - c) - np.abs(a - c) for a, b, c in zip(ct, cl, ctl))
    full = _join([np.clip(x + y - z, 0, 255) for x, y, z in zip(cl, ct, ctl)])
    ave = _channels(_average2(L, T))
    half = _join([np.clip(a + np.trunc((a - c) / 2).astype(np.int32), 0, 255)
                  for a, c in zip(ave, ctl)])
    black = np.full(n, _BLACK, np.uint32)
    return [black, L, T, TR, TL, _average2(_average2(L, TR), T), _average2(L, TL),
            _average2(L, T), _average2(TL, T), _average2(T, TR),
            _average2(_average2(L, TL), _average2(T, TR)), np.where(sel <= 0, T, L),
            full, half, black, black]


def _sub_pixels(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _join([x - y for x, y in zip(_channels(a), _channels(b))])


def _predictor_forward(img: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    h, w = img.shape
    flat = img.ravel()
    pred = np.empty_like(flat)
    tiles = _sub(w, bits)
    y, x = np.divmod(np.arange(flat.size), w)
    mode = modes[(y >> bits) * tiles + (x >> bits)]
    preds = _predictions(flat, w)
    for m in range(16):
        sel = mode == m
        pred[sel] = preds[m][sel]
    pred[x == 0] = flat[np.maximum(np.arange(flat.size) - w, 0)][x == 0]     # T
    pred[y == 0] = flat[np.maximum(np.arange(flat.size) - 1, 0)][y == 0]     # L
    pred[0] = _BLACK
    return _sub_pixels(flat, pred).reshape(h, w)


def _delta(t, c):
    return (t.astype(np.int32) * c.astype(np.int32)) >> 5


def _cross_forward(img: np.ndarray, bits: int, mults: np.ndarray) -> np.ndarray:
    h, w = img.shape
    a, r, g, b = _channels(img)
    tiles = _sub(w, bits)
    y, x = np.mgrid[:h, :w]
    m = mults[(y >> bits) * tiles + (x >> bits)].astype(np.uint8).view(np.int8)
    g8, r8 = g.astype(np.uint8).view(np.int8), r.astype(np.uint8).view(np.int8)
    new_r = r - _delta(m[..., 0], g8)
    new_b = b - _delta(m[..., 1], g8) - _delta(m[..., 2], r8)
    return _join([a, new_r, g, new_b])


def encode_vp8l(img: np.ndarray, *, transforms=(), predictor_bits: int = 3,
                predictor_modes="cycle", cross_bits: int = 3, cross_color=(5, -3, 7),
                palette=None, palette_entries: int | None = None, cache_bits: int = 0,
                lz77: bool = True, meta_bits: int = 0, meta_groups=2,
                max_symbol: bool = False, simple: bool = True, alpha_used=None,
                header: bool = True):
    """An image -> (a VP8L stream's bytes, the writer's statistics by `STATS`).

    `img`: (H, W, 4) RGBA, (H, W, 3) RGB or (H, W) uint8 (an alpha stream's
    green). `transforms` are applied and written in their order, from
    "predictor" (tiles of 2**`predictor_bits`, `predictor_modes` "cycle"
    (0-13 by tile) or modes cycled by tile), "cross_color" (tiles of
    2**`cross_bits`, `cross_color` (green->red, green->blue, red->blue)
    signed 8-bit multipliers cycled by tile, or "seeded"),
    "subtract_green" and "palette" (the image's colours sorted, or
    `palette`; `palette_entries` writes only that many, so that later
    indices are past the palette). `cache_bits` 0-11; `lz77`; `meta_bits`
    2-9 with `meta_groups` (n: tile i takes group i % n, or one per tile)
    for meta codes, 0 for none; `max_symbol`: normal codes say how many
    code lengths they hold; `simple=False` writes normal codes only.
    `alpha_used` is the header's bit (default: any alpha below 255);
    `header=False` leaves out the 5-byte header (an ALPH stream)."""
    argb = rgba_to_argb(img)
    h, w = argb.shape
    if not (0 < w <= 16384 and 0 < h <= 16384):
        raise ValueError(f"VP8L images are 1-16384 pixels a side, not {w}x{h}")
    if len(set(transforms)) != len(transforms) or not set(transforms) <= set(TRANSFORMS):
        raise ValueError(f"transforms are distinct names of {sorted(TRANSFORMS)}")
    if not 0 <= cache_bits <= 11 or (meta_bits and not 2 <= meta_bits <= 9):
        raise ValueError("cache_bits is 0-11 and meta_bits 0 or 2-9")
    cap = 65536 + 8 * argb.size + 1024 * len(transforms)
    buf = np.zeros(cap, np.uint8)
    stats = np.zeros(len(STATS), np.int64)
    flags = (2 if max_symbol else 0) | (0 if simple else 4)
    lib = _cuda.host_library("vp8l")
    pos = 0

    def image(pix: np.ndarray, level0: bool, cbits=0, mbits=0, groups=None):
        nonlocal pos
        pix = np.ascontiguousarray(pix, np.uint32)
        bitpos = np.array([pos], np.int64)
        gptr = None
        if groups is not None:
            groups = np.ascontiguousarray(groups, np.int32)
            gptr = groups.ctypes.data
        status = lib.gm_vp8l_encode_image(
            pix.ctypes.data, pix.shape[1], pix.shape[0], cbits, int(lz77), mbits, gptr,
            flags | (1 if level0 else 0), buf.ctypes.data, cap, bitpos.ctypes.data,
            stats.ctypes.data)
        if status:
            raise RuntimeError(f"gm_vp8l_encode_image returned {status}")
        pos = int(bitpos[0])

    if header:
        if alpha_used is None:
            alpha_used = bool((argb >> 24 != 255).any())
        pos = _put(buf, pos, 0x2F, 8)
        pos = _put(buf, pos, w - 1, 14)
        pos = _put(buf, pos, h - 1, 14)
        pos = _put(buf, pos, int(alpha_used), 1)
        pos = _put(buf, pos, 0, 3)
    cur = argb
    for name in transforms:
        pos = _put(buf, pos, 1, 1)
        pos = _put(buf, pos, TRANSFORMS[name], 2)
        cw = cur.shape[1]
        if name == "predictor":
            n_tiles = _sub(cw, predictor_bits) * _sub(h, predictor_bits)
            modes = np.resize(np.arange(14) if isinstance(predictor_modes, str) else
                              np.asarray(predictor_modes), n_tiles).astype(np.int64)
            pos = _put(buf, pos, predictor_bits - 2, 3)
            image((np.uint32(_BLACK) | modes.astype(np.uint32) << 8).reshape(
                _sub(h, predictor_bits), -1), False)
            cur = _predictor_forward(cur, predictor_bits, modes)
        elif name == "cross_color":
            n_tiles = _sub(cw, cross_bits) * _sub(h, cross_bits)
            if isinstance(cross_color, str):
                mults = np.random.default_rng(n_tiles).integers(-128, 128, (n_tiles, 3))
            else:
                mults = np.resize(np.asarray(cross_color), (n_tiles, 3))
            m8 = (np.asarray(mults) & 0xFF).astype(np.uint32)
            pos = _put(buf, pos, cross_bits - 2, 3)
            image((np.uint32(_BLACK) | m8[:, 2] << 16 | m8[:, 1] << 8 | m8[:, 0]).reshape(
                _sub(h, cross_bits), -1), False)
            cur = _cross_forward(cur, cross_bits, m8)
        elif name == "subtract_green":
            a, r, g, b = _channels(cur)
            cur = _join([a, r - g, g, b - g])
        else:
            pal = np.unique(cur) if palette is None else np.asarray(palette, np.uint32)
            if not 1 <= pal.size <= 256:
                raise ValueError(f"a palette of {pal.size} colours; 1-256 fit")
            order = np.argsort(pal, kind="stable")
            at = np.searchsorted(pal[order], cur)
            idx = order[np.minimum(at, pal.size - 1)]
            if not np.array_equal(pal[idx], cur):
                raise ValueError("the image has colours outside its palette")
            n_written = pal.size if palette_entries is None else palette_entries
            bits = 0 if n_written > 16 else 1 if n_written > 4 else 2 if n_written > 2 else 3
            pos = _put(buf, pos, n_written - 1, 8)
            delta = pal[:n_written].copy()
            delta[1:] = _sub_pixels(pal[1:n_written], pal[:n_written - 1])
            image(delta.reshape(1, -1), False)
            bpp = 8 >> bits
            xs = _sub(cw, bits)
            packed = np.zeros((h, xs), np.uint32)
            for k in range(1 << bits):
                cols = idx[:, k::1 << bits].astype(np.uint32)
                packed[:, :cols.shape[1]] |= cols << np.uint32(k * bpp)
            cur = np.uint32(_BLACK) | packed << 8
    pos = _put(buf, pos, 0, 1)
    groups = None
    if meta_bits:
        n_tiles = _sub(cur.shape[1], meta_bits) * _sub(h, meta_bits)
        groups = (np.arange(n_tiles) % meta_groups if np.ndim(meta_groups) == 0
                  else np.asarray(meta_groups))
        if groups.shape != (n_tiles,) or not 0 <= groups.min() <= groups.max() < 65536:
            raise ValueError(f"meta_groups gives one group of 0-65535 to each of the "
                             f"{n_tiles} tiles")
    image(cur, True, cache_bits, meta_bits, groups)
    return buf[:(pos + 7) >> 3].tobytes(), stats


def filter_alpha(alpha: np.ndarray, filter: int) -> np.ndarray:
    """An alpha plane -> its residuals under ALPH filter 0-3 (none,
    horizontal, vertical, gradient), libwebp's rules at the first row and
    column."""
    a = np.asarray(alpha).astype(np.int32)
    if filter == 0:
        return a.astype(np.uint8)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if filter == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif filter == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def encode_alpha(alpha: np.ndarray, compression: int = 1, filter: int = 0,
                 **options) -> bytes:
    """An (H, W) uint8 alpha plane -> an `ALPH` payload: compression 0 (raw)
    or 1 (a header-less VP8L stream of `encode_vp8l(**options)`, by default
    one colour-indexing transform), filter 0-3."""
    if compression not in (0, 1) or filter not in (0, 1, 2, 3):
        raise ValueError("ALPH compression is 0 or 1 and its filter 0-3")
    res = filter_alpha(alpha, filter)
    head = bytes([compression | filter << 2])
    if compression == 0:
        return head + res.tobytes()
    options.setdefault("transforms", ("palette",))
    return head + encode_vp8l(res, header=False, **options)[0]


# ------------------------------------------------------------ plain versions

class _Reader:
    """libwebp's VP8LBitReader (csrc/vp8l.cpp's BitReader)."""

    __slots__ = ("buf", "len", "pos", "val", "bit_pos", "eos")

    def __init__(self, data: bytes):
        self.buf, self.len = data, len(data)
        k = min(self.len, 8)
        self.val, self.pos, self.bit_pos, self.eos = int.from_bytes(data[:k], "little"), k, 0, 0

    def at_end(self) -> bool:
        return bool(self.eos) or (self.pos == self.len and self.bit_pos > 64)

    def set_end(self):
        self.eos, self.bit_pos = 1, 0

    def shift(self):
        while self.bit_pos >= 8 and self.pos < self.len:
            self.val = (self.val >> 8) | (self.buf[self.pos] << 56)
            self.pos += 1
            self.bit_pos -= 8
        if self.at_end():
            self.set_end()

    def prefetch(self) -> int:
        return (self.val >> (self.bit_pos & 63)) & 0xFFFFFFFF

    def fill(self):
        if self.bit_pos >= 32:
            self.shift()

    def read(self, n: int) -> int:
        if not self.eos and n <= 24:
            v = self.prefetch() & ((1 << n) - 1)
            self.bit_pos += n
            self.shift()
            return v
        self.set_end()
        return 0


class _Code:
    __slots__ = ("single", "count", "sorted", "root")


def _build_code(lengths: list, n: int, keep: bool):
    """csrc/vp8l.cpp's build_code -> (status, a _Code or None)."""
    count = [0] * 16
    for s in range(n):
        if lengths[s] > 15:
            return _BAD_CODE, None
        count[lengths[s]] += 1
    if count[0] == n:
        return _BAD_CODE, None
    code = _Code()
    code.single = -1
    if n - count[0] == 1:
        code.single = max(s for s in range(n) if lengths[s])
        return 0, code
    left = 1
    for ln in range(1, 16):
        left = (left << 1) - count[ln]
        if left < 0:
            return _BAD_CODE, None
    if left:
        return _BAD_CODE, None
    if not keep:
        return 0, None
    count[0] = 0
    code.count = count
    code.sorted = [s for ln in range(1, 16) for s in range(n) if lengths[s] == ln]
    code.root = [None] * 256
    c = k = 0
    for ln in range(1, 16):
        for _ in range(count[ln]):
            if ln <= 8:
                rev = int(format(c, f"0{ln}b")[::-1], 2)
                for r in range(rev, 256, 1 << ln):
                    code.root[r] = (code.sorted[k], ln)
            c += 1
            k += 1
        c <<= 1
    return 0, code


def _read_symbol(br: _Reader, code: _Code) -> int:
    if code.single >= 0:
        return code.single
    v = br.prefetch()
    hit = code.root[v & 0xFF]
    if hit is not None:
        br.bit_pos += hit[1]
        return hit[0]
    c = first = index = 0
    for ln in range(1, 9):
        c |= (v >> (ln - 1)) & 1
        first = (first + code.count[ln]) << 1
        index += code.count[ln]
        c <<= 1
    br.bit_pos += 8
    v = br.prefetch()
    for ln in range(9, 16):
        c |= (v >> (ln - 9)) & 1
        cnt = code.count[ln]
        if c - cnt < first:
            br.bit_pos += ln - 8
            return code.sorted[index + (c - first)]
        index += cnt
        first = (first + cnt) << 1
        c <<= 1
    return 0


class _Plain:
    """csrc/vp8l.cpp's Decoder: the reader, the statistics, the transforms."""

    def __init__(self, data: bytes, height: int):
        self.br = _Reader(data)
        self.info = [0] * len(STATS)
        self.info[0] = -1
        self.height = height
        self.seen = 0
        self.transforms = []

    def read_code(self, alphabet: int, keep: bool):
        br, info = self.br, self.info
        lengths = [0] * max(alphabet, 256)
        ok = True
        if br.read(1):
            num = br.read(1) + 1
            lengths[br.read(8 if br.read(1) else 1)] = 1
            if num == 2:
                lengths[br.read(8)] = 1
            info[_S["simple1" if num == 1 else "simple2"]] += 1
        else:
            info[_S["normal"]] += 1
            ccl = [0] * 19
            for i in range(br.read(4) + 4):
                ccl[CODE_LENGTH_ORDER[i]] = br.read(3)
            st, lcode = _build_code(ccl, 19, True)
            ok = st == 0
            if ok:
                max_symbol = alphabet
                if br.read(1):
                    info[_S["max_symbol"]] += 1
                    max_symbol = 2 + br.read(2 + 2 * br.read(3))
                    if max_symbol > alphabet:
                        ok = False
                symbol, prev = 0, 8
                while ok and symbol < alphabet:
                    if max_symbol == 0:
                        break
                    max_symbol -= 1
                    br.fill()
                    ln = _read_symbol(br, lcode)
                    if ln < 16:
                        lengths[symbol] = ln
                        symbol += 1
                        if ln:
                            prev = ln
                    else:
                        slot = ln - 16
                        info[_S["rep16"] + slot] += 1
                        repeat = (br.read(CODE_LENGTH_EXTRA_BITS[slot])
                                  + CODE_LENGTH_REPEAT_OFFSETS[slot])
                        if symbol + repeat > alphabet:
                            ok = False
                        else:
                            v = prev if ln == 16 else 0
                            lengths[symbol:symbol + repeat] = [v] * repeat
                            symbol += repeat
        ok = ok and not br.eos
        if not ok:
            return _BAD_CODE, None
        info[_S["max_len"]] = max(info[_S["max_len"]], max(lengths[:alphabet]))
        return _build_code(lengths, alphabet, keep)

    def read_codes(self, xsize: int, ysize: int, cache_bits: int, level0: bool):
        br = self.br
        num_groups, used, meta = 1, [True], (0, 0, None)
        if level0 and br.read(1):
            bits = 2 + br.read(3)
            xs = _sub(xsize, bits)
            st, img = self.stream(xs, _sub(ysize, bits), False, False)
            if st:
                return st, None, None
            image = [(p >> 8) & 0xFFFF for p in img]
            num_groups = max(image) + 1 if image else 1
            keep_all = num_groups <= 1000 and num_groups <= xsize * ysize
            used = [keep_all] * num_groups
            for g in image:
                used[g] = True
            self.info[_S["meta_bits"]], self.info[_S["groups"]] = bits, num_groups
            meta = (bits, xs, image)
        groups = {}
        for g in range(num_groups):
            codes = []
            for j in range(5):
                alphabet = ALPHABET_SIZE[j] + (1 << cache_bits if j == 0 and cache_bits else 0)
                st, code = self.read_code(alphabet, used[g])
                if st:
                    return st, None, None
                codes.append(code)
            if used[g]:
                groups[g] = codes
        return 0, meta, groups

    def transform(self, xsize: int):
        br, info = self.br, self.info
        kind = br.read(2)
        if self.seen & (1 << kind):
            return _BAD_TRANSFORM, xsize
        self.seen |= 1 << kind
        info[_S["order"]] |= kind << (4 * info[_S["transforms"]])
        info[_S["transforms"]] += 1
        t = {"type": kind, "bits": 0, "xsize": xsize, "data": None}
        self.transforms.append(t)
        st = 0
        if kind in (0, 1):
            t["bits"] = br.read(3) + 2
            info[_S["predictor_bits" if kind == 0 else "cross_bits"]] = t["bits"]
            st, t["data"] = self.stream(_sub(xsize, t["bits"]), _sub(self.height, t["bits"]),
                                        False, False)
        elif kind == 3:
            num = br.read(8) + 1
            bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
            t["bits"] = bits
            info[_S["palette"]], info[_S["palette_bits"]] = num, bits
            xsize = _sub(xsize, bits)
            st, pal = self.stream(num, 1, False, False)
            if st == 0:
                raw = np.array(pal, np.uint32).view(np.uint8)
                out = np.zeros(4 << (8 >> bits), np.uint8)
                out[:4] = raw[:4]
                for i in range(4, 4 * num):
                    out[i] = (int(raw[i]) + int(out[i - 4])) & 0xFF
                t["data"] = out.view(np.uint32).tolist()
        return st, xsize

    def stream(self, xsize: int, ysize: int, level0: bool, alpha: bool):
        """csrc/vp8l.cpp's decode_stream -> (status, pixels as a list)."""
        br, info = self.br, self.info
        txsize = xsize
        if level0:
            while br.read(1):
                st, txsize = self.transform(txsize)
                if st:
                    return st, None
        cache_bits = 0
        if br.read(1):
            cache_bits = br.read(4)
            if not 1 <= cache_bits <= 11:
                return _BAD_CACHE, None
        if level0:
            info[_S["cache_bits"]] = cache_bits
        st, meta, groups = self.read_codes(txsize, ysize, cache_bits, level0)
        if st:
            return st, None
        if (alpha and len(self.transforms) == 1 and self.transforms[0]["type"] == 3
                and cache_bits == 0
                and all(c[j].single >= 0 for c in groups.values() for j in (1, 2, 3))):
            info[_S["alpha_8b"]] = 1
            st, data = self.alpha_8b(meta, groups, txsize, ysize)
            return st, data and [v << 8 for v in data]
        return self.data(meta, groups, cache_bits, txsize, ysize)

    def data(self, meta, groups, cache_bits: int, width: int, height: int):
        """csrc/vp8l.cpp's decode_data."""
        br, info = self.br, self.info
        total = width * height
        data = [0] * total
        pos = last_cached = col = row = 0
        size = 1 << cache_bits if cache_bits else 0
        cache, shift = [0] * size, 32 - cache_bits
        mbits, mxs, mimage = meta
        status = 0
        while pos < total:
            g = groups[mimage[mxs * (row >> mbits) + (col >> mbits)]] if mbits else groups[0]
            br.fill()
            code = _read_symbol(br, g[0])
            if br.at_end():
                break
            if code < 256:
                red = _read_symbol(br, g[1])
                br.fill()
                blue = _read_symbol(br, g[2])
                alpha = _read_symbol(br, g[3])
                if br.at_end():
                    break
                data[pos] = alpha << 24 | red << 16 | code << 8 | blue
                pos += 1
                info[_S["literals"]] += 1
                col += 1
                if col >= width:
                    col, row = 0, row + 1
                    if size:
                        for p in range(last_cached, pos):
                            cache[((data[p] * _HASH_MUL) & 0xFFFFFFFF) >> shift] = data[p]
                        last_cached = pos
            elif code < 280:
                length = _copy_value(code - 256, br)
                dist_symbol = _read_symbol(br, g[4])
                br.fill()
                dist_code = _copy_value(dist_symbol, br)
                dist = _plane_to_distance(width, dist_code)
                if br.at_end():
                    break
                if pos < dist or total - pos < length:
                    status = _BAD_COPY
                    break
                for i in range(pos, pos + length):
                    data[i] = data[i - dist]
                info[_S["copies"]] += 1
                info[_S["long_copies" if dist_code > 120 else "plane_copies"]] += 1
                pos += length
                col += length
                while col >= width:
                    col, row = col - width, row + 1
                if size:
                    for p in range(last_cached, pos):
                        cache[((data[p] * _HASH_MUL) & 0xFFFFFFFF) >> shift] = data[p]
                    last_cached = pos
            else:
                for p in range(last_cached, pos):
                    cache[((data[p] * _HASH_MUL) & 0xFFFFFFFF) >> shift] = data[p]
                last_cached = pos
                data[pos] = cache[code - 280]
                pos += 1
                info[_S["cache_hits"]] += 1
                col += 1
                if col >= width:
                    col, row = 0, row + 1
                    for p in range(last_cached, pos):
                        cache[((data[p] * _HASH_MUL) & 0xFFFFFFFF) >> shift] = data[p]
                    last_cached = pos
        info[0] = pos
        if status:
            return status, None
        br.eos = int(br.at_end())
        return (_CUT, None) if br.eos else (0, data)

    def alpha_8b(self, meta, groups, width: int, height: int):
        """csrc/vp8l.cpp's decode_alpha_8b."""
        br, info = self.br, self.info
        end = width * height
        data = [0] * end
        pos = col = row = 0
        ok = True
        mbits, mxs, mimage = meta
        while not br.eos and pos < end:
            g = groups[mimage[mxs * (row >> mbits) + (col >> mbits)]] if mbits else groups[0]
            br.fill()
            code = _read_symbol(br, g[0])
            if code < 256:
                data[pos] = code
                pos += 1
                info[_S["literals"]] += 1
                col += 1
                if col >= width:
                    col, row = 0, row + 1
            else:
                length = _copy_value(code - 256, br)
                dist_symbol = _read_symbol(br, g[4])
                br.fill()
                dist_code = _copy_value(dist_symbol, br)
                dist = _plane_to_distance(width, dist_code)
                if pos >= dist and end - pos >= length:
                    for i in range(pos, pos + length):
                        data[i] = data[i - dist]
                else:
                    ok = False
                    break
                info[_S["copies"]] += 1
                info[_S["long_copies" if dist_code > 120 else "plane_copies"]] += 1
                pos += length
                col += length
                while col >= width:
                    col, row = col - width, row + 1
            br.eos = int(br.at_end())
        br.eos = int(br.at_end())
        info[0] = pos
        if not ok:
            return _BAD_COPY, None
        return (_CUT, None) if br.eos and pos < end else (0, data)

    def inverse(self, img: list, height: int) -> np.ndarray:
        """csrc/vp8l.cpp's inverse_transforms -> (height, width) uint32."""
        for t in reversed(self.transforms):
            width, bits, kind = t["xsize"], t["bits"], t["type"]
            if kind == 0:
                out = [0] * (width * height)
                tiles = _sub(width, bits)
                modes = t["data"]
                for y in range(height):
                    for x in range(width):
                        i = y * width + x
                        if y == 0:
                            pred = _BLACK if x == 0 else out[i - 1]
                        elif x == 0:
                            pred = out[i - width]
                        else:
                            mode = (modes[(y >> bits) * tiles + (x >> bits)] >> 8) & 0xF
                            self.info[_S["predictor_modes"]] |= 1 << mode
                            pred = _predict_plain(mode, out, i, width)
                        out[i] = _add_pixels(img[i], pred)
                img = out
            elif kind == 1:
                arr = np.array(img, np.uint32).reshape(height, width)
                tiles = _sub(width, bits)
                y, x = np.mgrid[:height, :width]
                m = np.array(t["data"], np.uint32)[(y >> bits) * tiles + (x >> bits)]
                a, r, g, b = _channels(arr)
                g8 = g.astype(np.uint8).view(np.int8)
                new_r = (r + _delta((m & 0xFF).astype(np.uint8).view(np.int8), g8)) & 0xFF
                new_b = (b + _delta(((m >> 8) & 0xFF).astype(np.uint8).view(np.int8), g8)
                         + _delta(((m >> 16) & 0xFF).astype(np.uint8).view(np.int8),
                                  new_r.astype(np.uint8).view(np.int8))) & 0xFF
                img = _join([a, new_r, g, new_b]).ravel().tolist()
            elif kind == 2:
                arr = np.array(img, np.uint32)
                a, r, g, b = _channels(arr)
                img = _join([a, r + g, g, b + g]).tolist()
            else:
                in_width = _sub(width, bits)
                arr = np.array(img, np.uint32).reshape(height, in_width)
                bpp = 8 >> bits
                x = np.arange(width)
                packed = (arr[:, x >> bits] >> 8) & 0xFF
                idx = (packed >> ((x & ((1 << bits) - 1)) * bpp).astype(np.uint32)) & (
                    (1 << bpp) - 1)
                img = np.array(t["data"], np.uint32)[idx].ravel().tolist()
        return np.array(img, np.uint32).reshape(height, -1)


def _copy_value(symbol: int, br: _Reader) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _plane_to_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = CODE_TO_PLANE[code - 1]
    dist = (d >> 4) * xsize + 8 - (d & 0xF)
    return dist if dist >= 1 else 1


def _add_pixels(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _ave2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _predict_plain(mode: int, out: list, i: int, w: int) -> int:
    L, T, TL, TR = out[i - 1], out[i - w], out[i - w - 1], out[i - w + 1]
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _ave2(_ave2(L, TR), T)
    if mode == 6:
        return _ave2(L, TL)
    if mode == 7:
        return _ave2(L, T)
    if mode == 8:
        return _ave2(TL, T)
    if mode == 9:
        return _ave2(T, TR)
    if mode == 10:
        return _ave2(_ave2(L, TL), _ave2(T, TR))
    if mode == 11:
        d = sum(abs(((L >> s) & 0xFF) - ((TL >> s) & 0xFF))
                - abs(((T >> s) & 0xFF) - ((TL >> s) & 0xFF)) for s in (24, 16, 8, 0))
        return T if d <= 0 else L
    if mode == 12:
        return sum(min(max(((L >> s) & 0xFF) + ((T >> s) & 0xFF) - ((TL >> s) & 0xFF), 0), 255)
                   << s for s in (24, 16, 8, 0))
    if mode == 13:
        ave = _ave2(L, T)
        out_v = 0
        for s in (24, 16, 8, 0):
            a, b = (ave >> s) & 0xFF, (TL >> s) & 0xFF
            out_v |= min(max(a + int((a - b) / 2), 0), 255) << s
        return out_v
    return _BLACK


def vp8l_decode_plain(stream: bytes, path: str = "<bytes>"):
    """`decode_vp8l` as a Python loop over the bits and the pixels (the
    plain version)."""
    w, h, _ = vp8l_size(stream, path)
    d = _Plain(stream, h)
    br = d.br
    ok = br.read(8) == 0x2F
    for n in (14, 14, 1):                      # the sizes (read by vp8l_size) and the alpha bit
        br.read(n)
    if not ok or br.read(3) != 0:
        raise _status_error(_BAD_HEADER, "VP8L data", path)
    if br.eos:
        raise _status_error(_CUT, "VP8L data", path)
    st, img = d.stream(w, h, True, False)
    if st:
        raise _status_error(_CUT if br.at_end() else st, "VP8L data", path)
    return d.inverse(img, h), np.array(d.info, np.int64)


def alpha_decode_plain(payload: bytes, width: int, height: int, path: str = "<bytes>"):
    """`decode_alpha` as a Python loop (the plain version)."""
    info = [0] * len(STATS)
    info[0] = -1
    if len(payload) <= 1:
        raise _status_error(_SHORT_ALPHA, "", path)
    head = payload[0]
    method, filt, pre = head & 3, (head >> 2) & 3, (head >> 4) & 3
    if method > 1 or pre > 1 or head >> 6:
        raise _status_error(_BAD_ALPHA_HEADER, "", path)
    if method == 0:
        if len(payload) - 1 < width * height:
            raise _status_error(_SHORT_ALPHA, "", path)
        a = np.frombuffer(payload, np.uint8, width * height, 1).reshape(height, width).copy()
    else:
        d = _Plain(payload[1:], height)
        st, img = d.stream(width, height, True, True)
        if st:
            raise _status_error(_CUT if d.br.at_end() else st, "WebP alpha (ALPH) data", path)
        a = ((d.inverse(img, height) >> 8) & 0xFF).astype(np.uint8)
        info = d.info
    info[_S["alpha_method"]], info[_S["alpha_filter"]], info[_S["alpha_pre"]] = method, filt, pre
    return _unfilter_plain(a, filt), np.array(info, np.int64)


def _unfilter_plain(a: np.ndarray, filt: int) -> np.ndarray:
    """The ALPH unfilters, row by row (csrc/vp8l.cpp's unfilter_alpha)."""
    out = a.astype(np.int64)
    h, w = out.shape
    if filt == 0:
        return a
    for y in range(h):
        if y == 0 or filt == 1:
            pred = 0 if y == 0 else int(out[y - 1, 0])
            row = out[y].copy()
            row[0] += pred
            out[y] = np.cumsum(row) & 0xFF
        elif filt == 2:
            out[y] = (out[y] + out[y - 1]) & 0xFF
        else:
            prev = out[y - 1].tolist()
            left = top_left = prev[0]
            row = out[y].tolist()
            for i in range(w):
                g = left + prev[i] - top_left
                left = (row[i] + min(max(g, 0), 255)) & 0xFF
                top_left = prev[i]
                row[i] = left
            out[y] = row
    return out.astype(np.uint8)
