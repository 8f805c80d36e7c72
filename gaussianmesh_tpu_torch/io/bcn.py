"""Block-compressed (BCn) textures in the port's own decoders, to the arrays
PIL 12's C `bcn` decoder gives (the JAX reader opens dataset images with
PIL; the machines the port runs on have none).

Blocks cover 4 x 4 tiles, row-major; pixels of the right and bottom tiles
past the image are dropped. Data holding fewer whole blocks than the image
needs raises, as PIL's "image file is truncated". The kinds are PIL's
decoder numbers (`Image.frombytes(mode, size, data, "bcn", (n, format))`):

- BC1 (DXT1), 8 bytes a tile, to RGBA: two little-endian 565 colours whose
  channels replicate their high bits into the low ones (31 reads 255), then
  2-bit indices, the first pixel in the low bits. Where the first colour's
  word is over the second's the block has four opaque colours, the two and
  their thirds; otherwise three, the two and their half, and transparent
  black.
- BC2 (DXT3), 16 bytes, to RGBA: 4-bit alphas (x 17, the low nibble
  first), then a BC1 colour block that always has four colours.
- BC3 (DXT5), 16 bytes, to RGBA: a BC4 block as the alpha, then BC2's
  colour block.
- BC4, 8 bytes, to L: two 8-bit ends and 3-bit indices; where the first is
  over the second, the ends and six sevenths between them, else the ends,
  four fifths between them, 0 and 255 (each an integer quotient).
- BC5, 16 bytes, to RGB: two BC4 blocks, R and G; B is 0. Signed (BC5S)
  ends read as int8 + 128 (B then 128), as PIL reads them.
- BC7, 16 bytes, to RGBA: the mode is the first set bit of the first byte;
  its partition (64 of two subsets, 64 of three, with their anchor
  indices), rotation and index selection (modes 4 and 5), the endpoints
  channel by channel, unique or shared p-bits, the endpoints expanded by
  replicating their high bits, then the 2-, 3- or 4-bit weights (modes 4
  and 5 with a second index set for the alpha), ((64 - w) e0 + w e1 + 32)
  >> 6. A first byte of 0 (the reserved mode) reads opaque black.
- BC6H, 16 bytes, to RGB, unsigned (`BC6H`) or signed (`BC6HS`,
  `signed=True`): the mode is the first 2 bits, or 5 where those are 10 or
  11 (14 modes; 0x13, 0x17, 0x1B and 0x1F are reserved and read black).
  Each mode scatters its endpoint fields over the block in its own order
  (`_BC6H_MODES`, the definition's table: Microsoft's D3D11 BC6H format
  description, Khronos' Data Format Specification; some fields run from
  their high bit down). Two regions (a 5-bit partition of BC7's 32 first
  two-subset ones, 3-bit weights, region 1's anchor from BC7's table) or
  one (4-bit weights); an anchor index is one bit shorter. Transformed
  modes store the endpoints after the first as deltas, sign-extended and
  added modulo the endpoint precision. Unsigned endpoints unquantize as
  0 -> 0, the largest -> 0xFFFF, else ((e << 15) + 0x4000) >> (bits - 1);
  signed ones by their magnitude, at or over 2^(bits - 1) - 1 -> 0x7FFF.
  The weights blend as (e0 (64 - w) + e1 w) >> 6, with no + 32 (PIL's
  `bc6_lerp`; the definition rounds: C11, at most one 8-bit level), then
  the half float is (v 31) >> 6 unsigned, or the sign and (|v| 31) >> 5.
  PIL brings each half h down to 8 bits as floor(255 h) in float32 with h
  clamped to [0, 1]: a negative half reads 0, 1.0 (0x3C00) and over 255,
  0x1C05 the first 1 (settled on every half of both signs through mode
  0x0F, whose 16-bit endpoints unquantize as they are:
  `tests/test_torch_bc6h.py::test_half_to_8_bits_is_pils_rule`). Under
  BC6HS PIL sign-extends the first endpoint but reads the transformed
  ones unsigned, so a negative one reads as a large positive (255 where
  the definition gives 0): fault B38; the port sign-extends them, as the
  definition says.

`shift565=True` reads BC1-BC3 as BLP's own Python decoders
(`BlpImagePlugin.decode_dxt1` / `3` / `5`): the 565 channels shifted up
with zero low bits (31 reads 248), and BC1's rule in BC2 and BC3 too: four
colours always.

The blocks are decoded by the port's C++ (`gm_bc1_decode` and
`gm_bcn_decode` of `csrc/image.cpp`, built by `ops/_cuda.py::host_library`
at first use; a failed build raises). `_bc1_plain` and `decode_plain` are
the same rules in numpy, the versions the C++ is held to byte for byte;
the training path never calls them.

`encode_bc1` writes BC1 blocks of an RGB image (each tile's colour box
corners as its two colours, every pixel the nearest of the four along
the line between them); `encode_bc2`, `encode_bc3`, `encode_bc4`,
`encode_bc5` and `encode_bc7` (mode 6: one subset, the RGBA box corners
as the endpoints) write the others in the same style, and `encode_bc6h`
BC6H of mode 0x03 (one region, 10-bit endpoints, 4-bit weights). They are for the
tests and `chip_smoke.py`; the training path does not write textures.
"""

from __future__ import annotations

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

BC1, BC2, BC3, BC4, BC5, BC6H, BC7 = 1, 2, 3, 4, 5, 6, 7
BLOCK_BYTES = {BC1: 8, BC2: 16, BC3: 16, BC4: 8, BC5: 16, BC6H: 16, BC7: 16}
CHANNELS = {BC1: 4, BC2: 4, BC3: 4, BC4: 1, BC5: 3, BC6H: 3, BC7: 4}


def bc1_blocks(width: int, height: int) -> int:
    """The BC1 blocks a width x height image takes."""
    return ((width + 3) // 4) * ((height + 3) // 4)


def _check(data: bytes, width: int, height: int, path: str, kind: int = BC1) -> None:
    need = BLOCK_BYTES[kind] * bc1_blocks(width, height)
    if len(data) < need:
        raise ValueError(f"{path}: BC{kind} data holds {len(data)} of {need} bytes (PIL: "
                         "image file is truncated)")


def _args(kind: int, signed: bool, shift565: bool) -> int:
    """The flags of `gm_bcn_decode` (bit 0 signed, bit 1 shifted 565),
    checked against the kind."""
    if kind not in BLOCK_BYTES:
        raise ValueError(f"BC{kind}: not a block kind the port decodes (1-7)")
    if signed and kind not in (BC5, BC6H):
        raise ValueError("only BC5 and BC6H have a signed form")
    if shift565 and kind not in (BC1, BC2, BC3):
        raise ValueError("the shifted 565 colours are BC1-BC3's")
    return int(signed) | int(shift565) << 1


def _out(kind: int, width: int, height: int) -> np.ndarray:
    c = CHANNELS[kind]
    return np.empty((height, width) + (() if c == 1 else (c,)), np.uint8)


def decode_bc1(data: bytes, width: int, height: int, path: str = "<bytes>") -> np.ndarray:
    """BC1 blocks -> uint8 (height, width, 4) RGBA (`gm_bc1_decode`)."""
    _check(data, width, height, path)
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    info = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_bc1_decode(src.ctypes.data, len(src), width,
                                                       height, out.ctypes.data,
                                                       info.ctypes.data)
    if status:
        raise RuntimeError(f"gm_bc1_decode returned {status}")
    return out


def decode(kind: int, data: bytes, width: int, height: int, path: str = "<bytes>", *,
           signed: bool = False, shift565: bool = False) -> np.ndarray:
    """Blocks of `kind` -> uint8 (height, width, 4) RGBA (BC1-BC3, BC7),
    (height, width) L (BC4) or (height, width, 3) RGB (BC5, BC6H), by
    `gm_bcn_decode`."""
    flags = _args(kind, signed, shift565)
    _check(data, width, height, path, kind)
    src = np.frombuffer(data, np.uint8)
    out = _out(kind, width, height)
    info = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_bcn_decode(src.ctypes.data, len(src), width,
                                                       height, kind, flags,
                                                       out.ctypes.data, info.ctypes.data)
    if status:
        raise RuntimeError(f"gm_bcn_decode returned {status}")
    return out


# ------------------------------------------------------------------ plain

def _expand565(v: np.ndarray, shift: bool = False) -> np.ndarray:
    """uint16 565 words -> int32 (..., 3), each channel's high bits
    replicated into its low ones (or shifted up, `shift`)."""
    v = v.astype(np.int32)
    r, g, b = v >> 11 & 31, v >> 5 & 63, v & 31
    if shift:
        return np.stack([r << 3, g << 2, b << 3], -1)
    return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2], -1)


def _palettes(c0: np.ndarray, c1: np.ndarray, four=None, shift: bool = False) -> np.ndarray:
    """Each block's four colours as PIL's `decode_bc1_color` makes them ->
    int32 (n, 4, 4) RGBA; `four` (default c0 > c1) says which blocks have
    four opaque colours."""
    p0, p1 = _expand565(c0, shift), _expand565(c1, shift)
    four = (c0 > c1)[:, None] if four is None else np.broadcast_to(four, c0.shape)[:, None]
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    rgb = np.stack([p0, p1, p2, p3], 1)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.int32)
    alpha[:, 3, 0] = np.where(four[:, 0], 255, 0)
    return np.concatenate([rgb, alpha], 2)


def _colour(blocks8: np.ndarray, four=None, shift: bool = False) -> np.ndarray:
    """BC1 colour blocks (n, 8) -> int32 (n, 16, 4) RGBA."""
    words = blocks8[:, :4].copy().view("<u2")
    lut = blocks8[:, 4:].copy().view("<u4")[:, 0]
    idx = (lut[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    pal = _palettes(words[:, 0], words[:, 1], four, shift)
    return np.take_along_axis(pal, idx[..., None].astype(np.int64), 1)


def _bc4_levels(a0: np.ndarray, a1: np.ndarray) -> np.ndarray:
    """BC4 ends (n,) int32 -> the eight levels (n, 8) of PIL's
    `decode_bc3_alpha`."""
    k = np.arange(2, 8)
    eight = ((8 - k) * a0[:, None] + (k - 1) * a1[:, None]) // 7
    six = ((6 - k[:4]) * a0[:, None] + (k[:4] - 1) * a1[:, None]) // 5
    six = np.concatenate([six, np.zeros_like(six[:, :1]), np.full_like(six[:, :1], 255)], 1)
    mid = np.where((a0 > a1)[:, None], eight, six)
    return np.concatenate([a0[:, None], a1[:, None], mid], 1)


def _bc4(blocks8: np.ndarray, signed: bool = False) -> np.ndarray:
    """BC4 blocks (n, 8) -> int32 (n, 16) values."""
    ends = blocks8[:, :2].view(np.int8) if signed else blocks8[:, :2]
    ends = ends.astype(np.int32) + (128 if signed else 0)
    bits = np.zeros(len(blocks8), np.uint64)
    for k in range(6):
        bits |= blocks8[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
    idx = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))) & np.uint64(7)
    return np.take_along_axis(_bc4_levels(ends[:, 0], ends[:, 1]), idx.astype(np.int64), 1)


# BC7's modes: subsets, partition bits, rotation bits, index-selection bits,
# colour and alpha endpoint bits, unique and shared p-bits, index bits and
# the second index set's bits (modes 4 and 5)
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# the partitions: bit i (two subsets) or bits 2i, 2i + 1 (three) give pixel
# i's subset
BC7_PARTITIONS2 = (
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
BC7_PARTITIONS3 = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254)
# the anchor (one index bit fewer) of subset 1 of two, and of subsets 1 and 2
# of three; subset 0's is pixel 0
BC7_ANCHORS2 = (
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15,
    2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8,
    15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
BC7_ANCHORS3A = (
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6,
    8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8,
    5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
BC7_ANCHORS3B = (
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3,
    15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
BC7_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
               4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


def _subsets(ns: int, part: np.ndarray) -> np.ndarray:
    """Each pixel's subset (k, 16) of blocks of `ns` subsets."""
    i = np.arange(16)
    if ns == 1:
        return np.zeros((len(part), 16), np.int64)
    if ns == 2:
        return (np.array(BC7_PARTITIONS2, np.int64)[part][:, None] >> i) & 1
    return (np.array(BC7_PARTITIONS3, np.int64)[part][:, None] >> (2 * i)) & 3


def _anchor(ns: int, part: np.ndarray) -> np.ndarray:
    """Whether each pixel (k, 16) holds one index bit fewer."""
    i = np.arange(16)
    a = np.repeat(i[None] == 0, len(part), 0)
    if ns == 2:
        a = a | (i[None] == np.array(BC7_ANCHORS2)[part][:, None])
    elif ns == 3:
        a = (a | (i[None] == np.array(BC7_ANCHORS3A)[part][:, None])
             | (i[None] == np.array(BC7_ANCHORS3B)[part][:, None]))
    return a


def _read(bits: np.ndarray, start: np.ndarray, width: np.ndarray) -> np.ndarray:
    """Little-endian fields of `width` bits at `start` ((k, m) each) of
    blocks' bit rows (k, 128) -> int64 (k, m)."""
    top = max(int(width.max(initial=0)), 1)
    k = np.arange(top)
    pos = np.minimum(start[..., None] + k, 127)
    got = np.take_along_axis(bits[:, None, :], pos.reshape(len(bits), -1, top), 2)
    return ((got.astype(np.int64) << k) * (k < width[..., None])).sum(-1)


def _bc7_mode(bits: np.ndarray, m: int) -> np.ndarray:
    """BC7 blocks of mode `m` as bit rows (k, 128) -> int32 (k, 16, 4)."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[m]
    n = len(bits)
    pos = m + 1

    def take(width):
        nonlocal pos
        v = _read(bits, np.full((n, 1), pos), np.full((n, 1), width))[:, 0]
        pos += width
        return v
    part, rot, sel = take(pb), take(rb), take(isb)
    ne = 2 * ns
    ep = np.full((n, ne, 4), 255, np.int64)
    for ch in range(4 if ab else 3):
        for e in range(ne):
            ep[:, e, ch] = take(cb if ch < 3 else ab)
    cbits, abits = cb, ab
    nch = 4 if ab else 3
    if epb or spb:
        cbits, abits = cb + 1, ab + (1 if ab else 0)
        for e in range(0, ne, 1 if epb else 2):
            p = take(1)
            for f in ((e,) if epb else (e, e + 1)):
                ep[:, f, :nch] = ep[:, f, :nch] << 1 | p[:, None]
    for ch in range(nch):
        b = cbits if ch < 3 else abits
        v = (ep[:, :, ch] << (8 - b)) & 255
        ep[:, :, ch] = v | v >> b
    sub = _subsets(ns, part)
    widths = ib - _anchor(ns, part)
    starts = pos + np.cumsum(widths, 1) - widths
    i0 = _read(bits, starts, widths)
    cw = np.array(BC7_WEIGHTS[ib])
    if ab and ib2:
        w2 = ib2 - (np.arange(16) == 0)[None].repeat(n, 0)
        s2 = pos + 16 * ib - ns + np.cumsum(w2, 1) - w2
        i1 = _read(bits, s2, w2)
        aw = np.array(BC7_WEIGHTS[ib2])
        sel = sel[:, None].astype(bool)
        wc = np.where(sel, aw[i1], cw[i0])
        wa = np.where(sel, cw[i0], aw[i1])
    else:
        wc = wa = cw[i0]
    e0 = np.take_along_axis(ep, (2 * sub)[..., None], 1)
    e1 = np.take_along_axis(ep, (2 * sub + 1)[..., None], 1)
    w = np.concatenate([np.repeat(wc[..., None], 3, 2), wa[..., None]], 2)
    px = ((64 - w) * e0 + w * e1 + 32) >> 6
    for r in (1, 2, 3):
        sw = rot == r
        px[sw, :, r - 1], px[sw, :, 3] = px[sw, :, 3], px[sw, :, r - 1].copy()
    return px.astype(np.int32)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    """BC7 blocks (n, 16) -> int32 (n, 16, 4) RGBA."""
    out = np.zeros((len(blocks), 16, 4), np.int32)
    out[..., 3] = 255                        # the reserved mode: opaque black
    first = blocks[:, 0].astype(np.int64)
    mode = np.full(len(blocks), -1)
    for m in range(7, -1, -1):
        mode[(first >> m) & 1 == 1] = m
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    for m in range(8):
        sel = mode == m
        if sel.any():
            out[sel] = _bc7_mode(bits[sel], m)
    return out


# BC6H's modes: the mode's value, its bits, regions, whether the endpoints
# after the first are deltas, the endpoint bits, the delta bits of R, G and
# B, then its endpoint fields in the order they follow the mode bits: a
# channel (r, g, b), an endpoint (w, x: region 0's two; y, z: region 1's)
# and its bits, low to high or (as in rw15:10) high to low. Two regions end
# at bit 77 and a 5-bit partition follows; their weights start at bit 82,
# one region's at bit 65.
_BC6H_MODES = (
    (0x00, 2, 2, 1, 10, (5, 5, 5), "gy4 by4 bz4 rw0:9 gw0:9 bw0:9 rx0:4 gz4 gy0:3 gx0:4 bz0 "
     "gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (0x01, 2, 2, 1, 7, (6, 6, 6), "gy5 gz4 gz5 rw0:6 bz0 bz1 by4 gw0:6 by5 bz2 gy4 bw0:6 bz3 "
     "bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 bx0:5 by0:3 ry0:5 rz0:5"),
    (0x02, 5, 2, 1, 11, (5, 4, 4), "rw0:9 gw0:9 bw0:9 rx0:4 rw10 gy0:3 gx0:3 gw10 bz0 gz0:3 "
     "bx0:3 bw10 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (0x06, 5, 2, 1, 11, (4, 5, 4), "rw0:9 gw0:9 bw0:9 rx0:3 rw10 gz4 gy0:3 gx0:4 gw10 gz0:3 "
     "bx0:3 bw10 bz1 by0:3 ry0:3 bz0 bz2 rz0:3 gy4 bz3"),
    (0x0A, 5, 2, 1, 11, (4, 4, 5), "rw0:9 gw0:9 bw0:9 rx0:3 rw10 by4 gy0:3 gx0:3 gw10 bz0 "
     "gz0:3 bx0:4 bw10 by0:3 ry0:3 bz1 bz2 rz0:3 bz4 bz3"),
    (0x0E, 5, 2, 1, 9, (5, 5, 5), "rw0:8 by4 gw0:8 gy4 bw0:8 bz4 rx0:4 gz4 gy0:3 gx0:4 bz0 "
     "gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (0x12, 5, 2, 1, 8, (6, 5, 5), "rw0:7 gz4 by4 gw0:7 bz2 gy4 bw0:7 bz3 bz4 rx0:5 gy0:3 "
     "gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:5 rz0:5"),
    (0x16, 5, 2, 1, 8, (5, 6, 5), "rw0:7 bz0 by4 gw0:7 gy5 gy4 bw0:7 gz5 bz4 rx0:4 gz4 gy0:3 "
     "gx0:5 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (0x1A, 5, 2, 1, 8, (5, 5, 6), "rw0:7 bz1 by4 gw0:7 by5 gy4 bw0:7 bz5 bz4 rx0:4 gz4 gy0:3 "
     "gx0:4 bz0 gz0:3 bx0:5 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (0x1E, 5, 2, 0, 6, (6, 6, 6), "rw0:5 gz4 bz0 bz1 by4 gw0:5 gy5 by5 bz2 gy4 bw0:5 gz5 bz3 "
     "bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 bx0:5 by0:3 ry0:5 rz0:5"),
    (0x03, 5, 1, 0, 10, (10, 10, 10), "rw0:9 gw0:9 bw0:9 rx0:9 gx0:9 bx0:9"),
    (0x07, 5, 1, 1, 11, (9, 9, 9), "rw0:9 gw0:9 bw0:9 rx0:8 rw10 gx0:8 gw10 bx0:8 bw10"),
    (0x0B, 5, 1, 1, 12, (8, 8, 8), "rw0:9 gw0:9 bw0:9 rx0:7 rw11:10 gx0:7 gw11:10 bx0:7 "
     "bw11:10"),
    (0x0F, 5, 1, 1, 16, (4, 4, 4), "rw0:9 gw0:9 bw0:9 rx0:3 rw15:10 gx0:3 gw15:10 bx0:3 "
     "bw15:10"))
BC6H_MODES = tuple(m[0] for m in _BC6H_MODES)
BC6H_RESERVED = (0x13, 0x17, 0x1B, 0x1F)


def _bc6h_fields(layout: str) -> list:
    """A mode's layout -> [(endpoint slot 3 e + channel, bit)] in stream
    order."""
    out = []
    for tok in layout.split():
        slot = 3 * "wxyz".index(tok[1]) + "rgb".index(tok[0])
        lo, _, hi = tok[2:].partition(":")
        a, b = int(lo), int(hi or lo)
        out += [(slot, bit) for bit in range(a, b + (1 if b >= a else -1), 1 if b >= a else -1)]
    return out


def _sign_extend(v: np.ndarray, bits) -> np.ndarray:
    return np.where(v & (1 << (np.asarray(bits) - 1)), v - (1 << np.asarray(bits)), v)


def _bc6h_unquantize(v: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if not signed:
        if bits >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << bits) - 1, 0xFFFF,
                                            ((v << 15) + 0x4000) >> (bits - 1)))
    if bits >= 16:
        return v
    m = np.abs(v)
    m = np.where(m == 0, 0, np.where(m >= (1 << (bits - 1)) - 1, 0x7FFF,
                                     ((m << 15) + 0x4000) >> (bits - 1)))
    return np.where(v < 0, -m, m)


def _half_to_8(v: np.ndarray, signed: bool) -> np.ndarray:
    """Blended values -> the 8-bit samples PIL gives: the half of the
    definition's last step, floor(255 h) in float32, h clamped to [0, 1]."""
    if signed:
        m = (np.abs(v) * 31) >> 5
        h = np.where(v < 0, 0x8000 | m, m)
    else:
        h = (v * 31) >> 6
    f = h.astype(np.uint16).view(np.float16).astype(np.float32)
    return np.floor(np.clip(f, 0, 1) * np.float32(255)).astype(np.int32)


def bc6h_stored(blocks: np.ndarray, mode: int) -> np.ndarray:
    """BC6H blocks (k, 16) of one mode -> their endpoint fields as stored
    (k, 12) int64 (r, g, b of w, x, y, z; deltas where the mode transforms
    them): `bc6h_block`'s `fields`."""
    _, mbits, _, _, _, _, layout = _BC6H_MODES[BC6H_MODES.index(mode)]
    raw = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
    ep = np.zeros((len(blocks), 12), np.int64)
    for i, (slot, bit) in enumerate(_bc6h_fields(layout)):
        ep[:, slot] |= raw[:, mbits + i] << bit
    return ep


def bc6h_endpoints(blocks: np.ndarray, mode: int, signed: bool) -> np.ndarray:
    """BC6H blocks (k, 16) of one mode -> their endpoints (k, 12) int64 (r,
    g, b of w, x, y, z) as the definition reads them: deltas added modulo
    the endpoint bits and, signed, every endpoint sign-extended."""
    _, _, ns, transformed, bits, delta, _ = _BC6H_MODES[BC6H_MODES.index(mode)]
    ep = bc6h_stored(blocks, mode)
    n = 6 * ns
    if transformed:
        d = np.array(delta * 4)[3:n]
        ep[:, 3:n] = (np.tile(ep[:, :3], ns * 2 - 1) + _sign_extend(ep[:, 3:n], d)) & (
            (1 << bits) - 1)
    if signed:
        ep[:, :n] = _sign_extend(ep[:, :n], bits)
    return ep


def bc6h_block(mode: int, fields: np.ndarray, part, idx: np.ndarray) -> np.ndarray:
    """BC6H blocks of one mode from their stored fields: `fields` (k, 12)
    the endpoint fields as stored (r, g, b of w, x, y, z: deltas where the
    mode transforms them), `part` (k,) the partition (two regions), `idx`
    (k, 16) the weights' indices (an anchor's high bit left out) -> (k, 16)
    uint8."""
    value, mbits, ns, _, _, _, layout = _BC6H_MODES[BC6H_MODES.index(mode)]
    fields, idx = np.asarray(fields, np.int64), np.asarray(idx, np.int64)
    k = len(fields)
    bits = np.zeros((k, 128), np.uint8)
    bits[:, :mbits] = (value >> np.arange(mbits)) & 1
    for i, (slot, bit) in enumerate(_bc6h_fields(layout)):
        bits[:, mbits + i] = (fields[:, slot] >> bit) & 1
    part = np.broadcast_to(np.asarray(part, np.int64), (k,))
    if ns == 2:
        bits[:, 77:82] = (part[:, None] >> np.arange(5)) & 1
    widths = (3 if ns == 2 else 4) - _anchor(ns, part)
    at = (82 if ns == 2 else 65) + np.cumsum(widths, 1) - widths
    for t in range(4):
        on = t < widths
        rows = np.nonzero(on)[0]
        bits[rows, at[on] + t] = (idx[on] >> t) & 1
    return np.packbits(bits, axis=1, bitorder="little")


def _bc6h(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """BC6H blocks (n, 16) -> int32 (n, 16, 3) RGB as PIL gives them but
    for B38 (every endpoint sign-extended under BC6HS)."""
    out = np.zeros((len(blocks), 16, 3), np.int32)       # the reserved modes: black
    two = blocks[:, 0] & 3
    mode = np.where(two < 2, two, blocks[:, 0] & 31)
    raw = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
    i = np.arange(16)
    for value, _, ns, _, bits, _, _ in _BC6H_MODES:
        sel = mode == value
        if not sel.any():
            continue
        k = int(sel.sum())
        ep = _bc6h_unquantize(bc6h_endpoints(blocks[sel], value, signed), bits, signed)
        if ns == 2:
            part = _read(raw[sel], np.full((k, 1), 77), np.full((k, 1), 5))[:, 0]
            sub = (np.array(BC7_PARTITIONS2, np.int64)[part][:, None] >> i) & 1
        else:
            part, sub = np.zeros(k, np.int64), np.zeros((k, 16), np.int64)
        ib = 3 if ns == 2 else 4
        widths = ib - _anchor(ns, part)
        idx = _read(raw[sel], (82 if ns == 2 else 65) + np.cumsum(widths, 1) - widths, widths)
        w = np.array(BC7_WEIGHTS[ib])[idx][..., None]
        ends = ep.reshape(k, 4, 3)
        e0 = np.take_along_axis(ends, (2 * sub)[..., None], 1)
        e1 = np.take_along_axis(ends, (2 * sub + 1)[..., None], 1)
        out[sel] = _half_to_8((e0 * (64 - w) + e1 * w) >> 6, signed)
    return out


def decode_plain(kind: int, data: bytes, width: int, height: int, path: str = "<bytes>", *,
                 signed: bool = False, shift565: bool = False) -> np.ndarray:
    """`decode` in numpy (the plain version)."""
    _args(kind, signed, shift565)
    _check(data, width, height, path, kind)
    bw, bh = (width + 3) // 4, (height + 3) // 4
    size = BLOCK_BYTES[kind]
    blocks = np.frombuffer(data, np.uint8, size * bw * bh).reshape(-1, size)
    if kind == BC1:
        px = _colour(blocks, None, shift565)
    elif kind in (BC2, BC3):
        px = _colour(blocks[:, 8:], True, shift565)
        if kind == BC2:
            nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], 2).reshape(-1, 16)
            px[..., 3] = nib.astype(np.int32) * 17
        else:
            px[..., 3] = _bc4(blocks[:, :8])
    elif kind == BC4:
        px = _bc4(blocks)[..., None]
    elif kind == BC5:
        px = np.stack([_bc4(blocks[:, :8], signed), _bc4(blocks[:, 8:], signed),
                       np.full((len(blocks), 16), 128 if signed else 0, np.int32)], 2)
    elif kind == BC6H:
        px = _bc6h(blocks, signed)
    else:
        px = _bc7(blocks)
    c = px.shape[-1]
    tiles = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, c)
    out = np.ascontiguousarray(tiles[:height, :width].astype(np.uint8))
    return out[..., 0] if c == 1 else out


def _bc1_plain(data: bytes, width: int, height: int, path: str = "<bytes>") -> np.ndarray:
    """`decode_bc1` in numpy (the plain version)."""
    return decode_plain(BC1, data, width, height, path)


# ------------------------------------------------------------------ writers

def _tiles_of(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> its 4 x 4 tiles (n, 16, C) int32, row-major, the edge
    tiles repeating their last row and column."""
    h, w, c = img.shape
    bh, bw = (h + 3) // 4, (w + 3) // 4
    pad = np.pad(img, ((0, 4 * bh - h), (0, 4 * bw - w), (0, 0)), mode="edge")
    return pad.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1, 16, c).astype(
        np.int32)


def _image(img, channels: int, name: str) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if channels == 1 and img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] != channels:
        raise ValueError(f"{name} takes {'(H, W)' if channels == 1 else f'(H, W, {channels})'}"
                         " images")
    return img


def _colour_blocks(tiles: np.ndarray, four: bool) -> tuple[np.ndarray, np.ndarray]:
    """RGB tiles (n, 16, 3) -> (BC1 colour blocks (n, 8), the RGBA they
    decode to (n, 16, 4)): the 565 corners of each tile's colour box, the
    larger word first, each pixel the nearest of the four colours along the
    line between them (a flat tile: one)."""
    def word(c):
        r, g, b = (c[:, k] for k in range(3))
        q = ((r * 31 + 127) // 255) << 11 | ((g * 63 + 127) // 255) << 5 | (b * 31 + 127) // 255
        return q.astype(np.uint16)
    c0, c1 = word(tiles.max(1)), word(tiles.min(1))
    pal = _palettes(c0, c1, True if four else None)
    # the nearest of the four colours along the line from c1 to c0 (thirds)
    d = pal[:, 0, :3] - pal[:, 1, :3]
    along = ((tiles - pal[:, 1, None, :3]) * d[:, None, :]).sum(2)
    step = np.rint(3 * along / np.maximum((d * d).sum(1), 1)[:, None])
    idx = np.array([1, 3, 2, 0], np.uint32)[np.clip(step, 0, 3).astype(np.int64)]
    idx[c0 == c1] = 0                   # one colour: no index past it
    lut = (idx << (2 * np.arange(16, dtype=np.uint32))).sum(1, dtype=np.uint32)
    blocks = np.empty((len(tiles), 8), np.uint8)
    blocks[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = lut.astype("<u4").view(np.uint8).reshape(-1, 4)
    return blocks, np.take_along_axis(pal, idx[..., None].astype(np.int64), 1)


def _bc4_blocks(tiles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One-channel tiles (n, 16) -> (BC4 blocks (n, 8), the values they
    decode to (n, 16)): the tile's largest and smallest value as the ends
    (eight levels), each pixel the nearest level."""
    a0, a1 = tiles.max(1), tiles.min(1)
    levels = _bc4_levels(a0, a1)
    idx = np.abs(tiles[:, :, None] - levels[:, None, :]).argmin(2)
    bits = (idx.astype(np.uint64) << (3 * np.arange(16, dtype=np.uint64))).sum(
        1, dtype=np.uint64)
    blocks = np.empty((len(tiles), 8), np.uint8)
    blocks[:, 0], blocks[:, 1] = a0, a1
    blocks[:, 2:] = bits.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6]
    return blocks, np.take_along_axis(levels, idx, 1)


def _finish(blocks: np.ndarray, px: np.ndarray, h: int, w: int) -> tuple[bytes, np.ndarray]:
    """Blocks (n, size) and their pixels (n, 16, c) -> (the bytes, the
    (h, w, c) image, (h, w) where c is 1)."""
    c = px.shape[-1]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, c)
    img = np.ascontiguousarray(img[:h, :w].astype(np.uint8))
    return np.ascontiguousarray(blocks).tobytes(), img[..., 0] if c == 1 else img


def encode_bc1(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 3) RGB -> (its BC1 blocks, the RGBA they decode to).
    Each tile's colours are the 565 corners of its colour box, the larger
    word first (four opaque colours; a flat tile one), each pixel the
    nearest of them along the line between the two; the edge tiles repeat
    their last row and column."""
    img = _image(img, 3, "encode_bc1")
    return _finish(*_colour_blocks(_tiles_of(img), False), *img.shape[:2])


def encode_bc2(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 4) RGBA -> (its BC2 blocks, what they decode to):
    `encode_bc1`'s colours, each alpha rounded to 4 bits."""
    img = _image(img, 4, "encode_bc2")
    tiles = _tiles_of(img)
    nib = ((tiles[..., 3] + 8) // 17).astype(np.uint8)
    colour, px = _colour_blocks(tiles[..., :3], True)
    px[..., 3] = nib.astype(np.int32) * 17
    return _finish(np.concatenate([nib[:, 0::2] | nib[:, 1::2] << 4, colour], 1), px,
                   *img.shape[:2])


def encode_bc3(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 4) RGBA -> (its BC3 blocks, what they decode to):
    `encode_bc4` of the alpha, `encode_bc1`'s colours."""
    img = _image(img, 4, "encode_bc3")
    tiles = _tiles_of(img)
    alpha, a = _bc4_blocks(tiles[..., 3])
    colour, px = _colour_blocks(tiles[..., :3], True)
    px[..., 3] = a
    return _finish(np.concatenate([alpha, colour], 1), px, *img.shape[:2])


def encode_bc4(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W) gray -> (its BC4 blocks, the L they decode to): each
    tile's largest and smallest value as the ends, each pixel the nearest
    of the eight levels."""
    img = _image(img, 1, "encode_bc4")
    blocks, v = _bc4_blocks(_tiles_of(img)[..., 0])
    return _finish(blocks, v[..., None], *img.shape[:2])


def encode_bc5(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 3) RGB -> (its BC5 blocks of R and G, the RGB they
    decode to: B 0)."""
    img = _image(img, 3, "encode_bc5")
    tiles = _tiles_of(img)
    (red, r), (green, g) = _bc4_blocks(tiles[..., 0]), _bc4_blocks(tiles[..., 1])
    return _finish(np.concatenate([red, green], 1), np.stack([r, g, np.zeros_like(r)], 2),
                   *img.shape[:2])


def encode_bc7(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 4) RGBA -> (its BC7 blocks of mode 6, the RGBA they
    decode to): each tile's RGBA box corners as its endpoints (the low one
    with p-bit 0, at or below the smallest values; the high one with p-bit
    1, at or over the largest), each pixel the nearest of the sixteen 4-bit
    weights along the line between them, the endpoints swapped where pixel
    0's index would need its fourth bit."""
    img = _image(img, 4, "encode_bc7")
    h, w = img.shape[:2]
    tiles = _tiles_of(img)
    n = len(tiles)
    lo, hi = tiles.min(1) >> 1, tiles.max(1) >> 1           # 7 bits, then the p-bit
    e0, e1 = lo << 1, hi << 1 | 1
    d = (e1 - e0).astype(np.float64)
    t = ((tiles - e0[:, None]) * d[:, None]).sum(2) / np.maximum((d * d).sum(1), 1)[:, None]
    weights = np.array(BC7_WEIGHTS[4])
    idx = np.searchsorted((weights[:-1] + weights[1:]) / 2, 64 * t)   # the nearest weight
    swap = idx[:, 0] >= 8
    idx[swap] = 15 - idx[swap]
    ends = np.stack([np.where(swap[:, None], hi, lo), np.where(swap[:, None], lo, hi)], 1)
    pbit = np.stack([swap, ~swap], 1).astype(np.int64)
    fields = [(np.full(n, 1 << 6), 7)]
    fields += [(ends[:, e, ch], 7) for ch in range(4) for e in range(2)]
    fields += [(pbit[:, 0], 1), (pbit[:, 1], 1)]
    fields += [(idx[:, i], 3 if i == 0 else 4) for i in range(16)]
    bits, at = np.zeros((n, 128), np.uint8), 0
    for v, k in fields:
        bits[:, at:at + k] = (v[:, None] >> np.arange(k)) & 1
        at += k
    # mode 6's endpoints are 8 bits with their p-bits: the decode is the blend
    full = ends << 1 | pbit[:, :, None]
    wt = weights[idx][..., None]
    px = ((64 - wt) * full[:, None, 0] + wt * full[:, None, 1] + 32) >> 6
    return _finish(np.packbits(bits, axis=1, bitorder="little"), px, h, w)


def encode_bc6h(img: np.ndarray, signed: bool = False) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 3) RGB -> (its BC6H blocks of mode 0x03, unsigned or
    signed, the RGB they decode to). Each channel's endpoints are the
    10-bit values whose own 8-bit reading is the tile's smallest value or
    under it, and its largest or over it (under PIL's rule, `_half_to_8`:
    a flat tile comes back as it was wherever an endpoint reads its value),
    each pixel the nearest of the sixteen blends, the endpoints swapped
    where pixel 0's index would need its fourth bit."""
    img = _image(img, 3, "encode_bc6h")
    h, w = img.shape[:2]
    tiles = _tiles_of(img)
    top = 512 if signed else 1024                   # signed: the endpoints >= 0
    q = np.arange(top)
    level = _half_to_8(_bc6h_unquantize(q, 10, signed), signed)      # non-decreasing
    lo = np.searchsorted(level, tiles.min(1), "right") - 1
    hi = np.minimum(np.searchsorted(level, tiles.max(1), "left"), top - 1)
    u0, u1 = (_bc6h_unquantize(e, 10, signed) for e in (lo, hi))
    wt = np.array(BC7_WEIGHTS[4])[None, :, None]
    blend = _half_to_8((u0[:, None] * (64 - wt) + u1[:, None] * wt) >> 6, signed)
    idx, best = np.zeros(tiles.shape[:2], np.int64), np.full(tiles.shape[:2], 1 << 30)
    for k in range(16):                         # the nearest blend, the first of ties
        err = ((tiles - blend[:, k, None]) ** 2).sum(2)
        idx = np.where(err < best, k, idx)
        best = np.minimum(err, best)
    px = np.take_along_axis(blend, idx[..., None], 1)
    swap = idx[:, 0] >= 8
    idx[swap] = 15 - idx[swap]
    ends = np.where(swap[:, None, None], np.stack([hi, lo], 1), np.stack([lo, hi], 1))
    fields = np.zeros((len(tiles), 12), np.int64)
    fields[:, :6] = ends.reshape(-1, 6) & 1023
    return _finish(bc6h_block(0x03, fields, 0, idx), px, h, w)
