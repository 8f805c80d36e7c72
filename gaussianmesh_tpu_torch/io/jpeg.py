"""JPEG without an imaging package: the machines the port runs on have none
(the JAX package reads JPEGs with PIL).

`read_jpeg` decodes 8-bit Huffman JPEGs, sequential (SOF0 baseline and
SOF1 extended), progressive (SOF2) and lossless (SOF3), and arithmetic-coded
ones, sequential (SOF9) and progressive (SOF10), with 1, 3 or 4
components, sampling factors 1-2 on each axis (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart
intervals, interleaved or single-component scans, to the arrays
`np.asarray(PIL.Image.open(p))` gives: (H, W) uint8 for gray, (H, W, 3) RGB
otherwise, and for 4 components (CMYK, YCCK) PIL's `convert("RGB")` of the
CMYK image it opens. It follows PIL 12's libjpeg-turbo step for step so
that the bits agree:

- a progressive file's scans (`jdphuff.c`: DC first and refinement, AC
  first with its EOB runs, AC refinement with its correction bits) each
  add their bits to the frame's coefficients; the scan parameters are
  checked as `start_pass_phuff_decoder` checks them. Where libjpeg only
  warns, this raises: a scan out of order (an AC scan before the
  component's DC, a refinement whose Ah is not the bits already sent), an
  AC refinement's new coefficient of a size other than 1, and a file that
  ends with coefficients 1-9 of a component unrefined (libjpeg-turbo would
  smooth the blocks, `jdcoefct.c`, which is not ported);

- the integer "islow" IDCT (`jidctint.c`: 13-bit constants, two passes
  with their descales, the output clamped to 0..255);
- "fancy" chroma upsampling (`jdsample.c`): the triangle filter for h2v1
  and h2v2 with its alternating rounding bias, and h1v2; plain
  replication where the downsampled width is 2 or less;
- the fixed-point YCbCr -> RGB tables (`jdcolor.c`: 16-bit scale,
  `ONE_HALF` rounding); a JFIF or Adobe marker, else the component ids,
  says whether the three components are YCbCr or RGB;
- a scan's Huffman table 0 or 1 that no DHT defined is the Annex K table
  (libjpeg-turbo's `jpeg_std_huff_table`, for Motion-JPEG frames);
- four components are CMYK, or YCCK where an Adobe marker's transform is
  not 0 (`default_decompress_parms`); YCCK goes to CMYK by
  `ycck_cmyk_convert` (the YCbCr -> RGB tables, inverted; K as it is).
  PIL opens every CMYK JPEG inverted (`CMYK;I`, Adobe's polarity), and
  `cmyk_to_rgb` is its `convert("RGB")`. The JAX reader keeps PIL's four
  CMYK channels and takes K as an alpha mask (fault B14); the port reads
  the RGB PIL converts to.

- a lossless file (SOF3, `jdlhuff.c`, `jdpred.c`, `jddiffct.c`) holds
  samples, not DCT blocks: each scan's Huffman-coded differences (category
  16 is 32768, with no bits) are added, mod 2^16, to a prediction, the
  scan's predictor Ss (1-7) of the samples left (Ra), above (Rb) and
  above-left (Rc); the first row of the scan and of each restart interval
  (which must be whole MCU rows) is predicted from 2^(7 - Pt) then Ra, the
  first column from Rb. Each sample comes out shifted up by its scan's
  point transform Pt, in 8 bits; a component sampled less than the largest
  is replicated, not filtered. libjpeg-turbo converts no colour in
  lossless mode: one component is gray, three with no marker (or Adobe
  transform 0) RGB as stored, four CMYK (PIL's `CMYK;I`, then
  `cmyk_to_rgb`); three under JFIF or another Adobe transform, and four
  under an Adobe transform other than 0, make PIL fail and raise.

- an arithmetic-coded file (T.81 Annex D's QM coder; `jdarith.c` step for
  step) holds the DCT blocks a Huffman file holds, coded as binary
  decisions at adaptive statistics bins: a DC difference conditioned on the
  previous one's class against the table's L and U, an AC band's
  end-of-block, zero-run, sign (at the fixed 0.5 bin) and magnitude
  decisions, the magnitude's second bin set chosen by k <= Kx; a
  progressive file's four kinds of scan as G.1.3 codes them, with no EOB
  runs. DAC segments set L / U (DC) and Kx (AC) of conditioning tables 0-3;
  each SOI resets every table to L 0, U 1, Kx 5, as libjpeg's marker reader
  does; DHT is not needed. The statistics, DC predictions and coder restart
  with each scan and each restart interval. Where an interval's bytes end
  at a marker the decoder reads zero bytes on (D.2.6: encoders drop the
  trailing zeros at their flush); where they end at the end of the file, a
  byte needed past it means the file is cut, and raises. Where libjpeg
  only warns ("bad arithmetic code": a magnitude past 2^15, a run of zeros
  past the band's end) and leaves the rest of the interval zero, this
  raises naming it. A DAC of L over U, of Kx outside 1-63 or of a table
  past 3, and a scan of a table past 3, raise (libjpeg takes tables 0-15
  and any Kx). PIL cannot load an arithmetic file past its 65,536-byte
  read block (fault B39: libjpeg-turbo's arithmetic decoder cannot wait for
  PIL's next block); the port reads it. Lossless arithmetic files (SOF11)
  raise: PIL's libjpeg-turbo cannot decode them either.

EXIF orientation is ignored, as a plain `Image.open` ignores it.
Hierarchical files and 12-bit samples raise with the cause.

`decode_jpeg` also reads the abbreviated streams of a JPEG-compressed TIFF
(`io/tiff.py`): the tables come from the TIFF's `JPEGTables` stream
(`jpeg_tables`), and the caller fixes the colour as libtiff does
(`color="as_is"`: the components as they are, whatever the markers say;
`"ycc"`: YCbCr -> RGB), and may check the frame before its scans.

`read_jpeg` parses the markers here and decodes each scan and the planes
in the port's C++ (`csrc/image.cpp`, built by `ops/_cuda.py::host_library`
at first use; a failed build raises). `read_jpeg_plain` is the same
decoder in Python and numpy, the version the C++ is held to byte for byte:
entropy decoding is one Python loop over the symbols, each decoded by one
lookup in a 16-bit peek table that holds the code length, the run and the
value when code and value bits fit in 16 bits (a second table and a bit
read otherwise), or for arithmetic coding one Python call a decision;
dequantisation, the IDCT, upsampling and colour conversion run vectorised
over all blocks. The training path never calls it.

`encode_jpeg_lossless` writes lossless JPEGs (any predictor and point
transform, restart intervals, interleaved or one scan a component) for the
tests and `chip_smoke.py`.

`write_jpeg` writes baseline JPEGs (one interleaved scan): the Annex K
quantisation and Huffman tables scaled by libjpeg's quality rule, 4:2:0 or
4:4:4, a float DCT, and Huffman coding vectorised (code words and bit
lengths per coefficient, packed with numpy, 0xFF stuffed); gray and YCbCr
with a JFIF marker, CMYK inverted with an Adobe marker of transform 0 (as
libjpeg writes PIL's CMYK) or YCCK with transform 2. With
`progressive=True` it writes the same coefficients as a progressive file
in libjpeg's `jpeg_simple_progression` script, each scan with its own
Huffman tables (Annex K.2) and EOB runs, vectorised over the blocks too.
With `arithmetic=True` the same coefficients are arithmetic-coded (SOF9, or
SOF10 in the same progression) by the C++ QM encoder (`arith_scans`,
`gm_jpeg_arith_encode`, `jcarith.c` step for step), with restart intervals
and DAC segments where asked (`arith_scans` codes any scan script).
`encode_jpeg` and `encode_jpeg_tables` give the bytes, abbreviated streams
and their tables included, for `io/tiff.py`'s writer.
"""

from __future__ import annotations

import array
import functools
import heapq
import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

JPEG_MAGIC = b"\xff\xd8\xff"

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_KINDS = {
    0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xCB: "lossless arithmetic-coded", 0xCD: "differential arithmetic-coded",
    0xCE: "differential progressive arithmetic-coded",
    0xCF: "differential lossless arithmetic-coded"}

# the arithmetic conditioning each SOI resets every table to (libjpeg's
# `get_soi`): DC L 0 and U 1, AC Kx 5
_DAC_DEFAULT = ((0,) * 4, (1,) * 4, (5,) * 4)

# Annex K.1 quantisation tables (natural order) and K.3 Huffman tables
# (code counts per length 1-16, then the symbols)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# a fast-table entry: value << 12 | run << 5 | bits consumed (1-31; 0 sends
# the symbol to the slow table). EOB's run of 64 ends the block.
_EOB_RUN = 64


def _canonical(bits, vals):
    """Annex C: the code word and length of each symbol, in table order."""
    codes, lengths, code = [], [], 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes.append(code)
            lengths.append(length)
            code += 1
        code <<= 1
    return codes, lengths, list(vals)


def _extend(v, s):
    """The signed value of `s` magnitude bits `v` (F.2.2.1 EXTEND)."""
    return np.where(v < (1 << s) >> 1, v - (1 << s) + 1, v) if s else np.zeros_like(v)


@functools.lru_cache(maxsize=32)
def _decode_tables(bits, vals, ac: bool):
    """-> (fast, slow): 65,536-entry peek tables as Python lists (read only;
    kept for the next scan with the same table: a TIFF's strips share
    theirs)."""
    fast = np.zeros(1 << 16, np.int64)
    for code, length, sym in zip(*_canonical(bits, vals)):
        lo, hi = code << (16 - length), (code + 1) << (16 - length)
        run, s = (sym >> 4, sym & 15) if ac else (0, sym)
        if ac and s == 0:
            run = 15 if run == 15 else _EOB_RUN     # ZRL, else end of block
        if length + s > 16:
            continue
        peek = np.arange(lo, hi)
        value = _extend((peek >> (16 - length - s)) & ((1 << s) - 1), s)
        fast[lo:hi] = value * 4096 + (run << 5 | (length + s))
    return fast.tolist(), _peek_table(bits, vals)


@functools.lru_cache(maxsize=32)
def _peek_table(bits, vals):
    """-> the slow table: symbol << 5 | code length for every 16-bit window
    that starts with a code word, 0 where none does (code words that
    overflow their length clipped off its end, as `csrc/image.cpp` clips
    them)."""
    slow = np.zeros(1 << 16, np.int64)
    for code, length, sym in zip(*_canonical(bits, vals)):
        slow[code << (16 - length):(code + 1) << (16 - length)] = sym << 5 | length
    return slow.tolist()


def _slow_symbol(W, p, slow, ac: bool):
    """A symbol whose code and value bits pass 16 -> (bits, run, value)."""
    e = slow[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
    length, sym = e & 31, e >> 5
    if not length:
        raise ValueError("corrupt JPEG data: no Huffman code matches")
    run, s = (sym >> 4, sym & 15) if ac else (0, sym)
    if s == 0:                          # DC 0, ZRL, or end of block
        return length, (_EOB_RUN if ac and run != 15 else run), 0
    q = p + length
    v = (W[q >> 3] >> (64 - (q & 7) - s)) & ((1 << s) - 1)
    if v < 1 << (s - 1):
        v -= (1 << s) - 1
    return length + s, run, v


def _huffman(W, tables, n_mcus, coef, base):
    """Decode `n_mcus` MCUs of one restart interval into `coef` (64 zigzag
    slots per block from `base`; DC slots get the differences).
    `tables` lists (dc_fast, dc_slow, ac_fast, ac_slow) per block of an
    MCU. -> bits consumed."""
    p = 0
    for _ in range(n_mcus):
        for dcf, dcs, acf, acs in tables:
            e = dcf[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            t = e & 31
            if t:
                p += t
                coef[base] = e >> 12
            else:
                t, _, v = _slow_symbol(W, p, dcs, False)
                p += t
                coef[base] = v
            k = 1
            while k < 64:
                e = acf[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                t = e & 31
                if t:
                    p += t
                    k += (e >> 5) & 127
                    if k < 64:
                        coef[base + k] = e >> 12
                else:
                    t, run, v = _slow_symbol(W, p, acs, True)
                    p += t
                    k += run
                    if k < 64:
                        coef[base + k] = v
                k += 1
            base += 64
    return p


def _windows(seg: np.ndarray) -> list:
    """W[i] = the 64 bits from byte i on (zeros past the end)."""
    n = len(seg)
    b = np.concatenate([seg, np.zeros(9, np.uint8)]).astype(np.uint64)
    w = np.zeros(n + 2, np.uint64)
    for i in range(8):
        w |= b[i:i + n + 2] << np.uint64(56 - 8 * i)
    return w.tolist()


def _entropy_segments(arr: np.ndarray):
    """The entropy-coded data at the start of `arr` -> (its restart
    intervals with stuffed zeros removed, bytes it spans)."""
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0) & ~rst]
    end = int(ends[0]) if len(ends) else len(arr)
    cuts = [0]
    for r in ff[rst & (ff < end)]:
        cuts += [int(r), int(r) + 2]
    cuts.append(end)
    segs = []
    for a, b in zip(cuts[::2], cuts[1::2]):
        s = arr[a:b]
        keep = np.ones(len(s), bool)
        keep[1:] = ~((s[1:] == 0) & (s[:-1] == 0xFF))
        segs.append(s[keep])
    return segs, end


def _idct_1d(g, shift: int):
    """One pass of `jidctint.c` over the 8 inputs `g` (int32 arrays) ->
    its 8 descaled outputs."""
    z1 = (g[2] + g[6]) * 4433
    tmp2 = z1 + g[6] * -15137
    tmp3 = z1 + g[2] * 6270
    tmp0 = (g[0] + g[4]) << 13
    tmp1 = (g[0] - g[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = g[7], g[5], g[3], g[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(o + half) >> shift for o in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct(zz: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 64) zigzag coefficients and their table -> (N, 8, 8) uint8.
    int32 throughout, as libjpeg-turbo's SIMD IDCT computes (exact for
    the coefficients an 8-bit encoder writes)."""
    nat = np.empty((64, len(zz)), np.int32)
    nat[ZIGZAG] = (zz * q.astype(np.int32)).T
    x = nat.reshape(8, 8, -1)                   # (row, column, block)
    cols = _idct_1d(list(x), 11)                # down the columns: 13 - PASS1_BITS
    ws = np.stack(cols)                         # (row, column, block)
    rows = _idct_1d([ws[:, u] for u in range(8)], 18)   # along rows: 13 + 2 + 3
    out = np.stack(rows, 1)                     # (row, column, block)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8).transpose(2, 0, 1)


def _upsample(p: np.ndarray, ry: int, rx: int) -> np.ndarray:
    """`jdsample.c` on one downsampled plane (int32) by (ry, rx), each 1
    or 2."""
    h, w = p.shape
    if (ry, rx) == (1, 1):
        return p
    if rx == 2 and w > 2 and ry in (1, 2):
        if ry == 2:                     # h2v2: vertical sums, then 1/16s
            up = np.concatenate([p[:1], p[:-1]])
            dn = np.concatenate([p[1:], p[-1:]])
            cs = np.stack([3 * p + up, 3 * p + dn], 1).reshape(2 * h, w)
            bias, shift = (8, 7), 4
        else:                           # h2v1
            cs, bias, shift = p, (1, 2), 2
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        even = (3 * cs + left + bias[0]) >> shift
        odd = (3 * cs + right + bias[1]) >> shift
        return np.stack([even, odd], 2).reshape(cs.shape[0], 2 * w)
    if (ry, rx) == (2, 1):              # h1v2
        up = np.concatenate([p[:1], p[:-1]])
        dn = np.concatenate([p[1:], p[-1:]])
        return np.stack([(3 * p + up + 1) >> 2, (3 * p + dn + 2) >> 2], 1).reshape(2 * h, w)
    return p.repeat(ry, 0).repeat(rx, 1)       # h2v1 / h2v2 at widths of 1-2


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    return ((fix(1.40200) * x + 32768) >> 16, (fix(1.77200) * x + 32768) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + 32768)


def _ycc_to_rgb(y, cb, cr):
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    rgb = np.empty(y.shape + (3,), np.int32)
    rgb[..., 0] = cr_r[cr]
    rgb[..., 1] = (cb_g[cb] + cr_g[cr]) >> 16
    rgb[..., 2] = cb_b[cb]
    rgb += y[..., None]
    return np.clip(rgb, 0, 255, out=rgb).astype(np.uint8)


class _Frame:
    def __init__(self, seg: bytes, path, progressive: bool = False, lossless: bool = False,
                 arithmetic: bool = False):
        self.progressive, self.lossless, self.arithmetic = progressive, lossless, arithmetic
        precision, self.height, self.width, nf = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise ValueError(f"{path}: {precision}-bit JPEG; only 8-bit samples are read")
        if nf not in (1, 3, 4):
            raise ValueError(f"{path}: {nf}-component JPEG; only 1, 3 or 4 are read")
        if self.height == 0:
            raise ValueError(f"{path}: the height comes in a DNL marker; not read")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(nf):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        if any(s not in (1, 2) for s in self.h + self.v):
            raise ValueError(f"{path}: sampling factors {list(zip(self.h, self.v))}; "
                             "only 1 and 2 are read")
        unit = 1 if lossless else 8     # a lossless data unit is one sample
        self.mcux = -(-self.width // (unit * self.hmax))
        self.mcuy = -(-self.height // (unit * self.vmax))
        if lossless:
            # each component's samples over the MCU-padded grid (mod 2^16),
            # and the point transform of the scan that sent them
            self.planes = [np.zeros((self.mcuy * v, self.mcux * h), np.int32)
                           for h, v in zip(self.h, self.v)]
            self.pt = [None] * nf
            return
        # coefficient blocks of each component over the MCU-padded grid, all
        # in one buffer: component c's (nby, nbx) blocks from block offset[c]
        self.grid = [(self.mcuy * v, self.mcux * h) for h, v in zip(self.h, self.v)]
        self.offset = np.cumsum([0] + [y * x for y, x in self.grid])
        self.blocks = np.zeros((int(self.offset[-1]), 64), np.int32)
        self.coef = [self.blocks[o:o + y * x].reshape(y, x, 64)
                     for o, (y, x) in zip(self.offset, self.grid)]
        self.q = [None] * nf
        # a progressive file's bits known of each coefficient (zig-zag), -1
        # before any scan sent it: libjpeg's `coef_bits`
        self.coef_bits = np.full((nf, 64), -1)
        self.orders = {}            # components of a scan -> _decode_order

    def comp_size(self, c):
        """The component's sample rows and columns (`downsampled_*`)."""
        return (-(-self.height * self.v[c] // self.vmax),
                -(-self.width * self.h[c] // self.hmax))


def _decode_order(frame: _Frame, comps):
    """A scan of `comps`: one component's own blocks, or the MCUs of the
    interleaved ones -> (the component of each block of an MCU, MCUs, and in
    decode order each block's component, block row, block column and row of
    frame.blocks)."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = frame.comp_size(c)
        by, bx = np.meshgrid(np.arange(-(-rows // 8)), np.arange(-(-cols // 8)),
                             indexing="ij")
        order = [(np.full(by.size, c), by.ravel(), bx.ravel())]
        comp, n_mcus = [c], by.size
    else:
        my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux), indexing="ij")
        my, mx = my.ravel(), mx.ravel()
        order, comp = [], []
        for c in comps:
            for v in range(frame.v[c]):
                for h in range(frame.h[c]):
                    order.append((np.full(my.size, c), my * frame.v[c] + v,
                                  mx * frame.h[c] + h))
                    comp.append(c)
        n_mcus = my.size
    # (n_mcus, blocks per MCU) -> decode order
    bc, by, bx = (np.stack([o[i] for o in order], 1).ravel() for i in range(3))
    nbx = np.array([x for _, x in frame.grid], np.int64)
    return comp, n_mcus, bc, by, bx, frame.offset[bc] + by * nbx[bc] + bx


class _Scan:
    """One SOS header against the frame: the scan's components, its blocks in
    decode order and the Huffman tables of each block of an MCU; in a
    progressive frame its kind, checked against the scans before it."""

    def __init__(self, frame: _Frame, seg: bytes, qt, dc, ac, path):
        ns = seg[0]
        self.ss, self.se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
        self.ah, self.al = ahl >> 4, ahl & 15
        if frame.lossless:
            self.kind = "lossless"
            if not (1 <= self.ss <= 7 and self.se == 0 and self.ah == 0 and self.al < 8):
                raise ValueError(f"{path}: lossless JPEG scan of Ss {self.ss}, Se {self.se}, "
                                 f"Ah {self.ah}, Al {self.al}: libjpeg-turbo takes a predictor "
                                 "Ss of 1-7, Se 0, Ah 0 and Al under 8 (PIL cannot load it)")
        elif not frame.progressive:
            self.kind = "sequential"
        elif self.ss == 0:
            self.kind = "dc_refine" if self.ah else "dc_first"
        else:
            self.kind = "ac_refine" if self.ah else "ac_first"
        # a progressive scan needs the tables of its kind alone
        need_dc = self.kind in ("sequential", "dc_first", "lossless")
        need_ac = self.kind in ("sequential", "ac_first", "ac_refine")
        comps, tabs = [], []
        for i in range(ns):
            cid, t = seg[1 + 2 * i:3 + 2 * i]
            if cid not in frame.ids:
                raise ValueError(f"{path}: scan names component {cid}, not in the frame")
            c = frame.ids.index(cid)
            if frame.arithmetic:
                # conditioning tables 0-3 (T.81 B.2.3; libjpeg-turbo takes 0-15)
                if (need_dc and (t >> 4) > 3) or (need_ac and (t & 15) > 3):
                    raise ValueError(f"{path}: scan uses arithmetic conditioning tables "
                                     f"{t >> 4} / {t & 15}; T.81 has 0-3")
            else:
                # libjpeg-turbo takes the Annex K table for an undefined table 0
                # or 1 (`jpeg_std_huff_table`: Motion-JPEG frames carry no DHT)
                if need_dc and (t >> 4) not in dc and (t >> 4) < 2:
                    dc[t >> 4] = (_DC_LUMA, _DC_CHROMA)[t >> 4]
                if need_ac and (t & 15) not in ac and (t & 15) < 2:
                    ac[t & 15] = (_AC_LUMA, _AC_CHROMA)[t & 15]
                if (need_dc and (t >> 4) not in dc) or (need_ac and (t & 15) not in ac):
                    raise ValueError(f"{path}: scan uses a Huffman table that is not defined")
            if frame.lossless:
                if frame.pt[c] is not None:
                    raise ValueError(f"{path}: component {cid} in two lossless scans")
                frame.pt[c] = self.al
            elif frame.tq[c] not in qt:
                raise ValueError(f"{path}: quantisation table {frame.tq[c]} not defined")
            elif frame.q[c] is None:        # latched at the component's first scan
                frame.q[c] = qt[frame.tq[c]]
            comps.append(c)
            tabs.append((t >> 4, t & 15))
        if frame.lossless:
            self.comps = comps
            self._lossless_order(frame, comps, tabs)
            return
        if frame.progressive:
            self._progression(frame, comps, path)
        elif (self.ss, self.se, ahl) != (0, 63, 0):
            raise ValueError(f"{path}: spectral selection {self.ss}-{self.se}, "
                             f"approximation {ahl:#x}: a progressive scan")

        # the blocks in decode order, the same for every scan of these
        # components (a progressive file has up to 10 scans)
        key = tuple(comps)
        if key not in frame.orders:
            frame.orders[key] = _decode_order(frame, comps)
        self.comp, self.n_mcus, self.bc, self.by, self.bx, self.dest = frame.orders[key]
        self.comps = comps
        self.tables = [tabs[0]] if len(comps) == 1 else [
            t for c, t in zip(comps, tabs) for _ in range(frame.v[c] * frame.h[c])]

    def _lossless_order(self, frame: _Frame, comps, tabs):
        """A lossless scan's MCUs: one sample of a lone component, else h x
        v samples of each -> `mcux`, `mcuy`, and per sample of an MCU its
        component, row and column in it, and DC table."""
        if len(comps) == 1:
            self.mcuy, self.mcux = frame.comp_size(comps[0])
            hv = {comps[0]: (1, 1)}
        else:
            self.mcuy, self.mcux = frame.mcuy, frame.mcux
            hv = {c: (frame.h[c], frame.v[c]) for c in comps}
        self.n_mcus = self.mcux * self.mcuy
        self.hv = [hv[c] for c in comps]
        self.comp, self.dy, self.dx, self.tables = [], [], [], []
        for j, (c, t) in enumerate(zip(comps, tabs)):
            h, v = hv[c]
            for y in range(v):
                for x in range(h):
                    self.comp.append(j)
                    self.dy.append(y)
                    self.dx.append(x)
                    self.tables.append(t[0])

    def _progression(self, frame: _Frame, comps, path):
        """`start_pass_phuff_decoder`'s checks (JERR_BAD_PROGRESSION), then
        its bookkeeping of each coefficient's bits, raising where libjpeg
        warns (JWRN_BOGUS_PROGRESSION)."""
        ss, se, ah, al = self.ss, self.se, self.ah, self.al
        causes = []
        if ss == 0 and se != 0:
            causes.append("a DC scan must end at 0")
        if ss != 0 and (ss > se or se > 63):
            causes.append("an AC scan must have 1 <= Ss <= Se <= 63")
        if ss != 0 and len(comps) != 1:
            causes.append(f"an AC scan must have one component, not {len(comps)}")
        if ah != 0 and al != ah - 1:
            causes.append("a refinement must have Al = Ah - 1")
        if al > 13:
            causes.append("Al over 13")
        if causes:
            raise ValueError(f"{path}: invalid progressive scan (Ss {ss}, Se {se}, Ah "
                             f"{ah}, Al {al}): " + "; ".join(causes))
        for c in comps:
            bits = frame.coef_bits[c]
            if ss != 0 and bits[0] < 0:
                raise ValueError(f"{path}: bogus progression: an AC scan of component "
                                 f"{frame.ids[c]} before its DC scan")
            known = np.maximum(bits[ss:se + 1], 0)
            if (known != ah).any():
                k = ss + int(np.flatnonzero(known != ah)[0])
                raise ValueError(f"{path}: bogus progression: component {frame.ids[c]}'s "
                                 f"coefficient {k} refined from Ah {ah} where "
                                 f"{int(known[k - ss])} bits are known")
            bits[ss:se + 1] = al


def _scan_plain(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac,
                path):
    """Decode one scan's entropy-coded data (`arr` onwards) into frame.coef
    in Python. -> bytes of entropy-coded data consumed."""
    built = {}
    for t in scan.tables:
        if t not in built:
            built[t] = (_decode_tables(*dc[t[0]], False) + _decode_tables(*ac[t[1]], True))
    tables = [built[t] for t in scan.tables]
    per_mcu, n_mcus, bc = len(tables), scan.n_mcus, scan.bc

    segs, used = _entropy_segments(arr)
    interval = restart or n_mcus
    n_int = -(-n_mcus // interval)
    if len(segs) < n_int:
        raise ValueError(f"{path}: {len(segs)} restart intervals, {n_int} expected")
    coef = array.array("i", bytes(4 * (n_mcus * per_mcu * 64 + 128)))
    for i in range(n_int):
        m = min(interval, n_mcus - i * interval)
        base = i * interval * per_mcu * 64
        try:
            p = _huffman(_windows(segs[i]), tables, m, coef, base)
        except IndexError:
            p = None
        if p is None or p > 8 * len(segs[i]):
            raise ValueError(f"{path}: entropy-coded data ends early (truncated JPEG)")
    blocks = np.frombuffer(coef, np.int32)[:n_mcus * per_mcu * 64].reshape(-1, 64).copy()

    # DC: each component's differences summed within each restart interval
    interval_of = np.arange(len(blocks)) // (interval * per_mcu)
    for c in set(scan.comps):
        sel = np.flatnonzero(bc == c)
        run = np.cumsum(blocks[sel, 0].astype(np.int64))
        first = np.flatnonzero(np.diff(interval_of[sel], prepend=-1))
        before = np.where(first > 0, run[first - 1], 0)
        run -= np.repeat(before, np.diff(np.append(first, len(sel))))
        blocks[sel, 0] = run
    frame.blocks[scan.dest] = blocks
    return used


def _packed_tables(defs):
    """Huffman tables [(bits, vals)] -> gm_jpeg_scan's (n, 17) int32 counts
    and (n, stride) uint8 symbols."""
    tables = np.zeros((max(1, len(defs)), 17), np.int32)
    vals = np.zeros((len(tables), max([1] + [len(v) for _, v in defs])), np.uint8)
    for j, (bits, v) in enumerate(defs):
        tables[j, 0], tables[j, 1:1 + len(bits)] = len(v), bits   # a cut DHT: fewer counts
        vals[j, :len(v)] = np.frombuffer(v, np.uint8)
    return tables, vals


def _native_status(status, entry, path, scan, restart, found):
    """An entropy decoder's status in `csrc/image.cpp` -> the plain
    version's error."""
    if status == 1:
        raise ValueError(f"{path}: entropy-coded data ends early (truncated JPEG)")
    if status == 2:
        raise ValueError("corrupt JPEG data: no Huffman code matches")
    if status == 3:
        n_int = -(-scan.n_mcus // (restart or scan.n_mcus))
        raise ValueError(f"{path}: {int(found[0])} restart intervals, {n_int} expected")
    if status == 4:
        raise ValueError(f"{path}: corrupt JPEG data: a DC magnitude category over 16")
    if status == 6:
        raise ValueError(f"{path}: corrupt JPEG data: an AC refinement's new "
                         "coefficient is not of size 1")
    if status:
        raise RuntimeError(f"{path}: {entry} returned {status}")


def _scan_native(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac,
                 path):
    """`_scan_plain` in `csrc/image.cpp` (`gm_jpeg_scan`): the same
    coefficients, the same errors. -> bytes of entropy-coded data consumed."""
    keys = sorted({("dc", d) for d, _ in scan.tables} | {("ac", a) for _, a in scan.tables})
    tables, vals = _packed_tables([(dc if kind == "dc" else ac)[i] for kind, i in keys])
    comp = np.array(scan.comp, np.int32)
    dc_tab = np.array([keys.index(("dc", d)) for d, _ in scan.tables], np.int32)
    ac_tab = np.array([keys.index(("ac", a)) for _, a in scan.tables], np.int32)
    dest = scan.dest.astype(np.int32)
    used, found = np.zeros(1, np.int64), np.zeros(1, np.int32)
    status = _cuda.host_library("image").gm_jpeg_scan(
        arr.ctypes.data, len(arr), scan.n_mcus, restart, len(scan.tables),
        comp.ctypes.data, dc_tab.ctypes.data, ac_tab.ctypes.data, tables.ctypes.data,
        vals.ctypes.data, vals.shape[1], len(keys), dest.ctypes.data,
        frame.blocks.ctypes.data, used.ctypes.data, found.ctypes.data)
    _native_status(status, "gm_jpeg_scan", path, scan, restart, found)
    return int(used[0])


# ------------------------------------------------------- progressive scans

def _read_bits(W, q, n):
    """`n` (1-16) bits from bit `q` of the windows `W`."""
    return (W[q >> 3] >> (64 - (q & 7) - n)) & ((1 << n) - 1)


def _extend_bits(v, s):
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _progressive_plain(scan: _Scan, seg: np.ndarray, blocks, dest: np.ndarray, tables,
                       set_, path):
    """One restart interval (`seg`, its bytes unstuffed) of a progressive
    scan in Python: the decode loop of `gm_jpeg_scan_progressive`, bit for
    bit and check for check (a bit count is checked before each symbol and
    each raw bit; past the end bits read as zeros). DC first returns the DC
    differences; the other kinds put their coefficients in `set_` ({index
    into blocks.ravel(): value}), or for an AC refinement's correction bits
    straight into `blocks`, whose values before the scan they read. -> (bits
    consumed, the DC differences)."""
    kind, ss, se, al = scan.kind, scan.ss, scan.se, scan.al
    n, p1, p = len(seg), 1 << scan.al, 0
    W = _windows(np.concatenate([seg, np.zeros(8, np.uint8)]))
    truncated = f"{path}: entropy-coded data ends early (truncated JPEG)"

    def symbol(q, slow):
        if (q >> 3) > n + 1:
            raise ValueError(truncated)
        e = slow[(W[q >> 3] >> (48 - (q & 7))) & 0xFFFF]
        if not e & 31:
            raise ValueError("corrupt JPEG data: no Huffman code matches")
        return q + (e & 31), e >> 5

    diffs = []
    if kind == "dc_first":
        for j in range(len(dest)):
            p, sym = symbol(p, tables[j % len(tables)])
            if sym > 16:
                raise ValueError(f"{path}: corrupt JPEG data: a DC magnitude category "
                                 "over 16")
            diffs.append(_extend_bits(_read_bits(W, p, sym), sym) if sym else 0)
            p += sym
        return p, diffs
    slow, eobrun = tables[0], 0
    if kind == "ac_first":
        for d in dest.tolist():
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                p, sym = symbol(p, slow)
                r, s = sym >> 4, sym & 15
                if s:
                    k += r
                    set_[d * 64 + min(k, 63)] = _extend_bits(_read_bits(W, p, s), s) << al
                    p += s
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(W, p, r)
                        p += r
                    eobrun -= 1
                    break
                k += 1
        return p, diffs

    # AC refinement. The band's nonzero coefficients before the scan, block
    # by block: the walk past them reads one correction bit each, in runs
    # (first coefficient, count, first bit) applied after the walk
    band = blocks[dest, ss:se + 1]
    bi, ki = np.nonzero(band)
    starts = np.searchsorted(bi, np.arange(len(dest) + 1)).tolist()
    pos = (ki + ss).tolist()
    runs = []

    def corrections(first, count, q):
        if (q + count - 1) >> 3 > n + 1:    # the check before the run's last bit
            raise ValueError(truncated)
        runs.append((first, count, q))
        return q + count

    for b, d in enumerate(dest.tolist()):
        i, end = starts[b], starts[b + 1]      # the next nonzero coefficient
        k = ss
        if not eobrun:
            while k <= se:
                p, sym = symbol(p, slow)
                r, s = sym >> 4, sym & 15
                if s:
                    if s != 1:
                        raise ValueError(f"{path}: corrupt JPEG data: an AC refinement's "
                                         "new coefficient is not of size 1")
                    s = p1 if _read_bits(W, p, 1) else -p1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(W, p, r)
                        p += r
                    break
                # past nonzero coefficients and r zero ones, to the zero one
                # the new coefficient takes (or past the band's end)
                first = i
                while True:
                    nxt = pos[i] if i < end else se + 1
                    if r < nxt - k:
                        k += r
                        break
                    r -= nxt - k
                    if i == end:
                        k = se + 1
                        break
                    k, i = nxt + 1, i + 1
                if i > first:
                    p = corrections(first, i - first, p)
                if s:
                    set_[d * 64 + min(k, 63)] = s
                k += 1
        if eobrun:
            if end > i:                         # the rest of the band's nonzero ones
                p = corrections(i, end - i, p)
            eobrun -= 1
    if runs:
        first, count, q = (np.array(x, np.int64) for x in zip(*runs))
        offs = np.repeat(np.cumsum(count) - count, count)
        at = np.arange(int(count.sum())) - offs
        idx, q = np.repeat(first, count) + at, np.repeat(q, count) + at
        bit = np.unpackbits(np.concatenate([seg, np.zeros(8, np.uint8)]))[q]
        v = band[bi[idx], ki[idx]].astype(np.int64)
        fix = (bit == 1) & ((v & p1) == 0)
        flat = blocks.reshape(-1)
        flat[dest[bi[idx[fix]]] * 64 + ki[idx[fix]] + ss] = v[fix] + np.where(
            v[fix] >= 0, p1, -p1)
    return p, diffs


def _scan_plain_progressive(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int,
                            dc, ac, path):
    """Decode one progressive scan's entropy-coded data (`arr` onwards) into
    frame.blocks in Python: the plain version of `_scan_native_progressive`.
    -> bytes of entropy-coded data consumed."""
    kind, per_mcu, n_mcus = scan.kind, len(scan.tables), scan.n_mcus
    segs, used = _entropy_segments(arr)
    interval = restart or n_mcus
    n_int = -(-n_mcus // interval)
    if len(segs) < n_int:
        raise ValueError(f"{path}: {len(segs)} restart intervals, {n_int} expected")
    if kind == "dc_first":
        tables = [_peek_table(*dc[d]) for d, _ in scan.tables]
    elif kind != "dc_refine":
        tables = [_peek_table(*ac[scan.tables[0][1]])]
    set_, diffs = {}, []
    for i in range(n_int):
        m = min(interval, n_mcus - i * interval) * per_mcu
        seg, first = segs[i], i * interval * per_mcu
        dest = scan.dest[first:first + m]
        if kind == "dc_refine":                 # one raw bit a block
            if m > 8 * len(seg):
                raise ValueError(f"{path}: entropy-coded data ends early (truncated JPEG)")
            bits = np.unpackbits(seg)[:m].astype(bool)
            frame.blocks[dest[bits], 0] |= np.int32(1 << scan.al)
            continue
        p, d = _progressive_plain(scan, seg, frame.blocks, dest, tables, set_, path)
        if p > 8 * len(seg):
            raise ValueError(f"{path}: entropy-coded data ends early (truncated JPEG)")
        diffs += d
    if kind == "dc_first":
        # each component's differences summed within each restart interval
        blocks = np.array(diffs, np.int64)
        interval_of = np.arange(len(blocks)) // (interval * per_mcu)
        for c in set(scan.comps):
            sel = np.flatnonzero(scan.bc == c)
            run = np.cumsum(blocks[sel])
            first = np.flatnonzero(np.diff(interval_of[sel], prepend=-1))
            before = np.where(first > 0, run[first - 1], 0)
            run -= np.repeat(before, np.diff(np.append(first, len(sel))))
            blocks[sel] = run << scan.al
        frame.blocks[scan.dest, 0] = (blocks & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    elif set_:
        idx = np.fromiter(set_.keys(), np.int64, len(set_))
        v = np.fromiter(set_.values(), np.int64, len(set_))
        frame.blocks.reshape(-1)[idx] = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return used


def _scan_native_progressive(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int,
                             dc, ac, path):
    """`_scan_plain_progressive` in `csrc/image.cpp`
    (`gm_jpeg_scan_progressive`): the same coefficients, the same errors.
    -> bytes of entropy-coded data consumed."""
    if scan.kind == "dc_first":
        keys = sorted({d for d, _ in scan.tables})
        defs, tab = [dc[d] for d in keys], [keys.index(d) for d, _ in scan.tables]
    elif scan.kind == "dc_refine":
        keys, defs, tab = [], [], [0] * len(scan.tables)
    else:
        keys, defs, tab = [scan.tables[0][1]], [ac[scan.tables[0][1]]], [0]
    tables, vals = _packed_tables(defs)
    comp = np.array(scan.comp, np.int32)
    tab = np.array(tab, np.int32)
    dest = scan.dest.astype(np.int32)
    used, found = np.zeros(1, np.int64), np.zeros(1, np.int32)
    status = _cuda.host_library("image").gm_jpeg_scan_progressive(
        arr.ctypes.data, len(arr), scan.n_mcus, restart, len(scan.tables),
        comp.ctypes.data, tab.ctypes.data, tables.ctypes.data, vals.ctypes.data,
        vals.shape[1], len(keys), dest.ctypes.data, scan.ss, scan.se, scan.ah, scan.al,
        frame.blocks.ctypes.data, used.ctypes.data, found.ctypes.data)
    _native_status(status, "gm_jpeg_scan_progressive", path, scan, restart, found)
    return int(used[0])


# ------------------------------------------------ arithmetic-coded scans

# T.81 Table D.2 as libjpeg's `jpeg_aritab` (`csrc/image.cpp`'s kQe): Qe
# << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113
# is the fixed estimate of 0.5 that signs and DC refinements are coded at
_QE = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171)
_FIXED_BIN = 113


def _i16(v: int) -> int:
    """`v` kept to 16 bits, as libjpeg's JCOEF keeps a coefficient."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _qm_decoder(seg: list, at_end: bool, path):
    """T.81 D.2's decoder (`jdarith.c`'s arith_decode) over one restart
    interval's unstuffed bytes `seg`, then zero bytes (the marker that ends
    the interval, D.2.6); where the interval runs to the end of the data
    (`at_end`), a byte fetched past it raises: the file is cut. -> decode(st,
    i), the decision coded at bin st[i] (which it updates)."""
    n = len(seg)
    a = c = pos = 0
    ct = -16                            # two bytes to fetch before the first decision

    def decode(st, i):
        nonlocal a, c, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if pos < n:
                    c = (c << 8) | seg[pos]
                    pos += 1
                elif at_end:
                    raise ValueError(f"{path}: entropy-coded data ends early (truncated JPEG)")
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        e = _QE[sv & 0x7F]
        qe = e >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
            else:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
        return sv >> 7
    return decode


def _bad_magnitude(path):
    return ValueError(f"{path}: corrupt JPEG data: bad arithmetic code (a magnitude past "
                      "2^15; libjpeg warns and zeroes the rest of the restart interval)")


def _bad_run(path):
    return ValueError(f"{path}: corrupt JPEG data: bad arithmetic code (a run of zeros past "
                      "the band's end; libjpeg warns and zeroes the rest of the restart "
                      "interval)")


def _arith_dc(decode, dc, ctx, ci, lo, hi, path) -> int:
    """One DC difference (F.1.4.4.1, Figures F.19-F.24) at its table's bins
    `dc`, in component slot ci's context ctx[ci] (0 zero, 4 / 8 small + /
    -, 12 / 16 large + / -: the magnitude class against L and U), which it
    updates."""
    st = ctx[ci]
    if not decode(dc, st):
        ctx[ci] = 0
        return 0
    sign = decode(dc, st + 1)
    st += 2 + sign
    m = decode(dc, st)
    if m:
        st = 20                         # X1
        while decode(dc, st):
            m <<= 1
            if m == 0x8000:
                raise _bad_magnitude(path)
            st += 1
    if m < (1 << lo) >> 1:
        ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        ctx[ci] = 12 + 4 * sign
    else:
        ctx[ci] = 4 + 4 * sign
    v, st = m, st + 14                  # M_k of the last X_k
    m >>= 1
    while m:
        if decode(dc, st):
            v |= m
        m >>= 1
    return -(v + 1) if sign else v + 1


def _arith_ac_value(decode, ac, st, k, kx, sign, path) -> int:
    """The rest of an AC value after its sign (Figures F.23 / F.24): `st` is
    the bin of its zero / nonzero decision; the magnitude chain's second
    set by k against Kx."""
    st += 2
    m = decode(ac, st)
    if m and decode(ac, st):
        m, st = 2, 189 if k <= kx else 217
        while decode(ac, st):
            m <<= 1
            if m == 0x8000:
                raise _bad_magnitude(path)
            st += 1
    v, st = m, st + 14
    m >>= 1
    while m:
        if decode(ac, st):
            v |= m
        m >>= 1
    return -(v + 1) if sign else v + 1


def _arith_ac_band(decode, ac, fixed, kx, k0, k1, al, zz, path) -> None:
    """An AC band k0..k1 of block `zz` (F.1.4.4.2; G.1.3.2's first scans):
    an end-of-block decision at 3 (k - 1), the zeros before the next value,
    its sign at the fixed bin, its magnitude, shifted up by `al`."""
    k = k0
    while k <= k1:
        st = 3 * (k - 1)
        if decode(ac, st):
            return
        while not decode(ac, st + 1):
            st += 3
            k += 1
            if k > k1:
                raise _bad_run(path)
        sign = decode(fixed, 0)
        zz[k] = _i16(_arith_ac_value(decode, ac, st, k, kx, sign, path) << al)
        k += 1


def _arith_ac_refine(decode, ac, fixed, ss, se, al, zz, path) -> None:
    """An AC refinement of block `zz` (G.1.3.3): past the previous passes'
    last nonzero coefficient an end-of-block decision at each k; a
    coefficient nonzero before takes a correction bit, a zero one a
    decision whether it becomes +-2^al (its sign at the fixed bin)."""
    p1 = 1 << al
    kex = se
    while kex > 0 and not zz[kex]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and decode(ac, st):
            return
        while True:
            if zz[k]:
                if decode(ac, st + 2):
                    zz[k] = _i16(zz[k] + (-p1 if zz[k] < 0 else p1))
                break
            if decode(ac, st + 1):
                zz[k] = -p1 if decode(fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                raise _bad_run(path)
        k += 1


def _arith_plain(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac, path,
                 cond):
    """One arithmetic-coded scan's entropy-coded data (`arr` onwards) into
    frame.blocks in Python, one decision at a time: the plain version of
    `_arith_native`, the same coefficients and the same errors. `cond`: [L,
    U, Kx] of each conditioning table. -> bytes of entropy-coded data
    consumed."""
    segs, used = _entropy_segments(arr)
    interval = restart or scan.n_mcus
    n_int = -(-scan.n_mcus // interval)
    if len(segs) < n_int:
        raise ValueError(f"{path}: {len(segs)} restart intervals, {n_int} expected")
    lo, hi, kx = cond
    kind, ss, se, al, per_mcu = scan.kind, scan.ss, scan.se, scan.al, len(scan.tables)
    rows = (frame.blocks[scan.dest].tolist() if frame.progressive
            else [[0] * 64 for _ in range(len(scan.dest))])
    b = 0
    for i in range(n_int):
        decode = _qm_decoder(segs[i].tolist(), i == len(segs) - 1 and used == len(arr), path)
        dcs, acs, fixed = [[0] * 64 for _ in range(4)], [[0] * 256 for _ in range(4)], [
            _FIXED_BIN]
        last, ctx = [0] * 4, [0] * 4
        for _ in range(min(interval, scan.n_mcus - i * interval)):
            for ci, (dt, at) in zip(scan.comp, scan.tables):
                zz = rows[b]
                b += 1
                if kind in ("sequential", "dc_first"):
                    diff = _arith_dc(decode, dcs[dt], ctx, ci, lo[dt], hi[dt], path)
                    last[ci] = (last[ci] + diff) & 0xFFFF
                    zz[0] = _i16(last[ci] << (al if kind == "dc_first" else 0))
                    if kind == "sequential":
                        _arith_ac_band(decode, acs[at], fixed, kx[at], 1, 63, 0, zz, path)
                elif kind == "dc_refine":
                    if decode(fixed, 0):
                        zz[0] = _i16(zz[0] | 1 << al)
                elif kind == "ac_first":
                    _arith_ac_band(decode, acs[at], fixed, kx[at], ss, se, al, zz, path)
                else:
                    _arith_ac_refine(decode, acs[at], fixed, ss, se, al, zz, path)
    if rows:
        frame.blocks[scan.dest] = np.array(rows, np.int32)
    return used


def _arith_native(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac, path,
                  cond):
    """`_arith_plain` in `csrc/image.cpp` (`gm_jpeg_arith_scan`): the same
    coefficients, the same errors. -> bytes of entropy-coded data
    consumed."""
    i32 = lambda v: np.ascontiguousarray(v, np.int32)  # noqa: E731
    comp, dest, cond = i32(scan.comp), i32(scan.dest), i32(cond).ravel()
    dc_tab, ac_tab = i32([d for d, _ in scan.tables]), i32([a for _, a in scan.tables])
    used, found = np.zeros(1, np.int64), np.zeros(1, np.int32)
    status = _cuda.host_library("image").gm_jpeg_arith_scan(
        arr.ctypes.data, len(arr), scan.n_mcus, restart, len(scan.tables), comp.ctypes.data,
        dc_tab.ctypes.data, ac_tab.ctypes.data, dest.ctypes.data, int(frame.progressive),
        scan.ss, scan.se, scan.ah, scan.al, cond.ctypes.data, frame.blocks.ctypes.data,
        used.ctypes.data, found.ctypes.data)
    if status == 13:
        raise _bad_magnitude(path)
    if status == 14:
        raise _bad_run(path)
    _native_status(status, "gm_jpeg_arith_scan", path, scan, restart, found)
    return int(used[0])


# ------------------------------------------------------- lossless scans

def _restart_rows(scan: _Scan, restart: int, path) -> int:
    """The MCU rows of a lossless scan's restart interval: libjpeg-turbo
    (`jddiffct.c`) takes only intervals of whole MCU rows."""
    if not restart:
        return scan.mcuy
    if restart % scan.mcux:
        raise ValueError(f"{path}: lossless JPEG restart interval of {restart} MCUs, not a "
                         f"whole number of {scan.mcux}-MCU rows (libjpeg-turbo refuses it; "
                         "PIL cannot load the file)")
    return restart // scan.mcux


def _undifference(plane: np.ndarray, rows: range, first: bool, predictor: int, pt: int):
    """`jdpred.c` on plane rows (in place, the differences -> the samples,
    mod 2^16): a first row (the scan's, or a restart interval's) from
    2^(7 - pt) then Ra; the others' first sample from Rb, the rest by the
    scan's predictor of Ra, Rb and Rc."""
    for y in rows:
        row = plane[y]
        if first:
            ra = 1 << (7 - pt)
            for x in range(len(row)):
                ra = (int(row[x]) + ra) & 0xFFFF
                row[x] = ra
            first = False
            continue
        prev = plane[y - 1]
        rb = int(prev[0])
        ra = (int(row[0]) + rb) & 0xFFFF
        row[0] = ra
        for x in range(1, len(row)):
            rc, rb = rb, int(prev[x])
            if predictor == 1:
                p = ra
            elif predictor == 2:
                p = rb
            elif predictor == 3:
                p = rc
            elif predictor == 4:
                p = ra + rb - rc
            elif predictor == 5:
                p = ra + ((rb - rc) >> 1)
            elif predictor == 6:
                p = rb + ((ra - rc) >> 1)
            else:
                p = (ra + rb) >> 1
            ra = (int(row[x]) + p) & 0xFFFF
            row[x] = ra


def _lossless_plain(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac,
                    path):
    """One lossless scan's entropy-coded data (`arr` onwards) -> its
    components' samples in frame.planes, in Python: each difference (a DC
    table's category, its bits; 16: 32768 with none) into its place, then
    each row undifferenced. -> bytes of entropy-coded data consumed."""
    rows_per = _restart_rows(scan, restart, path)
    tables = [(_decode_tables(*dc[t], False)[0], _peek_table(*dc[t])) for t in scan.tables]
    segs, used = _entropy_segments(arr)
    interval = rows_per * scan.mcux
    n_int = -(-scan.n_mcus // interval)
    if len(segs) < n_int:
        raise ValueError(f"{path}: {len(segs)} restart intervals, {n_int} expected")
    per = len(tables)
    diffs = np.zeros((scan.n_mcus, per), np.int64)
    truncated = f"{path}: entropy-coded data ends early (truncated JPEG)"
    for i in range(n_int):
        W, p = _windows(segs[i]), 0
        try:
            for m in range(i * interval, min((i + 1) * interval, scan.n_mcus)):
                for j, (fast, slow) in enumerate(tables):
                    e = fast[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                    if e & 31:
                        p += e & 31
                        diffs[m, j] = e >> 12
                        continue
                    e = slow[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                    length, size = e & 31, e >> 5
                    if not length:
                        raise ValueError("corrupt JPEG data: no Huffman code matches")
                    if size > 16:
                        raise ValueError(f"{path}: corrupt JPEG data: a difference category "
                                         "over 16")
                    p += length
                    if size == 16:
                        diffs[m, j] = 32768
                    elif size:
                        diffs[m, j] = _extend_bits(_read_bits(W, p, size), size)
                        p += size
        except IndexError:
            p = None
        if p is None or p > 8 * len(segs[i]):
            raise ValueError(truncated)
    my, mx = np.divmod(np.arange(scan.n_mcus), scan.mcux)
    for j, c in enumerate(scan.comp):
        comp = scan.comps[c]
        h, v = scan.hv[c]
        frame.planes[comp][my * v + scan.dy[j], mx * h + scan.dx[j]] = diffs[:, j]
    for c, comp in enumerate(scan.comps):
        v = scan.hv[c][1]
        plane = frame.planes[comp][:scan.mcuy * v, :scan.mcux * scan.hv[c][0]]
        for r0 in range(0, scan.mcuy, rows_per):
            _undifference(plane, range(r0 * v, min(r0 + rows_per, scan.mcuy) * v), True,
                          scan.ss, scan.al)
    return used


def _lossless_native(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac,
                     path):
    """`_lossless_plain` in `csrc/image.cpp` (`gm_jpeg_lossless`): the same
    samples, the same errors. -> bytes of entropy-coded data consumed."""
    rows_per = _restart_rows(scan, restart, path)
    keys = sorted(set(scan.tables))
    tables, vals = _packed_tables([dc[k] for k in keys])
    i32 = lambda v: np.ascontiguousarray(v, np.int32)  # noqa: E731
    comp, dy, dx = i32(scan.comp), i32(scan.dy), i32(scan.dx)
    tab = i32([keys.index(t) for t in scan.tables])
    hs, vs = i32([h for h, _ in scan.hv]), i32([v for _, v in scan.hv])
    planes = [frame.planes[c] for c in scan.comps]
    ptrs = np.array([p.ctypes.data for p in planes], np.uint64)
    stride = np.array([p.shape[1] for p in planes], np.int64)
    used, found = np.zeros(1, np.int64), np.zeros(1, np.int32)
    status = _cuda.host_library("image").gm_jpeg_lossless(
        arr.ctypes.data, len(arr), scan.mcux, scan.mcuy, rows_per, len(scan.comp),
        comp.ctypes.data, dy.ctypes.data, dx.ctypes.data, tab.ctypes.data, tables.ctypes.data,
        vals.ctypes.data, vals.shape[1], len(keys), len(planes), hs.ctypes.data,
        vs.ctypes.data, ptrs.ctypes.data, stride.ctypes.data, scan.ss, scan.al,
        used.ctypes.data, found.ctypes.data)
    if status == 4:
        raise ValueError(f"{path}: corrupt JPEG data: a difference category over 16")
    _native_status(status, "gm_jpeg_lossless", path, scan, rows_per * scan.mcux, found)
    return int(used[0])


def _lossless_image(frame: _Frame, mode: int) -> np.ndarray:
    """A lossless frame's planes -> the image: each sample shifted up by
    its scan's point transform (its low 8 bits, as libjpeg-turbo's 8-bit
    samples keep them), cropped, upsampled by replication (libjpeg-turbo
    does no fancy upsampling of lossless samples) and put in colour mode
    `mode`'s order."""
    planes = []
    for c, p in enumerate(frame.planes):
        rows, cols = frame.comp_size(c)
        x = ((p[:rows, :cols] << frame.pt[c]) & 0xFF).astype(np.uint8)
        x = x.repeat(frame.vmax // frame.v[c], 0).repeat(frame.hmax // frame.h[c], 1)
        planes.append(x[:frame.height, :frame.width])
    if mode == GRAY:
        return np.ascontiguousarray(planes[0])
    img = np.stack(planes, -1)
    if mode in (CMYK, CMYK_INVERTED):
        return cmyk_to_rgb(255 - img if mode == CMYK_INVERTED else img)
    return img


# gm_jpeg_planes' colour modes: one gray plane; YCbCr -> RGB; the three
# planes as they are (three, or four where the caller asks for them); CMYK as
# stored, inverted (PIL's `CMYK;I`) or from YCCK, each then to RGB by
# `cmyk_to_rgb`
GRAY, YCC, PLANES, CMYK, CMYK_INVERTED, YCCK = range(6)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) CMYK (PIL's mode CMYK) -> (..., 3) uint8 RGB, PIL's
    `convert("RGB")` (Pillow's `cmyk2rgb`): with nk = 255 - K, each of R, G,
    B is nk - MULDIV255(C, nk), MULDIV255(a, b) = (((a b + 128) >> 8) + a b +
    128) >> 8 (`gm_jpeg_planes` computes the same in C++). Every term fits
    16 bits: C nk + 128 <= 65,153."""
    x = np.asarray(cmyk).astype(np.uint8)
    nk = (255 - x[..., 3:]).astype(np.uint16)
    t = x[..., :3] * nk + np.uint16(128)
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def _planes_plain(frame: _Frame, mode: int) -> np.ndarray:
    """The frame's coefficients -> the image of colour mode `mode`, in
    numpy."""
    planes = []
    for c in range(len(frame.ids)):
        nby, nbx = frame.grid[c]
        pix = _idct(frame.coef[c].reshape(-1, 64), frame.q[c])
        pix = pix.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        rows, cols = frame.comp_size(c)
        p = _upsample(pix[:rows, :cols].astype(np.int32), frame.vmax // frame.v[c],
                      frame.hmax // frame.h[c])
        planes.append(p[:frame.height, :frame.width])
    if mode == GRAY:
        return planes[0].astype(np.uint8)
    if mode == PLANES:
        return np.stack(planes, -1).astype(np.uint8)
    if mode == YCC:
        return _ycc_to_rgb(*planes)
    if mode == YCCK:    # libjpeg's C, M, Y are 255 - R, G, B; PIL inverts them back
        cmyk = np.concatenate([_ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], -1)
    else:
        cmyk = np.stack(planes, -1)
        if mode == CMYK_INVERTED:
            cmyk = 255 - cmyk
    return cmyk_to_rgb(cmyk)


def _planes_native(frame: _Frame, mode: int) -> np.ndarray:
    """`_planes_plain` in `csrc/image.cpp` (`gm_jpeg_planes`)."""
    n = len(frame.ids)
    i32 = lambda v: np.ascontiguousarray(v, np.int32)  # noqa: E731
    sizes = [frame.comp_size(c) for c in range(n)]
    nby, nbx = i32([g[0] for g in frame.grid]), i32([g[1] for g in frame.grid])
    rows, cols = i32([r for r, _ in sizes]), i32([c for _, c in sizes])
    ry = i32([frame.vmax // v for v in frame.v])
    rx = i32([frame.hmax // h for h in frame.h])
    q = i32(np.stack(frame.q))
    offset = np.ascontiguousarray(frame.offset[:n], np.int64)
    c = n if mode == PLANES else 3
    out = np.empty((frame.height, frame.width) + (() if mode == GRAY else (c,)), np.uint8)
    status = _cuda.host_library("image").gm_jpeg_planes(
        frame.blocks.ctypes.data, n, offset.ctypes.data, nby.ctypes.data,
        nbx.ctypes.data, rows.ctypes.data, cols.ctypes.data, ry.ctypes.data,
        rx.ctypes.data, q.ctypes.data, frame.height, frame.width, mode, out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_jpeg_planes returned {status}")
    return out


def _read_dqt(seg: bytes, qt: dict, path) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        n = 128 if pq else 64
        vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
        if len(vals) != 64:
            raise ValueError(f"{path}: quantisation table {tq} is cut short")
        qt[tq] = vals.astype(np.int64)
        i += 1 + n


def _read_dht(seg: bytes, dc: dict, ac: dict) -> int:
    """-> the bytes the tables' counts call for past the segment's end (a
    cut table keeps the symbols there are)."""
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 15
        bits = tuple(seg[i + 1:i + 17])
        vals = seg[i + 17:i + 17 + sum(bits)]
        (ac if tc else dc)[th] = (bits, vals)
        i += 17 + sum(bits)
    return i - len(seg)


def _read_dac(seg: bytes, cond, path) -> None:
    """A DAC segment (T.81 B.2.4.3) into `cond` ([L, U, Kx], each by table):
    pairs of Tc / Tb and a value, DC (Tc 0) L in the low nibble and U in the
    high one with L <= U, AC (Tc 1) Kx of 1-63; tables 0-3. A bad index or
    value raises naming it, as libjpeg's "Bogus DAC index / value" (which
    takes tables 0-15 and any Kx)."""
    if len(seg) % 2:
        raise ValueError(f"{path}: DAC segment of {len(seg)} bytes, not pairs (bogus marker "
                         "length)")
    for index, val in zip(seg[::2], seg[1::2]):
        tc, tb = index >> 4, index & 15
        if tc > 1 or tb > 3:
            raise ValueError(f"{path}: bogus DAC index {index:#04x}: Tc 0-1 and Tb 0-3")
        if tc:
            if not 1 <= val <= 63:
                raise ValueError(f"{path}: bogus DAC value {val} for AC table {tb}: Kx is 1-63")
            cond[2][tb] = val
        else:
            if (val & 15) > val >> 4:
                raise ValueError(f"{path}: bogus DAC value {val:#04x} for DC table {tb}: "
                                 f"L {val & 15} over U {val >> 4}")
            cond[0][tb], cond[1][tb] = val & 15, val >> 4


def jpeg_tables(data: bytes, path="<bytes>") -> tuple:
    """A tables-only JPEG stream (SOI, DQT and DHT segments, EOI: a TIFF's
    `JPEGTables`) -> (quantisation, DC and AC tables) for `decode_jpeg`.
    APPn, COM and DRI segments are skipped (libjpeg resets the restart
    interval at each image's SOI); a stream that does not start with SOI,
    that holds another marker (a frame or a scan: libtiff's "Bogus
    JPEGTables field") or a segment cut short raises. A missing EOI is
    taken, as libjpeg's tables source supplies one; libjpeg also fills a cut
    segment with EOI markers and reads on, which this refuses."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: JPEGTables does not start with SOI")
    qt, dc, ac = {}, {}, {}
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEGTables: no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data) or data[pos] == 0xD9:
            break
        marker = data[pos]
        if marker not in (0xDB, 0xC4, 0xDD, 0xFE) and not 0xE0 <= marker <= 0xEF:
            raise ValueError(f"{path}: JPEGTables holds marker 0x{marker:02X}; only "
                             "tables (bogus JPEGTables)")
        length = int.from_bytes(data[pos + 1:pos + 3], "big")
        seg = data[pos + 3:pos + 1 + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{path}: JPEGTables cut short in marker 0x{marker:02X}")
        pos += 1 + length
        if marker == 0xDB:
            _read_dqt(seg, qt, path)
        elif marker == 0xC4 and _read_dht(seg, dc, ac) > 0:
            raise ValueError(f"{path}: JPEGTables cut short in a Huffman table")
    return qt, dc, ac


def _decode(data: bytes, path, native: bool, tables=None, color=None,
            on_frame=None) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG")
    qt, dc, ac = ({}, {}, {}) if tables is None else (dict(t) for t in tables)
    frame, restart, jfif, adobe, scans = None, 0, False, None, 0
    cond = [list(t) for t in _DAC_DEFAULT]
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG: no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0x01 <= marker <= 0xBF and (marker != 0x01 or not scans):
            # PIL's `_open` (before the first scan: "no marker found") and
            # libjpeg ("unsupported marker type") refuse these; TEM after
            # a scan libjpeg passes over, as it does RSTn
            raise ValueError(f"{path}: corrupt JPEG: marker 0x{marker:02X} at byte "
                             f"{pos - 1}, which PIL and libjpeg refuse")
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            _read_dqt(seg, qt, path)
        elif marker == 0xC4:
            _read_dht(seg, dc, ac)
        elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            frame = _Frame(seg, path, progressive=marker in (0xC2, 0xCA),
                           lossless=marker == 0xC3, arithmetic=marker in (0xC9, 0xCA))
            if on_frame is not None:
                on_frame(frame)
        elif marker == 0xCB:
            raise ValueError(f"{path}: lossless arithmetic-coded JPEG (SOF11); PIL's "
                             "libjpeg-turbo cannot decode it either (PIL fails to load the "
                             "file), so the JAX reader cannot load it")
        elif marker in _SOF_KINDS:
            raise ValueError(f"{path}: {_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}); "
                             "only baseline, extended sequential, progressive and "
                             "lossless Huffman JPEGs and sequential and progressive "
                             "arithmetic-coded ones are read")
        elif marker == 0xCC:
            _read_dac(seg, cond, path)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            scan = _Scan(frame, seg, qt, dc, ac, path)
            if frame.arithmetic:
                decoder = functools.partial(_arith_native if native else _arith_plain,
                                            cond=[list(t) for t in cond])
            elif frame.lossless:
                decoder = _lossless_native if native else _lossless_plain
            elif frame.progressive:
                decoder = _scan_native_progressive if native else _scan_plain_progressive
            else:
                decoder = _scan_native if native else _scan_plain
            pos += decoder(frame, scan, np.frombuffer(data, np.uint8, offset=pos), restart,
                           dc, ac, path)
            scans += 1
    if frame is None or not scans:
        raise ValueError(f"{path}: no frame or no scan")
    if frame.lossless:
        for c in range(len(frame.ids)):
            if frame.pt[c] is None:
                raise ValueError(f"{path}: component {frame.ids[c]} has no scan")
        mode = _color_mode(len(frame.ids), color, jfif, adobe, frame.ids, path, lossless=True)
        if mode in (YCC, YCCK):
            raise ValueError(
                f"{path}: a lossless JPEG of {len(frame.ids)} components whose markers "
                f"({'JFIF' if jfif else f'Adobe transform {adobe}'}) call for a "
                f"{'YCbCr' if mode == YCC else 'YCCK'} -> RGB conversion; libjpeg-turbo "
                "converts no colour in lossless mode, so PIL cannot load the file")
        return _lossless_image(frame, mode)

    for c in range(len(frame.ids)):
        if frame.q[c] is None:
            raise ValueError(f"{path}: component {frame.ids[c]} has no scan")
    # `smoothing_ok` of jdcoefct.c: nonzero quantisers 0-9 and a coefficient
    # 1-9 not sent in full make libjpeg-turbo smooth the blocks
    if (frame.progressive and all((q[:10] != 0).all() for q in frame.q)
            and (frame.coef_bits[:, 1:10] != 0).any()):
        raise ValueError(f"{path}: progressive JPEG with coefficients left unrefined; "
                         "libjpeg would smooth them (block smoothing is not read)")
    return (_planes_native if native else _planes_plain)(
        frame, _color_mode(len(frame.ids), color, jfif, adobe, frame.ids, path))


def _color_mode(nf, color, jfif, adobe, ids, path, lossless: bool = False) -> int:
    """libjpeg's colour space of `nf` components (`default_decompress_parms`),
    or the one the caller fixes -> gm_jpeg_planes' mode. Three components
    with no JFIF or Adobe marker are RGB in a lossless frame whatever their
    ids (libjpeg-turbo 3)."""
    if color not in (None, "as_is", "ycc", "raw_cmyk"):
        raise ValueError(f"color {color!r}: None, 'as_is', 'ycc' or 'raw_cmyk'")
    if color == "raw_cmyk":
        if nf == 4:
            return PLANES
        color = None
    if color == "ycc":
        if nf != 3:
            raise ValueError(f"{path}: {nf} components where YCbCr needs 3")
        return YCC
    if nf == 1:
        return GRAY
    if color == "as_is":
        return PLANES if nf == 3 else CMYK
    if nf == 4:
        return CMYK_INVERTED if adobe in (None, 0) else YCCK
    if jfif:
        return YCC
    if adobe is not None:
        return PLANES if adobe == 0 else YCC
    return PLANES if lossless or tuple(ids) == (82, 71, 66) else YCC


def decode_jpeg(data: bytes, path="<bytes>", *, native: bool = True, tables=None,
                color=None, on_frame=None) -> np.ndarray:
    """`read_jpeg` (native) or `read_jpeg_plain` of a JPEG's bytes. `tables`
    (`jpeg_tables`' result) seed the tables of an abbreviated stream; `color`
    fixes the colour space as libtiff does: "as_is" takes the components as
    they are (1 gray, 3 the planes, 4 CMYK as stored, then `cmyk_to_rgb`),
    "ycc" three components as YCbCr; "raw_cmyk" gives four components as
    stored, with no CMYK conversion ((H, W, 4): BLP1's B, G, R and alpha,
    `io/blp.py`), and one or three as by default; `on_frame(frame)` sees
    the frame header before the scans (it raises to refuse one)."""
    return _decode(data, path, native, tables, color, on_frame)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline, extended sequential, progressive or lossless 8-bit Huffman
    JPEG, or a sequential or progressive arithmetic-coded one -> uint8 (H,
    W) gray or (H, W, 3) RGB, the bits PIL 12
    (libjpeg-turbo) decodes (a CMYK or YCCK file: PIL's `convert("RGB")` of
    it); decoded by `csrc/image.cpp`."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode(data, path, native=True)


def read_jpeg_plain(path: str) -> np.ndarray:
    """`read_jpeg` in Python and numpy alone: the plain version the C++
    decoder is held to (tests and `chip_smoke.py`; slow)."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode(data, path, native=False)


# ---------------------------------------------------------------- encoder

def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's `jpeg_quality_scaling` + `jpeg_add_quant_table` (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _encode_tables(bits, vals):
    codes, lengths, syms = _canonical(bits, vals)
    code, size = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code[syms], size[syms] = codes, lengths
    return code, size


def _fdct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    a = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    a[0] /= np.sqrt(2)
    return a


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A plane edge-padded to rows x cols -> (rows / 8, cols / 8, 64)."""
    h, w = plane.shape
    p = np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")
    return p.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3).reshape(
        rows // 8, cols // 8, 64)


_SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2)}


def _magnitude(v):
    """Values -> (their magnitude category, their extra bits) (F.1.2.1)."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return size, np.where(v < 0, v + (1 << size) - 1, v)


def _pack(val, ln) -> bytes:
    """Code words `val` of `ln` bits each (up to 33), in order -> the
    entropy-coded bytes: MSB first, padded with 1 bits, 0xFF stuffed. Each
    word lands in the 64-bit word its first bit falls in and, past its end,
    the next; the words' parts are ORed together word by word."""
    val, ln = np.asarray(val, np.int64), np.asarray(ln, np.int64)
    total = int(ln.sum())
    words = np.zeros(total // 64 + 2, np.uint64)
    if total:
        starts = np.cumsum(ln) - ln
        at, end = starts >> 6, (starts & 63) + ln
        v = (val & ((1 << ln) - 1)).astype(np.uint64)
        over = end > 64
        high = np.where(over, v >> np.where(over, end - 64, 0).astype(np.uint64),
                        v << np.where(over, 0, 64 - end).astype(np.uint64))
        low = np.where(over, v << np.where(over, 128 - end, 0).astype(np.uint64),
                       np.uint64(0))
        word, first = np.unique(at, return_index=True)
        words[word] |= np.bitwise_or.reduceat(high, first)
        words[word + 1] |= np.bitwise_or.reduceat(low, first)
    by = words.byteswap().view(np.uint8)[:-(-total // 8)].copy()
    if total % 8:
        by[-1] |= (1 << (8 - total % 8)) - 1
    ff = by == 0xFF
    stuffed = np.repeat(by, 1 + ff)
    stuffed[np.flatnonzero(ff) + np.arange(int(ff.sum())) + 1] = 0
    return stuffed.tobytes()


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _subsample(p: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """Means over (sv, sh) cells of a plane, edge padded."""
    h, w = p.shape
    p = np.pad(p, ((0, -h % sv), (0, -w % sh)), mode="edge")
    return np.floor(p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh).mean((1, 3)) + 0.5)


def _ycc_planes(img: np.ndarray) -> list:
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    return [np.clip(np.round(p), 0, 255) for p in ycc]


def _coefficients(img: np.ndarray, quality: int, subsampling: str, color: str = "auto"):
    """write_jpeg's image -> (quantisation tables, per component its
    sampling, table and (rows, cols) of zig-zag quantised coefficients over
    the MCU-padded grid). `color` "auto": gray, YCbCr (chroma subsampled),
    or four channels of PIL's CMYK stored inverted, as libjpeg writes PIL's
    CMYK; "ycck": PIL's C, M, Y as the R, G, B of YCbCr (chroma subsampled),
    255 - K (libjpeg's `cmyk_ycck_convert` of the inverted CMYK); "as_is":
    the channels as they are, one table, 4:4:4 (a TIFF's Photometric 1, 2
    and 5)."""
    h, w = img.shape[:2]
    qs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    sh, sv = _SUBSAMPLING[subsampling]
    if img.ndim == 2:
        planes, samp, qsel = [img.astype(np.float64)], [(1, 1)], [0]
    elif color == "as_is" or (color == "auto" and img.shape[2] == 4):
        planes = [img[..., i].astype(np.float64) for i in range(img.shape[2])]
        if color == "auto":
            planes = [255.0 - p for p in planes]
        samp, qsel = [(1, 1)] * len(planes), [0] * len(planes)
    else:
        planes = [_subsample(p, sh, sv) if i else p
                  for i, p in enumerate(_ycc_planes(img))]
        samp, qsel = [(sh, sv), (1, 1), (1, 1)], [0, 1, 1]
        if color == "ycck":
            planes.append(255.0 - img[..., 3].astype(np.float64))
            samp, qsel = samp + [(sh, sv)], qsel + [0]
    hmax, vmax = samp[0]
    mcuy, mcux = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    a = _fdct_matrix()
    grids = []
    for p, (sh, sv), qi in zip(planes, samp, qsel):
        blk = _blocks(p - 128.0, mcuy * 8 * sv, mcux * 8 * sh).reshape(-1, 8, 8)
        coef = (a @ blk @ a.T).reshape(mcuy * sv, mcux * sh, 64)
        grids.append(np.round(coef / qs[qi]).astype(np.int64)[..., ZIGZAG])   # zigzag order
    return qs, samp, qsel, grids


def _dqt(qs, n) -> bytes:
    return b"".join(_segment(0xDB, bytes([i]) + qs[i][ZIGZAG].astype(np.uint8).tobytes())
                    for i in range(n))


def _dht(n) -> bytes:
    """The Annex K Huffman tables of `n` table pairs (luma, then chroma)."""
    return b"".join(_segment(0xC4, bytes([i]) + bytes(dct[0]) + dct[1] + bytes([0x10 | i])
                             + bytes(act[0]) + act[1])
                    for i, (dct, act) in enumerate(((_DC_LUMA, _AC_LUMA),
                                                    (_DC_CHROMA, _AC_CHROMA))[:n]))


# APP0 JFIF, and APP14 Adobe (version 100, no flags) of transform 0 or 2
_JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _adobe(transform):
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def _headers(h, w, qs, samp, qsel, sof, app=_JFIF, tables=True) -> list:
    nc = len(samp)
    out = [b"\xff\xd8", app] + ([_dqt(qs, max(qsel) + 1)] if tables else [])
    out.append(_segment(sof, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, sh << 4 | sv, qsel[i]]) for i, (sh, sv) in enumerate(samp))))
    return out


def _baseline(h, w, qs, samp, qsel, grids, tables=True) -> list:
    """One interleaved scan with the Annex K Huffman tables (their DHT first
    unless `tables` is false: an abbreviated stream)."""
    mcuy, mcux = grids[0].shape[0] // samp[0][1], grids[0].shape[1] // samp[0][0]
    blocks = np.concatenate([q.reshape(mcuy, sv, mcux, sh, 64).transpose(0, 2, 1, 3, 4)
                             .reshape(mcuy * mcux, sv * sh, 64)
                             for q, (sh, sv) in zip(grids, samp)], 1)
    per_mcu = blocks.shape[1]
    comp_of = np.concatenate([np.full(sh * sv, i) for i, (sh, sv) in enumerate(samp)])
    blocks = blocks.reshape(-1, 64)
    comp = np.tile(comp_of, len(blocks) // per_mcu)

    # DC differences per component in scan order
    dcv = blocks[:, 0].copy()
    for c in range(len(samp)):
        sel = np.flatnonzero(comp == c)
        dcv[sel] = np.diff(blocks[sel, 0], prepend=0)
    # Huffman tables by 2 * (0 luma / 1 chroma) + (0 DC / 1 AC)
    code_of, len_of = (np.stack(x) for x in zip(*(_encode_tables(*t) for t in (
        _DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA))))
    tsel = 2 * np.array(qsel)[comp]

    # symbols as (sort key, table, symbol, extra bits, their length); the key
    # orders them by block, then DC, ZRLs and AC by position, then EOB
    events = []

    def emit(key, table, sym, extra=0, elen=0):
        n = len(key)
        events.append([key, table, np.broadcast_to(sym, n),
                       np.broadcast_to(extra, n), np.broadcast_to(elen, n)])

    nb = len(blocks)
    size, extra = _magnitude(dcv)
    emit(np.arange(nb) * 260, tsel, size, extra, size)
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    prev = np.concatenate([[0], k[:-1]])
    prev[np.flatnonzero(np.diff(b, prepend=-1))] = 0    # first in its block
    run = k - prev - 1
    size, extra = _magnitude(blocks[b, k])
    for j in range(3):                  # ZRLs before runs of 16 or more
        z = np.flatnonzero(run >= 16 * (j + 1))
        emit(b[z] * 260 + k[z] * 4 + j, tsel[b[z]] + 1, 0xF0)
    emit(b * 260 + k * 4 + 3, tsel[b] + 1, (run % 16) << 4 | size, extra, size)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    emit(eob * 260 + 256, tsel[eob] + 1, 0)

    order = np.argsort(np.concatenate([e[0] for e in events]), kind="stable")
    tab, sym, ext, elen = (np.concatenate([e[i] for e in events])[order].astype(np.int64)
                           for i in range(1, 5))
    code, clen = code_of[tab, sym], len_of[tab, sym]
    nc = len(samp)
    out = [_dht(max(qsel) + 1)] if tables else []
    out.append(_segment(0xDA, bytes([nc]) + b"".join(
        bytes([i + 1, qsel[i] << 4 | qsel[i]]) for i in range(nc)) + b"\x00\x3f\x00"))
    out.append(_pack(code << elen | (ext & ((1 << elen) - 1)), clen + elen))
    return out


def _optimal_table(freq):
    """Symbol counts (256) -> (16 code counts, symbols): Annex K.2 as
    libjpeg's `jpeg_gen_optimal_table`, a pseudo-symbol 256 keeping the code
    of all ones free, lengths over 16 folded back."""
    syms = [int(x) for x in np.flatnonzero(freq)] + [256]
    size = dict.fromkeys(syms, 0)
    # ties to the larger symbol, as libjpeg takes them
    heap = [(int(freq[x]) if x < 256 else 1, -x, [x]) for x in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, t1, a = heapq.heappop(heap)
        f2, t2, b = heapq.heappop(heap)
        for x in a + b:
            size[x] += 1
        heapq.heappush(heap, (f1 + f2, max(t1, t2), a + b))
    bits = np.zeros(max(33, max(size.values()) + 1), np.int64)
    for x in syms:
        bits[size[x]] += 1
    for i in range(len(bits) - 1, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                        # the pseudo-symbol
    order = sorted((size[x], x) for x in syms if x < 256)
    return tuple(int(c) for c in bits[1:17]), bytes(x for _, x in order)


# one EOB run codes at most 2^15 - 1 blocks (EOB14 and 14 bits)
_MAX_EOBRUN = 0x7FFF


def _ac_events(t, sign, refine: bool):
    """An AC scan's band over its blocks (t (blocks, L): the magnitudes after
    the point transform, `sign` their signs) -> the scan's symbols and raw
    bits as (key, symbol or -1 for a raw bit, extra bits, their length).

    A first scan codes each nonzero t as (run, size) with its value bits; a
    refinement codes each t of 1 (newly nonzero) as (run, 1) with its sign
    bit, and gives each t over 1 (nonzero before) its next bit, t & 1, as a
    correction bit. Runs count the zeros (t == 0) in between; ZRLs code 16 of
    them each. A block whose band does not end on a coded coefficient joins
    an EOB run, coded before the next block that codes one (or at the end),
    at most 2^15 - 1 blocks a run. The decoder reads a correction bit while
    walking past its coefficient, so each one follows the first symbol
    whose walk reaches past it: in a block, a symbol's key is 2 (e + 1) for
    e the position its walk starts after, a correction bit's 2 k + 1."""
    nb, L = t.shape
    span = 2 * L + 2
    coded = t == 1 if refine else t > 0
    zero = t == 0
    zb, zk = np.nonzero(zero)
    zoff = np.searchsorted(zb, np.arange(nb + 1))
    zbefore = np.cumsum(zero, 1) - zero                 # zeros before each position
    b, k = np.nonzero(coded)
    first = np.diff(b, prepend=-1) != 0
    prev = np.where(first, -1, np.concatenate([[-1], k[:-1]]))
    z0 = np.where(prev < 0, 0, zbefore[b, np.maximum(prev, 0)] + zero[b, np.maximum(prev, 0)])
    run = zbefore[b, k] - z0
    n_zrl = run // 16
    keys, syms, extras, elens = [], [], [], []
    # ZRLs: the m-th ends at the (z0 + 16 m)-th zero after the previous symbol
    zi = np.repeat(np.arange(len(b)), n_zrl)
    m = np.arange(len(zi)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl) + 1
    zend = lambda i, mm: zk[zoff[b[i]] + z0[i] + 16 * mm - 1]     # noqa: E731
    zstart = prev[zi]
    later = m > 1
    zstart[later] = zend(zi[later], m[later] - 1)
    keys.append(b[zi] * span + 2 * (zstart + 1))
    syms.append(np.full(len(zi), 0xF0))
    extras.append(np.zeros(len(zi), np.int64))
    elens.append(np.zeros(len(zi), np.int64))
    start = prev.copy()
    after = np.flatnonzero(n_zrl)
    start[after] = zend(after, n_zrl[after])
    keys.append(b * span + 2 * (start + 1))
    if refine:
        syms.append((run % 16) << 4 | 1)
        extras.append((sign[b, k] > 0).astype(np.int64))
        elens.append(np.ones(len(b), np.int64))
        hb, hk = np.nonzero(t > 1)                      # correction bits
        keys.append(hb * span + 2 * hk + 1)
        syms.append(np.full(len(hb), -1))
        extras.append(t[hb, hk] & 1)
        elens.append(np.ones(len(hb), np.int64))
    else:
        size, extra = _magnitude(np.where(sign[b, k] < 0, -t[b, k], t[b, k]))
        syms.append((run % 16) << 4 | size)
        extras.append(extra)
        elens.append(size)
    # EOB runs: from each block that codes a coefficient (and block 0) to
    # the next, the blocks whose band does not end on a coded coefficient
    last = np.full(nb, -1)
    np.maximum.at(last, b, k)
    trails = last < L - 1
    seg = np.union1d([0], b)
    run_start = np.where(trails[seg], seg, seg + 1)
    run_len = np.append(seg[1:], nb) - run_start
    keep = run_len > 0
    run_start, run_len = run_start[keep], run_len[keep]
    n_chunk = -(-run_len // _MAX_EOBRUN)
    ci = np.repeat(np.arange(len(run_len)), n_chunk)
    j = np.arange(len(ci)) - np.repeat(np.cumsum(n_chunk) - n_chunk, n_chunk)
    x = run_start[ci] + j * _MAX_EOBRUN
    n = np.minimum(run_len[ci] - j * _MAX_EOBRUN, _MAX_EOBRUN)
    r = np.frexp(n.astype(np.float64))[1].astype(np.int64) - 1
    keys.append(x * span + 2 * (last[x] + 1))
    syms.append(r << 4)
    extras.append(n - (1 << r))
    elens.append(r)
    return [np.concatenate(a).astype(np.int64) for a in (keys, syms, extras, elens)]


def simple_progression(nc: int) -> list:
    """libjpeg's `jpeg_simple_progression` script for `nc` components:
    [(components, Ss, Se, Ah, Al)]."""
    if nc == 3:     # Cr before Cb, as libjpeg
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    every = tuple(range(nc))        # the all-purpose script: each AC band by component
    return ([(every, 0, 0, 0, 1)]
            + [((c,), ss, se, ah, al) for ss, se, ah, al in
               ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1)) for c in every]
            + [(every, 0, 0, 1, 0)] + [((c,), 1, 63, 1, 0) for c in every])


def _scan_blocks(h, w, samp, grids, comps):
    """A scan's blocks in its order -> ((n, 64) zig-zag coefficients, the
    component of each): interleaved, the MCUs of every component's h x v
    blocks; one component alone, its own blocks over its sampled size."""
    hmax, vmax = samp[0]
    if len(comps) > 1:
        mcuy, mcux = grids[0].shape[0] // vmax, grids[0].shape[1] // hmax
        parts = [grids[c].reshape(mcuy, samp[c][1], mcux, samp[c][0], 64)
                 .transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, -1, 64) for c in comps]
        blocks = np.concatenate(parts, 1).reshape(-1, 64)
        comp = np.tile(np.concatenate([np.full(p.shape[1], c) for c, p in
                                       zip(comps, parts)]), mcuy * mcux)
        return blocks, comp
    c = comps[0]
    rows = -(-h * samp[c][1] // vmax)
    cols = -(-w * samp[c][0] // hmax)
    blocks = grids[c][:-(-rows // 8), :-(-cols // 8)].reshape(-1, 64)
    return blocks, np.full(len(blocks), c)


def _progressive(h, w, qs, samp, qsel, grids) -> list:
    """The coefficients as `jpeg_simple_progression`'s scans, each after a
    DHT of its own optimal tables."""
    out = []
    for comps, ss, se, ah, al in simple_progression(len(samp)):
        blocks, comp = _scan_blocks(h, w, samp, grids, comps)
        tab = np.array(qsel)[comp]
        if ss == 0 and ah:              # DC refinement: a raw bit a block
            keys, syms = np.arange(len(blocks)), np.full(len(blocks), -1)
            extras, elens = (blocks[:, 0] >> al) & 1, np.ones(len(blocks), np.int64)
        elif ss == 0:                   # DC first: differences of coef >> Al
            v = blocks[:, 0] >> al
            diff = v.copy()
            for c in comps:
                sel = np.flatnonzero(comp == c)
                diff[sel] = np.diff(v[sel], prepend=0)
            size, extras = _magnitude(diff)
            keys, syms, elens = np.arange(len(blocks)), size, size
        else:
            band = blocks[:, ss:se + 1]
            keys, syms, extras, elens = _ac_events(np.abs(band) >> al, np.sign(band),
                                                   refine=ah > 0)
            tab = np.full(len(keys), qsel[comps[0]])
        order = np.argsort(keys, kind="stable")
        syms, extras, elens, tab = syms[order], extras[order], elens[order], tab[order]
        code, clen = np.zeros(len(syms), np.int64), np.zeros(len(syms), np.int64)
        dht = b""
        huffman = syms >= 0
        for t in sorted(set(tab[huffman].tolist())):
            sel = huffman & (tab == t)
            bits, vals = _optimal_table(np.bincount(syms[sel], minlength=256))
            dht += bytes([(0 if ss == 0 else 0x10) | t]) + bytes(bits) + vals
            cw, cl = _encode_tables(bits, vals)
            code[sel], clen[sel] = cw[syms[sel]], cl[syms[sel]]
        if dht:
            out.append(_segment(0xC4, dht))
        td_ta = [(qsel[c] << 4 if ss == 0 and not ah else 0) | (qsel[c] if ss else 0)
                 for c in comps]
        out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c + 1, t]) for c, t in zip(comps, td_ta)) + bytes([ss, se, ah << 4 | al])))
        out.append(_pack(code << elens | (extras & ((1 << elens) - 1)), clen + elens))
    return out


def _dac(comps, dc_used: bool, ac_used: bool, tabs, cond) -> bytes:
    """A DAC segment of the conditioning of the tables a scan of `comps`
    uses (libjpeg's `emit_dac`), b"" where it uses none."""
    body = b""
    for t in sorted({tabs[c] for c in comps}):
        if dc_used:
            body += bytes([t, cond[0][t] | cond[1][t] << 4])
        if ac_used:
            body += bytes([0x10 | t, cond[2][t]])
    return _segment(0xCC, body) if body else b""


def arith_scans(h, w, samp, grids, script, tabs, restart: int = 0, dac=None) -> list:
    """Coefficient grids (`_coefficients`' layout) as arithmetic-coded scans
    (`gm_jpeg_arith_encode`, `jcarith.c`): `script` [(components, Ss, Se,
    Ah, Al)], all (0, 63, 0, 0) for an SOF9 frame's sequential scans, else
    an SOF10 frame's; component c coded with conditioning table tabs[c]
    (0-3); an RSTn marker every `restart` MCUs; with `dac`
    ((L, U, Kx), each of 4 tables) a DAC segment before each scan for the
    tables it uses, and that conditioning (else the defaults L 0, U 1, Kx 5
    and no DAC). -> [DAC, SOS, entropy-coded data] of each scan."""
    progressive = any((ss, se, ah, al) != (0, 63, 0, 0) for _, ss, se, ah, al in script)
    cond = _DAC_DEFAULT if dac is None else tuple(tuple(int(x) for x in t) for t in dac)
    flat = np.array(cond, np.int32).ravel()
    lib = _cuda.host_library("image")
    out = []
    for comps, ss, se, ah, al in script:
        blocks, comp = _scan_blocks(h, w, samp, grids, comps)
        per_mcu = sum(samp[c][0] * samp[c][1] for c in comps) if len(comps) > 1 else 1
        blocks = np.ascontiguousarray(blocks, np.int32)
        slot = np.ascontiguousarray(comp[:per_mcu], np.int32)
        tab = np.ascontiguousarray(np.asarray(tabs)[slot], np.int32)
        dc_used = not progressive or (ss == 0 and ah == 0)
        ac_used = not progressive or ss > 0
        if dac is not None:
            out.append(_dac(comps, dc_used, ac_used, tabs, cond))
        td_ta = [(tabs[c] << 4 if ss == 0 else 0) | (tabs[c] if ss or not progressive else 0)
                 for c in comps]
        out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c + 1, t]) for c, t in zip(comps, td_ta)) + bytes([ss, se, ah << 4 | al])))
        cap, n_out = 1024 + blocks.size, np.zeros(1, np.int64)
        while True:
            buf = np.empty(cap, np.uint8)
            status = lib.gm_jpeg_arith_encode(
                blocks.ctypes.data, len(blocks) // per_mcu, per_mcu, slot.ctypes.data,
                tab.ctypes.data, tab.ctypes.data, int(progressive), ss, se, ah, al, restart,
                flat.ctypes.data, buf.ctypes.data, cap, n_out.ctypes.data)
            if status != 10:
                break
            cap = int(n_out[0])
        if status == 15:
            raise ValueError("a coefficient outside +-32767 (more than 16 bits)")
        if status:
            raise RuntimeError(f"gm_jpeg_arith_encode returned {status}")
        out.append(buf[:int(n_out[0])].tobytes())
    return out


# ------------------------------------------------------- lossless (SOF3)

def _predict(plane: np.ndarray, predictor: int, pt: int, rows_per_interval: int) -> np.ndarray:
    """The encoder's side of `_undifference`: each sample's prediction
    from the samples before it (H.1.2.1), the first row of the scan and of
    each restart interval by 2^(7 - pt) then Ra, the first column by Rb.
    -> int64 predictions, the plane's shape."""
    x = plane.astype(np.int64)
    ra = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    rb = np.pad(x, ((1, 0), (0, 0)))[:-1]
    rc = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    first = np.arange(len(x)) % rows_per_interval == 0
    pred[first] = ra[first]
    pred[first, 0] = 1 << (7 - pt)
    return pred


def _lossless_scan(planes, samp, comps, predictor, pt, restart, tables) -> list:
    """One SOF3 scan of the components `comps` (their planes already
    shifted down by `pt`): a DHT of one optimal DC table a component (ids
    `tables[c]`), the SOS, the entropy-coded data with RSTn markers between
    restart intervals."""
    if len(comps) > 1:                  # interleaved: MCUs of h x v samples each
        rows, cols = planes[comps[0]].shape
        mcuy, mcux = -(-rows // samp[comps[0]][1]), -(-cols // samp[comps[0]][0])
    else:
        c = comps[0]
        mcuy, mcux = planes[c].shape
    if restart and restart % mcux:
        raise ValueError(f"a restart interval of {restart} MCUs is not whole MCU rows of "
                         f"{mcux} (libjpeg-turbo's lossless coder refuses it)")
    rows = restart // mcux if restart else mcuy
    parts, comp_of = [], []
    for c in comps:
        sh, sv = samp[c] if len(comps) > 1 else (1, 1)
        p = planes[c]
        p = np.pad(p, ((0, mcuy * sv - p.shape[0]), (0, mcux * sh - p.shape[1])), mode="edge")
        d = (p.astype(np.int64) - _predict(p, predictor, pt, rows * sv)) & 0xFFFF
        d = np.where(d >= 1 << 15, d - (1 << 16), d)
        parts.append(d.reshape(mcuy, sv, mcux, sh).transpose(0, 2, 1, 3).reshape(
            mcuy * mcux, sv * sh))
        comp_of += [c] * (sv * sh)
    return lossless_entropy(np.concatenate(parts, 1), comp_of, tables, predictor, pt, restart)


def lossless_entropy(diffs: np.ndarray, comp_of, tables, predictor: int, pt: int,
                     restart: int = 0) -> list:
    """A lossless scan's differences (MCUs, samples an MCU; -32768 or 32768
    coded as category 16, with no bits) and the component of each sample of
    an MCU -> [its DHT (one optimal table a component, id `tables[c]`), its
    SOS, the entropy-coded data with an RSTn marker every `restart` MCUs]."""
    comp_of = np.asarray(comp_of)
    comps = list(dict.fromkeys(comp_of.tolist()))
    size, extra = _magnitude(diffs)
    elen = np.where(size == 16, 0, size)
    dht, code, clen = b"", np.zeros_like(size), np.zeros_like(size)
    for c in comps:
        sel = comp_of == c
        bits, vals = _optimal_table(np.bincount(size[:, sel].ravel(), minlength=256))
        dht += bytes([tables[c]]) + bytes(bits) + vals
        cw, cl = _encode_tables(bits, vals)
        code[:, sel], clen[:, sel] = cw[size[:, sel]], cl[size[:, sel]]
    words = code << elen | (extra & ((1 << elen) - 1))
    per = restart or len(diffs)
    data = b""
    for i, a in enumerate(range(0, len(diffs), per)):
        if i:
            data += bytes([0xFF, 0xD0 + (i - 1) % 8])
        data += _pack(words[a:a + per].ravel(), (clen + elen)[a:a + per].ravel())
    sos = _segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([c + 1, tables[c] << 4]) for c in comps) + bytes([predictor, 0, pt]))
    return [_segment(0xC4, dht), sos, data]


_LOSSLESS_MARKERS = {"none": b"", "jfif": _JFIF, "adobe0": _adobe(0), "adobe1": _adobe(1),
                     "adobe2": _adobe(2)}


def encode_jpeg_lossless(img: np.ndarray, predictor: int, point_transform: int = 0,
                         restart: int = 0, interleave: bool = True, *,
                         marker: str = "none", sampling=None) -> bytes:
    """(H, W) gray, (H, W, 3) or (H, W, 4) uint8 -> an 8-bit lossless JPEG
    (SOF3, Huffman): the components as they are (no colour transform),
    shifted down by `point_transform`, predicted by `predictor` (1-7), the
    differences coded with one optimal DC table a component; one
    interleaved scan, or one scan a component; a DRI of `restart` MCUs
    (whole MCU rows) where given; `marker` "none", "jfif" or "adobe0" /
    "adobe1" / "adobe2" before the frame. `sampling` [(h, v)] a component
    writes each component's samples at that share of the largest (its plane
    taken every hmax / h, vmax / v samples), for the tests."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise ValueError(f"encode_jpeg_lossless takes uint8 (H, W), (H, W, 3) or (H, W, 4), "
                         f"not {img.dtype} {img.shape}")
    if not 1 <= predictor <= 7 or not 0 <= point_transform <= 7:
        raise ValueError(f"predictor {predictor} (1-7), point transform {point_transform} "
                         "(0-7)")
    h, w = img.shape[:2]
    chans = [img] if img.ndim == 2 else [img[..., i] for i in range(img.shape[2])]
    samp = list(sampling or [(1, 1)] * len(chans))
    hmax, vmax = max(s[0] for s in samp), max(s[1] for s in samp)
    planes = []
    for ch, (sh, sv) in zip(chans, samp):
        rows, cols = -(-h * sv // vmax), -(-w * sh // hmax)
        pad = np.pad(ch, ((0, rows * (vmax // sv) - h), (0, cols * (hmax // sh) - w)),
                     mode="edge")
        planes.append(pad[::vmax // sv, ::hmax // sh][:rows, :cols] >> point_transform)
    out = [b"\xff\xd8", _LOSSLESS_MARKERS[marker]]
    out.append(_segment(0xC3, struct.pack(">BHHB", 8, h, w, len(chans)) + b"".join(
        bytes([i + 1, sh << 4 | sv, 0]) for i, (sh, sv) in enumerate(samp))))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    every = list(range(len(chans)))
    for comps in ([every] if interleave else [[c] for c in every]):
        out += _lossless_scan(planes, samp, comps, predictor, point_transform, restart,
                              every)
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode_jpeg(img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0",
                progressive: bool = False, *, color: str = "auto",
                tables: bool = True, arithmetic: bool = False, restart: int = 0,
                dac=None) -> bytes:
    """`write_jpeg`'s bytes. `color` as `_coefficients` takes it: "auto"
    (gray or YCbCr with a JFIF marker, four channels as inverted CMYK with an
    Adobe marker of transform 0), "ycck" (four channels, an Adobe marker of
    transform 2) or "as_is" (the channels with no marker: libtiff's
    JCS_UNKNOWN). `tables=False` writes an abbreviated baseline stream (no
    DQT, DHT or marker segment: a JPEG-compressed TIFF's strip or tile, its
    tables in `encode_jpeg_tables`). `arithmetic` codes the same
    coefficients with the QM coder (`arith_scans`): SOF9, one interleaved
    scan, or with `progressive` SOF10 in `jpeg_simple_progression`'s scans; each
    component with the conditioning table of its quantisation table, an
    RSTn marker every `restart` MCUs and, with `dac` ((L, U, Kx), each of 4
    tables), DAC segments of that conditioning."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_jpeg takes uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise ValueError(f"write_jpeg takes (H, W), (H, W, 3) or (H, W, 4), not {img.shape}")
    if subsampling not in _SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}: one of {list(_SUBSAMPLING)}")
    if color not in ("auto", "ycck", "as_is") or (
            color == "ycck" and (img.ndim == 2 or img.shape[2] != 4)):
        raise ValueError(f"color {color!r} of a {img.shape} image: 'auto', 'as_is', or "
                         "'ycck' for four channels")
    if (progressive or arithmetic) and not tables:
        raise ValueError("an abbreviated stream is baseline")
    if (restart or dac is not None) and not arithmetic:
        raise ValueError("restart intervals and DAC segments are written in arithmetic-coded "
                         "files only")
    h, w = img.shape[:2]
    qs, samp, qsel, grids = _coefficients(img, quality, subsampling, color)
    app = (b"" if color == "as_is" else _adobe(2) if color == "ycck" else
           _adobe(0) if len(samp) == 4 else _JFIF)
    sof = (0xC8 if arithmetic else 0xC0) + (2 if progressive else 1 if arithmetic else 0)
    out = _headers(h, w, qs, samp, qsel, sof, app if tables else b"", tables)
    if arithmetic:
        script = (simple_progression(len(samp)) if progressive else
                  [(tuple(range(len(samp))), 0, 63, 0, 0)])
        if restart:
            out.append(_segment(0xDD, struct.pack(">H", restart)))
        out += arith_scans(h, w, samp, grids, script, qsel, restart, dac)
    else:
        out += (_progressive(h, w, qs, samp, qsel, grids) if progressive else
                _baseline(h, w, qs, samp, qsel, grids, tables))
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode_jpeg_tables(quality: int = 90, n_tables: int = 2) -> bytes:
    """The tables-only stream (SOI, DQT, DHT, EOI) of `encode_jpeg(...,
    tables=False)`'s streams: the quantisation tables at `quality` and the
    Annex K Huffman tables, luma alone (`n_tables` 1) or luma and chroma."""
    qs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    return b"\xff\xd8" + _dqt(qs, n_tables) + _dht(n_tables) + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 90,
               subsampling: str = "4:2:0", progressive: bool = False,
               ycck: bool = False, arithmetic: bool = False) -> None:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) CMYK (PIL's mode CMYK) uint8
    -> a JPEG with the Annex K quantisation tables at libjpeg's `quality`.
    Gray and RGB (as YCbCr) with a JFIF marker, chroma subsampled 4:2:0,
    4:2:2, 4:4:0 or not at all (4:4:4); CMYK inverted at 4:4:4 with an Adobe
    marker of transform 0 (as libjpeg writes PIL's CMYK), or with `ycck` as
    YCCK, Cb and Cr subsampled. Baseline (one interleaved scan, the Annex K
    Huffman tables), or with `progressive` the same coefficients in
    `jpeg_simple_progression`'s scans (SOF2); with `arithmetic` the same
    coefficients arithmetic-coded (SOF9, or SOF10 with `progressive`)."""
    data = encode_jpeg(img, quality, subsampling, progressive,
                       color="ycck" if ycck else "auto", arithmetic=arithmetic)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
