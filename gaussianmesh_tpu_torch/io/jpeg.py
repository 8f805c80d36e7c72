"""Baseline JPEG without an imaging package: the machines the port runs on
have none (the JAX package reads JPEGs with PIL).

`read_jpeg` decodes 8-bit sequential Huffman JPEGs (SOF0 baseline and SOF1
extended) with 1 or 3 components, sampling factors 1-2 on each axis
(4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals, interleaved or
single-component scans, to the arrays `np.asarray(PIL.Image.open(p))`
gives: (H, W) uint8 for gray, (H, W, 3) RGB otherwise. It follows PIL 12's
libjpeg-turbo step for step so that the bits agree:

- the integer "islow" IDCT (`jidctint.c`: 13-bit constants, two passes
  with their descales, the output clamped to 0..255);
- "fancy" chroma upsampling (`jdsample.c`): the triangle filter for h2v1
  and h2v2 with its alternating rounding bias, and h1v2; plain
  replication where the downsampled width is 2 or less;
- the fixed-point YCbCr -> RGB tables (`jdcolor.c`: 16-bit scale,
  `ONE_HALF` rounding); a JFIF or Adobe marker, else the component ids,
  says whether the three components are YCbCr or RGB.

EXIF orientation is ignored, as a plain `Image.open` ignores it.
Progressive, arithmetic-coded, lossless and hierarchical files, 12-bit
samples and 4-component (CMYK / YCCK) files raise with the cause.

`read_jpeg` parses the markers here and decodes each scan and the planes
in the port's C++ (`csrc/image.cpp`, built by `ops/_cuda.py::host_library`
at first use; a failed build raises). `read_jpeg_plain` is the same
decoder in Python and numpy, the version the C++ is held to byte for byte:
entropy decoding is one Python loop over the symbols, each decoded by one
lookup in a 16-bit peek table that holds the code length, the run and the
value when code and value bits fit in 16 bits (a second table and a bit
read otherwise); dequantisation, the IDCT, upsampling and colour
conversion run vectorised over all blocks. The training path never calls
it.

`write_jpeg` writes baseline JPEGs (JFIF, one interleaved scan): the
Annex K quantisation and Huffman tables scaled by libjpeg's quality
rule, 4:2:0 or 4:4:4, a float DCT, and Huffman coding vectorised (code
words and bit lengths per coefficient, packed with numpy, 0xFF stuffed).
"""

from __future__ import annotations

import array
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
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded", 0xCA: "progressive arithmetic-coded",
    0xCB: "lossless arithmetic-coded", 0xCD: "differential arithmetic-coded",
    0xCE: "differential progressive arithmetic-coded",
    0xCF: "differential lossless arithmetic-coded"}

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


def _decode_tables(bits, vals, ac: bool):
    """-> (fast, slow): 65,536-entry peek tables as Python lists."""
    fast = np.zeros(1 << 16, np.int64)
    slow = np.zeros(1 << 16, np.int64)
    for code, length, sym in zip(*_canonical(bits, vals)):
        lo, hi = code << (16 - length), (code + 1) << (16 - length)
        slow[lo:hi] = sym << 5 | length
        run, s = (sym >> 4, sym & 15) if ac else (0, sym)
        if ac and s == 0:
            run = 15 if run == 15 else _EOB_RUN     # ZRL, else end of block
        if length + s > 16:
            continue
        peek = np.arange(lo, hi)
        value = _extend((peek >> (16 - length - s)) & ((1 << s) - 1), s)
        fast[lo:hi] = value * 4096 + (run << 5 | (length + s))
    return fast.tolist(), slow.tolist()


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
    def __init__(self, seg: bytes, path):
        precision, self.height, self.width, nf = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise ValueError(f"{path}: {precision}-bit JPEG; only 8-bit samples are read")
        if nf == 4:
            raise ValueError(f"{path}: 4-component (CMYK / YCCK) JPEG; only gray "
                             "and 3-component JPEGs are read")
        if nf not in (1, 3):
            raise ValueError(f"{path}: {nf}-component JPEG; only 1 or 3 are read")
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
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # coefficient blocks of each component over the MCU-padded grid, all
        # in one buffer: component c's (nby, nbx) blocks from block offset[c]
        self.grid = [(self.mcuy * v, self.mcux * h) for h, v in zip(self.h, self.v)]
        self.offset = np.cumsum([0] + [y * x for y, x in self.grid])
        self.blocks = np.zeros((int(self.offset[-1]), 64), np.int32)
        self.coef = [self.blocks[o:o + y * x].reshape(y, x, 64)
                     for o, (y, x) in zip(self.offset, self.grid)]
        self.q = [None] * nf

    def comp_size(self, c):
        """The component's sample rows and columns (`downsampled_*`)."""
        return (-(-self.height * self.v[c] // self.vmax),
                -(-self.width * self.h[c] // self.hmax))


class _Scan:
    """One SOS header against the frame: the scan's components, its blocks in
    decode order and the Huffman tables of each block of an MCU."""

    def __init__(self, frame: _Frame, seg: bytes, qt, dc, ac, path):
        ns = seg[0]
        comps, tabs = [], []
        for i in range(ns):
            cid, t = seg[1 + 2 * i:3 + 2 * i]
            if cid not in frame.ids:
                raise ValueError(f"{path}: scan names component {cid}, not in the frame")
            c = frame.ids.index(cid)
            if (t >> 4) not in dc or (t & 15) not in ac:
                raise ValueError(f"{path}: scan uses a Huffman table that is not defined")
            if frame.tq[c] not in qt:
                raise ValueError(f"{path}: quantisation table {frame.tq[c]} not defined")
            if frame.q[c] is None:          # latched at the component's first scan
                frame.q[c] = qt[frame.tq[c]]
            comps.append(c)
            tabs.append((t >> 4, t & 15))
        ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
        if (ss, se, ahl) != (0, 63, 0):
            raise ValueError(f"{path}: spectral selection {ss}-{se}, approximation "
                             f"{ahl:#x}: a progressive scan")

        # the blocks in decode order: (component, block row, block column)
        if ns == 1:
            c = comps[0]
            rows, cols = frame.comp_size(c)
            by, bx = np.meshgrid(np.arange(-(-rows // 8)), np.arange(-(-cols // 8)),
                                 indexing="ij")
            order = [(np.full(by.size, c), by.ravel(), bx.ravel())]
            self.comp, self.tables = [c], [tabs[0]]
            self.n_mcus = by.size
        else:
            my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux),
                                 indexing="ij")
            my, mx = my.ravel(), mx.ravel()
            order, self.comp, self.tables = [], [], []
            for c, t in zip(comps, tabs):
                for v in range(frame.v[c]):
                    for h in range(frame.h[c]):
                        order.append((np.full(my.size, c), my * frame.v[c] + v,
                                      mx * frame.h[c] + h))
                        self.comp.append(c)
                        self.tables.append(t)
            self.n_mcus = my.size
        self.comps = comps
        # (n_mcus, blocks per MCU) -> decode order
        self.bc, self.by, self.bx = (np.stack([o[i] for o in order], 1).ravel()
                                     for i in range(3))


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
    for c in set(scan.comps):
        sel = bc == c
        frame.coef[c][scan.by[sel], scan.bx[sel]] = blocks[sel]
    return used


def _scan_native(frame: _Frame, scan: _Scan, arr: np.ndarray, restart: int, dc, ac,
                 path):
    """`_scan_plain` in `csrc/image.cpp` (`gm_jpeg_scan`): the same
    coefficients, the same errors. -> bytes of entropy-coded data consumed."""
    keys = sorted({("dc", d) for d, _ in scan.tables} | {("ac", a) for _, a in scan.tables})
    defs = [(dc if kind == "dc" else ac)[i] for kind, i in keys]
    tables = np.zeros((len(keys), 17), np.int32)
    vals = np.zeros((len(keys), max(1, max(len(v) for _, v in defs))), np.uint8)
    for j, (bits, v) in enumerate(defs):
        tables[j, 0], tables[j, 1:1 + len(bits)] = len(v), bits   # a cut DHT: fewer counts
        vals[j, :len(v)] = np.frombuffer(v, np.uint8)
    comp = np.array(scan.comp, np.int32)
    dc_tab = np.array([keys.index(("dc", d)) for d, _ in scan.tables], np.int32)
    ac_tab = np.array([keys.index(("ac", a)) for _, a in scan.tables], np.int32)
    nbx = np.array([x for _, x in frame.grid], np.int64)
    dest = (frame.offset[scan.bc] + scan.by * nbx[scan.bc] + scan.bx).astype(np.int32)
    used, found = np.zeros(1, np.int64), np.zeros(1, np.int32)
    status = _cuda.host_library("image").gm_jpeg_scan(
        arr.ctypes.data, len(arr), scan.n_mcus, restart, len(scan.tables),
        comp.ctypes.data, dc_tab.ctypes.data, ac_tab.ctypes.data, tables.ctypes.data,
        vals.ctypes.data, vals.shape[1], len(keys), dest.ctypes.data,
        frame.blocks.ctypes.data, used.ctypes.data, found.ctypes.data)
    if status == 1:
        raise ValueError(f"{path}: entropy-coded data ends early (truncated JPEG)")
    if status == 2:
        raise ValueError("corrupt JPEG data: no Huffman code matches")
    if status == 3:
        n_int = -(-scan.n_mcus // (restart or scan.n_mcus))
        raise ValueError(f"{path}: {int(found[0])} restart intervals, {n_int} expected")
    if status == 4:
        raise ValueError(f"{path}: corrupt JPEG data: a DC magnitude category over 16")
    if status:
        raise RuntimeError(f"{path}: gm_jpeg_scan returned {status}")
    return int(used[0])


def _planes_plain(frame: _Frame, rgb: bool) -> np.ndarray:
    """The frame's coefficients -> the image, in numpy."""
    planes = []
    for c in range(len(frame.ids)):
        nby, nbx = frame.grid[c]
        pix = _idct(frame.coef[c].reshape(-1, 64), frame.q[c])
        pix = pix.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        rows, cols = frame.comp_size(c)
        p = _upsample(pix[:rows, :cols].astype(np.int32), frame.vmax // frame.v[c],
                      frame.hmax // frame.h[c])
        planes.append(p[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _planes_native(frame: _Frame, rgb: bool) -> np.ndarray:
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
    out = np.empty((frame.height, frame.width) + (() if n == 1 else (3,)), np.uint8)
    status = _cuda.host_library("image").gm_jpeg_planes(
        frame.blocks.ctypes.data, n, offset.ctypes.data, nby.ctypes.data,
        nbx.ctypes.data, rows.ctypes.data, cols.ctypes.data, ry.ctypes.data,
        rx.ctypes.data, q.ctypes.data, frame.height, frame.width,
        0 if n == 1 else 2 if rgb else 1, out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_jpeg_planes returned {status}")
    return out


def _decode(data: bytes, path, native: bool) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG")
    qt, dc, ac = {}, {}, {}
    frame, restart, jfif, adobe, scans = None, 0, False, None, 0
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
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                if len(vals) != 64:
                    raise ValueError(f"{path}: quantisation table {tq} is cut short")
                qt[tq] = vals.astype(np.int64)
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = tuple(seg[i + 1:i + 17])
                vals = seg[i + 17:i + 17 + sum(bits)]
                (ac if tc else dc)[th] = (bits, vals)
                i += 17 + sum(bits)
        elif marker in (0xC0, 0xC1):
            frame = _Frame(seg, path)
        elif marker in _SOF_KINDS:
            raise ValueError(f"{path}: {_SOF_KINDS[marker]} JPEG (SOF{marker - 0xC0}); "
                             "only baseline and extended sequential Huffman JPEGs "
                             "are read")
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG; only Huffman coding is read")
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
            pos += (_scan_native if native else _scan_plain)(
                frame, scan, np.frombuffer(data, np.uint8, offset=pos), restart, dc, ac,
                path)
            scans += 1
    if frame is None or not scans:
        raise ValueError(f"{path}: no frame or no scan")

    for c in range(len(frame.ids)):
        if frame.q[c] is None:
            raise ValueError(f"{path}: component {frame.ids[c]} has no scan")
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = tuple(frame.ids) == (82, 71, 66)
    return (_planes_native if native else _planes_plain)(frame, rgb)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline / extended sequential 8-bit JPEG -> uint8 (H, W) gray or
    (H, W, 3) RGB, the bits PIL 12 (libjpeg-turbo) decodes; decoded by
    `csrc/image.cpp`."""
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


def write_jpeg(path: str, img: np.ndarray, quality: int = 90,
               subsampling: str = "4:2:0") -> None:
    """(H, W) gray or (H, W, 3) RGB uint8 -> a baseline JFIF JPEG with the
    Annex K tables at libjpeg's `quality`; chroma subsampled 4:2:0, 4:2:2,
    4:4:0 or not at all (4:4:4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_jpeg takes uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3), not {img.shape}")
    if subsampling not in _SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}: one of {list(_SUBSAMPLING)}")
    h, w = img.shape[:2]
    qs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    if img.ndim == 2:
        planes, samp, qsel = [img.astype(np.float64)], [(1, 1)], [0]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        ycc = [0.299 * r + 0.587 * g + 0.114 * b,
               -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
               0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        planes = [np.clip(np.round(p), 0, 255) for p in ycc]
        sh, sv = _SUBSAMPLING[subsampling]
        samp, qsel = [(sh, sv), (1, 1), (1, 1)], [0, 1, 1]
        for i in (1, 2):                # means over (sv, sh) cells, edge padded
            p = np.pad(planes[i], ((0, -h % sv), (0, -w % sh)), mode="edge")
            planes[i] = np.floor(p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh)
                                 .mean((1, 3)) + 0.5)
    hmax, vmax = samp[0]
    mcuy, mcux = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    a = _fdct_matrix()
    comp_blocks = []
    for p, (sh, sv), qi in zip(planes, samp, qsel):
        blk = _blocks(p - 128.0, mcuy * 8 * sv, mcux * 8 * sh).reshape(-1, 8, 8)
        coef = (a @ blk @ a.T).reshape(mcuy * sv, mcux * sh, 64)
        q = np.round(coef / qs[qi]).astype(np.int64)[..., ZIGZAG]   # zigzag order
        comp_blocks.append(q.reshape(mcuy, sv, mcux, sh, 64).transpose(0, 2, 1, 3, 4)
                           .reshape(mcuy * mcux, sv * sh, 64))
    blocks = np.concatenate(comp_blocks, 1)             # (MCUs, blocks per MCU, 64)
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

    def magnitude(v):
        size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
        return size, np.where(v < 0, v + (1 << size) - 1, v)

    # symbols as (sort key, table, symbol, extra bits, their length); the key
    # orders them by block, then DC, ZRLs and AC by position, then EOB
    events = []

    def emit(key, table, sym, extra=0, elen=0):
        n = len(key)
        events.append([key, table, np.broadcast_to(sym, n),
                       np.broadcast_to(extra, n), np.broadcast_to(elen, n)])

    nb = len(blocks)
    size, extra = magnitude(dcv)
    emit(np.arange(nb) * 260, tsel, size, extra, size)
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    prev = np.concatenate([[0], k[:-1]])
    prev[np.flatnonzero(np.diff(b, prepend=-1))] = 0    # first in its block
    run = k - prev - 1
    size, extra = magnitude(blocks[b, k])
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
    val = code << elen | (ext & ((1 << elen) - 1))
    ln = clen + elen
    total = int(ln.sum())
    starts = np.cumsum(ln) - ln
    owner = np.repeat(np.arange(len(ln)), ln)
    j = np.arange(total) - starts[owner]
    bits = ((val[owner] >> (ln[owner] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    by = np.packbits(bits)
    ff = by == 0xFF
    stuffed = np.repeat(by, 1 + ff)
    stuffed[np.flatnonzero(ff) + np.arange(int(ff.sum())) + 1] = 0

    def segment(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    nc = len(samp)
    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i in range(1 if nc == 1 else 2):
        out.append(segment(0xDB, bytes([i]) + qs[i][ZIGZAG].astype(np.uint8).tobytes()))
    out.append(segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, sh << 4 | sv, qsel[i]]) for i, (sh, sv) in enumerate(samp))))
    for i, (dct, act) in enumerate(((_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA))
                                   [:1 if nc == 1 else 2]):
        out.append(segment(0xC4, bytes([i]) + bytes(dct[0]) + dct[1]
                           + bytes([0x10 | i]) + bytes(act[0]) + act[1]))
    out.append(segment(0xDA, bytes([nc]) + b"".join(
        bytes([i + 1, qsel[i] << 4 | qsel[i]]) for i in range(nc)) + b"\x00\x3f\x00"))
    out += [stuffed.tobytes(), b"\xff\xd9"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))
