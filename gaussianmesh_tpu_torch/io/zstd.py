"""Zstandard frames (RFC 8878), the codec of TIFF compression 50000 (the
JAX reader reaches libtiff's `ZSTDDecode`, and through it libzstd, by PIL;
the machines the port runs on have neither, and Python 3.12 has no
Zstandard module).

`decode(data, size)` reads the first frame of `data` as libtiff reads a
strip: libzstd 1.5.7's `ZSTD_decompressStream` into a `size`-byte buffer,
the whole strip as its input, called until the frame ends, the buffer is
full or the input runs out. So:

- a skippable frame gives no bytes; bytes after the frame are not read;
- a legacy frame (formats 0.6 and 0.7, which libzstd also reads) raises;
- the frame header's reserved bit, a window log over 31, and a
  dictionary ID (libtiff loads no dictionary) raise;
- where the header states a content size of at most `size` bytes and the
  whole frame is there, the frame is decoded in one pass: it must give
  exactly that many bytes, and its window is not checked;
- otherwise the window may be at most libzstd's default limit (2^27 bytes,
  plus 1), each block may give at most min(window, 128 KiB) bytes (and,
  where the content size fits libzstd's buffer, no more than it), and the
  decode stops once the output passes `size`: the rest of the frame, its
  checksum among it, is not read (a frame that fills the output exactly
  goes on to its next block and to its checksum);
- a frame that ends before the output is full raises ("cut short").

Blocks: raw, RLE and compressed; literals raw, RLE, Huffman-coded in 1 or 4
streams (weights direct or FSE-coded) or treeless; sequences with each of
the literal-length, offset and match-length tables predefined, RLE,
FSE-coded or repeated, the three repeat offsets, matches within the output;
the content checksum (XXH64, low 32 bits). Each check is libzstd's, at the
same point: a bit stream of sequences, or of Huffman-coded literals, must be
used up exactly, except the four streams that libzstd's fast decoder takes
(`_huffman_fast`).

`decode`, `encode` and `xxh64` run in the port's C++ (`gm_zstd_decode`,
`gm_zstd_encode`, `gm_xxh64` of `csrc/zstd.cpp`, built by
`ops/_cuda.py::host_library` at first use; a failed build raises).
`decode_plain` and `xxh64_plain` are the same walks in Python, which the
C++ is held to byte for byte and error for error; the training path never
calls them. `encode` (no plain twin: libzstd is its oracle in the tests)
writes one frame with its content size and, optionally, a checksum: raw
blocks where compressing does not pay, RLE blocks, or compressed blocks of
a greedy hash matcher with the repeat offsets, Huffman-coded or raw
literals and FSE-coded, predefined or RLE sequence tables.
"""

from __future__ import annotations

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

MAGIC = 0xFD2FB528
_SKIPPABLE, _SKIPPABLE_MASK = 0x184D2A50, 0xFFFFFFF0
_LEGACY = (0xFD2FB526, 0xFD2FB527)     # formats 0.6 and 0.7, which libzstd 1.5.7 reads
WINDOW_LIMIT = (1 << 27) + 1           # libzstd's ZSTD_WINDOWLOG_LIMIT_DEFAULT, plus 1
BLOCK_MAX = 1 << 17
_WILDCOPY = 32                         # libzstd's WILDCOPY_OVERLENGTH (its buffer's size)
_M64 = (1 << 64) - 1

# status -> message; csrc/zstd.cpp returns the same codes, with info[1:3]
_ERRORS = {
    1: "Zstandard frame cut short",
    2: "not a Zstandard frame (first bytes {0:08x})",
    3: "Zstandard frame header's reserved bit is set",
    4: "Zstandard window log {0} over 31",
    5: "Zstandard window of {0} bytes over libzstd's default limit of 2^27 + 1",
    6: "Zstandard frame names dictionary {0}; no dictionary is loaded",
    7: "reserved Zstandard block type",
    8: "Zstandard block of {0} bytes past its maximum of {1}",
    9: "Zstandard block decodes to more than the {0} bytes it may give",
    10: "Zstandard literals section corrupt",
    11: "Zstandard literals of {0} bytes past the block's limit of {1}",
    12: "Zstandard treeless literals with no Huffman table before them",
    13: "Zstandard Huffman weights leave no power of two",
    14: "Zstandard FSE table of accuracy log {0} over {1}",
    15: "Zstandard FSE table's counts do not sum to its size",
    16: "Zstandard bit stream not used up exactly",
    17: "Zstandard sequences section corrupt",
    18: "Zstandard sequence table repeated with no table before it",
    19: "Zstandard sequence takes more literals than the block has",
    20: "Zstandard match offset {0} before the start of the output ({1} bytes)",
    21: "Zstandard frame decodes to {0} bytes; its header says {1}",
    22: "Zstandard content checksum {0:08x}; the data's is {1:08x}",
    23: "legacy Zstandard frame (format 0.{0}), which libzstd reads and the port does not",
}
_CUT, _OUTPUT = 1, 9


class ZstdError(ValueError):
    """A frame `decode` refuses (`code` is the status of `_ERRORS`)."""

    def __init__(self, code: int, a: int = 0, b: int = 0):
        super().__init__(_ERRORS[code].format(a, b))
        self.code = code


def decode(data: bytes, size: int) -> np.ndarray:
    """The first Zstandard frame of `data` -> at most `size` bytes, uint8, as
    libtiff's `ZSTDDecode` gives them (see the module docstring)."""
    src = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(max(size, 1), np.uint8)
    info = np.zeros(3, np.int64)
    status = _cuda.host_library("zstd").gm_zstd_decode(
        src.ctypes.data, len(src), out.ctypes.data, size, info.ctypes.data)
    if status in _ERRORS:
        a = int(info[1])
        raise ZstdError(status, a & _M64 if status == 20 else a, int(info[2]))
    if status:
        raise RuntimeError(f"gm_zstd_decode returned {status}")
    return out[:int(info[0])]


def encode(data, checksum: bool = False) -> bytes:
    """Bytes (or a uint8 array) -> one Zstandard frame with its content size
    and, with `checksum`, its content checksum (see the module docstring)."""
    src = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8)
                               if isinstance(data, (bytes, bytearray, memoryview)) else
                               np.asarray(data, np.uint8).ravel())
    cap = src.size + 3 * (src.size // BLOCK_MAX + 1) + 32
    out = np.empty(cap, np.uint8)
    n_out = np.zeros(1, np.int64)
    status = _cuda.host_library("zstd").gm_zstd_encode(
        src.ctypes.data, src.size, int(checksum), out.ctypes.data, cap, n_out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_zstd_encode returned {status}")
    return out[:int(n_out[0])].tobytes()


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of `data` (`gm_xxh64`)."""
    src = np.frombuffer(bytes(data), np.uint8)
    out = np.zeros(1, np.uint64)
    _cuda.host_library("zstd").gm_xxh64(src.ctypes.data, len(src), seed, out.ctypes.data)
    return int(out[0])


# ------------------------------------------------------------------ tables
# literal-length and match-length codes -> (baseline, extra bits), RFC 8878 3.1.1.3.2.1
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13),
    (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# predefined distributions (accuracy 6, 6, 5)
LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
              2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1,
              -1, -1]
OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
              -1, -1, -1, -1]
# (the table's largest symbol, its largest accuracy log) of LL, OF, ML and Huffman weights
LL_MAX, OF_MAX, ML_MAX, WEIGHT_MAX = (35, 9), (31, 8), (52, 9), (255, 6)
HUF_LOG_MAX = 12                       # libzstd's HUF_TABLELOG_MAX


def fse_table(norm, log):
    """Normalized counts (-1: "less than 1") at accuracy `log` -> the
    decoding table, [(symbol, bits, next state baseline)] of 2^log states
    (RFC 8878 4.1.1)."""
    size = 1 << log
    sym = [0] * size
    nxt = list(norm)
    high = size - 1
    for s, p in enumerate(norm):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    pos, step = 0, (size >> 1) + (size >> 3) + 3
    for s, p in enumerate(norm):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    table = []
    for u in range(size):
        s = sym[u]
        state = nxt[s]
        nxt[s] += 1
        bits = log - (state.bit_length() - 1)
        table.append((s, bits, (state << bits) - size))
    return table


_PREDEFINED = (fse_table(LL_DEFAULT, 6), fse_table(OF_DEFAULT, 5), fse_table(ML_DEFAULT, 6))


# ------------------------------------------------------------------ bits
class _Back:
    """A bit stream read backward from its last byte's highest set bit (the
    marker), as libzstd's BIT_DStream reads it: `left` bits remain. Past the
    start a read gives 0 (the stream must then raise: it is not used up
    exactly) and a lookup the bits libzstd's 64-bit container gives."""

    def __init__(self, data: bytes, left: int | None = None):
        if left is None:
            if not data or data[-1] == 0:
                raise ZstdError(16)
            left = 8 * len(data) - 9 + data[-1].bit_length()
        self.data = data
        self.left = left
        self.first = int.from_bytes(data[:8], "little")

    def read(self, n: int) -> int:
        left = self.left
        self.left -= n
        if left < n or n == 0:
            return 0
        lo = left - n
        return int.from_bytes(self.data[lo >> 3:(left + 7) >> 3], "little") >> (lo & 7) & (
            (1 << n) - 1)

    def peek(self, n: int) -> int:
        """The next n bits, zeros past the start (a Huffman lookup)."""
        left = self.left
        if left >= n:
            lo = left - n
            return int.from_bytes(self.data[lo >> 3:(left + 7) >> 3], "little") >> (
                lo & 7) & ((1 << n) - 1)
        if left <= 0:                   # BIT_lookBitsFast's shifts, taken mod 64
            return ((self.first << (-left & 63)) & _M64) >> (64 - n)
        return (self.first & ((1 << left) - 1)) << (n - left)


def _ncount(data: bytes, pos: int, end: int, max_symbol: int, max_log: int):
    """An FSE table description at data[pos:end] (RFC 8878 4.1.1) -> (its
    decoding table, the position after it), as libzstd's FSE_readNCount:
    fields read LSB first, zeros past `end`."""
    bit = 4
    log = (data[pos] & 15 if pos < end else 0) + 5
    if log > max_log:
        raise ZstdError(14, log, max_log)

    def field(width):
        nonlocal bit
        at = pos * 8 + bit
        v = int.from_bytes(data[at >> 3:min(end, (at + width + 7) >> 3)], "little")
        return v >> (at & 7) & ((1 << width) - 1)

    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    norm = []
    previous0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if previous0:
            while True:
                rep = field(2)
                bit += 2
                norm += [0] * rep
                if rep != 3:
                    break
            if len(norm) > max_symbol:
                break
        v = field(nbits)
        top = 2 * threshold - 1 - remaining
        if v & (threshold - 1) < top:
            count = v & (threshold - 1)
            bit += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            bit += nbits
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        previous0 = count == 0
        while remaining < threshold and remaining > 1:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ZstdError(15)
    after = pos + ((bit + 7) >> 3)
    if after > end:
        raise ZstdError(15)
    return fse_table(norm, log), after


# ------------------------------------------------------------------ literals
def _huffman_table(data: bytes, pos: int, end: int):
    """A Huffman tree description at data[pos:end] -> ((code -> (symbol,
    bits)) of 2^log entries, log), the position after it."""
    if pos >= end:
        raise ZstdError(10)
    head = data[pos]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            raise ZstdError(10)
        weights = []
        for b in data[pos + 1:pos + 1 + size]:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
    else:
        size = head
        if pos + 1 + size > end:
            raise ZstdError(10)
        weights = _fse_weights(data[pos + 1:pos + 1 + size])
    after = pos + 1 + size
    if any(w > HUF_LOG_MAX for w in weights):
        raise ZstdError(13)
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        raise ZstdError(13)
    log = total.bit_length()
    if log > HUF_LOG_MAX:
        raise ZstdError(13)
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise ZstdError(13)
    weights.append(rest.bit_length())
    if weights.count(1) < 2 or weights.count(1) & 1:
        raise ZstdError(13)
    table = [None] * (1 << log)
    at = 0
    for w in range(1, log + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                span = 1 << (w - 1)
                table[at:at + span] = [(s, log + 1 - w)] * span
                at += span
    return (table, log), after


def _fse_weights(data: bytes) -> list:
    """FSE-coded Huffman weights: two interleaved states over one backward
    stream until a state update reads past its start (libzstd's
    FSE_decompress_usingDTable), 255 weights at most."""
    table, pos = _ncount(data, 0, len(data), *WEIGHT_MAX)
    bits = _Back(data[pos:])
    log = len(table).bit_length() - 1
    state = [bits.read(log), bits.read(log)]
    if bits.left < 0:
        raise ZstdError(16)
    out = []
    while True:
        for a in (0, 1):
            if len(out) > 253:
                raise ZstdError(13)
            sym, nb, base = table[state[a]]
            out.append(sym)
            state[a] = base + bits.read(nb)
            if bits.left < 0:
                out.append(table[state[1 - a]][0])
                return out


def _huffman_stream(data: bytes, table, log: int, n: int, out: bytearray) -> None:
    """n symbols of one stream, which they must use up exactly."""
    bits = _Back(data)
    for _ in range(n):
        sym, nb = table[bits.peek(log)]
        out.append(sym)
        bits.left -= nb
    if bits.left != 0:
        raise ZstdError(16)


def _huffman_fast(data: bytes, ends, table, log: int, size: int, out: bytearray) -> None:
    """Four streams as libzstd's fast 4-stream decoder reads them (taken
    where the table's log is at most 11 and each stream holds 8 bytes or
    more): stream i from data[:ends[i]] backward, past its start into the
    bytes before it, a last byte of 0 read whole; its bits need not be used
    up. The streams advance 5 symbols at a time together until stream 3
    has fewer than 5 left, stream 0 is within 7 bytes of the section's
    start or a stream's position passes the one before it; a stream then
    more than 8 bytes past its start raises."""
    seg = (size + 3) // 4
    counts = (seg, seg, seg, size - 3 * seg)
    used = []                           # per stream, its bits used after each 5 symbols
    for i in range(4):
        last = data[ends[i] - 1]
        bits = _Back(data[:ends[i]], 8 * ends[i] - (9 - last.bit_length() if last else 0))
        start = bits.left
        marks = [8 * ends[i] - start]
        for j in range(counts[i]):
            sym, nb = table[bits.peek(log)]
            out.append(sym)
            bits.left -= nb
            if j % 5 == 4:
                marks.append(8 * ends[i] - bits.left)
        used.append(marks)
    k = 0
    while True:
        ip = [ends[i] - 8 - (used[i][k] >> 3) for i in range(4)]
        iters = min((counts[3] - 5 * k) // 5, ip[0] // 7)
        if iters == 0 or any(ip[i] < ip[i - 1] for i in (1, 2, 3)):
            break
        k += iters
    starts = (6,) + tuple(ends[:3])
    if any(used[i][k] >> 3 > ends[i] - starts[i] for i in range(4)):
        raise ZstdError(16)


def _literals(block: bytes, st, lit_limit: int):
    """The literals section at the start of `block` -> (the literals, the
    position after the section)."""
    n = len(block)
    if n < 2:
        raise ZstdError(10)
    kind, fmt = block[0] & 3, block[0] >> 2 & 3
    if kind < 2:                                    # raw, RLE
        if fmt in (0, 2):
            head, size = 1, block[0] >> 3
        elif fmt == 1:
            if kind == 1 and n < 3:
                raise ZstdError(10)
            head, size = 2, int.from_bytes(block[:2], "little") >> 4
        else:
            if n < 3 + kind:
                raise ZstdError(10)
            head, size = 3, int.from_bytes(block[:3], "little") >> 4
        if size > lit_limit:
            raise ZstdError(11, size, lit_limit)
        if kind == 1:
            return bytes([block[head]]) * size, head + 1
        if head + size > n:
            raise ZstdError(10)
        return block[head:head + size], head + size
    if kind == 3 and st["huffman"] is None:         # treeless
        raise ZstdError(12)
    if n < 5:
        raise ZstdError(10)
    h = int.from_bytes(block[:5], "little")
    if fmt < 2:
        head, size, csize = 3, h >> 4 & 0x3FF, h >> 14 & 0x3FF
    elif fmt == 2:
        head, size, csize = 4, h >> 4 & 0x3FFF, h >> 18 & 0x3FFF
    else:
        head, size, csize = 5, h >> 4 & 0x3FFFF, h >> 22 & 0x3FFFF
    if size > lit_limit:
        raise ZstdError(11, size, lit_limit)
    streams = 1 if fmt == 0 else 4
    if streams == 4 and size < 6:
        raise ZstdError(10)
    end = head + csize
    if end > n:
        raise ZstdError(10)
    pos = head
    if kind == 2:
        if csize == 0:
            raise ZstdError(10)
        st["huffman"], pos = _huffman_table(block, pos, end)
        if pos >= end:
            raise ZstdError(10)
    table, log = st["huffman"]
    out = bytearray()
    if streams == 1:
        _huffman_stream(block[pos:end], table, log, size, out)
    else:
        if end - pos < 10:
            raise ZstdError(10)
        l1, l2, l3 = (int.from_bytes(block[pos + 2 * i:pos + 2 * i + 2], "little")
                      for i in range(3))
        if l1 + l2 + l3 > end - pos - 6:
            raise ZstdError(10)
        seg = (size + 3) // 4
        lengths = (l1, l2, l3, end - pos - 6 - l1 - l2 - l3)
        ends = np.cumsum((6,) + lengths)[1:].tolist()
        if log <= 11 and min(lengths) >= 8 and 3 * seg < size:
            _huffman_fast(block[pos:end], ends, table, log, size, out)
        else:
            for i, ln in enumerate(lengths):
                _huffman_stream(block[pos + ends[i] - ln:pos + ends[i]], table, log,
                                seg if i < 3 else size - 3 * seg, out)
    return bytes(out), end


# ------------------------------------------------------------------ sequences
def _seq_table(block: bytes, pos: int, end: int, mode: int, which: int, st):
    """Table `which` (0 LL, 1 OF, 2 ML) in `mode` -> (table, position after)."""
    max_symbol, max_log = (LL_MAX, OF_MAX, ML_MAX)[which]
    if mode == 0:
        table = _PREDEFINED[which]
    elif mode == 1:
        if pos >= end:
            raise ZstdError(17)
        if block[pos] > max_symbol:
            raise ZstdError(17)
        table, pos = [(block[pos], 0, 0)], pos + 1
    elif mode == 2:
        table, pos = _ncount(block, pos, end, max_symbol, max_log)
    else:
        if not st["fse_entropy"]:
            raise ZstdError(18)
        table = st["tables"][which]
    st["tables"][which] = table
    return table, pos


def _block(block: bytes, out: bytearray, st, cap: int, bsm: int) -> None:
    """A compressed block appended to `out`, at most `cap` bytes."""
    lits, pos = _literals(block, st, min(bsm, cap))
    n = len(block)
    if pos >= n:
        raise ZstdError(17)
    nseq = block[pos]
    pos += 1
    if nseq > 127:
        if nseq == 255:
            if pos + 2 > n:
                raise ZstdError(17)
            nseq = int.from_bytes(block[pos:pos + 2], "little") + 0x7F00
            pos += 2
        else:
            if pos >= n:
                raise ZstdError(17)
            nseq = ((nseq - 128) << 8) + block[pos]
            pos += 1
    start = len(out)
    if nseq == 0:
        if pos != n:
            raise ZstdError(17)
        if len(lits) > cap:
            raise ZstdError(_OUTPUT, cap)
        out += lits
        return
    if pos >= n or block[pos] & 3:
        raise ZstdError(17)
    modes = block[pos]
    pos += 1
    ll, pos = _seq_table(block, pos, n, modes >> 6, 0, st)
    of, pos = _seq_table(block, pos, n, modes >> 4 & 3, 1, st)
    ml, pos = _seq_table(block, pos, n, modes >> 2 & 3, 2, st)
    st["fse_entropy"] = True
    bits = _Back(block[pos:])
    s_ll = bits.read(len(ll).bit_length() - 1)
    s_of = bits.read(len(of).bit_length() - 1)
    s_ml = bits.read(len(ml).bit_length() - 1)
    rep = st["rep"]
    lit = 0
    for i in range(nseq):
        ll_code, ll_nb, ll_next = ll[s_ll]
        of_code, of_nb, of_next = of[s_of]
        ml_code, ml_nb, ml_next = ml[s_ml]
        ll_base, ll_bits = LL_CODES[ll_code]
        ml_base, ml_bits = ML_CODES[ml_code]
        ll0 = ll_base == 0
        if of_code > 1:
            offset = (1 << of_code) - 3 + bits.read(of_code)
            rep[:] = [offset, rep[0], rep[1]]
        elif of_code == 0:
            offset = rep[1] if ll0 else rep[0]
            if ll0:
                rep[:2] = [offset, rep[0]]
        else:
            idx = 1 + ll0 + bits.read(1)
            offset = rep[0] - 1 if idx == 3 else rep[idx]
            if offset == 0:
                offset = _M64
            if idx != 1:
                rep[2] = rep[1]
            rep[:2] = [offset, rep[0]]
        mlen = ml_base + bits.read(ml_bits) if ml_bits else ml_base
        llen = ll_base + bits.read(ll_bits) if ll_bits else ll_base
        if i != nseq - 1:
            s_ll = ll_next + bits.read(ll_nb)
            s_ml = ml_next + bits.read(ml_nb)
            s_of = of_next + bits.read(of_nb)
        # execute
        if llen > len(lits) - lit:
            raise ZstdError(19)
        if len(out) - start + llen + mlen > cap:
            raise ZstdError(_OUTPUT, cap)
        out += lits[lit:lit + llen]
        lit += llen
        if offset > len(out):
            raise ZstdError(20, offset & _M64, len(out))
        src = len(out) - offset
        if offset >= mlen:
            out += out[src:src + mlen]
        else:
            chunk = out[src:]
            out += (chunk * (mlen // offset + 1))[:mlen]
    if bits.left != 0:
        raise ZstdError(16)
    if len(out) - start + len(lits) - lit > cap:
        raise ZstdError(_OUTPUT, cap)
    out += lits[lit:]


# ------------------------------------------------------------------ frame
def _header(data: bytes):
    """-> None for a skippable frame, else (header size, window, FCS or
    None, checksum flag); raises on the header's faults and where it is cut
    short."""
    n = len(data)
    if n < 5:
        magic = int.from_bytes(data[:4] + MAGIC.to_bytes(4, "little")[n:], "little")
        skip = int.from_bytes(data[:4] + _SKIPPABLE.to_bytes(4, "little")[n:], "little")
        if magic != MAGIC and skip & _SKIPPABLE_MASK != _SKIPPABLE:
            raise ZstdError(2, int.from_bytes(data[:4].ljust(4, b"\0"), "big"))
        raise ZstdError(_CUT)
    magic = int.from_bytes(data[:4], "little")
    if magic & _SKIPPABLE_MASK == _SKIPPABLE:
        if n < 8 or 8 + int.from_bytes(data[4:8], "little") > n:
            raise ZstdError(_CUT)
        return None
    if magic in _LEGACY:
        raise ZstdError(23, magic & 15)
    if magic != MAGIC:
        raise ZstdError(2, int.from_bytes(data[:4], "big"))
    fhd = data[4]
    single = fhd >> 5 & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single, 2, 4, 8)[fhd >> 6]
    size = 5 + (1 - single) + did_size + fcs_size
    if n < size:
        raise ZstdError(_CUT)
    if fhd & 8:
        raise ZstdError(3)
    pos = 5
    window = 0
    if not single:
        log = (data[5] >> 3) + 10
        if log > 31:
            raise ZstdError(4, log)
        window = (1 << log) + ((1 << log) >> 3) * (data[5] & 7)
        pos = 6
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    fcs = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    if single:
        window = fcs
    if did:
        raise ZstdError(6, did)
    return size, window, fcs if fcs_size else None, fhd >> 2 & 1


def _frame_size(data: bytes, head: int, checksum: int):
    """libzstd's walk over the block headers -> whether the whole frame is
    there (no reserved block type, every block and the checksum in `data`)."""
    pos, n = head, len(data)
    while True:
        if pos + 3 > n:
            return False
        h = int.from_bytes(data[pos:pos + 3], "little")
        if h >> 1 & 3 == 3:
            return False
        pos += 3 + (1 if h >> 1 & 3 == 1 else h >> 3)
        if pos > n:
            return False
        if h & 1:
            return pos + 4 * checksum <= n


def decode_plain(data: bytes, size: int) -> np.ndarray:
    """`decode` as a Python walk (the plain version)."""
    data = bytes(data)
    head = _header(data)
    if head is None:
        return np.zeros(0, np.uint8)
    hsize, window, fcs, checksum = head
    bsm = min(window, BLOCK_MAX)
    one_pass = fcs is not None and fcs <= size and _frame_size(data, hsize, checksum)
    if not one_pass and max(window, 1024) > WINDOW_LIMIT:
        raise ZstdError(5, max(window, 1024))
    ring = max(window, 1024) + 2 * bsm + 2 * _WILDCOPY
    fcs_limited = fcs is not None and fcs <= ring
    st = {"huffman": None, "tables": [None] * 3, "fse_entropy": False, "rep": [1, 4, 8]}
    out = bytearray()
    pos, n = hsize, len(data)

    def more():                        # libzstd waits for input that never comes
        if len(out) < size:
            raise ZstdError(_CUT)
        return np.frombuffer(bytes(out[:size]), np.uint8)

    while True:
        if pos + 3 > n:
            return more()
        h = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, bsize = h & 1, h >> 1 & 3, h >> 3
        if kind == 3:
            raise ZstdError(7)
        csize = 1 if kind == 1 else bsize
        pos += 3
        if one_pass:
            cap = size - len(out)
        else:
            if csize > bsm:
                raise ZstdError(8, csize, bsm)
            cap = min(bsm, fcs - len(out)) if fcs_limited else bsm
            if csize == 0:                         # libzstd skips an empty block
                if last:
                    break
                continue
        if kind == 0:
            piece = csize if one_pass else min(csize, n - pos)
            if not one_pass and piece == 0:
                return more()
            if piece > cap:
                raise ZstdError(_OUTPUT, cap)
            out += data[pos:pos + piece]
            pos += piece
            if piece < csize:
                return more()
        else:
            if pos + csize > n:
                return more()
            if kind == 1:
                if bsize > cap:
                    raise ZstdError(_OUTPUT, cap)
                out += data[pos:pos + 1] * bsize
            else:
                if csize > bsm:
                    raise ZstdError(8, csize, bsm)
                _block(data[pos:pos + csize], out, st, cap, bsm)
            pos += csize
        if last and fcs is not None and len(out) != fcs:
            raise ZstdError(21, len(out), fcs)
        if not one_pass and len(out) > size:
            return np.frombuffer(bytes(out[:size]), np.uint8)
        if last:
            break
    if checksum:
        if pos + 4 > n:
            return more()
        want, got = int.from_bytes(data[pos:pos + 4], "little"), xxh64_plain(out) & 0xFFFFFFFF
        if want != got:
            raise ZstdError(22, want, got)
    return np.frombuffer(bytes(out), np.uint8)


# ------------------------------------------------------------------ XXH64
_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                           0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64_plain(data, seed: int = 0) -> int:
    """XXH64 of `data` (the plain version of `xxh64`)."""
    data = bytes(data)
    n = len(data)
    pos = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data[:n // 32 * 32], "<u8").reshape(-1, 4).tolist()
        for stripe in lanes:
            v = [_round(a, b) for a, b in zip(v, stripe)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for a in v:
            h = ((h ^ _round(0, a)) * _P1 + _P4) & _M64
        pos = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= int.from_bytes(data[pos:pos + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    for b in data[pos:]:
        h ^= b * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)
