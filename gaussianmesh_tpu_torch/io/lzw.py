"""LZW as TIFF (compression 5) and GIF code it, one engine with two
parameters (the JAX reader reaches libtiff's and PIL's C through PIL; the
machines the port runs on have neither):

- TIFF: codes read MSB first from 9 bits, Clear 256, EOI 257, and the code
  width grows one code early (once the next free entry is 2^width - 1);
- GIF: codes read LSB first from min_bits + 1 bits (a minimum code size of
  2-8), Clear 1 << min_bits, EOI the code after it, no early change.

Both: codes up to 12 bits, a table of 4,096 entries that, once full, takes no
more until a Clear (GIF's deferred clear); a code equal to the next free
entry is the last string and its own first byte (KwKwK). A code past the
next free entry, or a string that would run past the strip's or frame's
size, raises; the decode stops at EOI, where the data runs out, or with the
output full, and the caller judges output that stops short.

`lzw_decode` / `lzw_encode` run in the port's C++ (`gm_lzw_decode` /
`gm_lzw_encode` of `csrc/image.cpp`, built by `ops/_cuda.py::host_library` at
first use; a failed build raises). `lzw_decode_plain` / `lzw_encode_plain`
are the same walks in Python, the versions the C++ is held to byte for
byte; the training path never calls them.
"""

from __future__ import annotations

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

MAX_BITS = 12
TABLE = 1 << MAX_BITS
# where the encoders emit a Clear: libtiff's choice, below the full table
CLEAR_AT = TABLE - 2
_PAST_TABLE, _OVERFLOW = 7, 8          # csrc/image.cpp's kPastTable, kOverflow


def _params(variant: str, min_bits: int):
    """-> (msb_first, early) of "tiff" (min_bits 8) or "gif" (2-8)."""
    if variant == "tiff":
        if min_bits != 8:
            raise ValueError(f"TIFF LZW has 8-bit literals, not {min_bits}")
        return True, 1
    if variant == "gif":
        if not 2 <= min_bits <= 8:
            raise ValueError(f"LZW minimum code size {min_bits}; GIF allows 2-8")
        return False, 0
    raise ValueError(f"LZW variant {variant!r}: 'tiff' or 'gif'")


def _past_table(code: int, nxt: int) -> ValueError:
    return ValueError(f"LZW code {code} past the table's next free entry {nxt}")


def _overflow(out_size: int) -> ValueError:
    return ValueError(f"LZW data decodes past the {out_size} bytes it should fill")


def lzw_decode(data: bytes, out_size: int, variant: str = "tiff",
               min_bits: int = 8) -> np.ndarray:
    """LZW `data` -> at most `out_size` bytes, uint8 (fewer where EOI or the
    data's end comes first)."""
    msb, early = _params(variant, min_bits)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(out_size, np.uint8)
    info = np.zeros(3, np.int64)
    status = _cuda.host_library("image").gm_lzw_decode(
        src.ctypes.data, len(src), int(msb), min_bits, early, out.ctypes.data, out_size,
        info.ctypes.data)
    if status == _PAST_TABLE:
        raise _past_table(int(info[1]), int(info[2]))
    if status == _OVERFLOW:
        raise _overflow(out_size)
    if status:
        raise RuntimeError(f"gm_lzw_decode returned {status}")
    return out[:int(info[0])]


def lzw_decode_plain(data: bytes, out_size: int, variant: str = "tiff",
                     min_bits: int = 8) -> np.ndarray:
    """`lzw_decode` as a Python loop over the codes (the plain version)."""
    msb, early = _params(variant, min_bits)
    clear, eoi = 1 << min_bits, (1 << min_bits) + 1
    literals = [bytes([i]) for i in range(clear)]
    table = literals + [b"", b""]
    width, nxt, prev = min_bits + 1, clear + 2, None
    acc = nacc = pos = 0
    n = len(data)
    out = bytearray()
    while len(out) < out_size:
        while nacc < width:
            if pos == n:
                return np.frombuffer(bytes(out), np.uint8)
            acc = (acc << 8 | data[pos]) if msb else acc | data[pos] << nacc
            pos += 1
            nacc += 8
        if msb:
            nacc -= width
            code = acc >> nacc
            acc &= (1 << nacc) - 1
        else:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nacc -= width
        if code == clear:
            table = literals + [b"", b""]
            width, nxt, prev = min_bits + 1, clear + 2, None
            continue
        if code == eoi:
            break
        if code < nxt:
            s = table[code]
        elif code == nxt and prev is not None:
            s = prev + prev[:1]
        else:
            raise _past_table(code, nxt)
        if len(s) > out_size - len(out):
            raise _overflow(out_size)
        out += s
        if prev is not None and nxt < TABLE:
            table.append(prev + s[:1])
            nxt += 1
        prev = s
        if nxt + early >= 1 << width and width < MAX_BITS:
            width += 1
    return np.frombuffer(bytes(out), np.uint8)


def _check_encode(data, variant, min_bits, clear_at):
    params = _params(variant, min_bits)
    src = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8)
                               if isinstance(data, (bytes, bytearray)) else
                               np.asarray(data, np.uint8).ravel())
    if src.size and int(src.max()) >> min_bits:
        raise ValueError(f"LZW input byte {int(src.max())} past {min_bits}-bit literals")
    if clear_at <= (1 << min_bits) + 2:
        raise ValueError(f"clear_at {clear_at} leaves no room for a table entry")
    return params, src


def lzw_encode(data, variant: str = "tiff", min_bits: int = 8,
               clear_at: int = CLEAR_AT) -> bytes:
    """Bytes (or a uint8 array) -> LZW: Clear, greedy matches, a Clear each
    time the next free entry reaches `clear_at` (`TABLE`: never; the table
    is held full), EOI."""
    (msb, early), src = _check_encode(data, variant, min_bits, clear_at)
    cap = 2 * src.size + 64          # 12-bit codes of one byte each, and Clears
    out = np.empty(cap, np.uint8)
    n_out = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_lzw_encode(
        src.ctypes.data, src.size, int(msb), min_bits, early, clear_at, out.ctypes.data,
        cap, n_out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_lzw_encode returned {status}")
    return out[:int(n_out[0])].tobytes()


def lzw_encode_plain(data, variant: str = "tiff", min_bits: int = 8,
                     clear_at: int = CLEAR_AT) -> bytes:
    """`lzw_encode` in Python with a dict for the table (the plain version:
    the tests' sizes)."""
    (msb, early), src = _check_encode(data, variant, min_bits, clear_at)
    clear = 1 << min_bits
    out = bytearray()
    acc = nacc = 0
    nxt = clear + 2

    def put(code):
        nonlocal acc, nacc
        w = min_bits + 1
        while w < MAX_BITS and nxt - 1 + early >= 1 << w:
            w += 1
        if msb:
            acc = acc << w | code
            nacc += w
            while nacc >= 8:
                nacc -= 8
                out.append(acc >> nacc & 0xFF)
            acc &= (1 << nacc) - 1
        else:
            acc |= code << nacc
            nacc += w
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8

    put(clear)
    if src.size:
        codes = {}
        pre = int(src[0])
        for b in src[1:].tolist():
            key = pre << 8 | b
            if key in codes:
                pre = codes[key]
                continue
            put(pre)
            if nxt < TABLE:
                codes[key] = nxt
                nxt += 1
            if nxt == clear_at < TABLE:
                put(clear)
                codes = {}
                nxt = clear + 2
            pre = b
        put(pre)
        if nxt < TABLE:
            nxt += 1
    put(clear + 1)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if msb else acc)
    return bytes(out)
