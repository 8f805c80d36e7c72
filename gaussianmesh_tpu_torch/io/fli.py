"""Autodesk FLI / FLC animations' first frame in numpy and the port's C++,
to the arrays PIL 12 gives (the JAX reader opens dataset images with PIL;
the machines the port runs on have none).

`read_fli` reads what PIL's `FliImagePlugin` opens: a 128-byte header
(magic 0xAF11 for FLI, 0xAF12 for FLC at byte 4, flags 0 or 3 at byte 14,
bytes 20-21, 42-79 and 88-127 zero), the frame count at byte 6 and the
size at bytes 8 and 10, little-endian. `_open` looks for the palette in
the first frame (after a prefix chunk 0xF100 where one comes first): the
first COLOR_256 (chunk 4) or COLOR_64 (chunk 11) sub-chunk, whose packets
(a skip and a count, 0 meaning 256) set entries of a gray ramp; chunk 11's
6-bit levels are shifted left by 2 (63 -> 252), as PIL shifts them.

The first frame is decoded as PIL's `fli` decoder decodes it, from byte
128 (the frame after a prefix chunk is not found: PIL cannot load such a
file, "unrecognized data stream contents", and neither does `read_fli`),
on a zeroed plane: BRUN (15) and COPY (16) fill it, BLACK (13) clears it,
LC (12) and SS2 (7) are applied to it; palettes (4, 11) and the stamp (18)
are skipped. Each chunk's reads are bounded by the bytes left in the frame
(a frame whose last chunk holds fewer than 10 bytes is a "buffer overrun",
as in PIL), not by the chunk's own size. `gm_fli_frame` of
`csrc/image.cpp` walks the chunks; `_frame_plain` here is the same walk in
Python, held to it byte for byte. The frame is read in blocks of its
size, as PIL's `ImageFile.load` reads it (`_load`).

PIL opens the image as mode P, whose `np.asarray` is the indices (fault
B15): `read_fli` expands them as `convert("RGB")` does. A header PIL's
`_open` refuses, and a file its palette search or first frame size runs
off, give way (`io/giveway.py`); a frame PIL cannot decode raises with its
cause.

`encode_fli` / `write_fli` write one frame of each chunk kind with a
256- or 64-level palette, for the tests and `chip_smoke.py`; the training
path does not write FLI.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.ops import _cuda

FLI_MAGICS = (0xAF11, 0xAF12)
_HEADER = 128
_FRAME = 0xF1FA
_PREFIX = 0xF100
# gm_fli_frame's statuses (csrc/image.cpp) and the PIL causes they stand for
_END, _NEED_MORE, _CONSUMED, _OVERRUN, _UNKNOWN, _BROKEN = 0, 1, 2, 3, 4, 5
_CAUSES = {_OVERRUN: "buffer overrun", _UNKNOWN: "unrecognized data stream contents",
           _BROKEN: "broken data stream"}
CHUNKS = {"ss2": 7, "lc": 12, "black": 13, "brun": 15, "copy": 16}


def fli_accept(head: bytes) -> bool:
    """PIL's `FliImagePlugin._accept`: the magic at byte 4 and the flags."""
    return (len(head) >= 16 and int.from_bytes(head[4:6], "little") in FLI_MAGICS
            and int.from_bytes(head[14:16], "little") in (0, 3))


def read_fli(path: str) -> np.ndarray:
    """An FLI / FLC file -> uint8 (H, W, 3), its first frame."""
    with open(path, "rb") as f:
        return decode_fli(f.read(), path)


def decode_fli(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_fli` of an FLI / FLC file's bytes (`path` names it in errors)."""
    return _decode(data, path, _frame)


def decode_fli_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_fli` with the frame walked by the plain version."""
    return _decode(data, path, _frame_plain)


def _u16(b: bytes, at: int) -> int:
    """A little-endian 16-bit word; struct.error (PIL's `i16`) past the end."""
    return struct.unpack_from("<H", b, at)[0]


def _u32(b: bytes, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _palette(data: bytes, pos: int, shift: int):
    """PIL's `FliImageFile._palette` from `pos` -> the 256 entries."""
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    i = 0
    packets = _u16(data, pos)
    pos += 2
    for _ in range(packets):
        s = data[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            pal[i] = [(s[k] << shift) & 255, (s[k + 1] << shift) & 255,
                      (s[k + 2] << shift) & 255]
            i += 1
    return pal


def header(data: bytes, path: str = "<bytes>"):
    """An FLI / FLC file's `_open` -> (width, height, the palette, the
    first frame's size); gives way where `_open` does (its SyntaxError,
    struct.error, IndexError, EOFError)."""
    s = data[:_HEADER]
    if not (fli_accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise GiveWay(f"{path}: not an FLI/FLC file")
    n_frames, w, h = struct.unpack_from("<3H", s, 6)
    try:
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        pos = _HEADER
        s = data[pos:pos + 16]
        if _u16(s, 4) == _PREFIX:
            pos = _HEADER + _u32(s, 0)
            s = data[pos:pos + 16]
        if _u16(s, 4) == _FRAME:
            pos += 16
            size = None
            for _ in range(_u16(s, 6)):
                if size is not None:
                    pos += size - 6
                s = data[pos:pos + 6]
                pos += 6
                kind = _u16(s, 4)
                if kind in (4, 11):
                    pal = _palette(data, pos, 2 if kind == 11 else 0)
                    break
                size = _u32(s, 0)
                if not size:
                    break
    except (struct.error, IndexError) as err:
        raise GiveWay(f"{path}: FLI palette search runs off the file ({err})") from None
    if n_frames == 0:
        raise GiveWay(f"{path}: an FLI file of 0 frames (PIL: attempt to seek outside "
                      "sequence)")
    s = data[_HEADER:_HEADER + 4]
    if not s:
        raise GiveWay(f"{path}: FLI missing frame size")
    if len(s) < 4:
        raise GiveWay(f"{path}: FLI frame size cut short")
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: an FLI image of {w}x{h} pixels (PIL: not identified)")
    return w, h, pal, _u32(s, 0)


def _load(data: bytes, w: int, h: int, framesize: int, walk):
    """PIL's `ImageFile.load` of the frame: blocks of `framesize` bytes from
    byte 128 handed to the decoder (`walk(buf, w, h, plane)` -> (status,
    bytes consumed)) until it ends the frame -> the (h, w) plane."""
    plane = np.zeros((h, w), np.uint8)
    pos, buf = _HEADER, b""
    while True:
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise ValueError(f"FLI frame data ends early (PIL: image file is truncated "
                             f"({len(buf)} bytes not processed))")
        buf += s
        status, used = walk(buf, w, h, plane)
        if status == _END:
            return plane
        if status in _CAUSES:
            raise ValueError(f"FLI frame: PIL's decoder fails ({_CAUSES[status]} when "
                             "reading image file)")
        buf = buf[used:]


def _decode(data: bytes, path: str, walk) -> np.ndarray:
    w, h, pal, framesize = header(data, path)
    try:
        plane = _load(data, w, h, framesize, walk)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
    return pal[plane]


def _frame(buf: bytes, w: int, h: int, plane: np.ndarray):
    """The decoder's call on `buf` (`gm_fli_frame`) -> (status, consumed)."""
    src = np.frombuffer(buf, np.uint8)
    info = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_fli_frame(src.ctypes.data, len(src), w, h,
                                                      plane.ctypes.data, info.ctypes.data)
    if status not in (_END, _NEED_MORE, _CONSUMED, *_CAUSES):
        raise RuntimeError(f"gm_fli_frame returned {status}")
    return status, int(info[0])


def _i32(b, at: int) -> int:
    """A little-endian 32-bit word as the C decoder's int reads it."""
    v = b[at] | b[at + 1] << 8 | b[at + 2] << 16 | b[at + 3] << 24
    return v - (1 << 32) if v >= 1 << 31 else v


def _frame_plain(buf: bytes, w: int, h: int, plane: np.ndarray):
    """`_frame` as a Python loop over the chunks (the plain version)."""
    n = len(buf)
    if n < 4:
        return _NEED_MORE, 0
    if n + n % 2 < _u32(buf, 0):
        return _NEED_MORE, 0
    if n < 8:
        return _OVERRUN, 0
    if buf[4] | buf[5] << 8 != _FRAME:
        return _UNKNOWN, 0
    rows = plane
    chunks = buf[6] | buf[7] << 8
    ptr, left = 16, n - 16
    for _ in range(chunks):
        if left < 10:
            return _OVERRUN, 0
        end = ptr + left                  # reads past here overrun
        d = ptr + 6
        kind = buf[ptr + 4] | buf[ptr + 5] << 8
        if kind in (4, 11, 18):
            pass
        elif kind == 7:                   # SS2: word deltas
            lines = buf[d] | buf[d + 1] << 8
            d += 2
            y = line = 0
            while line < lines and y < h:
                if d + 2 > end:
                    return _OVERRUN, 0
                packets = buf[d] | buf[d + 1] << 8
                d += 2
                row = y
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            return _OVERRUN, 0
                        row = y
                    else:
                        rows[row, w - 1] = packets & 255
                    if d + 2 > end:
                        return _OVERRUN, 0
                    packets = buf[d] | buf[d + 1] << 8
                    d += 2
                x = p = 0
                while p < packets:
                    if d + 2 > end:
                        return _OVERRUN, 0
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        if d + 4 > end:
                            return _OVERRUN, 0
                        i = 256 - buf[d + 1]
                        if x + 2 * i > w:
                            break
                        rows[row, x:x + 2 * i:2] = buf[d + 2]
                        rows[row, x + 1:x + 2 * i:2] = buf[d + 3]
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > w:
                            break
                        if d + 2 + i > end:
                            return _OVERRUN, 0
                        rows[row, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                return _OVERRUN, 0
        elif kind == 12:                  # LC: byte deltas
            y = buf[d] | buf[d + 1] << 8
            ymax = y + (buf[d + 2] | buf[d + 3] << 8)
            d += 4
            while y < ymax and y < h:
                if d + 1 > end:
                    return _OVERRUN, 0
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    if d + 2 > end:
                        return _OVERRUN, 0
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > w:
                            break
                        if d + 3 > end:
                            return _OVERRUN, 0
                        rows[y, x:x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > w:
                            break
                        if d + 2 + i > end:
                            return _OVERRUN, 0
                        rows[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return _OVERRUN, 0
        elif kind == 13:                  # BLACK
            rows[:] = 0
        elif kind == 15:                  # BRUN: byte runs
            for y in range(h):
                d += 1                    # the packet count, unread
                x = 0
                while x < w:
                    if d + 2 > end:
                        return _OVERRUN, 0
                    if buf[d] & 0x80:
                        i = 256 - buf[d]
                        if x + i > w:
                            break
                        if d + i + 1 > end:
                            return _OVERRUN, 0
                        rows[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 1)
                        d += i + 1
                    else:
                        i = buf[d]
                        if x + i > w:
                            break
                        rows[y, x:x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != w:
                    return _OVERRUN, 0
        elif kind == 16:                  # COPY
            if d + w * h > end:
                return _CONSUMED, ptr
            rows[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
        else:
            return _UNKNOWN, 0
        advance = _i32(buf, ptr)
        if advance == 0:
            return _BROKEN, 0
        if advance < 0 or advance > left:
            return _OVERRUN, 0
        ptr += advance
        left -= advance
    return _END, 0


# ------------------------------------------------------------------ writer

def _brun(idx: np.ndarray) -> bytes:
    """BRUN data: each row a packet-count byte (0: unread), then runs of 2
    to 127 as (count, value) and literal spans of up to 128 as (-count,
    bytes)."""
    h, w = idx.shape
    start, length, run = runs.segments(idx, 2, 127, 128)
    head = np.zeros((len(start), 2), np.uint8)
    head[:, 0] = np.where(run, length, 256 - length).astype(np.uint8)
    head[run, 1] = idx.ravel()[start[run]]
    body = runs.assemble(idx.ravel(), start, head, np.where(run, 2, 1),
                         np.where(run, 0, length), np.zeros(len(start), np.int64))
    # a zero byte before each row's first span
    size = np.where(run, 2, 1 + length)
    row_of = start // w
    at = np.concatenate([[0], np.cumsum(size)])
    row_at = at[np.searchsorted(row_of, np.arange(h))]
    return np.insert(body, row_at, 0).tobytes()


def _lc(idx: np.ndarray, base: np.ndarray) -> bytes:
    """LC data changing `base` into `idx`: the first changed row and the
    count of rows, then each row's packets: a skip, then a literal of up to
    127 bytes (count, bytes) or a run of up to 128 (-count, value)."""
    changed = np.flatnonzero((idx != base).any(1))
    y0 = int(changed[0]) if len(changed) else 0
    y1 = int(changed[-1]) + 1 if len(changed) else 0
    out = bytearray(struct.pack("<2H", y0, y1 - y0))
    for y in range(y0, y1):
        diff = np.flatnonzero(idx[y] != base[y])
        packets, x = [], 0
        k = 0
        while k < len(diff):
            x0 = int(diff[k])
            skip = x0 - x
            while skip > 255:             # a skip of 255 and an empty literal
                packets.append(bytes((255, 0)))
                skip -= 255
                x += 255
            row = idx[y, x0:x0 + 127]
            same = int(np.argmax(row != row[0])) if (row != row[0]).any() else len(row)
            if same >= 3:
                n = min(same, 128)
                packets.append(bytes((skip, 256 - n, int(row[0]))))
            else:
                n = min(127, int(diff[-1]) + 1 - x0)
                packets.append(bytes((skip, n)) + idx[y, x0:x0 + n].tobytes())
            x = x0 + n
            k = int(np.searchsorted(diff, x))
        if len(packets) > 255:
            raise ValueError("encode_fli: an LC row needs more than 255 packets")
        out.append(len(packets))
        out += b"".join(packets)
    return bytes(out)


def _ss2(idx: np.ndarray, base: np.ndarray) -> bytes:
    """SS2 data changing `base` into `idx` (even width): the count of coded
    rows, then each a skip-lines word where rows are skipped and a packet
    count, then packets: a skip in bytes, then a literal of up to 127 words
    (count, words) or a run of up to 128 words (-count, word)."""
    h, w = idx.shape
    words = idx.reshape(h, w // 2, 2)
    old = base.reshape(h, w // 2, 2)
    out, lines, skip = bytearray(), 0, 0
    for y in range(h):
        diff = np.flatnonzero((words[y] != old[y]).any(1))
        if not len(diff):
            skip += 1
            continue
        if skip:
            out += struct.pack("<H", 65536 - skip)
            skip = 0
        packets, x, k = [], 0, 0
        while k < len(diff):
            x0 = int(diff[k])
            gap = 2 * (x0 - x)
            while gap > 254:
                packets.append(bytes((254, 0)))
                gap -= 254
                x += 127
            row = words[y, x0:x0 + 128]
            eq = (row == row[0]).all(1)
            same = int(np.argmin(eq)) if not eq.all() else len(row)
            if same >= 2:
                n = same
                packets.append(bytes((gap, 256 - n)) + row[0].tobytes())
            else:
                n = min(127, int(diff[-1]) + 1 - x0)
                packets.append(bytes((gap, n)) + words[y, x0:x0 + n].tobytes())
            x = x0 + n
            k = int(np.searchsorted(diff, x))
        out += struct.pack("<H", len(packets)) + b"".join(packets)
        lines += 1
    return struct.pack("<H", lines) + bytes(out)


def _chunk(kind: int, body: bytes) -> bytes:
    """A sub-chunk: its size (header included, padded to even), its type."""
    body += b"\0" * (len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def encode_fli(idx: np.ndarray, palette: np.ndarray, chunk: str = "brun",
               flc: bool = False, levels: int = 256) -> bytes:
    """Indices (H, W) uint8 and a palette (N <= 256, 3) -> the bytes of an
    FLI (magic 0xAF11) or FLC (0xAF12) of one frame: a palette chunk (4 for
    `levels` 256, 11 for 64: the palette's values >> 2), then `chunk`: "brun",
    "copy", "lc" or "ss2" (the latter two as deltas from a zeroed plane;
    SS2 needs an even width), or "black" (the indices ignored)."""
    idx = np.ascontiguousarray(idx, np.uint8)
    palette = np.asarray(palette, np.uint8)
    h, w = idx.shape
    if levels not in (64, 256) or len(palette) > 256:
        raise ValueError("encode_fli takes a palette of at most 256 entries, 256 or 64 levels")
    n = len(palette)
    colours = (palette >> 2) if levels == 64 else palette
    pal_body = struct.pack("<HBB", 1, 0, n % 256) + colours.tobytes()
    zero = np.zeros_like(idx)
    body = {"brun": lambda: _brun(idx), "copy": idx.tobytes,
            "lc": lambda: _lc(idx, zero), "ss2": lambda: _ss2(idx, zero),
            "black": bytes}[chunk]()
    subs = _chunk(4 if levels == 256 else 11, pal_body) + _chunk(CHUNKS[chunk], body)
    frame = struct.pack("<IHH8x", 16 + len(subs), _FRAME, 2) + subs
    head = bytearray(_HEADER)
    struct.pack_into("<IHHHHHH", head, 0, _HEADER + len(frame), FLI_MAGICS[flc], 1, w, h,
                     8, 0)
    struct.pack_into("<I", head, 16, 5 if flc else 1)      # speed
    return bytes(head) + frame


def write_fli(path: str, idx: np.ndarray, palette: np.ndarray, **kwargs) -> None:
    """`encode_fli(idx, palette, **kwargs)` written to `path` (its directory
    made if needed)."""
    data = encode_fli(idx, palette, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
