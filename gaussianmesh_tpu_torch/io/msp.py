"""Windows Paint (MSP) images in numpy and the port's C++, to the arrays PIL
12 gives (the JAX reader opens dataset images with PIL; the machines the
port runs on have none).

`read_msp` reads what PIL's `MspImagePlugin` opens: a 32-byte header of 16
little-endian words ("DanM" for version 1, "LinS" for version 2, then the
width and height) whose XOR is 0, then 1-bit rows of `ceil(width / 8)`
bytes, a set bit white. Version 1 stores the rows; version 2 a map of each
row's length, then the rows, each a run of `0, count, value` (count
copies) or of `n` and n literal bytes; a row of length 0 is blank (0xFF).
PIL's `MspDecoder` joins what the rows give into one stream, so a row that
gives more or fewer bytes than its width runs into the next; `read_msp`
walks them the same way (`gm_msp_rle` of `csrc/image.cpp`; `_rle_plain`
here is the same walk in Python, held to it byte for byte).

PIL opens both as mode 1, whose `np.asarray` is a bool array that the JAX
reader divides by 255 (fault B16): `read_msp` gives `convert("L")`'s 0 and
255. A bad checksum, a header cut short or a size of 0 gives way
(`io/giveway.py`); a map or row the file cuts, a run cut by the end of its
row and rows that give too few bytes raise with PIL's cause.

`encode_msp` / `write_msp` write version 1 (as PIL does) and version 2,
for the tests and `chip_smoke.py`; the training path does not write MSP.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.ops import _cuda

MSP_MAGICS = (b"DanM", b"LinS")
_HEADER = 32
_TRUNCATED, _ROW_CORRUPT = 1, 12       # gm_msp_rle's statuses (csrc/image.cpp)


def read_msp(path: str) -> np.ndarray:
    """An MSP image -> uint8 (H, W), 0 and 255."""
    with open(path, "rb") as f:
        return decode_msp(f.read(), path)


def decode_msp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_msp` of an MSP file's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle)


def decode_msp_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_msp` with version 2's rows walked by the plain version."""
    return _decode(data, path, _rle_plain)


def _rle(data: bytes, rows: int, row_bytes: int):
    """Version 2's row map and rows (`data`: the file after its header) ->
    (the stream's first rows * row_bytes bytes, uint8; its whole length;
    None, or (status, row) where the walk failed) (`gm_msp_rle`)."""
    src = np.frombuffer(data, np.uint8)
    total = rows * row_bytes
    out = np.zeros(total, np.uint8)
    info = np.zeros(2, np.int64)
    status = _cuda.host_library("image").gm_msp_rle(
        src.ctypes.data, len(src), rows, row_bytes, total, out.ctypes.data, info.ctypes.data)
    if status not in (0, _TRUNCATED, _ROW_CORRUPT):
        raise RuntimeError(f"gm_msp_rle returned {status}")
    n = int(info[0])
    return out[:min(n, total)], n, (status, int(info[1])) if status else None


def _rle_plain(data: bytes, rows: int, row_bytes: int):
    """`_rle` as a Python loop over the rows and runs (the plain version)."""
    total = rows * row_bytes
    out = bytearray()
    if len(data) < 2 * rows:
        return np.zeros(0, np.uint8), 0, (_TRUNCATED, -1)
    lengths = struct.unpack_from(f"<{rows}H", data)
    pos, failed = 2 * rows, None
    for y, length in enumerate(lengths):
        if length == 0:
            out += b"\xff" * row_bytes
            continue
        if pos + length > len(data):
            failed = (_TRUNCATED, y)
            break
        row = data[pos:pos + length]
        pos += length
        k = 0
        while k < length:
            kind = row[k]
            k += 1
            if kind == 0:
                if k + 2 > length:
                    failed = (_ROW_CORRUPT, y)
                    break
                out += row[k + 1:k + 2] * row[k]
                k += 2
            else:
                out += row[k:k + kind]
                k += kind
        if failed:
            break
    return np.frombuffer(bytes(out[:total]), np.uint8), len(out), failed


def header(data: bytes, path: str = "<bytes>"):
    """An MSP header as PIL's `_open` reads it -> (width, height, version);
    gives way where `_open` does."""
    if data[:4] not in MSP_MAGICS:
        raise GiveWay(f"{path}: not an MSP file")
    if len(data) < _HEADER:
        raise GiveWay(f"{path}: MSP header cut short")
    words = np.frombuffer(data, "<u2", 16)
    if np.bitwise_xor.reduce(words):
        raise GiveWay(f"{path}: bad MSP checksum")
    w, h = int(words[2]), int(words[3])
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: MSP image of {w}x{h} pixels (PIL: not identified)")
    return w, h, 1 if data[:4] == b"DanM" else 2


def _decode(data: bytes, path: str, rle) -> np.ndarray:
    w, h, version = header(data, path)
    row = (w + 7) // 8
    total = row * h
    if version == 1:
        px = np.frombuffer(data, np.uint8, min(total, max(0, len(data) - _HEADER)), _HEADER)
        if len(px) < total:
            raise ValueError(f"{path}: MSP data ends after {len(px)} of {total} bytes (image "
                             "file is truncated)")
    else:
        px, n, failed = rle(data[_HEADER:], h, row)
        if failed is not None:
            status, y = failed
            if y < 0:
                raise ValueError(f"{path}: Truncated MSP file in row map")
            if status == _TRUNCATED:
                (length,) = struct.unpack_from("<H", data, _HEADER + 2 * y)
                raise ValueError(f"{path}: Truncated MSP file, expected {length} bytes on "
                                 f"row {y}")
            raise ValueError(f"{path}: Corrupted MSP file in row {y} (a run cut by the end "
                             "of its row)")
        if n < total:
            raise ValueError(f"{path}: MSP rows give {n} of {total} bytes (PIL: not enough "
                             "image data)")
    bits = np.unpackbits(px.reshape(h, row), axis=1)[:, :w]
    return bits * np.uint8(255)


# ------------------------------------------------------------------ writer

def _rows_v2(packed: np.ndarray, blank_rows: bool) -> tuple[np.ndarray, bytes]:
    """Packed rows (H, row bytes) -> (each row's length, the rows): runs of
    3 or more as 0, count, value (at most 255), the bytes between as n and
    n bytes (at most 255); a row of all 0xFF as length 0 where
    `blank_rows`."""
    h = packed.shape[0]
    start, length, run = runs.segments(packed, 3, 255, 255)
    x = packed.ravel()
    head = np.stack([np.where(run, 0, length), np.where(run, length, 0), x[start]], 1)
    size = np.where(run, 3, 1 + length)
    row_of = start // packed.shape[1]
    keep = np.ones(len(start), bool)
    if blank_rows:
        blank = (packed == 0xFF).all(1)
        keep = ~blank[row_of]
    body = runs.assemble(x, start[keep], head[keep].astype(np.uint8),
                         np.where(run, 3, 1)[keep], np.where(run, 0, length)[keep],
                         np.zeros(int(keep.sum()), np.int64))
    lengths = np.bincount(row_of[keep], size[keep], minlength=h).astype(np.int64)
    return lengths, body.tobytes()


def encode_msp(img: np.ndarray, version: int = 1, blank_rows: bool = True) -> bytes:
    """(H, W) (0 black, anything else white) -> the bytes of an MSP file of
    version 1 or 2 (rows of all white as length 0 where `blank_rows`)."""
    img = np.asarray(img)
    h, w = img.shape
    packed = np.packbits(img != 0, axis=1)
    words = [0] * 16
    words[0], words[1] = struct.unpack("<2H", MSP_MAGICS[version - 1])
    words[2], words[3] = w, h
    words[4:8] = [1, 1, 1, 1]
    words[8], words[9] = w, h
    check = 0
    for word in words:
        check ^= word
    words[12] = check
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + packed.tobytes()
    lengths, body = _rows_v2(packed, blank_rows)
    if lengths.max(initial=0) > 0xFFFF:
        raise ValueError("encode_msp: a row of more than 65,535 coded bytes")
    return head + lengths.astype("<u2").tobytes() + body


def write_msp(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_msp(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_msp(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
