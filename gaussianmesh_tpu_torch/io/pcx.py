"""PCX images in numpy and the port's C++, to the arrays PIL 12 gives (the
JAX reader opens dataset images with PIL; the machines the port runs on
have none).

`read_pcx` reads the five layouts PIL's `PcxImagePlugin` opens (bits a
sample x planes):

- 1 x 1 -> (H, W) 0 and 255, as PIL's `convert("L")` (PIL opens it as mode
  1, whose `np.asarray` is a bool array that the JAX reader divides by 255:
  fault B16);
- 1 x 2 and 1 x 4 -> RGB from the header's 16-colour palette, the index's
  bit k from plane k (PIL opens them as mode P: fault B15, whose
  `convert("RGB")` this is);
- 8 x 1 (version 5) -> (H, W), or RGB where the 256-colour palette after
  the `0x0C` marker at the end of the file is not the gray ramp (PIL's
  rule for L against P; P expanded as `convert("RGB")`, B15);
- 8 x 3 (version 5) -> RGB, the three planes of each row in turn.

Each row holds `planes` planes of PIL's stride: ceil(width * bits / 8)
bytes, made even where the header's `bytes_per_line` differs from it; the
padding byte of an odd width is decoded and dropped. PIL misreads an 8 x 3
file of width 3 with even planes, its own included (fault B22: it moves
the planes past their padding only where the row's length is not a
multiple of the width, so it takes a padding byte for a sample);
`read_pcx` reads each plane from its own stride, and refuses an 8 x 3
file of width 1, which PIL cannot load at all. The RLE rows are walked as
PIL's `PcxDecode` walks them (`gm_pcx_rle` of `csrc/image.cpp`;
`_rle_plain` here is the same walk in Python, held to it byte for byte):
a byte of 0xC0 or more repeats the next byte by its low 6 bits, any other
byte is itself; a run that crosses the end of its row raises (PIL: buffer
overrun), and so does data that ends before the image is full.

`encode_pcx` / `write_pcx` write 8 x 1 (with a palette) and 8 x 3 files,
for the tests and `chip_smoke.py`; the training path does not write PCX.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.ops import _cuda

_GRAY = np.repeat(np.arange(256, dtype=np.uint8), 3)
DCX_MAGIC = b"\xb1\x68\xde\x3a"          # 0x3ADE68B1, little-endian


def pcx_accept(head: bytes) -> bool:
    """PIL's `PcxImagePlugin._accept`: byte 0 is 10 and the version 0, 2, 3
    or 5."""
    return len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)


def pcx_size_ok(data: bytes) -> bool:
    """Whether PIL's `_open` gets past its size check (else it tries the
    next format, as it does for a file under the 68 bytes it reads)."""
    if len(data) < 12:
        return False
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", data, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def read_pcx(path: str) -> np.ndarray:
    """A PCX -> uint8 (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_pcx(f.read(), path)


def decode_pcx(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_pcx` of a PCX file's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle)


def decode_pcx_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_pcx` with the RLE rows walked by the plain version."""
    return _decode(data, path, _rle_plain)


def read_dcx(path: str) -> np.ndarray:
    """A DCX -> its first page, `read_pcx`'s array."""
    with open(path, "rb") as f:
        return decode_dcx(f.read(), path)


def decode_dcx(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_dcx` of a DCX file's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle, dcx_pages(data, path)[0])


def decode_dcx_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_dcx` with the RLE rows walked by the plain version."""
    return _decode(data, path, _rle_plain, dcx_pages(data, path)[0])


def dcx_pages(data: bytes, path: str = "<bytes>") -> list[int]:
    """A DCX's page offsets, read as `DcxImageFile._open` reads them: up to
    1,024, ending at a 0 (a table the file cuts first, or one of no pages,
    gives way)."""
    if data[:4] != DCX_MAGIC:
        raise ValueError(f"{path}: not a DCX")
    pages = []
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            raise GiveWay(f"{path}: DCX page table cut short after {i} offsets")
        (offset,) = struct.unpack_from("<I", data, 4 + 4 * i)
        if not offset:
            break
        pages.append(offset)
    if not pages:
        raise GiveWay(f"{path}: a DCX of no pages (PIL: attempt to seek outside sequence)")
    return pages


def _rle(data: bytes, row_bytes: int, rows: int):
    """RLE data -> (the bytes decoded, at most row_bytes * rows; whether a
    run crossed the end of its row) (`gm_pcx_rle`)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(row_bytes * rows, np.uint8)
    n_out = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_pcx_rle(
        src.ctypes.data, len(src), row_bytes, rows, out.ctypes.data, n_out.ctypes.data)
    if status not in (0, 8):
        raise RuntimeError(f"gm_pcx_rle returned {status}")
    return out[:int(n_out[0])], status == 8


def _rle_plain(data: bytes, row_bytes: int, rows: int):
    """`_rle` as a Python loop over the bytes (the plain version)."""
    total = row_bytes * rows
    out = bytearray()
    i, n = 0, len(data)
    while len(out) < total and i < n:
        b = data[i]
        if b >= 0xC0:
            if n - i < 2:
                break
            if len(out) % row_bytes + (b & 63) > row_bytes:
                return np.frombuffer(bytes(out), np.uint8), True
            out += data[i + 1:i + 2] * (b & 63)
            i += 2
        else:
            out.append(b)
            i += 1
    return np.frombuffer(bytes(out), np.uint8), False


def _decode(data: bytes, path: str, rle, start: int = 0) -> np.ndarray:
    """The PCX image whose header is at `start` (a DCX page's offset; its
    data runs to the end of the file, and an 8 x 1 image's palette is the
    file's last 769 bytes, as PIL seeks them)."""
    head = data[start:start + 68]
    if not pcx_accept(head) or len(head) < 68:
        raise GiveWay(f"{path}: not a PCX")
    if not pcx_size_ok(head):
        raise GiveWay(f"{path}: PCX of no size (PIL: bad PCX image size)")
    version, _, bits = head[1:4]
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", head, 4)
    planes = head[65]
    (given,) = struct.unpack_from("<H", head, 66)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if not ((bits == 1 and planes in (1, 2, 4)) or (version == 5 and bits == 8
                                                    and planes in (1, 3))):
        raise ValueError(f"{path}: PCX of {bits} bits x {planes} planes (version "
                         f"{version}), which PIL does not read (unknown PCX mode)")
    if bits == 8 and planes == 3 and w == 1:
        raise ValueError(f"{path}: an 8 x 3 PCX of width 1, which PIL cannot load "
                         "(image file is truncated; fault B22)")
    if bits == 8 and planes == 1 and len(data) < 769:
        raise ValueError(f"{path}: an 8 x 1 PCX of {len(data)} bytes, which PIL cannot "
                         "open: it seeks 769 bytes back from the end for a palette")
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    px, crossed = rle(data[start + 128:], planes * stride, h)
    if crossed:
        raise ValueError(f"{path}: a PCX run crosses the end of its row (PIL: buffer "
                         "overrun)")
    if len(px) < planes * stride * h:
        raise ValueError(f"{path}: PCX data ends after {len(px)} of "
                         f"{planes * stride * h} bytes (cut short)")
    rows = px.reshape(h, planes, stride)
    if bits == 8:
        img = rows[:, :, :w].transpose(0, 2, 1)
        if planes == 3:
            return np.ascontiguousarray(img)
        img = img[..., 0]
        tail = data[-769:]
        if tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1)
            if not np.array_equal(pal, _GRAY):
                return pal.reshape(256, 3)[img]
        return np.ascontiguousarray(img)
    bit = np.unpackbits(rows, axis=2)[:, :, :w].astype(np.uint8)
    if planes == 1:
        return (bit[:, 0] * np.uint8(255))
    idx = (bit << np.arange(planes, dtype=np.uint8)[None, :, None]).sum(1, dtype=np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    pal[:16] = np.frombuffer(head, np.uint8, 48, 16).reshape(16, 3)
    return pal[idx]


# ------------------------------------------------------------------ writer

def _rle_encode(rows: np.ndarray) -> bytes:
    """Rows (H, row bytes) -> PCX RLE: runs of 2 or more (or any byte of 0xC0
    or more) as (0xC0 | count, byte), at most 63, the other bytes as
    themselves, no run crossing a row's end."""
    start, length, run = runs.segments(rows, 2, 63, 1)
    x = rows.ravel()
    coded = run | (x[start] >= 0xC0)
    head = np.stack([0xC0 | length, x[start]], 1).astype(np.uint8)
    head[~coded, 0] = x[start[~coded]]
    return runs.assemble(x, start, head, np.where(coded, 2, 1), np.zeros(len(start),
                         np.int64), np.zeros(len(start), np.int64)).tobytes()


def encode_pcx(img: np.ndarray, palette: np.ndarray | None = None) -> bytes:
    """uint8 (H, W) (`palette`: (256, 3) uint8 RGB of its indices, else the
    gray ramp) or (H, W, 3) RGB -> the bytes of a version-5 8 x 1 or 8 x 3
    PCX, each plane padded to an even stride."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError("encode_pcx takes uint8 (H, W) or (H, W, 3)")
    h, w = img.shape[:2]
    planes = 1 if img.ndim == 2 else 3
    stride = w + w % 2
    rows = np.zeros((h, planes, stride), np.uint8)
    rows[:, :, :w] = img.reshape(h, w, planes).transpose(0, 2, 1)
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 72, 72)
    head += bytes(48) + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    head = head.ljust(128, b"\0")
    body = _rle_encode(rows.reshape(h, planes * stride))
    if planes == 3:
        return head + body
    pal = _GRAY if palette is None else np.asarray(palette, np.uint8).reshape(768)
    return head + body + b"\x0c" + pal.tobytes()


def write_pcx(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_pcx(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_pcx(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def encode_dcx(pages: list) -> bytes:
    """Pages, each an `encode_pcx` argument (an image, or (image, palette))
    -> the bytes of a DCX: its magic, the pages' offsets ending at a 0,
    then the PCX files in turn."""
    files = [encode_pcx(*(p if isinstance(p, tuple) else (p,))) for p in pages]
    offset = 8 + 4 * len(files)
    table = b""
    for f in files:
        table += struct.pack("<I", offset)
        offset += len(f)
    return DCX_MAGIC + table + bytes(4) + b"".join(files)


def write_dcx(path: str, pages: list) -> None:
    """`encode_dcx(pages)` written to `path` (its directory made if
    needed)."""
    data = encode_dcx(pages)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
