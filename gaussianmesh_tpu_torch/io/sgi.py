"""SGI images in numpy and the port's C++, to the arrays PIL 12 gives (the
JAX reader opens dataset images with PIL; the machines the port runs on
have none).

`read_sgi` reads what PIL's `SgiImagePlugin` opens: magic 474, 1 or 2
bytes a sample (2: big-endian, of which PIL keeps the high byte), and the
(dimension, channels) pairs (1 or 2, 1) -> (H, W) gray, (3, 3) -> RGB and
(3, 4) -> RGBA; PIL refuses 2 channels, dimension 3 with 1 channel and
other sample sizes, and so does `read_sgi`. Rows are stored bottom-up,
plane after plane, verbatim or RLE (compression 1: a table of each row's
offset and one of its length, then the rows), walked as PIL's
`SgiRleDecode` walks them (`gm_sgi_rle` of `csrc/image.cpp`; `_rle_plain`
here is the same walk in Python, held to it byte for byte; see there for
its edges: a row's samples its data does not reach keep the row before's,
and a control byte left over at the row's last count stops the decode
with the rows after it black, as PIL returns them). Data that PIL finds
past its buffer (a cut file, an offset before the header) raises.

`encode_sgi` / `write_sgi` write gray, RGB and RGBA at 1 or 2 bytes a
sample, verbatim or RLE, for the tests and `chip_smoke.py`; the training
path does not write SGI files.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import runs
from gaussianmesh_tpu_torch.ops import _cuda

SGI_MAGIC = b"\x01\xda"
_HEADER = 512
_CHANNELS = {(1, 1): 1, (2, 1): 1, (3, 3): 3, (3, 4): 4}


def read_sgi(path: str) -> np.ndarray:
    """An SGI image -> uint8 (H, W), (H, W, 3) or (H, W, 4)."""
    with open(path, "rb") as f:
        return decode_sgi(f.read(), path)


def decode_sgi(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_sgi` of an SGI file's bytes (`path` names it in errors)."""
    return _decode(data, path, _rle)


def decode_sgi_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_sgi` with the RLE rows walked by the plain version."""
    return _decode(data, path, _rle_plain)


def _rle(data, starts, lengths, xsize, ysize, zsize, bpc):
    """RLE rows (`data`: the file after its header) -> (ysize, xsize * zsize
    * bpc) uint8 in stored order, or None where PIL overruns its buffer
    (`gm_sgi_rle`)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((ysize, xsize * zsize * bpc), np.uint8)
    st = np.ascontiguousarray(starts, np.uint32)
    ln = np.ascontiguousarray(lengths, np.uint32)
    status = _cuda.host_library("image").gm_sgi_rle(
        src.ctypes.data, len(src), st.ctypes.data, ln.ctypes.data, xsize, ysize, zsize, bpc,
        out.ctypes.data)
    if status not in (0, 8):
        raise RuntimeError(f"gm_sgi_rle returned {status}")
    return None if status else out


def _rle_plain(data, starts, lengths, xsize, ysize, zsize, bpc):
    """`_rle` as a Python loop over the packets (the plain version)."""
    out = np.zeros((ysize, xsize * zsize * bpc), np.uint8)
    buf = bytearray(xsize * zsize * bpc)
    end = len(data) - 1
    step = zsize * bpc
    for y in range(ysize):
        for c in range(zsize):
            at = int(starts[y + c * ysize])
            if at < _HEADER:
                return None
            src, x, dest = at - _HEADER, 0, c * bpc
            left = int(np.int64(lengths[y + c * ysize]).astype(np.int32))
            while left > 0:
                if src + bpc - 1 > end:
                    return None
                pixel = data[src + bpc - 1]
                src += bpc
                if left == 1 and pixel:
                    return out                     # PIL stops here, no error
                count = pixel & 127
                if not count:
                    break
                if x + count > xsize:
                    return None
                x += count
                if pixel & 128:
                    if src + bpc * count > end:
                        return None
                    for k in range(count):
                        buf[dest:dest + bpc] = data[src:src + bpc]
                        src += bpc
                        dest += step
                else:
                    if src + (bpc - 1) * 2 > end:
                        return None
                    sample = data[src:src + bpc]
                    for k in range(count):
                        buf[dest:dest + bpc] = sample
                        dest += step
                    src += bpc
                left -= 1
        out[y] = np.frombuffer(bytes(buf), np.uint8)
    return out


def _decode(data: bytes, path: str, rle) -> np.ndarray:
    if data[:2] != SGI_MAGIC:
        raise ValueError(f"{path}: not an SGI image")
    if len(data) < _HEADER:
        raise ValueError(f"{path}: SGI header cut short")
    compression, bpc, dim, xsize, ysize, zsize = struct.unpack_from(">BBHHHH", data, 2)
    if bpc not in (1, 2) or (dim, zsize) not in _CHANNELS:
        raise ValueError(f"{path}: SGI image of {bpc} bytes a sample, dimension {dim} and "
                         f"{zsize} channels, which PIL does not read (unsupported SGI "
                         "image mode)")
    if compression not in (0, 1):
        raise ValueError(f"{path}: SGI compression {compression}, which PIL cannot load")
    if xsize == 0 or ysize == 0:
        raise ValueError(f"{path}: SGI image of {xsize}x{ysize} pixels")
    z = _CHANNELS[dim, zsize]
    body = data[_HEADER:]
    if compression == 0:
        size = xsize * ysize * bpc * z
        if len(body) < size:
            raise ValueError(f"{path}: SGI image data cut short (truncated)")
        planes = np.frombuffer(body, np.uint8, size).reshape(z, ysize, xsize, bpc)[..., 0]
        img = planes.transpose(1, 2, 0)
    else:
        n = ysize * z
        if len(body) < 8 * n:
            raise ValueError(f"{path}: SGI RLE tables cut short (PIL: buffer overrun)")
        starts = np.frombuffer(body, ">u4", n)
        lengths = np.frombuffer(body, ">u4", n, 4 * n)
        rows = rle(body, starts, lengths, xsize, ysize, z, bpc)
        if rows is None:
            raise ValueError(f"{path}: SGI RLE data runs past its row or its file (PIL: "
                             "buffer overrun)")
        img = rows.reshape(ysize, xsize, z, bpc)[..., 0]
    img = img[::-1]
    return np.ascontiguousarray(img[..., 0] if z == 1 else img)


# ------------------------------------------------------------------ writer

def _rle_row(samples: np.ndarray, bpc: int) -> np.ndarray:
    """One plane's rows (H, W) of `bpc`-byte samples (uint16 where 2) -> the
    RLE bytes of each row, concatenated, and each row's length: runs of 3
    or more as repeated packets, the samples between as copied ones, at
    most 127 a packet, then a 0 control."""
    h, w = samples.shape
    start, length, run = runs.segments(samples, 3, 127, 127)
    raw = samples.astype(">u2").view(np.uint8).reshape(-1) if bpc == 2 else samples.ravel()
    # a packet's control, its samples' bytes; the row ends with a 0 control
    ctrl = np.where(run, length, 128 | length).astype(np.uint16)
    take = np.where(run, 1, length) * bpc
    row_of = start // w
    head = (ctrl.astype(">u2").view(np.uint8).reshape(-1, 2) if bpc == 2
            else ctrl.astype(np.uint8)[:, None])
    body = runs.assemble(raw, start * bpc, head, np.full(len(start), bpc), take,
                         np.zeros(len(start), np.int64))
    size = bpc + take
    per_row = np.bincount(row_of, size, minlength=h).astype(np.int64)
    ends = np.cumsum(per_row)
    out = np.insert(body, np.repeat(ends, bpc), 0)
    return out, per_row + bpc


def encode_sgi(img: np.ndarray, bpc: int = 1, rle: bool = False) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA (uint16 samples
    where `bpc` is 2) -> the bytes of an SGI image, verbatim or RLE."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, z = img.shape
    if z not in (1, 3, 4) or bpc not in (1, 2) or img.dtype != (np.uint16 if bpc == 2
                                                                  else np.uint8):
        raise ValueError("encode_sgi takes (H, W), (H, W, 3) or (H, W, 4), uint8 at bpc 1 "
                         "and uint16 at bpc 2")
    dim = 3 if z > 1 else (1 if h == 1 else 2)
    head = struct.pack(">hBBHHHHii", 474, int(rle), bpc, dim, w, h, z, 0, 255)
    head = head.ljust(_HEADER, b"\0")
    planes = img[::-1].transpose(2, 0, 1)
    if not rle:
        return head + planes.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    bodies, lens = zip(*(_rle_row(np.ascontiguousarray(p), bpc) for p in planes))
    lengths = np.concatenate(lens)
    starts = _HEADER + 8 * h * z + np.cumsum(lengths) - lengths
    return (head + starts.astype(">u4").tobytes() + lengths.astype(">u4").tobytes()
            + b"".join(b.tobytes() for b in bodies))


def write_sgi(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_sgi(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_sgi(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
