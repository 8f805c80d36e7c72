"""QOI ("Quite OK Image") images in numpy and the port's C++, to the arrays
PIL 12 gives (the JAX reader opens dataset images with PIL; the machines
the port runs on have none).

`read_qoi` reads a `qoif` file: a 14-byte header (width, height, channels,
colour space), then ops. PIL opens 3 channels as RGB and any other count as
RGBA, and so does `read_qoi`: (H, W, 3) or (H, W, 4). The ops are walked as
PIL's `QoiDecoder` walks them (`gm_qoi_decode` of `csrc/image.cpp`;
`_ops_plain` here is the same walk in Python, held to it byte for
byte): RGB, RGBA, INDEX (the 64-entry index of pixels by (3r + 5g + 7b +
11a) % 64), DIFF, LUMA and RUN, from the previous pixel (0, 0, 0, 255).
Decoding stops at the last pixel, as PIL's does, so the 8-byte end marker
is not read; data that ends before then raises.

`encode_qoi` / `write_qoi` write RGB and RGBA images with every op, for the
tests and `chip_smoke.py`; the training path does not write QOI files.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

QOI_MAGIC = b"qoif"
_END = b"\x00" * 7 + b"\x01"


def read_qoi(path: str) -> np.ndarray:
    """A QOI file -> uint8 (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_qoi(f.read(), path)


def decode_qoi(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_qoi` of a QOI file's bytes (`path` names it in errors)."""
    return _decode(data, path, _ops)


def decode_qoi_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_qoi` with the ops walked by the plain version."""
    return _decode(data, path, _ops_plain)


def _ops(data: bytes, channels: int, pixels: int):
    """The ops after the header -> (pixels * channels uint8, or None where
    the data ends first) (`gm_qoi_decode`)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(pixels * channels, np.uint8)
    status = _cuda.host_library("image").gm_qoi_decode(
        src.ctypes.data, len(src), channels, pixels, out.ctypes.data)
    if status not in (0, 1):
        raise RuntimeError(f"gm_qoi_decode returned {status}")
    return None if status else out


def _ops_plain(data: bytes, channels: int, pixels: int):
    """`_ops` as a Python loop over the ops (the plain version)."""
    index = [(0, 0, 0, 0)] * 64
    r, g, b, a = 0, 0, 0, 255
    out = bytearray()
    want = pixels * channels
    i, n = 0, len(data)
    while len(out) < want:
        if i >= n:
            return None
        op = data[i]
        i += 1
        if op in (0xFE, 0xFF):
            k = 3 if op == 0xFE else 4
            if n - i < k:
                return None
            r, g, b = data[i:i + 3]
            if k == 4:
                a = data[i + 3]
            i += k
        elif op >> 6 == 0:
            r, g, b, a = index[op]
        elif op >> 6 == 1:
            r = (r + ((op >> 4) & 3) - 2) & 255
            g = (g + ((op >> 2) & 3) - 2) & 255
            b = (b + (op & 3) - 2) & 255
        elif op >> 6 == 2:
            if i >= n:
                return None
            dg = (op & 63) - 32
            r = (r + dg + (data[i] >> 4) - 8) & 255
            g = (g + dg) & 255
            b = (b + dg + (data[i] & 15) - 8) & 255
            i += 1
        else:
            out += bytes((r, g, b, a)[:channels]) * ((op & 63) + 1)
            continue
        index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
        out += bytes((r, g, b, a)[:channels])
    return np.frombuffer(bytes(out[:want]), np.uint8)


def _decode(data: bytes, path: str, ops) -> np.ndarray:
    if data[:4] != QOI_MAGIC:
        raise ValueError(f"{path}: not a QOI file")
    if len(data) < 14:
        raise ValueError(f"{path}: QOI header cut short")
    w, h, channels = struct.unpack_from(">IIB", data, 4)
    if w == 0 or h == 0:
        raise ValueError(f"{path}: QOI image of {w}x{h} pixels")
    c = 3 if channels == 3 else 4
    px = ops(data[14:], c, w * h)
    if px is None:
        raise ValueError(f"{path}: QOI data ends before the image is full (cut short)")
    return px.reshape(h, w, c)


# ------------------------------------------------------------------ writer

def _hash(px: np.ndarray) -> np.ndarray:
    p = px.astype(np.int64)
    return (p[:, 0] * 3 + p[:, 1] * 5 + p[:, 2] * 7 + p[:, 3] * 11) % 64


def encode_qoi(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W, 4) RGBA -> the bytes of a QOI file, its
    ops chosen as the format's reference encoder chooses them: a run of the
    previous pixel (at most 62), else INDEX where the index holds the
    pixel, else DIFF, LUMA, RGB or, where the alpha changes, RGBA; then
    the end marker. In numpy: the index entry a pixel finds is that of the
    last pixel before it with its hash that was not in a run."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("encode_qoi takes uint8 (H, W, 3) or (H, W, 4)")
    h, w, c = img.shape
    px = img.reshape(-1, c)
    if c == 3:
        px = np.concatenate([px, np.full((len(px), 1), 255, np.uint8)], 1)
    n = len(px)
    prev = np.concatenate([np.array([[0, 0, 0, 255]], np.uint8), px[:-1]])
    same = (px == prev).all(1)
    # runs: maximal stretches of pixels equal to the one before, cut at 62
    start = np.flatnonzero(same & ~np.concatenate([[False], same[:-1]]))
    end = np.flatnonzero(same & ~np.concatenate([same[1:], [False]])) + 1
    # INDEX: the last earlier pixel (outside a run) with the same hash; the
    # reference encoder stores every pixel that is not in a run
    stored = np.flatnonzero(~same)
    hs = _hash(px[stored])
    order = np.lexsort((stored, hs))
    before = np.full(len(stored), -1)
    grp = hs[order]
    has = np.zeros(len(grp), bool)
    has[1:] = grp[1:] == grp[:-1]
    before[order[has]] = stored[order][np.flatnonzero(has) - 1]
    hit = np.zeros(n, bool)
    ok = before >= 0
    hit[stored[ok]] = (px[stored[ok]] == px[before[ok]]).all(1)
    d = px.astype(np.int16) - prev.astype(np.int16)
    d = (d + 128) % 256 - 128                           # wrapped differences
    same_a = d[:, 3] == 0
    diff = same_a & ((d[:, :3] >= -2) & (d[:, :3] <= 1)).all(1)
    dg = d[:, 1]
    dr, db = d[:, 0] - dg, d[:, 2] - dg
    luma = same_a & (dg >= -32) & (dg <= 31) & (dr >= -8) & (dr <= 7) & (db >= -8) & (db <= 7)
    out = np.zeros((n, 5), np.uint8)
    size = np.zeros(n, np.int64)
    sel = ~same & hit
    out[sel, 0] = _hash(px[sel])
    size[sel] = 1
    sel = ~same & ~hit & diff
    out[sel, 0] = (0x40 | (d[sel, 0] + 2) << 4 | (d[sel, 1] + 2) << 2 | (d[sel, 2] + 2))
    size[sel] = 1
    rest = ~same & ~hit & ~diff
    sel = rest & luma
    out[sel, 0] = 0x80 | (dg[sel] + 32)
    out[sel, 1] = (dr[sel] + 8) << 4 | (db[sel] + 8)
    size[sel] = 2
    sel = rest & ~luma & same_a
    out[sel, 0] = 0xFE
    out[sel, 1:4] = px[sel, :3]
    size[sel] = 4
    sel = rest & ~luma & ~same_a
    out[sel, 0] = 0xFF
    out[sel, 1:5] = px[sel]
    size[sel] = 5
    # one RUN op at the end of each stretch of 62 run pixels and of each run
    length = end - start
    k = -(-length // 62)
    which = np.repeat(np.arange(len(start)), k)
    j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    last = np.minimum(start[which] + (j + 1) * 62, end[which]) - 1
    out[last, 0] = 0xC0 | (last - (start[which] + j * 62))
    size[last] = 1
    keep = np.arange(5)[None, :] < size[:, None]
    head = struct.pack(">4sIIBB", QOI_MAGIC, w, h, c, 0)
    return head + out[keep].tobytes() + _END


def write_qoi(path: str, img: np.ndarray) -> None:
    """`encode_qoi(img)` written to `path` (its directory made if needed)."""
    data = encode_qoi(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
