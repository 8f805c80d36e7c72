"""McIdas area files in numpy, to the arrays PIL 12 gives (the JAX reader
opens dataset images with PIL; the machines the port runs on have none).

`read_mcidas` reads what PIL's `McIdasImagePlugin` opens: a directory of
64 big-endian signed words (W1-W64; the file starts `0 4`), then lines of
samples. W9 is the height, W10 the width, W11 the bytes a sample and W14
the bands; the data start at W34 + W15 and a line is W15 + W10 * W11 *
W14 bytes (W15 a line's prefix). PIL reads the first W10 samples of each
line, so a line of several bands gives its first W10 samples (whether
those are band 1 is not settled: fault note C6). A line length of 0 or
less reads the lines packed; one shorter than W10 samples reads lines that
overlap, as PIL's memory map of the file does; either way a line the file
cuts raises.

- 1 byte a sample is L, read as it is.
- 2 bytes (PIL's `I;16B`, which the JAX reader trains as values up to 257:
  fault B7's kind) give each sample's high byte.
- 4 bytes (PIL's mode I, 32-bit samples the JAX reader divides by 255:
  fault B21's kind) are refused with that cause.

A directory cut short, another byte count, a width or height under 1 give
way (`io/giveway.py`), as in PIL; a data start before the file raises
("Tile offset cannot be negative").

`encode_mcidas` / `write_mcidas` write 1- and 2-byte files, for the tests
and `chip_smoke.py`; the training path does not write McIdas areas.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

MCIDAS_MAGIC = b"\0\0\0\0\0\0\0\4"


def mcidas_accept(head: bytes) -> bool:
    """PIL's `McIdasImagePlugin._accept`."""
    return head.startswith(MCIDAS_MAGIC)


def read_mcidas(path: str) -> np.ndarray:
    """A McIdas area -> uint8 (H, W)."""
    with open(path, "rb") as f:
        return decode_mcidas(f.read(), path)


def directory(data: bytes, path: str = "<bytes>") -> list:
    """The area directory as PIL's `_open` reads it -> [0, W1, ..., W64];
    gives way where `_open` does."""
    if len(data) < 256 or not mcidas_accept(data):
        raise GiveWay(f"{path}: not an McIdas area file")
    return [0, *struct.unpack(">64i", data[:256])]


def decode_mcidas(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_mcidas` of a McIdas area's bytes (`path` names it in errors)."""
    w = directory(data, path)
    width, height, size = w[10], w[9], w[11]
    if size not in (1, 2, 4):
        raise GiveWay(f"{path}: unsupported McIdas format ({size} bytes a sample)")
    if width <= 0 or height <= 0:
        raise GiveWay(f"{path}: a McIdas area of {width}x{height} pixels (PIL: not "
                      "identified)")
    if size == 4:
        raise ValueError(f"{path}: a McIdas area of 32-bit samples (PIL's mode I), which the "
                         "JAX reader trains as the values / 255 (fault B21's kind); not read")
    offset = w[34] + w[15]
    if offset < 0:
        raise ValueError(f"{path}: McIdas data start {offset} (PIL: Tile offset cannot be "
                         "negative)")
    row = width * size
    stride = w[15] + width * size * w[14]
    if stride <= 0:
        stride = row
    need = offset + (height - 1) * stride + row
    if len(data) < need:
        raise ValueError(f"{path}: McIdas data ends {need - len(data)} bytes before its last "
                         "line (PIL: image file is truncated)")
    lines = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8)[offset:],
                                            (height, row), (stride, 1))
    return np.ascontiguousarray(lines[:, ::size])      # a 2-byte sample's high byte


def encode_mcidas(img: np.ndarray, size: int = 1, bands: int = 1,
                  prefix: int = 0) -> bytes:
    """(H, W) uint8 (`size` 1) or uint16 (`size` 2) samples -> the bytes of
    a McIdas area whose lines hold `bands` bands (the image the first; the
    others its complement) after a `prefix` of zero bytes."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or size not in (1, 2) or img.dtype != (np.uint8 if size == 1
                                                               else np.uint16):
        raise ValueError("encode_mcidas takes (H, W) uint8 (size 1) or uint16 (size 2)")
    h, w = img.shape
    words = [0] * 65
    words[2] = 4
    words[9], words[10], words[11], words[14], words[15], words[34] = h, w, size, bands, \
        prefix, 256
    body = img.astype(">u1" if size == 1 else ">u2")
    line = [body] + [~body] * (bands - 1)
    rows = np.concatenate([np.zeros((h, prefix), np.uint8)]
                          + [b.view(np.uint8).reshape(h, -1) for b in line], 1)
    return struct.pack(">64i", *words[1:]) + rows.tobytes()


def write_mcidas(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_mcidas(img, **kwargs)` written to `path` (its directory made
    if needed)."""
    data = encode_mcidas(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
