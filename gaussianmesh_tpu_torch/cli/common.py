"""Shared command-line plumbing (port of `gaussianmesh_tpu/cli/common.py`):
the parser of every parameter group plus `--device`, and PNG output.

PNGs are written and read with `zlib` and `struct` alone (8-bit RGB, one
IDAT chunk, filter type 0 on every row): the machines the port runs on need
no imaging package.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch

from gaussianmesh_tpu_torch import config as cfg_mod

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    for cls in cfg_mod.GROUPS.values():
        cfg_mod.add_group(p, cls)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def to_uint8(color) -> np.ndarray:
    """(3, H, W) float in [0, 1] -> (H, W, 3) uint8, truncated as the JAX
    command line's images are."""
    arr = color.detach().cpu().numpy() if torch.is_tensor(color) else np.asarray(color)
    return (np.clip(arr, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A PNG as `write_png` writes it -> (H, W, 3) uint8; other PNGs raise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters other than type 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_image(path: str, color) -> None:
    """(3, H, W) float image -> PNG (RGB; the reference's render.py wrote BGR
    through cv2)."""
    write_png(path, to_uint8(color))
