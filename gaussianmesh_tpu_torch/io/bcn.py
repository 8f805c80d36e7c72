"""Block-compressed (BCn) textures in the port's own decoders, to the arrays
PIL 12's C `bcn` decoder gives (the JAX reader opens dataset images with
PIL; the machines the port runs on have none).

`decode_bc1` decodes BC1 (DXT1) blocks to RGBA, as PIL's `bcn` decoder
does in mode 1 (`Image.frombytes("RGBA", size, data, "bcn", (1,))`): 8
bytes a 4 x 4 tile, tiles row-major, two little-endian 565 colours whose
channels replicate their high bits into the low ones (31 reads 255), then
2-bit indices, the first pixel in the low bits. Where the first colour's
word is over the second's the block has four opaque colours, the two and
their thirds; otherwise three, the two and their half, and transparent
black. Pixels of the right and bottom tiles past the image are dropped. A
file holding fewer whole blocks than the image needs raises, as PIL's
"image file is truncated".

The blocks are decoded by the port's C++ (`gm_bc1_decode` of
`csrc/image.cpp`, built by `ops/_cuda.py::host_library` at first use; a
failed build raises). `_bc1_plain` is the same rule in numpy, the version
the C++ is held to byte for byte; the training path never calls it.
BC2-BC7 (DDS, BLP) are still to come, beside these.

`encode_bc1` writes BC1 blocks of an RGB image (each tile's colour box
corners as its two colours, every pixel the nearest of the four along
the line between them), for the tests and `chip_smoke.py`; the training
path does not write textures.
"""

from __future__ import annotations

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda


def bc1_blocks(width: int, height: int) -> int:
    """The BC1 blocks a width x height image takes."""
    return ((width + 3) // 4) * ((height + 3) // 4)


def _check(data: bytes, width: int, height: int, path: str) -> None:
    need = 8 * bc1_blocks(width, height)
    if len(data) < need:
        raise ValueError(f"{path}: BC1 data holds {len(data)} of {need} bytes (PIL: image "
                         "file is truncated)")


def decode_bc1(data: bytes, width: int, height: int, path: str = "<bytes>") -> np.ndarray:
    """BC1 blocks -> uint8 (height, width, 4) RGBA (`gm_bc1_decode`)."""
    _check(data, width, height, path)
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    info = np.zeros(1, np.int64)
    status = _cuda.host_library("image").gm_bc1_decode(src.ctypes.data, len(src), width,
                                                       height, out.ctypes.data,
                                                       info.ctypes.data)
    if status:
        raise RuntimeError(f"gm_bc1_decode returned {status}")
    return out


def _expand565(v: np.ndarray) -> np.ndarray:
    """uint16 565 words -> int32 (..., 3), each channel's high bits
    replicated into its low ones."""
    v = v.astype(np.int32)
    r, g, b = v >> 11 & 31, v >> 5 & 63, v & 31
    return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2], -1)


def _palettes(c0: np.ndarray, c1: np.ndarray) -> np.ndarray:
    """Each block's four colours as PIL's `decode_bc1_color` makes them ->
    int32 (n, 4, 4) RGBA."""
    p0, p1 = _expand565(c0), _expand565(c1)
    four = (c0 > c1)[:, None]
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    rgb = np.stack([p0, p1, p2, p3], 1)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.int32)
    alpha[:, 3, 0] = np.where(four[:, 0], 255, 0)
    return np.concatenate([rgb, alpha], 2)


def _bc1_plain(data: bytes, width: int, height: int, path: str = "<bytes>") -> np.ndarray:
    """`decode_bc1` in numpy (the plain version)."""
    _check(data, width, height, path)
    bw, bh = (width + 3) // 4, (height + 3) // 4
    blocks = np.frombuffer(data, np.uint8, 8 * bw * bh).reshape(-1, 8)
    words = blocks.view("<u2")
    lut = blocks[:, 4:].copy().view("<u4")[:, 0]
    idx = (lut[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    pal = _palettes(words[:, 0], words[:, 1])
    px = np.take_along_axis(pal, idx[..., None].astype(np.int64), 1)   # (n, 16, 4)
    tiles = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, 4)
    return np.ascontiguousarray(tiles[:height, :width].astype(np.uint8))


def encode_bc1(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """uint8 (H, W, 3) RGB -> (its BC1 blocks, the RGBA they decode to).
    Each tile's colours are the 565 corners of its colour box, the larger
    word first (four opaque colours; a flat tile one), each pixel the
    nearest of them along the line between the two; the edge tiles repeat
    their last row and column."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_bc1 takes (H, W, 3) RGB images")
    h, w = img.shape[:2]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    pad = np.pad(img, ((0, 4 * bh - h), (0, 4 * bw - w), (0, 0)), mode="edge")
    tiles = pad.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    tiles = tiles.astype(np.int32)

    def word(c):
        r, g, b = (c[:, k] for k in range(3))
        q = ((r * 31 + 127) // 255) << 11 | ((g * 63 + 127) // 255) << 5 | (b * 31 + 127) // 255
        return q.astype(np.uint16)
    c0, c1 = word(tiles.max(1)), word(tiles.min(1))
    pal = _palettes(c0, c1)
    # the nearest of the four colours along the line from c1 to c0 (thirds)
    d = pal[:, 0, :3] - pal[:, 1, :3]
    along = ((tiles - pal[:, 1, None, :3]) * d[:, None, :]).sum(2)
    step = np.rint(3 * along / np.maximum((d * d).sum(1), 1)[:, None])
    idx = np.array([1, 3, 2, 0], np.uint32)[np.clip(step, 0, 3).astype(np.int64)]
    idx[c0 == c1] = 0                   # one colour: no index past it
    lut = (idx << (2 * np.arange(16, dtype=np.uint32))).sum(1, dtype=np.uint32)
    blocks = np.empty((len(tiles), 8), np.uint8)
    blocks[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = lut.astype("<u4").view(np.uint8).reshape(-1, 4)
    px = np.take_along_axis(pal, idx[..., None].astype(np.int64), 1)
    rgba = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, 4)
    return blocks.tobytes(), np.ascontiguousarray(rgba[:h, :w].astype(np.uint8))
