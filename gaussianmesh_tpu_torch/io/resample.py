"""PIL's default resize without PIL (the JAX reader resizes with
`PIL.Image.resize`, whose default filter is BICUBIC for L, LA, RGB and
RGBA; the machines the port runs on have no PIL).

`resize` follows Pillow 12's `Resample.c` to the same bits:

- per output pixel, the bicubic kernel (a = -0.5) over a support widened
  by the downscale factor, evaluated in float64 at the source pixel
  centres, normalised by its sum, then rounded to fixed point with 22
  fraction bits (half away from zero);
- a horizontal pass, then a vertical one, each accumulating in int32 from
  a rounding offset of 2^21 and clipped to uint8 (a pass is skipped where
  its size does not change);
- LA and RGBA resized premultiplied by alpha (PIL's `La` / `RGBa` modes,
  rounded as `MULDIV255`) and divided back after, as `Image.resize` does.

`resize` runs each pass in the port's C++ (`gm_resample_pass` of
`csrc/image.cpp`, built by `ops/_cuda.py::host_library` at first use; a
failed build raises); the coefficients and the alpha steps stay here in
numpy. `resize_plain` runs the passes in numpy too (`_pass_plain`, one
vectorised step per filter tap): the version the C++ is held to byte for
byte, which the training path never calls.
"""

from __future__ import annotations

import math

import numpy as np

from gaussianmesh_tpu_torch.ops import _cuda

PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0                          # bicubic


def _bicubic(x: np.ndarray) -> np.ndarray:
    """`bicubic_filter` of Resample.c with a = -0.5, its operation order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def coefficients(in_size: int, out_size: int):
    """`precompute_coeffs` + `normalize_coeffs_8bpc` for the full box ->
    (first source index (out,), int32 weights (out, ksize)), a weight of 0
    past each output's last source pixel."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):              # the C loop's summation order
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5 + w * (1 << PRECISION_BITS),
                              0.5 + w * (1 << PRECISION_BITS)))
    return xmin, fixed.astype(np.int32)


def _pass_plain(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` of an (H, W, C) uint8 image, in numpy."""
    xmin, k = coefficients(img.shape[axis], out_size)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0))     # gathered as uint8
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    last = img.shape[axis] - 1
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for x in range(k.shape[1]):
        acc += src[np.minimum(xmin + x, last)] * k[:, x].reshape(shape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)     # clip8
    return np.moveaxis(out, 0, axis)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """`_pass_plain` in `csrc/image.cpp` (`gm_resample_pass`)."""
    xmin, k = coefficients(img.shape[axis], out_size)
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    out = np.empty((out_size, w, c) if axis == 0 else (h, out_size, c), np.uint8)
    xmin = np.ascontiguousarray(xmin, np.int32)
    k = np.ascontiguousarray(k)
    status = _cuda.host_library("image").gm_resample_pass(
        img.ctypes.data, h, w, c, axis, out_size, xmin.ctypes.data, k.ctypes.data,
        k.shape[1], out.ctypes.data)
    if status:
        raise RuntimeError(f"gm_resample_pass returned {status}")
    return out


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) gray or (H, W, C) with C in 1-4 (L, LA, RGB, RGBA) ->
    the (th, tw) image `PIL.Image.resize((tw, th))` gives; `img` itself
    where it already has that size."""
    return _resize(img, size, _pass)


def resize_plain(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`resize` with both passes in numpy (the plain version)."""
    return _resize(img, size, _pass_plain)


def _resize(img: np.ndarray, size: tuple[int, int], one_pass) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8, not {img.dtype}")
    tw, th = (int(s) for s in size)
    if tw < 1 or th < 1:
        raise ValueError(f"resize to {tw}x{th}")
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    h, w, c = x.shape
    if c not in (1, 2, 3, 4):
        raise ValueError(f"resize takes 1-4 channels, not {c}")
    if (tw, th) == (w, h):
        return img
    alpha = c in (2, 4)
    if alpha:                           # RGBA -> RGBa, LA -> La
        a = x[..., -1:].astype(np.int32)
        x = np.concatenate([_muldiv255(x[..., :-1], a), x[..., -1:]], -1)
    if tw != w:
        x = one_pass(x, tw, 1)
    if th != h:
        x = one_pass(x, th, 0)
    if alpha:                           # back, as rgba2rgbA / La2LA
        a = x[..., -1:].astype(np.int32)
        color = x[..., :-1].astype(np.int32)
        div = np.clip(255 * color // np.maximum(a, 1), 0, 255)
        x = np.concatenate([np.where((a == 255) | (a == 0), color, div).astype(np.uint8),
                            x[..., -1:]], -1)
    return x[..., 0] if gray else x
