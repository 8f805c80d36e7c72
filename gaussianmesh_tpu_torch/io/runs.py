"""Runs of equal values within the rows of an image, in numpy, for the
run-length writers (TIFF's PackBits in `io/tiff.py`, BMP's RLE8 and RLE4 in
`io/bmp.py`), which the tests and `chip_smoke.py` use; the training path
reads such files and never writes them."""

from __future__ import annotations

import numpy as np


def _chunks(start: np.ndarray, length: np.ndarray, most: int):
    """Spans (start, length) cut into pieces of at most `most`."""
    n = -(-length // most)
    first = np.cumsum(n) - n
    which = np.repeat(np.arange(len(start)), n)
    k = np.arange(int(n.sum())) - first[which]
    return start[which] + k * most, np.minimum(most, length[which] - k * most)


def segments(rows: np.ndarray, min_run: int, max_run: int, max_literal: int):
    """rows (H, W) -> the spans of the flattened rows, in order, none
    crossing a row's end: (start, length, is_run). A run is `min_run` or
    more equal values (cut into pieces of at most `max_run`); the values
    between runs of one row form literal spans of at most `max_literal`."""
    h, w = rows.shape
    x = rows.ravel()
    new = np.ones(x.size, bool)
    new[1:] = x[1:] != x[:-1]
    new[::w] = True
    start = np.flatnonzero(new)
    length = np.diff(np.append(start, x.size))
    run = length >= min_run
    # consecutive literal runs of one row make one literal span
    lit_start = ~run & np.append(True, run[:-1] | (start[1:] % w == 0))
    group = np.cumsum(lit_start)[~run] - 1
    l_start = start[~run][lit_start[~run]]
    l_len = np.bincount(group, length[~run], minlength=len(l_start)).astype(np.int64)
    r_start, r_len = _chunks(start[run], length[run], max_run)
    l_start, l_len = _chunks(l_start, l_len, max_literal)
    s = np.concatenate([r_start, l_start])
    order = np.argsort(s, kind="stable")
    return (s[order], np.concatenate([r_len, l_len])[order],
            np.concatenate([np.ones(len(r_start), bool), np.zeros(len(l_start), bool)])[order])


def assemble(x: np.ndarray, start, head: np.ndarray, head_len, take, pad,
             step: int = 1) -> np.ndarray:
    """The bytes of spans -> uint8: span i is head[i, :head_len[i]], then
    take[i] values x[start[i] + step * j], then pad[i] zero bytes."""
    size = head_len + take + pad
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    for j in range(head.shape[1]):
        has = head_len > j
        out[at[has] + j] = head[has, j]
    which = np.repeat(np.arange(len(start)), take)
    j = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
    out[at[which] + head_len[which] + j] = x[start[which] + step * j]
    return out
