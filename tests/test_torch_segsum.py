"""Layouts that reach the edges of K3 (`csrc/segment_sum.cu`): segments
of up to `segsum.LONG_SEGMENT` rows, which 4 lanes sum; longer ones, which
the whole block that holds them sums, 64 rows a pass; several long ones in
one block; and the empty cases. On the CPU the plain version
`segment_sum_plain` is held against a numpy float64 `np.add.at` on each of
them, and the wrapper's input checks are tried; `tests/test_torch_cuda.py`
holds the kernel against the plain version on the same layouts on the
card. This file imports no JAX."""

import numpy as np
import pytest
import torch

from gaussianmesh_tpu_torch.ops import segsum

torch.set_num_threads(2)

FULL_SCREEN = 120 * 68   # tiles of a 1920x1080 image: one pair per tile
BLOCK = 64               # Gaussians per block of the kernel (its kPerBlock)
LAYOUTS = ("edges", "run_at_top", "block_of_long", "dense", "m0", "n1",
           "all_dead")


def k3_layout(name: str, seed: int = 0):
    """-> rows (M, 16) f32, grouped_pos (M,) int32 (a seeded permutation of
    M, as the binning's inverse sort scatters rows), seg_starts (N + 1,)
    int32, lengths (N,) for one named layout:
      edges:         2,000 Gaussians of 0-6 pairs, and among them segments
                     of 0, 1, LONG_SEGMENT, LONG_SEGMENT + 1, BLOCK,
                     BLOCK + 1, 2 BLOCK + 1 and FULL_SCREEN pairs (the last
                     also at the highest id);
      run_at_top:    3,000 Gaussians of 0-4 pairs and a 40,000-pair run at
                     the highest destination;
      block_of_long: 1,000 Gaussians of 0-6 pairs; every Gaussian of one
                     block 33-300 pairs, and the first and last of the next
                     block 500 and 1,000;
      dense:         1,500 Gaussians of 0-128 pairs each;
      m0:            no Gaussian and no pair (only the dummy row);
      n1:            one Gaussian of 1,000 pairs;
      all_dead:      4,099 Gaussians, none with a pair (M = 0)."""
    rng = np.random.default_rng(seed)
    L = segsum.LONG_SEGMENT
    if name == "edges":
        lengths = rng.integers(0, 7, 2000)
        special = [0, 1, L, L + 1, BLOCK, BLOCK + 1, 2 * BLOCK + 1, FULL_SCREEN]
        lengths[[3, 4, 5, 6, 700, 701, 1200, 1500]] = special
        lengths[-1] = FULL_SCREEN
    elif name == "run_at_top":
        lengths = rng.integers(0, 5, 3000)
        lengths[-1] = 40_000
    elif name == "block_of_long":
        lengths = rng.integers(0, 7, 1000)
        lengths[2 * BLOCK:3 * BLOCK] = rng.integers(L + 1, 301, BLOCK)
        lengths[[3 * BLOCK, 4 * BLOCK - 1]] = [500, 1000]
    elif name == "dense":
        lengths = rng.integers(0, 129, 1500)
    elif name == "m0":
        lengths = np.zeros(0, np.int64)
    elif name == "n1":
        lengths = np.array([1000])
    elif name == "all_dead":
        lengths = np.zeros(4099, np.int64)
    else:
        raise ValueError(name)
    m = int(lengths.sum())
    rows = rng.normal(size=(m, segsum.FEAT)).astype(np.float32)
    grouped_pos = rng.permutation(m).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return rows, grouped_pos, starts, lengths


def reference(rows, grouped_pos, lengths):
    """float64 np.add.at of each emission pair's row into its Gaussian."""
    out = np.zeros((lengths.shape[0] + 1, rows.shape[1]))
    dest = np.repeat(np.arange(lengths.shape[0]), lengths)
    np.add.at(out, dest, rows[grouped_pos].astype(np.float64))
    return out


def assert_column_close(out, ref, rel=1e-6):
    """|out - ref| <= rel x each column's largest |ref| (the smoke's K3 bar)."""
    ref = np.asarray(ref, np.float64)
    col = np.maximum(np.abs(ref).max(0, initial=0.0), 1e-30)
    err = np.abs(np.asarray(out, np.float64) - ref) / col
    assert err.max(initial=0.0) <= rel, err.max()


@pytest.mark.parametrize("name", LAYOUTS)
def test_segment_sum_plain_layouts(name):
    rows, gp, starts, lengths = k3_layout(name)
    out = segsum.segment_sum_plain(torch.tensor(rows), torch.tensor(gp),
                                   torch.tensor(starts)).numpy()
    assert out.shape == (lengths.shape[0] + 1, segsum.FEAT)
    assert (out[-1] == 0).all()
    assert_column_close(out, reference(rows, gp, lengths))
    # the wrapper takes the plain version on CPU tensors
    again = segsum.segment_sum(torch.tensor(rows), torch.tensor(gp),
                               torch.tensor(starts)).numpy()
    assert np.array_equal(out, again)


@pytest.mark.parametrize("name", LAYOUTS)
def test_segment_starts_is_exclusive_cumsum(name):
    """`segment_starts` turns per-Gaussian pair counts into the (N + 1,)
    int32 starts K3 and its plain version read, total last."""
    _, _, starts, lengths = k3_layout(name)
    got = segsum.segment_starts(torch.tensor(lengths, dtype=torch.int32))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), starts)


BAD_INPUTS = {
    "rows_float64": lambda r, g, s: (r.double(), g, s),
    "rows_15_columns": lambda r, g, s: (r[:, :15], g, s),
    "grouped_pos_int64": lambda r, g, s: (r, g.long(), s),
    "seg_starts_2d": lambda r, g, s: (r, g, s[None]),
    "grouped_pos_short": lambda r, g, s: (r, g[:-1], s),
    "seg_starts_empty": lambda r, g, s: (r, g, s[:0]),
    "devices_differ": lambda r, g, s: (r.to("meta"), g, s),
    "neither_cpu_nor_cuda": lambda r, g, s: (r.to("meta"), g.to("meta"),
                                             s.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_segment_sum_rejects_malformed_inputs(case):
    """The wrapper raises on inputs the kernel cannot read (wrong dtype,
    width or length, tensors on different devices, a device that is
    neither the CPU nor CUDA) instead of launching on them."""
    rows, gp, starts, _ = (torch.tensor(x) for x in k3_layout("n1"))
    with pytest.raises(ValueError):
        segsum.segment_sum(*BAD_INPUTS[case](rows, gp, starts))
