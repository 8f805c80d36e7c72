"""Whole-training-state checkpoints (port of `gaussianmesh_tpu/utils/checkpoint.py`;
the reference saved a tuple with jt.save at --checkpoint_iterations,
train_mesh_gaussian.py:133-135).

A checkpoint is `torch.save` of a trainer's `capture()`: a host tree of
plain dicts, CPU tensors and ints (the generator state is a uint8
tensor), read back with `torch.load(..., weights_only=True)`, which accepts
nothing else.

The Gaussian-table-sharded trainer writes per-rank checkpoints in place of
the JAX package's orbax directory (`path + ".orbax"`): a directory `path +
".shards"` (`shard_dir`) holding

- `rank<r>.pt`, written by rank r: its shard of the per-row trees
  (`ROW_TREES`: parameters, binding, statistics, both Adam moments), the
  rows [r C / D, (r + 1) C / D) of the table;
- `replicated.pt`, written by rank 0: the rest of the capture (the vertex
  pool, the step counters, the generator state);
- `index.json`, written by rank 0: {"world": D, "capacity": C}.

A trainer of the same D reads its own rank file and the replicated one; any
other D, a single process included, reads every rank file and cuts the
joined table again (`load_checkpoint_sharded`).
"""

from __future__ import annotations

import json
import os

import torch

# the capture's trees with one entry per Gaussian row; the rest is replicated
ROW_TREES = ("params", "binding", "state", "mu", "nu")


def save_checkpoint(path: str, tree: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(tree, path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def shard_dir(path: str) -> str:
    return path + ".shards"


def rows_of(tree: dict) -> int:
    return tree["binding"]["alive"].shape[0]


def shard_rows(tree: dict, rank: int, world: int) -> dict:
    """Rank's contiguous slice [r C / D, (r + 1) C / D) of a capture's
    per-row trees; the other entries as they are. C must split into D."""
    c = rows_of(tree)
    if c % world:
        raise ValueError(f"{c} rows do not split into {world} shards")
    lo, hi = rank * c // world, (rank + 1) * c // world
    return {k: ({f: x[lo:hi] for f, x in v.items()} if k in ROW_TREES else v)
            for k, v in tree.items()}


def join_shards(shards: list[dict]) -> dict:
    """The per-row trees of D shards concatenated in rank order."""
    return {k: {f: torch.cat([s[k][f] for s in shards]) for f in shards[0][k]}
            for k in ROW_TREES}


def save_checkpoint_sharded(path: str, tree: dict, rank: int, world: int) -> None:
    """Rank's part of a per-rank checkpoint in the directory `path`: `tree`
    is its `capture()` (its shard's rows and the replicated state)."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: tree[k] for k in ROW_TREES}, os.path.join(path, f"rank{rank}.pt"))
    if rank == 0:
        torch.save({k: v for k, v in tree.items() if k not in ROW_TREES},
                   os.path.join(path, "replicated.pt"))
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump({"world": world, "capacity": world * rows_of(tree)}, f)


def load_checkpoint_sharded(path: str, rank: int = 0, world: int = 1) -> dict:
    """The capture of rank `rank` of `world` from the per-rank checkpoint in
    `path` (world 1: the whole table)."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    tree = load_checkpoint(os.path.join(path, "replicated.pt"))
    if world == index["world"]:
        return {**tree, **load_checkpoint(os.path.join(path, f"rank{rank}.pt"))}
    joined = join_shards([load_checkpoint(os.path.join(path, f"rank{r}.pt"))
                          for r in range(index["world"])])
    return shard_rows({**tree, **joined}, rank, world)
