"""Process-group bootstrap and per-process data slicing (port of
`gaussianmesh_tpu/parallel/multihost.py` on `torch.distributed`).

- `initialize()` joins the process group that torchrun describes
  (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`); in a
  single-process run it does nothing, so entry points call it
  unconditionally. `nccl` for CUDA, `gloo` for the CPU, unless the caller
  names the backend; `nccl` with more ranks on a host than cards raises.
  A rank takes card `LOCAL_RANK` before it joins, and under `nccl` hands
  that card to the group (`device_id`), so the group's communicators and
  every barrier run on it.
- `process_camera_slice(n)` is the contiguous camera range this process
  loads.

Every group gets the timeout `group_timeout()`: `GM_DIST_TIMEOUT` seconds,
600 by default, so a hung collective fails instead of waiting.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


def group_timeout() -> timedelta:
    return timedelta(seconds=float(os.environ.get("GM_DIST_TIMEOUT", "600")))


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize(backend: str | None = None) -> bool:
    """Join torchrun's process group; -> True when this is a multi-process
    run. With CUDA present, a rank takes card LOCAL_RANK % device_count
    (LOCAL_RANK itself under nccl, which needs a card per rank)."""
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1 or dist.is_initialized():
        return dist.is_initialized()
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    local_rank = _env_int("LOCAL_RANK", 0)
    if backend == "nccl":
        cards = torch.cuda.device_count() if cuda else 0
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        if local_world > cards:
            raise RuntimeError(
                f"nccl needs a card per rank: {local_world} ranks on this host, "
                f"{cards} cards (name the gloo backend to share a card)")
    bound = {}
    if cuda:
        card = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            bound["device_id"] = card
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=world, rank=_env_int("RANK", 0),
                            timeout=group_timeout(), **bound)
    return True


def process_camera_slice(n_cameras: int) -> tuple[int, int]:
    """[start, end) of the cameras this process loads: a contiguous split
    over the world, the remainder going to the leading ranks."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    base, rem = divmod(n_cameras, p)
    start = i * base + min(i, rem)
    return start, start + base + (1 if i < rem else 0)


def is_writer() -> bool:
    """True on the rank that writes files and logs (rank 0, or a single
    process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing in a single process); under nccl on this
    rank's current card."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
