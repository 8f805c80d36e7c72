"""Timing helpers of the port's measurement tools (`bench_torch.py`,
`tools/profile_raster_torch.py`, `tools/bench_playback_torch.py`).

Three readings of a call `fn()`, each over n calls:

* `host_ms`: the median over n calls of the host clock around one call
  that ends in `torch.cuda.synchronize()` — what a caller waits for. The
  port's frames and steps are host bound and the host's cores are shared,
  so single calls vary by a few ms; the median of synchronized calls is
  steadier than a mean over calls issued back to back;
* `queued_ms`: CUDA events around n calls queued behind a sleep of the card
  (`torch.cuda._sleep`), so the card's own time where the host issues the
  calls faster than the card runs them. A call that reads a value back
  (binning's `int(...)` sizes) waits there for the card, so for such a call
  it reads the host's pace as well;
* `profile`: `torch.profiler` over n calls: the device's busy ms (the sum
  of its operations' own times), the device operations (kernels, copies,
  fills) per call and the largest ones. A profiler session slows every
  later launch of the process on the host, so a tool takes its profiles
  after its host times, and reads the idle share as 1 - busy / host ms
  (`idle_share`), not from the profiled wall time.

On the CPU the device readings are None: there is no device clock to read.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

SLEEP_CYCLES = 10_000_000   # ~5 ms at an H100's clock


def card(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them
    (`--query-gpu=name,power.limit --format=csv,noheader`); on the CPU the
    torch device and None."""
    if device.type != "cuda":
        return {"name": str(device), "power_limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(device.index or 0)],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_times(fn, n: int, device: torch.device, warm: int = 1) -> list[float]:
    """Host ms of each of n calls of fn() after `warm` warm ones, each
    clock stopped after a synchronize."""
    for _ in range(warm):
        fn()
    sync(device)
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def host_ms(fn, n: int, device: torch.device, warm: int = 1) -> float:
    """Median host ms of fn() over n synchronized calls (`host_times`)."""
    return statistics.median(host_times(fn, n, device, warm))


def queued_ms(fn, n: int, device: torch.device, warm: int = 1) -> float | None:
    """Mean ms between CUDA events around n calls of fn() issued while the
    card sleeps; None on the CPU."""
    if device.type != "cuda":
        return None
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def profile(fn, n: int, device: torch.device, top: int = 8) -> dict:
    """torch.profiler over n calls of fn() -> busy_ms, device_operations and
    the profiled wall ms per call, and the `top` largest device operations
    ({name, ms, count} per call); every value None on the CPU."""
    if device.type != "cuda":
        return dict(profiled_wall_ms=None, busy_ms=None, device_operations=None,
                    largest=None)
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0)
            rows.append((us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(profiled_wall_ms=wall, busy_ms=busy,
                device_operations=sum(r[1] for r in rows),
                largest=[dict(name=k[:120], ms=ms, count=c) for ms, c, k in rows[:top]])


def idle_share(busy_ms: float | None, host_ms: float) -> float | None:
    """The share of a call's host ms in which the device is idle."""
    return None if busy_ms is None else 1.0 - busy_ms / host_ms


def kernel_launches() -> dict[str, int]:
    """The launch counters of the port's three kernel wrappers (K1, K2, K3);
    each counts the kernel's launches on CUDA tensors, none on the CPU."""
    from gaussianmesh_tpu_torch.ops import segsum, tile_blend

    return {"K1": tile_blend.blend_forward.launches,
            "K2": tile_blend.blend_backward.launches,
            "K3": segsum.segment_sum.launches}


def launches_of(fn, device: torch.device) -> dict[str, int]:
    """K1-K3 launches of one call of fn()."""
    before = kernel_launches()
    fn()
    sync(device)
    return {k: v - before[k] for k, v in kernel_launches().items()}
