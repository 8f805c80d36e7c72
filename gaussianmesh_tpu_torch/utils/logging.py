"""Observability: tensorboard scalars, images and histograms, a profiler
hook and a step timer (port of `gaussianmesh_tpu/utils/logging.py`).

The reference logs through tensorboardX when it imports
(train_mesh_gaussian.py:25-29, 176-211); here too, and stdout alone where
it does not. `profile_trace` wraps `torch.profiler` (device activity when a
card is present) and writes a Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TrainLogger:
    """A thin tensorboardX writer under <model_path>/tb that degrades to
    nothing (the trainers print their own progress) without tensorboardX."""

    def __init__(self, model_path: str):
        self.writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print("[log] tensorboardX unavailable: stdout only")
        else:
            self.writer = SummaryWriter(os.path.join(model_path, "tb"))

    def scalars(self, step: int, values: dict) -> None:
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), step)

    def image(self, step: int, tag: str, chw) -> None:
        """A (C, H, W) image in [0, 1] (clipped), a tensor or an array."""
        if self.writer is None:
            return
        self.writer.add_image(tag, np.clip(_numpy(chw), 0, 1), step)

    def histogram(self, step: int, tag: str, values) -> None:
        if self.writer is None:
            return
        self.writer.add_histogram(tag, _numpy(values), step)

    def close(self) -> None:
        """Flush and close; later `scalars` calls do nothing."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """`torch.profiler` over the block (CPU, and CUDA when a card is
    present), its Chrome trace written to log_dir/trace.json; a no-op when
    log_dir is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling per-step host wall-clock statistics for progress reporting
    (a step's device work finishes later unless the caller synchronizes)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: list[float] = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1e3 * (sum(self.times) / max(len(self.times), 1))
