"""Training meters, a copy of `clipself_tpu/utils/meters.py` (reference
`AverageMeter`, `src/training/train.py:14-30`, and the samples/s logging at
`train.py:143-151`)."""

from __future__ import annotations

import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class ThroughputMeter:
    """images/sec since the last window() call. The caller synchronises the
    device before reading it (CUDA work is asynchronous)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int):
        self._images += n_images

    def window(self) -> float:
        """images/sec over the window since the previous window()/reset(),
        then start a new window."""
        ips = self.images_per_sec
        self.reset()
        return ips

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0
