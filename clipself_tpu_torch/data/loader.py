"""Training data for the distill step (a port of the synthetic part of
`clipself_tpu/data/loader.py`; the COCO datasets and the native loader are
not ported yet, ROADMAP.md queue 1 item 2)."""

from __future__ import annotations

import numpy as np


class SyntheticDistillData:
    """Deterministic synthetic batches shaped like GridDistillDataset items,
    the same `default_rng(seed)` draws as `clipself_tpu/data/loader.py:205-222`:
    images [B, S, S, 3], boxes [B, M, 5] (xyxy in [0, 1], valid = 1), crops
    [B, M, s, s, 3], float32 NumPy. Iterating repeats the one batch."""

    def __init__(self, batch_size=2, det_size=1024, crop_size=224, max_anns=20, seed=0):
        rng = np.random.default_rng(seed)
        b, m = batch_size, max_anns
        lo = rng.uniform(0, 0.5, (b, m, 2)).astype(np.float32)
        hi = np.clip(lo + rng.uniform(0.05, 0.5, (b, m, 2)), 0, 1).astype(np.float32)
        self.batch = {
            "images": rng.normal(size=(b, det_size, det_size, 3)).astype(np.float32),
            "boxes": np.concatenate([lo, hi, np.ones((b, m, 1), np.float32)], -1),
            "crops": rng.normal(size=(b, m, crop_size, crop_size, 3)).astype(np.float32),
        }

    def __iter__(self):
        while True:
            yield self.batch
