"""The greedy-NMS kernel's time against its block size, on one CUDA card.

    python -m clipself_tpu_torch.tools.nms_times

Times `ops.nms.nms_keep_mask` (CUDA events, mean of 20 launches after a
warm-up) at the detector's shapes (8 x 2000 RPN-like candidates at IoU 0.7,
8 x 2000 class-offset candidates at 0.4, one image) with the block capped at
128, 256, 512 and 1024 threads, and checks every mask against the 1024-thread
one. The first line names the card and its power limit. `ops/nms.py` ships
the cap that measured fastest.
"""

from __future__ import annotations

import subprocess

import torch

from clipself_tpu_torch.detector.data import synthetic_nms_case
from clipself_tpu_torch.ops import nms

CASES = (("anchors", 8, 0.7), ("class_offset", 8, 0.4), ("anchors", 1, 0.7))
BLOCK_SIZES = (1024, 512, 256, 128)


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("nms_times: no CUDA device is available")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    shipped, out = nms.MAX_THREADS, {}
    try:
        for seed, (kind, b, thr) in enumerate(CASES):
            boxes, valid = (t.to(dev) for t in synthetic_nms_case(kind, b, 2000, seed))
            want = None
            for threads in BLOCK_SIZES:
                nms.MAX_THREADS = threads
                keep = nms.nms_keep_mask(boxes, valid, thr)  # warm-up
                want = keep if want is None else want
                if not torch.equal(keep, want):
                    raise RuntimeError(f"{kind}: the mask changed with {threads} threads")
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    nms.nms_keep_mask(boxes, valid, thr)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 20
                out[f"{kind} [{b}, 2000] thr {thr}, {threads} threads"] = ms
                print(
                    f"nms {kind} [{b}, 2000, 4] thr {thr}: {threads} threads {ms:.4f} ms, kept "
                    f"{keep.sum(dim=1).tolist()}",
                    flush=True,
                )
    finally:
        nms.MAX_THREADS = shipped
    return out


if __name__ == "__main__":
    main()
