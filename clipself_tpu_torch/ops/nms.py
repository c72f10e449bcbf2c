"""Greedy NMS keep mask over score-sorted boxes, batched over images.

Boxes [B, N, 4] (or [N, 4]) xyxy, already sorted by score within each image,
a validity row [B, N] and one IoU threshold give keep [B, N] bool: walking
the boxes in order, a box that no kept box has suppressed is kept and
suppresses every later box j with

    inter / max(area_j + area_i - inter, 1e-6) > thr        (strict),

areas and intersections clamped at 0; invalid slots start suppressed and a
suppressed box suppresses nothing. The CUDA kernel (`csrc/nms.cu`) replaces
the Pallas kernel of `clipself_tpu/ops/nms_pallas.py`; `nms_keep_mask_plain`
is the same function in plain PyTorch, one rounded float32 operation at a
time in the same operand order, so the two masks are equal, not merely close.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises. There is no size rule: the JAX package takes its kernel
only from 256 boxes up, a tuning rule of the TPU.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()
# Threads of the one block that walks an image (fewer where the boxes are fewer):
# each kept box costs a barrier and ceil(remaining / threads) IoUs a thread,
# all on one SM; on an H100 1024 threads measured fastest at 2000 boxes.
MAX_THREADS = 1024


def _batched(boxes: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, bool]:
    single = boxes.dim() == 2
    if single:
        boxes, valid = boxes[None], valid[None]
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"nms_keep_mask: boxes {tuple(boxes.shape)} must be [B, N, 4] or [N, 4] and valid "
            f"{tuple(valid.shape)} its leading dims"
        )
    return boxes, valid, single


def nms_keep_mask_plain(
    sorted_boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Plain PyTorch version, on any device: one step per box, every image
    of the batch at once."""
    boxes, valid, single = _batched(sorted_boxes, valid)
    n = boxes.shape[1]
    x0, y0, x1, y1 = boxes.float().unbind(-1)  # each [B, N]
    area = torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    sup = ~valid.bool()
    for i in range(n - 1):
        live = ~sup[:, i : i + 1]  # [B, 1]: box i is kept in these images
        j = slice(i + 1, n)
        iw = torch.clamp(
            torch.minimum(x1[:, j], x1[:, i : i + 1]) - torch.maximum(x0[:, j], x0[:, i : i + 1]),
            min=0.0,
        )
        ih = torch.clamp(
            torch.minimum(y1[:, j], y1[:, i : i + 1]) - torch.maximum(y0[:, j], y0[:, i : i + 1]),
            min=0.0,
        )
        inter = iw * ih
        iou = inter / torch.clamp(area[:, j] + area[:, i : i + 1] - inter, min=1e-6)
        sup[:, j].logical_or_((iou > thr) & live)
    keep = ~sup
    return keep[0] if single else keep


def nms_keep_mask(
    sorted_boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """keep [B, N] (or [N]) bool for score-sorted boxes [B, N, 4] (or
    [N, 4]) with validity [B, N]; boxes are read as float32."""
    if sorted_boxes.device.type == "cpu":
        return nms_keep_mask_plain(sorted_boxes, valid, iou_threshold)
    if sorted_boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_mask: unsupported device {sorted_boxes.device}")
    boxes, valid, single = _batched(sorted_boxes, valid)
    if valid.device != boxes.device:
        raise ValueError(f"nms_keep_mask: valid on {valid.device}, boxes on {boxes.device}")
    if valid.dtype != torch.bool:
        raise TypeError(f"nms_keep_mask: valid must be bool, got {valid.dtype}")
    b, n = valid.shape
    lib = _build.LIBRARY.get()
    if n > lib.clipself_nms_max_boxes():
        raise ValueError(
            f"nms_keep_mask: {n} boxes an image exceed the {lib.clipself_nms_max_boxes()} that "
            "one block's shared memory holds"
        )
    boxes = boxes.float().contiguous()
    valid = valid.contiguous()
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep[0] if single else keep
    threads = min(MAX_THREADS, 32 * ((n + 31) // 32))
    with torch.cuda.device(boxes.device):
        err = lib.clipself_nms(
            boxes.data_ptr(), valid.data_ptr(), float(iou_threshold), keep.data_ptr(),
            b, n, threads, _build.stream_handle(boxes),
        )
    _build.check(err, "nms launch")
    LAUNCHES.add()
    return keep[0] if single else keep
