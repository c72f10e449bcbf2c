"""Greedy NMS keep mask over score-sorted boxes, batched over images.

Boxes [B, N, 4] (or [N, 4]) xyxy, already sorted by score within each image,
a validity row [B, N] and one IoU threshold give keep [B, N] bool: walking
the boxes in order, a box that no kept box has suppressed is kept and
suppresses every later box j with

    inter / max(area_j + area_i - inter, 1e-6) > thr        (strict),

areas and intersections clamped at 0; invalid slots start suppressed and a
suppressed box suppresses nothing. The CUDA kernels (`csrc/nms.cu`) replace
the Pallas kernel of `clipself_tpu/ops/nms_pallas.py`: one builds the
[N, ceil(N / 64)] bit matrix of "j > i and iou(i, j) > thr" on the whole
card, one scans it a block of 64 boxes at a time, one thread block an image.
`nms_keep_mask_plain` is the same function in plain PyTorch, one rounded
float32 operation at a time in the same operand order, one step a box;
`nms_keep_mask_blockwise_plain` mirrors the kernels' two phases (the boolean
matrix from the same operations, then the block-of-64 scan). The three masks
are equal, not merely close.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises. There is no size rule: the JAX package takes its kernel
only from 256 boxes up, a tuning rule of the TPU.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()  # calls of the wrapper that reached the card
BLOCK = 64  # boxes a word of the bit matrix, and a block of the scan
MAX_BOXES = 131072  # an image: the scan keeps a bit a box in shared memory


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


def suppression_matrix_plain(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """over [B, N, N] bool: over[b, i, j] iff j > i and iou(i, j) > thr, from
    the single rounded operations of `nms_keep_mask_plain` (what the matrix
    kernel packs into 64-bit words)."""
    n = boxes.shape[1]
    x0, y0, x1, y1 = (c[:, None, :] for c in boxes.float().unbind(-1))  # the later box j
    area = torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)
    xi0, yi0, xi1, yi1, area_i = (c.transpose(1, 2) for c in (x0, y0, x1, y1, area))
    iw = torch.clamp(torch.minimum(x1, xi1) - torch.maximum(x0, xi0), min=0.0)
    ih = torch.clamp(torch.minimum(y1, yi1) - torch.maximum(y0, yi0), min=0.0)
    inter = iw * ih
    iou = inter / torch.clamp(area + area_i - inter, min=1e-6)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    return (iou > thr) & later


def nms_keep_mask_blockwise_plain(
    sorted_boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The kernels' algorithm in plain PyTorch, on any device: the boolean
    suppression matrix, then for each block of 64 boxes in order 64 short
    steps over the block's diagonal square (a box whose bit of `removed` is
    clear is kept and ORs its diagonal row in) and one OR of the kept boxes'
    rows into the later boxes' `removed`."""
    boxes, valid, single = _batched(sorted_boxes, valid)
    n = boxes.shape[1]
    over = suppression_matrix_plain(boxes, iou_threshold)
    removed = ~valid.bool()
    keep = torch.zeros_like(removed)
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        cur = removed[:, lo:hi].clone()
        for r in range(hi - lo):
            # bit r is final: only the rows before it reach it
            cur |= over[:, lo + r, lo:hi] & ~cur[:, r : r + 1]
        kept = ~cur
        keep[:, lo:hi] = kept
        removed[:, hi:] |= (over[:, lo:hi, hi:] & kept[:, :, None]).any(dim=1)
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
    if n > MAX_BOXES:
        raise ValueError(f"nms_keep_mask: {n} boxes an image exceed the {MAX_BOXES} it takes")
    boxes = boxes.float().contiguous()
    valid = valid.contiguous()
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep[0] if single else keep
    # the bit matrix: scratch between the two kernels; the words left of a
    # row's diagonal word are neither written nor read
    matrix = torch.empty((b, n, (n + BLOCK - 1) // BLOCK), dtype=torch.int64, device=boxes.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(boxes.device):
        err = lib.clipself_nms(
            boxes.data_ptr(), valid.data_ptr(), float(iou_threshold), matrix.data_ptr(),
            keep.data_ptr(), b, n, _build.stream_handle(boxes),
        )
    _build.check(err, "nms launch")
    LAUNCHES.add()
    return keep[0] if single else keep
