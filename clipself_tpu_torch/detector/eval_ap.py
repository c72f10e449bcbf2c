"""COCO-protocol detection AP evaluation, pure NumPy: a copy of
`clipself_tpu/detector/eval_ap.py`, pinned equal to the original by
`tests/test_torch_detector_eval.py`.

Re-implements the COCOeval bbox/segm protocol the reference gets from
pycocotools via mmdet (`F-ViT/datasets/coco_ov.py:158-380`): greedy
score-ordered matching per (image, class) at IoU thresholds .5:.05:.95,
101-point interpolated precision, maxDets=100, plus the open-vocabulary
report — per-class AP50 averaged over base (seen) and novel (unseen) groups
(`coco_ov.py:350-374`) and LVIS-style rare/common/frequent means.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU [D, G]; crowd gt uses intersection-over-det area (COCO convention)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _mask_iou_matrix(det_masks, gt_masks, iscrowd) -> np.ndarray:
    if len(det_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(det_masks), len(gt_masks)))
    d = np.asarray([m.reshape(-1).astype(bool) for m in det_masks])
    g = np.asarray([m.reshape(-1).astype(bool) for m in gt_masks])
    inter = (d[:, None] & g[None, :]).sum(-1).astype(np.float64)
    union = (d[:, None] | g[None, :]).sum(-1).astype(np.float64)
    area_d = d.sum(-1).astype(np.float64)
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _match_image(
    det_scores: np.ndarray,
    iou: np.ndarray,
    gt_ignore: np.ndarray,
    thrs: np.ndarray,
    gt_crowd: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy matching per threshold (pycocotools `evaluateImg` loop).

    Returns (tp [T, D], ignore_det [T, D]) in score-sorted det order.
    Only CROWD gts may be matched by several dets (`gtm[tind, gind] > 0 and
    not iscrowd[gind] -> continue` upstream); non-crowd ignored gts are
    consumed like real ones.
    """
    if gt_crowd is None:
        gt_crowd = gt_ignore
    order = np.argsort(-det_scores, kind="stable")
    iou = iou[order]
    # gts sorted with ignored last (COCOeval convention: a det can only fall
    # back to an ignored gt after every real gt has failed to match)
    gt_order = np.argsort(gt_ignore, kind="stable")
    iou = iou[:, gt_order]
    gt_ignore = gt_ignore[gt_order]
    gt_crowd = gt_crowd[gt_order]
    d, g = iou.shape
    t = len(thrs)
    tp = np.zeros((t, d), bool)
    ign = np.zeros((t, d), bool)
    for ti, thr in enumerate(thrs):
        taken = np.zeros(g, bool)
        for di in range(d):
            best = min(thr, 1.0 - 1e-10)
            best_g = -1
            for gi in range(g):
                if taken[gi] and not gt_crowd[gi]:
                    continue
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[gi]:
                    break  # already have a real match; ignored gts can't improve
                if iou[di, gi] < best:
                    continue
                best = iou[di, gi]
                best_g = gi
            if best_g > -1:
                taken[best_g] = True
                if gt_ignore[best_g]:
                    ign[ti, di] = True
                else:
                    tp[ti, di] = True
    return tp, ign


class DetectionEvaluator:
    """Accumulates per-image detections/gts and computes COCO AP.

    add_image() per image with arrays; summarize() returns the metric dict.
    Labels are contiguous [0, num_classes).
    """

    def __init__(self, num_classes: int, max_dets: int = 100, with_mask: bool = False):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.with_mask = with_mask
        # per class: list of (scores, tp[T,D], ign[T,D]); gt count
        self._dets = defaultdict(list)
        self._npos = np.zeros(num_classes, np.int64)

    def add_image(
        self,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_labels: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_ignore: Optional[np.ndarray] = None,
        det_masks=None,
        gt_masks=None,
        gt_crowd: Optional[np.ndarray] = None,
    ):
        """All boxes xyxy in the same (original-image) coordinate frame.

        gt_ignore marks gts excluded from scoring; gt_crowd (a subset,
        default = gt_ignore) additionally allows many-to-one matching and
        the intersection-over-det IoU (COCO iscrowd semantics).
        """
        if gt_ignore is None:
            gt_ignore = np.zeros(len(gt_boxes), bool)
        if gt_crowd is None:
            gt_crowd = gt_ignore
        for c in np.unique(np.concatenate([det_labels, gt_labels])).astype(int):
            dm = det_labels == c
            gm = gt_labels == c
            self._npos[c] += int((gm & ~gt_ignore).sum())
            if not dm.any():
                continue
            # pycocotools caps dets PER (image, class) at maxDet
            # (`evaluateImg`: dt = dt[0:maxDet]); a global per-image cap is
            # the detector's own business (roi_head max_per_img)
            keep = np.argsort(-det_scores[dm], kind="stable")[: self.max_dets]
            scores_c = det_scores[dm][keep]
            if self.with_mask:
                masks_c = [m for m, k in zip(det_masks, dm) if k]
                iou = _mask_iou_matrix(
                    [masks_c[i] for i in keep],
                    [m for m, k in zip(gt_masks, gm) if k],
                    gt_crowd[gm],
                )
            else:
                iou = _iou_matrix(det_boxes[dm][keep], gt_boxes[gm], gt_crowd[gm])
            tp, ign = _match_image(
                scores_c, iou, gt_ignore[gm], IOU_THRS, gt_crowd=gt_crowd[gm]
            )
            order = np.argsort(-scores_c, kind="stable")
            self._dets[c].append((scores_c[order], tp, ign))

    def _class_ap(self, c: int) -> np.ndarray:
        """AP per IoU threshold for one class; NaN if no gt."""
        t = len(IOU_THRS)
        if self._npos[c] == 0:
            return np.full(t, np.nan)
        if not self._dets[c]:
            return np.zeros(t)
        scores = np.concatenate([d[0] for d in self._dets[c]])
        tp = np.concatenate([d[1] for d in self._dets[c]], axis=1)
        ign = np.concatenate([d[2] for d in self._dets[c]], axis=1)
        order = np.argsort(-scores, kind="stable")
        tp, ign = tp[:, order], ign[:, order]
        ap = np.zeros(t)
        for ti in range(t):
            use = ~ign[ti]
            if not use.any():
                continue  # every det ignored (crowd-matched): AP stays 0
            tpc = np.cumsum(tp[ti][use])
            fpc = np.cumsum(~tp[ti][use])
            rec = tpc / self._npos[c]
            prec = tpc / np.maximum(tpc + fpc, 1e-9)
            # make precision monotone decreasing, then 101-pt interpolate
            for i in range(len(prec) - 1, 0, -1):
                prec[i - 1] = max(prec[i - 1], prec[i])
            idx = np.searchsorted(rec, RECALL_THRS, side="left")
            ap[ti] = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0).mean()
        return ap

    def summarize(
        self,
        class_names: Optional[Sequence[str]] = None,
        base_classes: Optional[Sequence[str]] = None,
        novel_classes: Optional[Sequence[str]] = None,
        groups: Optional[dict] = None,
    ) -> dict:
        """Returns mAP / AP50 / AP75 (+ per-group AP50 and per-group mAP)."""
        per_class = np.stack([self._class_ap(c) for c in range(self.num_classes)])

        def _nm(vals) -> float:
            # nanmean without the "Mean of empty slice" RuntimeWarning when a
            # class group is empty or entirely absent from the gt
            a = np.asarray(vals, np.float64).ravel()
            a = a[~np.isnan(a)]
            return float(a.mean()) if a.size else float("nan")

        out = {
            "mAP": _nm(per_class),
            "AP50": _nm(per_class[:, 0]),
            "AP75": _nm(per_class[:, 5]),
        }
        if class_names is not None:
            name_ap50 = {n: per_class[i, 0] for i, n in enumerate(class_names)}
            name_map = {n: _nm(per_class[i]) for i, n in enumerate(class_names)}
            if base_classes:
                out["AP50_base"] = _nm([name_ap50[n] for n in base_classes if n in name_ap50])
            if novel_classes:
                out["AP50_novel"] = _nm([name_ap50[n] for n in novel_classes if n in name_ap50])
            for gname, members in (groups or {}).items():
                out[f"mAP_{gname}"] = _nm([name_map[n] for n in members if n in name_map])
        return out
