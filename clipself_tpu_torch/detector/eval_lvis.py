"""Official-LVIS-protocol detection AP evaluation, pure NumPy: a copy of
`clipself_tpu/detector/eval_lvis.py`, pinned equal to the original by
`tests/test_torch_detector_lvis.py`.

Implements the semantics of the lvis-api `LVISEval`/`LVISResults` pair the
reference uses for its OV-LVIS numbers (`F-ViT/datasets/lvls_ov.py:120-180`).
These differ from COCOeval in ways that move the headline metrics:

  - detections are capped at `max_dets` (300) PER IMAGE across all
    categories (COCOeval caps per (image, class));
  - federated annotations: category c is only evaluated on images where it
    is positively labeled (has gt) or negatively labeled (c in the image's
    `neg_category_ids`) — detections of c elsewhere are dropped, neither TP
    nor FP;
  - unmatched detections of a category in the image's
    `not_exhaustive_category_ids` are ignored instead of counted as FP;
  - AP is averaged over categories present in the gt (absent categories
    keep the -1 sentinel and drop out of every mean), and APr/APc/APf are
    the means over the rare/common/frequent frequency groups.

Matching itself (greedy score-ordered per iou threshold, ignored gts last)
is the COCO loop of `eval_ap.py` without crowd handling — LVIS has no crowd
annotations.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from clipself_tpu_torch.detector.eval_ap import _iou_matrix, _mask_iou_matrix, _match_image

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = np.array(
    [
        [0.0, 1e5**2],
        [0.0, 32.0**2],
        [32.0**2, 96.0**2],
        [96.0**2, 1e5**2],
    ]
)
AREA_LBLS = ("all", "small", "medium", "large")


class LvisEvaluator:
    """Accumulates per-image detections/gts and computes LVIS AP.

    Labels are contiguous [0, num_classes). `freq_index[c]` maps class c to
    its frequency group (0=rare, 1=common, 2=frequent); pass None to skip
    the APr/APc/APf report (e.g. in unit fixtures without frequency data).
    """

    def __init__(
        self,
        num_classes: int,
        freq_index: Optional[np.ndarray] = None,
        max_dets: int = 300,
        with_mask: bool = False,
    ):
        self.num_classes = num_classes
        self.freq_index = None if freq_index is None else np.asarray(freq_index)
        self.max_dets = max_dets
        self.with_mask = with_mask
        # per (class, area_idx): list of (scores desc, tp [T,D], ign [T,D])
        self._dets = defaultdict(list)
        # per (class, area_idx): number of non-ignored gts
        self._npos = np.zeros((num_classes, len(AREA_RNGS)), np.int64)

    def add_image(
        self,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_labels: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_areas: Optional[np.ndarray] = None,
        neg_labels: Sequence[int] = (),
        not_exhaustive_labels: Sequence[int] = (),
        det_masks=None,
        gt_masks=None,
        gt_ignore: Optional[np.ndarray] = None,
    ):
        """All boxes xyxy in the same (original-image) coordinate frame.

        gt_areas: the LVIS annotation `area` field (polygon area), NOT the
        box area; falls back to box area when absent. neg_labels /
        not_exhaustive_labels: this image's `neg_category_ids` /
        `not_exhaustive_category_ids`, mapped to contiguous labels.
        gt_ignore: optional per-gt bool forcing a gt to ignore at every area
        range (not in the lvis-api protocol — used by the mask path for gts
        beyond the fixed raster budget, which must be neither FN nor FP).
        """
        det_labels = np.asarray(det_labels, int)
        gt_labels = np.asarray(gt_labels, int)
        if gt_areas is None:
            gt_areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (
                gt_boxes[:, 3] - gt_boxes[:, 1]
            )
        # LVISResults: per-IMAGE cap across all categories, by score
        if len(det_scores) > self.max_dets:
            keep = np.argsort(-det_scores, kind="stable")[: self.max_dets]
            keep = np.sort(keep)  # keep original order for stable re-sorts
            det_boxes = det_boxes[keep]
            det_scores = det_scores[keep]
            det_labels = det_labels[keep]
            if det_masks is not None:
                det_masks = [det_masks[i] for i in keep]
        det_areas = (det_boxes[:, 2] - det_boxes[:, 0]) * (
            det_boxes[:, 3] - det_boxes[:, 1]
        )
        # federated filter: only evaluate c where positively or negatively
        # labeled; gt presence defines positive
        pos = set(np.unique(gt_labels).tolist())
        neg = set(int(c) for c in neg_labels)
        nel = set(int(c) for c in not_exhaustive_labels)
        classes = sorted(pos | {c for c in set(det_labels.tolist()) if c in neg})
        for c in classes:
            gm = gt_labels == c
            dm = (det_labels == c) if (c in pos or c in neg) else np.zeros_like(det_labels, bool)
            # gt ignore per area range: [A, G]
            g_area = gt_areas[gm]
            gt_ig_by_area = (g_area[None, :] < AREA_RNGS[:, 0:1]) | (
                g_area[None, :] > AREA_RNGS[:, 1:2]
            )
            if gt_ignore is not None:
                gt_ig_by_area = gt_ig_by_area | np.asarray(gt_ignore, bool)[gm][None, :]
            self._npos[c] += (~gt_ig_by_area).sum(axis=1)
            if not dm.any():
                continue
            scores_c = det_scores[dm]
            order = np.argsort(-scores_c, kind="stable")
            scores_sorted = scores_c[order]
            if self.with_mask:
                dmasks = [m for m, k in zip(det_masks, dm) if k]
                gmasks = [m for m, k in zip(gt_masks, gm) if k]
                iou = _mask_iou_matrix(dmasks, gmasks, np.zeros(int(gm.sum()), bool))
            else:
                iou = _iou_matrix(
                    det_boxes[dm], gt_boxes[gm], np.zeros(int(gm.sum()), bool)
                )
            d_area = det_areas[dm][order]
            for ai in range(len(AREA_RNGS)):
                gt_ig = gt_ig_by_area[ai]
                tp, ign = _match_image(
                    scores_c,
                    iou,
                    gt_ig,
                    IOU_THRS,
                    gt_crowd=np.zeros(len(gt_ig), bool),
                )
                # LVIS rule: UNMATCHED dets whose area is out of range or
                # whose category is not exhaustively annotated are ignored
                d_out = (d_area < AREA_RNGS[ai, 0]) | (d_area > AREA_RNGS[ai, 1])
                if c in nel:
                    d_out = np.ones_like(d_out)
                unmatched = ~(tp | ign)
                ign = ign | (unmatched & d_out[None, :])
                self._dets[c, ai].append((scores_sorted, tp, ign))

    def _class_ap(self, c: int, ai: int) -> tuple[np.ndarray, np.ndarray]:
        """(AP per iou thr, recall per iou thr) for one (class, area);
        -1 sentinel where the category has no gt in range."""
        t = len(IOU_THRS)
        entries = self._dets[c, ai]
        if self._npos[c, ai] == 0:
            # lvis accumulate: num_gt == 0 -> precision/recall stay -1,
            # excluded from every mean (even if ignored gts or dets exist)
            return np.full(t, -1.0), np.full(t, -1.0)
        if not entries:
            # gt present but zero detections anywhere: AP 0 / recall 0,
            # COUNTED in the mean (lvis accumulate still fills the rows)
            return np.zeros(t), np.zeros(t)
        scores = np.concatenate([e[0] for e in entries])
        tp = np.concatenate([e[1] for e in entries], axis=1)
        ign = np.concatenate([e[2] for e in entries], axis=1)
        order = np.argsort(-scores, kind="stable")
        tp, ign = tp[:, order], ign[:, order]
        ap = np.zeros(t)
        rec_last = np.zeros(t)
        npos = self._npos[c, ai]
        for ti in range(t):
            use = ~ign[ti]
            tpc = np.cumsum(tp[ti][use]).astype(np.float64)
            fpc = np.cumsum(~tp[ti][use]).astype(np.float64)
            if len(tpc) == 0:
                # lvis accumulate: num_tp == 0 -> recall 0, precision row of
                # pr_at_recall defaults (all zeros)
                continue
            rec = tpc / npos
            rec_last[ti] = rec[-1]
            prec = tpc / (fpc + tpc + np.spacing(1))
            for i in range(len(prec) - 1, 0, -1):
                prec[i - 1] = max(prec[i - 1], prec[i])
            idx = np.searchsorted(rec, RECALL_THRS, side="left")
            ap[ti] = np.where(
                idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0
            ).mean()
        return ap, rec_last

    def summarize(self) -> dict:
        """LVISEval.summarize keys (AP/AP50/AP75/APs/APm/APl/APr/APc/APf,
        AR@max_dets) plus mAP/mAP_rare/... aliases for report continuity."""
        t = len(IOU_THRS)
        a = len(AREA_RNGS)
        per = -np.ones((self.num_classes, a, t))
        rec = -np.ones((self.num_classes, a, t))
        for c in range(self.num_classes):
            for ai in range(a):
                per[c, ai], rec[c, ai] = self._class_ap(c, ai)

        def _mean(s):
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        out = {
            "AP": _mean(per[:, 0]),
            "AP50": _mean(per[:, 0, 0]),
            "AP75": _mean(per[:, 0, 5]),
            "APs": _mean(per[:, 1]),
            "APm": _mean(per[:, 2]),
            "APl": _mean(per[:, 3]),
            f"AR@{self.max_dets}": _mean(rec[:, 0]),
        }
        if self.freq_index is not None:
            for gi, name in enumerate("rcf"):
                out[f"AP{name}"] = _mean(per[self.freq_index == gi][:, 0])
        out["mAP"] = out["AP"]
        if "APr" in out:
            out["mAP_rare"] = out["APr"]
            out["mAP_common"] = out["APc"]
            out["mAP_frequent"] = out["APf"]
        return out
