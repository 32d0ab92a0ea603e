"""LVIS box AP in numpy (the port's copy of
cddmsl_tpu/evaluation/lvis_eval.py `LVISEvaluator`).

What differs from COCO: no score threshold is applied here; a detection of
class c on an image is ignored where it matches no ground truth and the
image does not evaluate c exhaustively: c is in its
`not_exhaustive_category_ids`, or neither annotated on it nor among its
`neg_category_ids`; and the AP is also reported over the rare (at most 10
training images), common (11 to 100) and frequent classes (APr, APc, APf),
by the metadata's `class_image_counts`. The greedy matching and the
101-point AP are `coco_eval`'s.
"""

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.catalog import MetadataCatalog
from .coco_eval import AREA_RANGES, IOU_THRESHOLDS, RECALL_POINTS, _box_area, _eval_image


class LVISEvaluator:
    # `inference_on_dataset` hands the per-image ignore ids only to
    # evaluators that say they take them
    accepts_lvis_ignore = True

    def __init__(self, dataset_name: str = "", num_classes: int = 0,
                 class_image_counts: Optional[Sequence[int]] = None):
        if dataset_name:
            meta = MetadataCatalog.get(dataset_name)
            classes = meta.get("thing_classes")
            num_classes = num_classes or (len(classes) if classes else 0)
            class_image_counts = class_image_counts or meta.get("class_image_counts")
        if num_classes <= 0:
            raise ValueError(f"LVISEvaluator of {dataset_name!r}: no classes")
        self.num_classes = num_classes
        self.class_image_counts = class_image_counts
        self.reset()

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))  # class -> image -> [(score, box)]
        self._gts = defaultdict(lambda: defaultdict(list))  # class -> image -> [box]
        self._neg = {}
        self._not_exhaustive = {}
        self._images = set()

    def process(self, image_id, boxes, scores, classes):
        self._images.add(image_id)
        for b, s, c in zip(boxes, scores, classes):
            self._dets[int(c)][image_id].append((float(s), np.asarray(b, np.float64)))

    def process_gt(self, image_id, boxes, classes, iscrowd=None, neg_category_ids=(),
                   not_exhaustive_category_ids=()):
        """`iscrowd` (the loop's third argument) is not read: LVIS has no
        crowd annotations."""
        self._images.add(image_id)
        self._neg[image_id] = set(int(c) for c in neg_category_ids)
        self._not_exhaustive[image_id] = set(int(c) for c in not_exhaustive_category_ids)
        for b, c in zip(boxes, classes):
            self._gts[int(c)][image_id].append(np.asarray(b, np.float64))

    def _class_pr(self, c: int, area_lo: float, area_hi: float) -> Optional[np.ndarray]:
        """(T, 101) interpolated precision of class `c`; None when it has
        no ground truth in the area range."""
        T = len(IOU_THRESHOLDS)
        all_scores, all_tp, all_ign = [], [], []
        npos = 0
        for img in self._images:
            gts = np.array(self._gts.get(c, {}).get(img, [])).reshape(-1, 4)
            evaluated = len(gts) > 0 or c in self._neg.get(img, set())
            areas = _box_area(gts)
            gt_ignore = (areas < area_lo) | (areas > area_hi)
            npos += int((~gt_ignore).sum())
            det_list = self._dets.get(c, {}).get(img, [])
            if not det_list:
                continue
            det_boxes = np.array([b for _, b in det_list]).reshape(-1, 4)
            det_scores = np.array([s for s, _ in det_list])
            scores, tp, ign = _eval_image(det_boxes, det_scores, gts, gt_ignore, np.zeros(len(gts), bool),
                                          IOU_THRESHOLDS)
            if not evaluated or c in self._not_exhaustive.get(img, set()):
                ign = ign | ~tp  # an unmatched detection is no false positive here
            order = np.argsort(-det_scores, kind="stable")
            d_areas = _box_area(det_boxes)
            ign = ign | (((d_areas < area_lo) | (d_areas > area_hi))[order][None, :] & ~tp)
            all_scores.append(scores)
            all_tp.append(tp)
            all_ign.append(ign)
        if npos == 0:
            return None
        if not all_scores:
            return np.zeros((T, len(RECALL_POINTS)))
        order = np.argsort(-np.concatenate(all_scores), kind="mergesort")
        tp = np.concatenate(all_tp, axis=1)[:, order]
        ign = np.concatenate(all_ign, axis=1)[:, order]
        out = np.zeros((T, len(RECALL_POINTS)))
        for t in range(T):
            keep = ~ign[t]
            tps = np.cumsum(tp[t][keep])
            fps = np.cumsum(~tp[t][keep])
            rec = tps / npos
            prec = tps / np.maximum(tps + fps, 1e-10)
            for i in range(len(prec) - 1, 0, -1):
                prec[i - 1] = max(prec[i - 1], prec[i])
            idx = np.searchsorted(rec, RECALL_POINTS, side="left")
            out[t] = np.where(idx < len(prec), prec[np.minimum(idx, max(len(prec) - 1, 0))], 0.0) if len(prec) else 0.0
        return out

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        """{"bbox": {AP, AP50, AP75, APr, APc, APf}} over the classes with
        ground truth (NaN where a bucket has none)."""
        lo, hi = AREA_RANGES["all"]
        ap_all, ap50, ap75 = [], [], []
        bucket = {"r": [], "c": [], "f": []}
        for c in range(self.num_classes):
            if not any(len(v) for v in self._gts.get(c, {}).values()):
                continue
            pr = self._class_pr(c, lo, hi)
            if pr is None:
                continue
            ap = float(np.mean(pr))
            ap_all.append(ap)
            ap50.append(float(np.mean(pr[0])))
            ap75.append(float(np.mean(pr[5])))
            if self.class_image_counts is not None and c < len(self.class_image_counts):
                n = self.class_image_counts[c]
                bucket["r" if n <= 10 else ("c" if n <= 100 else "f")].append(ap)
        mean = lambda xs: 100 * float(np.mean(xs)) if xs else float("nan")  # noqa: E731
        return {"bbox": {"AP": mean(ap_all), "AP50": mean(ap50), "AP75": mean(ap75), "APr": mean(bucket["r"]),
                         "APc": mean(bucket["c"]), "APf": mean(bucket["f"])}}
