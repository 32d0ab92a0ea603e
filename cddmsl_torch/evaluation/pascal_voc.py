"""PASCAL-VOC detection evaluation (host-side numpy; the port's copy of
cddmsl_tpu/evaluation/pascal_voc.py).

Mirrors the reference PascalVOCDetectionEvaluator
(detectron2/evaluation/pascal_voc_evaluation.py:20-129 + voc_eval :201):
IoU thresholds 50:95:5, the 11-point "07 metric" for year==2007 datasets,
per-class AP50 in the output, difficult-instance handling, and the
target-class subset evaluation used for Watercolor/Comic (6-class) targets.
"""

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.catalog import MetadataCatalog


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(
    detections: List[dict],  # [{image_id, score, bbox}]
    gt_by_image: Dict[str, dict],  # image_id -> {boxes (G,4), difficult (G,)}
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> float:
    """AP for one class (reference pascal_voc_evaluation.py voc_eval :201)."""
    npos = 0
    matched = {}
    for iid, g in gt_by_image.items():
        npos += int((~g["difficult"]).sum())
        matched[iid] = np.zeros(len(g["boxes"]), bool)

    if not detections:
        return 0.0
    dets = sorted(detections, key=lambda d: -d["score"])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, det in enumerate(dets):
        g = gt_by_image.get(det["image_id"])
        if g is None or len(g["boxes"]) == 0:
            fp[i] = 1
            continue
        bb = np.asarray(det["bbox"], np.float32)
        gts = g["boxes"]
        ixmin = np.maximum(gts[:, 0], bb[0])
        iymin = np.maximum(gts[:, 1], bb[1])
        ixmax = np.minimum(gts[:, 2], bb[2])
        iymax = np.minimum(gts[:, 3], bb[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inters = iw * ih
        uni = (
            (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
            + (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0)
            - inters
        )
        overlaps = inters / uni
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > ovthresh:
            if g["difficult"][jmax]:
                continue  # ignored
            if not matched[det["image_id"]][jmax]:
                tp[i] = 1
                matched[det["image_id"]][jmax] = True
            else:
                fp[i] = 1
        else:
            fp[i] = 1

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(npos, 1)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


class PascalVOCDetectionEvaluator:
    """Accumulates per-class detections; evaluates AP at IoU 50:95:5.

    `target_classnames` restricts evaluation to a class subset (the
    Watercolor/Comic 6-class case, reference train_net.py:102-103)."""

    def __init__(self, dataset_name: str, target_classnames: Optional[Sequence[str]] = None):
        meta = MetadataCatalog.get(dataset_name)
        self.class_names = list(meta.thing_classes)
        self.target_classnames = list(target_classnames) if target_classnames else self.class_names
        self.use_07_metric = meta.get("year", 2007) == 2007
        self.reset()

    def reset(self):
        self._dets_by_class = defaultdict(list)
        self._gt_by_class = defaultdict(dict)

    def process_gt(self, image_id: str, boxes: np.ndarray, classes: np.ndarray, difficult=None):
        if difficult is None:
            difficult = np.zeros(len(boxes), bool)
        for c in range(len(self.class_names)):
            sel = classes == c
            self._gt_by_class[c][image_id] = {
                "boxes": np.asarray(boxes[sel], np.float32),
                "difficult": np.asarray(difficult[sel], bool),
            }

    def process(self, image_id: str, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        """Register predictions for one image (boxes in original-image
        coords, XYXY)."""
        for box, score, cls in zip(boxes, scores, classes):
            self._dets_by_class[int(cls)].append(
                {"image_id": image_id, "score": float(score), "bbox": box}
            )

    def evaluate(self) -> Dict[str, float]:
        thresholds = [t / 100 for t in range(50, 100, 5)]
        aps = defaultdict(list)  # thresh -> [per-class AP]
        ap50_per_class = {}
        for c, name in enumerate(self.class_names):
            if name not in self.target_classnames:
                continue
            for t in thresholds:
                ap = voc_eval_class(
                    self._dets_by_class.get(c, []),
                    self._gt_by_class.get(c, {}),
                    ovthresh=t,
                    use_07_metric=self.use_07_metric,
                )
                aps[t].append(ap)
                if t == 0.5:
                    ap50_per_class[f"AP50-{name}"] = 100 * ap
        mean_per_thresh = {t: np.mean(v) for t, v in aps.items()}
        ret = {
            "AP": 100 * float(np.mean(list(mean_per_thresh.values()))),
            "AP50": 100 * float(mean_per_thresh[0.5]),
            "AP75": 100 * float(mean_per_thresh[0.75]),
        }
        ret.update(ap50_per_class)
        return {"bbox": ret}
