"""COCO-style bbox, segm and keypoints AP in numpy (the port's copy of
cddmsl_tpu/evaluation/coco_eval.py `COCOEvaluator` and `_oks_matrix`).

101-point interpolated AP averaged over IoU .50:.95, AP50 and AP75, the
small/medium/large area splits and the per-class AP, with crowd boxes as
ignored ground truth (pycocotools' `COCOeval` rules). On a set of the 65
open-vocabulary classes it reports first the AP50 over the novel, the base
and all classes (`AP50_split_target`, `_base`, `_all`; -1 where no class of
the split has ground truth). The matcher is the numpy one.

The keypoints task matches by OKS (pycocotools' `computeOks`, with the
ground truth's area taken as its box's, as JAX's evaluator takes it) over
the all / medium / large ranges; the sigmas are TEST.KEYPOINT_OKS_SIGMAS
where set, else the set's keypoint_oks_sigmas metadata, else COCO person's.
A ground truth without labelled keypoints is ignored; an image whose
detections or ground truth of a class carry no keypoints is left out of
that class's matching (its ground truth still counts).
"""

import json
import os
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.catalog import MetadataCatalog
from .masks import mask_iou_matrix, paste_masks_np, rle_area, rle_encode, segmentation_to_rle

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)  # pycocotools Params.setDetParams
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
# pycocotools Params.setKpParams: keypoints AP over all, medium and large only
KP_AREA_RANGES = {k: AREA_RANGES[k] for k in ("all", "medium", "large")}
# pycocotools' COCO person sigmas (Params.kpt_oks_sigmas)
COCO_PERSON_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0


def _oks_matrix(det_kps: np.ndarray, gt_kps: np.ndarray, gt_boxes: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """(D, K, 3) detected x (G, K, 3) ground-truth keypoints -> (D, G) OKS,
    each ground truth's area its box's. A ground truth without labelled
    keypoints scores by the distance outside its box grown by its size on
    each side."""
    d_n, g_n = len(det_kps), len(gt_kps)
    if d_n == 0 or g_n == 0:
        return np.zeros((d_n, g_n))
    var = (sigmas[:det_kps.shape[1]] * 2.0) ** 2
    areas = np.maximum((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]), 1e-6)
    out = np.zeros((d_n, g_n))
    for g in range(g_n):
        xg, yg, vg = gt_kps[g, :, 0], gt_kps[g, :, 1], gt_kps[g, :, 2]
        lab = vg > 0
        x0, y0, x1, y1 = gt_boxes[g]
        bw, bh = x1 - x0, y1 - y0
        for d in range(d_n):
            xd, yd = det_kps[d, :, 0], det_kps[d, :, 1]
            if lab.sum() > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - bw - xd) + np.maximum(0, xd - (x1 + bw))
                dy = np.maximum(0, y0 - bh - yd) + np.maximum(0, yd - (y1 + bh))
            e = (dx ** 2 + dy ** 2) / var / (areas[g] + np.spacing(1)) / 2.0
            out[d, g] = np.mean(np.exp(-e[lab])) if lab.sum() > 0 else np.mean(np.exp(-e))
    return out


def _iou_matrix(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D,4),(G,4) XYXY -> (D,G); crowd GT uses intersection-over-det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def _eval_image(dets, det_scores, gts, gt_ignore, iscrowd, thresholds, ious=None):
    """Greedy matching per COCOeval.evaluateImg: for each threshold, the
    detections by score (descending) take the best free ground truth.
    Returns the sorted scores and (T, D) true-positive and ignored flags.
    `ious` (D, G) in the given orders replaces the box IoU (segm's mask IoU)."""
    order = np.argsort(-det_scores, kind="stable")
    dets = dets[order]
    # real ground truth before ignored (cocoeval sorts by the ignore flag)
    g_order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
    gts, gt_ignore, iscrowd = gts[g_order], gt_ignore[g_order], iscrowd[g_order]
    ious = _iou_matrix(dets, gts, iscrowd) if ious is None else ious[order][:, g_order]
    T, D, G = len(thresholds), len(dets), len(gts)
    tp = np.zeros((T, D), bool)
    ignore_det = np.zeros((T, D), bool)
    for t_i, t in enumerate(thresholds):
        matched = np.zeros(G, bool)
        for d in range(D):
            best, best_iou = -1, min(t, 1 - 1e-10)
            for g in range(G):
                if matched[g] and not iscrowd[g]:
                    continue
                # once matched to a real ground truth, never switch to an ignored one
                if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best = g
            if best == -1:
                continue
            matched[best] = True
            if gt_ignore[best]:
                ignore_det[t_i, d] = True
            else:
                tp[t_i, d] = True
    return det_scores[order], tp, ignore_det


def _box_area(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0)
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


class COCOEvaluator:
    """Accumulates detections and ground truth; `evaluate()` returns
    {task: {AP, AP50, AP75, APs, APm, APl, AP-<class>...}} for each of
    `tasks` ("bbox", "segm", "keypoints"; APs is NaN for keypoints) and,
    with `output_json`, writes the detections in the COCO results schema.
    `kpt_oks_sigmas` (TEST.KEYPOINT_OKS_SIGMAS) overrides the set's
    keypoint_oks_sigmas metadata.

    The bbox task's box layout is three hooks, which RotatedCOCOEvaluator
    overrides (XYWHA): `box_dim`, `_box_area` and `_box_iou`, which gives
    the (D, G) IoU matrix or None for the axis-aligned one."""

    box_dim = 4

    def _box_area(self, boxes: np.ndarray) -> np.ndarray:
        return _box_area(boxes)

    def _box_iou(self, dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> Optional[np.ndarray]:
        return None

    def __init__(self, dataset_name: str, output_json: Optional[str] = None, tasks: Sequence[str] = ("bbox",),
                 kpt_oks_sigmas=None):
        meta = MetadataCatalog.get(dataset_name)
        classes = meta.get("thing_classes")
        self.num_classes = len(classes) if classes else 80
        self.class_names = classes
        self.output_json = output_json
        self.tasks = tuple(tasks)
        if kpt_oks_sigmas is None:
            kpt_oks_sigmas = meta.get("keypoint_oks_sigmas")
        self.kpt_oks_sigmas = np.asarray(kpt_oks_sigmas) if kpt_oks_sigmas is not None else COCO_PERSON_SIGMAS
        self.reset()

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))  # class -> image -> [(score, box, rle or None)]
        self._gts = defaultdict(lambda: defaultdict(list))  # class -> image -> [(box, iscrowd, rle or None)]
        # the keypoints task's (K, 3) arrays or None, in step with _dets and _gts
        self._det_kps = defaultdict(lambda: defaultdict(list))
        self._gt_kps = defaultdict(lambda: defaultdict(list))
        self._images = set()

    def process(self, image_id, boxes, scores, classes, masks=None, image_hw=None, keypoints=None):
        """`masks` (N, M, M) box-frame probabilities: pasted at `image_hw`
        and encoded when the segm task is on. `keypoints` (N, K, 3): the
        decoded (x, y, score) of each detection."""
        self._images.add(image_id)
        rles = [None] * len(boxes)
        if masks is not None and "segm" in self.tasks:
            pasted = paste_masks_np(np.asarray(masks), np.asarray(boxes), image_hw)
            rles = [rle_encode(m) for m in pasted]
        kps = [None] * len(boxes) if keypoints is None else keypoints
        for b, s, c, r, kp in zip(boxes, scores, classes, rles, kps):
            self._dets[int(c)][image_id].append((float(s), np.asarray(b, np.float64), r))
            if "keypoints" in self.tasks:
                self._det_kps[int(c)][image_id].append(None if kp is None else np.asarray(kp, np.float64))

    def process_gt(self, image_id, boxes, classes, iscrowd=None, segmentations=None, image_hw=None,
                   keypoints=None):
        """`segmentations`: per instance its COCO segmentation (original
        image coordinates), encoded at `image_hw` for the segm task.
        `keypoints`: per instance its (K, 3) (x, y, flag) or None."""
        self._images.add(image_id)
        if iscrowd is None:
            iscrowd = np.zeros(len(boxes), bool)
        rles = [None] * len(boxes)
        if segmentations is not None and "segm" in self.tasks:
            rles = [segmentation_to_rle(seg, image_hw) for seg in segmentations]
        kps = [None] * len(boxes) if keypoints is None else keypoints
        for b, c, cr, r, kp in zip(boxes, classes, iscrowd, rles, kps):
            self._gts[int(c)][image_id].append((np.asarray(b, np.float64), bool(cr), r))
            if "keypoints" in self.tasks:
                self._gt_kps[int(c)][image_id].append(None if kp is None else np.asarray(kp, np.float64))

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        out = {task: self._evaluate_task(task) for task in self.tasks}
        if self.output_json:
            self.dump_predictions(self.output_json)
        return out

    def dump_predictions(self, path: str) -> None:
        """The detections as COCO results: image_id, category_id (the
        contiguous id), bbox in XYWH, score, and with segm the mask's RLE."""
        records = []
        for c, per_img in self._dets.items():
            for img, dets in per_img.items():
                for score, box, rle in dets:
                    x1, y1, x2, y2 = [float(v) for v in box]
                    rec = {"image_id": img, "category_id": int(c), "bbox": [x1, y1, x2 - x1, y2 - y1],
                           "score": float(score)}
                    if rle is not None:
                        rec["segmentation"] = rle
                    records.append(rec)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(records, f)

    def _evaluate_task(self, task: str) -> Dict[str, float]:
        ranges = KP_AREA_RANGES if task == "keypoints" else AREA_RANGES
        ap_per_class = {area: [] for area in ranges}
        ap50, ap75 = [], []
        ap50_by_class = {}
        named = {}
        for c in range(self.num_classes):
            if not any(len(v) for v in self._gts.get(c, {}).values()):
                continue
            for area, (lo, hi) in ranges.items():
                precisions = self._class_pr(c, lo, hi, task)  # (T, 101)
                ap = np.nan if precisions is None else float(np.mean(precisions))
                ap_per_class[area].append(ap)
                if area == "all":
                    if self.class_names and c < len(self.class_names):
                        named[f"AP-{self.class_names[c]}"] = 100 * ap if np.isfinite(ap) else float("nan")
                    if precisions is not None:
                        ap50.append(float(np.mean(precisions[0])))
                        ap75.append(float(np.mean(precisions[5])))
                        ap50_by_class[c] = ap50[-1]
        return {
            **(self._ovd_splits(ap50_by_class) if task == "bbox" else {}),
            "AP": 100 * float(np.nanmean(ap_per_class["all"])) if ap_per_class["all"] else float("nan"),
            "AP50": 100 * float(np.mean(ap50)) if ap50 else float("nan"),
            "AP75": 100 * float(np.mean(ap75)) if ap75 else float("nan"),
            "APs": 100 * float(np.nanmean(ap_per_class["small"])) if ap_per_class.get("small") else float("nan"),
            "APm": 100 * float(np.nanmean(ap_per_class["medium"])) if ap_per_class["medium"] else float("nan"),
            "APl": 100 * float(np.nanmean(ap_per_class["large"])) if ap_per_class["large"] else float("nan"),
            **named,
        }

    def _ovd_splits(self, ap50_by_class: Dict[int, float]) -> Dict[str, float]:
        """{AP50_split_target, _base, _all} over the classes with ground
        truth, where the set names the 65 open-vocabulary classes."""
        if not self.class_names or len(self.class_names) != 65:
            return {}
        from ..data.datasets.coco_zeroshot_categories import COCO_OVD_ALL_CLS, COCO_SEEN_CLS, COCO_UNSEEN_CLS

        out = {}
        for split, names in (("target", COCO_UNSEEN_CLS), ("base", COCO_SEEN_CLS), ("all", COCO_OVD_ALL_CLS)):
            vals = [v for c, v in ap50_by_class.items() if self.class_names[c] in set(names)]
            out[f"AP50_split_{split}"] = 100 * float(np.mean(vals)) if vals else -1.0
        return out

    def _class_pr(self, c: int, area_lo: float, area_hi: float, task: str = "bbox") -> Optional[np.ndarray]:
        """(T, 101) interpolated precision of class `c` in an area range for
        `task`; None when it has no ground truth there. An image whose
        detections or ground truth of the class have no mask is left out of
        segm's matching (its ground truth still counts), and so is one whose
        detections or ground truth have no keypoints from the keypoints
        task's, where a ground truth without labelled keypoints is ignored."""
        T = len(IOU_THRESHOLDS)
        all_scores, all_tp, all_ign = [], [], []
        npos = 0
        det_imgs, gt_imgs = self._dets.get(c, {}), self._gts.get(c, {})
        segm = task == "segm"
        for img in self._images:
            gt_list = gt_imgs.get(img, [])
            gts = np.array([b for b, _, _ in gt_list]).reshape(-1, self.box_dim)
            iscrowd = np.array([cr for _, cr, _ in gt_list], bool)
            areas = np.array([rle_area(r) if r else 0.0 for _, _, r in gt_list]) if segm else self._box_area(gts)
            gt_ignore = iscrowd | (areas < area_lo) | (areas > area_hi)
            gkps = self._gt_kps.get(c, {}).get(img, [])
            if task == "keypoints":
                n_lab = np.array([0 if k is None else int((k[:, 2] > 0).sum()) for k in gkps]).reshape(-1)
                if len(n_lab) == len(gt_ignore):
                    gt_ignore = gt_ignore | (n_lab == 0)
            npos += int((~gt_ignore).sum())
            det_list = det_imgs.get(img, [])
            if not det_list:
                continue
            det_boxes = np.array([b for _, b, _ in det_list]).reshape(-1, self.box_dim)
            det_scores = np.array([s for s, _, _ in det_list])
            ious = self._box_iou(det_boxes, gts, iscrowd) if task == "bbox" else None
            if segm:
                det_rles, gt_rles = [r for _, _, r in det_list], [r for _, _, r in gt_list]
                if any(r is None for r in det_rles + gt_rles):
                    continue
                ious = mask_iou_matrix(det_rles, gt_rles, iscrowd)
            elif task == "keypoints":
                dkps = self._det_kps.get(c, {}).get(img, [])
                if any(k is None for k in dkps + gkps):
                    continue
                ious = _oks_matrix(np.stack(dkps) if dkps else np.zeros((0, 1, 3)),
                                   np.stack(gkps) if gkps else np.zeros((0, 1, 3)), gts, self.kpt_oks_sigmas)
            scores, tp, ign = _eval_image(det_boxes, det_scores, gts, gt_ignore, iscrowd, IOU_THRESHOLDS, ious)
            # unmatched detections outside the area range are ignored
            d_areas = (np.array([rle_area(r) for _, _, r in det_list], np.float64) if segm
                       else self._box_area(det_boxes))
            order = np.argsort(-det_scores, kind="stable")
            out_of_range = ((d_areas < area_lo) | (d_areas > area_hi))[order]
            ign = ign | (out_of_range[None, :] & ~tp)
            all_scores.append(scores)
            all_tp.append(tp)
            all_ign.append(ign)
        if npos == 0:
            return None
        if not all_scores:
            return np.zeros((T, len(RECALL_POINTS)))
        scores = np.concatenate(all_scores)
        order = np.argsort(-scores, kind="mergesort")
        tp = np.concatenate(all_tp, axis=1)[:, order]
        ign = np.concatenate(all_ign, axis=1)[:, order]
        out = np.zeros((T, len(RECALL_POINTS)))
        for t in range(T):
            keep = ~ign[t]
            tps = np.cumsum(tp[t][keep])
            fps = np.cumsum(~tp[t][keep])
            rec = tps / npos
            prec = tps / np.maximum(tps + fps, 1e-10)
            # the monotone precision envelope, read at the 101 recall points
            for i in range(len(prec) - 1, 0, -1):
                prec[i - 1] = max(prec[i - 1], prec[i])
            idx = np.searchsorted(rec, RECALL_POINTS, side="left")
            out[t] = np.where(idx < len(prec), prec[np.minimum(idx, max(len(prec) - 1, 0))], 0.0) if len(prec) else 0.0
        return out
