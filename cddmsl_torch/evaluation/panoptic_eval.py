"""Panoptic Quality (PQ, SQ, RQ), the port's copy of
cddmsl_tpu/evaluation/panoptic_eval.py: computed from the definition
(Kirillov et al., "Panoptic Segmentation") with panopticapi's rules, in
memory, no PNG round trip.

Per image the ground truth and the prediction are segment-id maps (0 is
VOID or unassigned) with their segments_info. A ground-truth and a
predicted segment of the same category and `isthing` match when their IoU
is above 0.5, the union leaving out the prediction's pixels on VOID. Crowd
segments never match and are no false negatives; an unmatched prediction
more than half on VOID or on a crowd region of its category is no false
positive. Per category PQ = sum(IoU of matches) / (TP + FP/2 + FN/2), SQ =
sum(IoU) / TP, RQ = TP / (TP + FP/2 + FN/2), averaged over the categories
seen, for all of them, the things and the stuff.

`inference_on_dataset_panoptic` runs PanopticFPN's inference, takes each
image's argmax map to its original size (crop, then NEAREST), rescales its
boxes, combines on the host (models/panoptic_fpn.py
`combine_semantic_and_instance_outputs`) and reads the ground truth from
the panoptic PNG.
"""

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel import comm
from .sem_seg_eval import feed_rows, nearest_resize

logger = logging.getLogger(__name__)

VOID = 0
_OFFSET = np.int64(1) << 32


class PQStat:
    """Per (category_id, isthing): [iou_sum, tp, fp, fn]."""

    def __init__(self):
        self.stats: Dict[Tuple[int, bool], List[float]] = defaultdict(lambda: [0.0, 0, 0, 0])

    def __iadd__(self, other: "PQStat"):
        for k, v in other.stats.items():
            mine = self.stats[k]
            for i in range(4):
                mine[i] += v[i]
        return self

    def average(self, isthing: Optional[bool] = None) -> Dict[str, float]:
        """The mean PQ, SQ and RQ over the categories (of `isthing`, or all)
        with tp + fp + fn > 0, and their number."""
        pq = sq = rq = 0.0
        n = 0
        for (cat, thing), (iou, tp, fp, fn) in self.stats.items():
            if isthing is not None and thing != isthing:
                continue
            if tp + fp + fn == 0:
                continue
            n += 1
            denom = tp + 0.5 * fp + 0.5 * fn
            pq += iou / denom
            sq += iou / tp if tp else 0.0
            rq += tp / denom
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}


def pq_compute_single_image(pan_gt: np.ndarray, gt_segments: Sequence[dict], pan_pred: np.ndarray,
                            pred_segments: Sequence[dict]) -> PQStat:
    """One image's PQStat. `pan_gt`, `pan_pred`: (H, W) int id maps, 0 VOID;
    `gt_segments` {id, category_id, isthing, iscrowd?}, `pred_segments` {id,
    category_id, isthing}. Areas are counted on the maps: a segment absent
    from its map counts for nothing."""
    stat = PQStat()
    pan_gt = np.asarray(pan_gt, np.int64)
    pan_pred = np.asarray(pan_pred, np.int64)
    if pan_gt.shape != pan_pred.shape:
        raise ValueError(f"gt {pan_gt.shape} vs pred {pan_pred.shape} shape mismatch")
    gt_by_id = {int(s["id"]): s for s in gt_segments}
    pred_by_id = {int(s["id"]): s for s in pred_segments}
    gt_ids, gt_counts = np.unique(pan_gt, return_counts=True)
    pred_ids, pred_counts = np.unique(pan_pred, return_counts=True)
    gt_area = dict(zip(gt_ids.tolist(), gt_counts.tolist()))
    pred_area = dict(zip(pred_ids.tolist(), pred_counts.tolist()))
    # every (gt id, pred id) intersection in one pass
    pair_ids, pair_counts = np.unique(pan_gt * _OFFSET + pan_pred, return_counts=True)
    inter = {(int(p // _OFFSET), int(p % _OFFSET)): int(c) for p, c in zip(pair_ids.tolist(), pair_counts.tolist())}

    gt_matched, pred_matched = set(), set()
    for (g, p), intersection in inter.items():
        if g not in gt_by_id or p not in pred_by_id:
            continue
        gi, pi = gt_by_id[g], pred_by_id[p]
        if gi.get("iscrowd", 0):
            continue
        # the category and `isthing`: the loader's thing-space and stuff-space ids may collide
        if gi["category_id"] != pi["category_id"] or bool(gi.get("isthing", True)) != bool(pi.get("isthing", True)):
            continue
        union = pred_area.get(p, 0) + gt_area.get(g, 0) - intersection - inter.get((VOID, p), 0)
        if union <= 0:
            continue
        iou = intersection / union
        if iou > 0.5:
            s = stat.stats[(int(gi["category_id"]), bool(gi.get("isthing", True)))]
            s[0] += iou
            s[1] += 1
            gt_matched.add(g)
            pred_matched.add(p)

    crowd_by_cat: Dict[int, int] = {}
    for g, gi in gt_by_id.items():
        if g in gt_matched or gt_area.get(g, 0) == 0:
            continue
        if gi.get("iscrowd", 0):
            crowd_by_cat[int(gi["category_id"])] = g
            continue
        stat.stats[(int(gi["category_id"]), bool(gi.get("isthing", True)))][3] += 1

    for p, pi in pred_by_id.items():
        if p in pred_matched:
            continue
        area = pred_area.get(p, 0)
        if area == 0:
            continue
        ignored = inter.get((VOID, p), 0)
        crowd = crowd_by_cat.get(int(pi["category_id"]))
        if crowd is not None:
            ignored += inter.get((crowd, p), 0)
        if ignored / area > 0.5:
            continue
        stat.stats[(int(pi["category_id"]), bool(pi.get("isthing", True)))][2] += 1
    return stat


class COCOPanopticEvaluator:
    """(id map, segments_info) pairs per image_id, predictions and ground
    truth, matched in memory; PQ, SQ and RQ for all categories, the things
    (_th) and the stuff (_st), in percent. Category ids are compared as
    given (with `isthing`): predictions and ground truth share the
    loader's thing and stuff spaces. An image with ground truth and no
    prediction counts every non-crowd segment as a false negative."""

    tasks = ("panoptic_seg",)

    def __init__(self, dataset_name: str = ""):
        self.dataset_name = dataset_name
        self.reset()

    def reset(self):
        self._preds: Dict[object, Tuple[np.ndarray, list]] = {}
        self._gts: Dict[object, Tuple[np.ndarray, list]] = {}

    def process(self, image_id, panoptic_ids: np.ndarray, segments_info: List[dict]):
        self._preds[image_id] = (np.asarray(panoptic_ids), list(segments_info))

    def process_gt(self, image_id, panoptic_ids: np.ndarray, segments_info: List[dict]):
        self._gts[image_id] = (np.asarray(panoptic_ids), list(segments_info))

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        total = PQStat()
        missing = 0
        for image_id, (gt_map, gt_segs) in self._gts.items():
            if image_id in self._preds:
                pred = self._preds[image_id]
            else:
                pred = (np.zeros_like(gt_map), [])
                missing += 1
            total += pq_compute_single_image(gt_map, gt_segs, pred[0], pred[1])
        if missing:
            logger.warning("%d images had ground truth and no prediction (counted as false negatives)", missing)
        out = {}
        for name, flag in (("", None), ("_th", True), ("_st", False)):
            avg = total.average(isthing=flag)
            out[f"PQ{name}"] = 100.0 * avg["pq"]
            out[f"SQ{name}"] = 100.0 * avg["sq"]
            out[f"RQ{name}"] = 100.0 * avg["rq"]
        logger.info("Panoptic results: PQ %.3f SQ %.3f RQ %.3f (th %.3f / st %.3f)", out["PQ"], out["SQ"], out["RQ"],
                    out["PQ_th"], out["PQ_st"])
        return {"panoptic_seg": out}


def load_gt_panoptic(meta: dict):
    """A record's ground truth (id map, segments_info): its `pan_seg_ids`,
    or its panoptic PNG decoded; (None, None) without either."""
    if "pan_seg_ids" in meta:
        return np.asarray(meta["pan_seg_ids"]), meta["segments_info"]
    if "pan_seg_file_name" in meta:
        from PIL import Image

        from ..data.datasets.coco_panoptic import rgb2id

        return rgb2id(np.asarray(Image.open(meta["pan_seg_file_name"]).convert("RGB"))), meta["segments_info"]
    return None, None


def inference_on_dataset_panoptic(model, data_loader, evaluator: COCOPanopticEvaluator,
                                  combine_kwargs: Optional[dict] = None, device=None) -> Dict[str, dict]:
    """PanopticFPN's inference over the loader; per real image the argmax
    map cropped to its true size and resized NEAREST to its original size,
    the boxes scaled by original / true size (float32), then the host
    combine (`combine_kwargs`: overlap_threshold, stuff_area_limit,
    instances_score_thresh) with the masks' paste where the model gives
    masks, fed with the record's ground truth. Under a process group rank 0 scores and every rank returns the
    metrics."""
    from ..models.panoptic_fpn import combine_semantic_and_instance_outputs

    evaluator.reset()
    device = device if device is not None else next(model.parameters()).device
    kw = combine_kwargs or {}

    def infer(batch):
        det, sem = model.inference(batch)
        boxes, scores, classes, valid = (t.cpu().numpy() for t in (det.boxes, det.scores, det.classes, det.valid))
        masks = None if det.masks is None else det.masks.cpu().numpy()
        sem = sem.cpu().numpy()
        sizes, origs = batch.image_sizes.cpu().numpy(), batch.orig_sizes.cpu().numpy()
        rows = []
        for i in range(len(sem)):
            (h, w), (oh, ow) = sizes[i], origs[i]
            sx, sy = ow / max(w, 1), oh / max(h, 1)
            rows.append(combine_semantic_and_instance_outputs(
                boxes[i] * np.array([sx, sy, sx, sy], np.float32), scores[i], classes[i], valid[i],
                nearest_resize(sem[i][:h, :w], (oh, ow)), det_masks=None if masks is None else masks[i], **kw))
        return rows

    def feed(meta, row):
        evaluator.process(meta["image_id"], *row)
        gt_map, gt_segs = load_gt_panoptic(meta)
        if gt_map is not None:
            evaluator.process_gt(meta["image_id"], gt_map, gt_segs)

    feed_rows(data_loader, infer, feed, device, "Panoptic")
    if comm.get_world_size() == 1:
        return evaluator.evaluate()
    return comm.broadcast_object(evaluator.evaluate() if comm.is_main_process() else None)
