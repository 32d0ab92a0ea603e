"""COCO-style AP over rotated (XYWHA) boxes (counterpart of
cddmsl_tpu/evaluation/rotated_coco_eval.py): `COCOEvaluator`'s matching
and precision with the rotated IoU of ops/rotated.py, box areas w * h, the
bbox task only, crowd ground truth refused (detectron2's
RotatedCOCOEvaluator asserts none), and detections dumped in their 5-d
layout."""

import json
import os

import numpy as np
import torch

from ..ops.rotated import pairwise_iou_rotated
from .coco_eval import COCOEvaluator


class RotatedCOCOEvaluator(COCOEvaluator):
    """COCOEvaluator over (N, 5) XYWHA boxes (absolute degrees)."""

    box_dim = 5

    def __init__(self, dataset_name: str = "", output_json=None):
        super().__init__(dataset_name, output_json=output_json, tasks=("bbox",))

    def _box_area(self, boxes: np.ndarray) -> np.ndarray:
        if len(boxes) == 0:
            return np.zeros(0)
        return boxes[:, 2] * boxes[:, 3]

    def _box_iou(self, dets: np.ndarray, gts: np.ndarray, iscrowd) -> np.ndarray:
        if len(dets) == 0 or len(gts) == 0:
            return np.zeros((len(dets), len(gts)))
        if np.any(iscrowd):
            raise NotImplementedError("RotatedCOCOEvaluator does not support crowd ground truth")
        iou = pairwise_iou_rotated(torch.from_numpy(np.asarray(dets, np.float32)),
                                   torch.from_numpy(np.asarray(gts, np.float32)))
        return iou.numpy().astype(np.float64)

    def dump_predictions(self, path: str) -> None:
        """The detections with their XYWHA boxes as they are."""
        records = [{"image_id": img, "category_id": int(c), "bbox": [float(v) for v in box], "score": float(score)}
                   for c, per_img in self._dets.items() for img, dets in per_img.items() for score, box, _ in dets]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(records, f)
