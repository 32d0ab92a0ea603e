"""Cityscapes evaluators (counterpart of
cddmsl_tpu/evaluation/cityscapes_eval.py). detectron2 scores them with the
cityscapesscripts package; JAX computes them natively, and so does the port:

- `CityscapesInstanceEvaluator`: COCO AP over IoU .50:.95 per thing class,
  reported as AP and AP50 only, on masks ("segm"), or on boxes ("bbox")
  with a warning that the box AP is a proxy for the published mask-level
  metric;
- `CityscapesSemSegEvaluator`: the confusion-matrix metrics over the 19
  evaluation classes, ignoring label 255.

No registered set names the "cityscapes_instance" evaluator type: Cityscapes'
instance sets (cityscapes_fine_instance_seg_*) are VOC-scored box sets, as
in JAX (`build_evaluator`).
"""

import logging
from typing import Dict

from .coco_eval import COCOEvaluator
from .sem_seg_eval import SemSegEvaluator

CITYSCAPES_THING_CLASSES = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]

logger = logging.getLogger(__name__)


class CityscapesInstanceEvaluator(COCOEvaluator):
    def __init__(self, dataset_name: str = "", tasks=("segm",)):
        if "segm" not in tasks:
            logger.warning("CityscapesInstanceEvaluator without a mask head: reporting bbox-IoU AP, a proxy for "
                           "the published mask-level metric")
        super().__init__(dataset_name, tasks=tasks)
        if not dataset_name:  # no set: the 8 Cityscapes things (a named set's classes, or 80, as in JAX)
            self.class_names = list(CITYSCAPES_THING_CLASSES)
            self.num_classes = len(CITYSCAPES_THING_CLASSES)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        # cityscapesscripts reports AP and AP50 (no AP75 or area splits)
        return {task: {"AP": res["AP"], "AP50": res["AP50"]} for task, res in super().evaluate().items()}


class CityscapesSemSegEvaluator(SemSegEvaluator):
    """Semantic IoU over the 19 evaluation classes (evalPixelLevel's metrics)."""

    CLASSES = ["road", "sidewalk", "building", "wall", "fence", "pole", "traffic light", "traffic sign",
               "vegetation", "terrain", "sky", "person", "rider", "car", "truck", "bus", "train", "motorcycle",
               "bicycle"]

    def __init__(self, dataset_name: str = ""):
        super().__init__(dataset_name="", num_classes=len(self.CLASSES), ignore_label=255, class_names=self.CLASSES)
