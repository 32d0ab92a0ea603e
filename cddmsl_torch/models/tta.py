"""Test-time augmentation (counterpart of cddmsl_tpu/models/tta.py
`GeneralizedRCNNWithTTA`): the detector's inference on the batch and on its
horizontal flip, the flipped detections mapped back across the original
width, both sets concatenated and merged by one class-aware NMS per image
(`batched_nms`, kernel K4 on the card).

As in JAX the flip mirrors the whole padded canvas, and the unflip reads
each image's original width (`orig_sizes`), the frame the detections come
back in. JAX's trainer never wraps a model in it (TEST.AUG.ENABLED is read
nowhere there, and `check_supported` refuses it): it is built by hand
around any detector whose `inference(batch)` gives a `DetectionResult`.
"""

from typing import List

import torch

from ..ops.nms import batched_nms
from .fast_rcnn import DetectionResult
from .rcnn import DetBatch


def _flip_batch(batch: DetBatch) -> DetBatch:
    return batch._replace(image=batch.image.flip(2),
                          image_trgt=None if batch.image_trgt is None else batch.image_trgt.flip(2))


def _unflip_boxes(boxes: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    x1 = widths[:, None] - boxes[..., 2]
    x2 = widths[:, None] - boxes[..., 0]
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


class GeneralizedRCNNWithTTA:
    def __init__(self, model, flip: bool = True, nms_thresh: float = 0.5, max_det: int = 100):
        self.model = model
        self.flip = flip
        self.nms_thresh = nms_thresh
        self.max_det = max_det

    @torch.no_grad()
    def __call__(self, batch: DetBatch) -> DetectionResult:
        results: List[DetectionResult] = [self.model.inference(batch)]
        if self.flip:
            det_f = self.model.inference(_flip_batch(batch))
            widths = batch.orig_sizes[:, 1].to(det_f.boxes.device, torch.float32)
            results.append(det_f._replace(boxes=_unflip_boxes(det_f.boxes, widths)))
        boxes, scores, classes, valid = (torch.cat([getattr(r, f) for r in results], dim=1)
                                         for f in ("boxes", "scores", "classes", "valid"))
        idx, keep = batched_nms(boxes, scores, classes, self.nms_thresh, self.max_det, valid=valid)
        take = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
        return DetectionResult(boxes[take, idx], torch.where(keep, scores[take, idx], torch.zeros_like(keep, dtype=scores.dtype)),
                               classes[take, idx], keep)
