"""Fast R-CNN output layers and static-shape inference (counterpart of
cddmsl_tpu/models/fast_rcnn.py `FastRCNNOutputLayers`, `DetectionResult`
and `fast_rcnn_inference_single_image`). Losses are not ported yet."""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_regression import Box2BoxTransform
from ..ops.nms import batched_nms
from ..structures import boxes as box_ops


class DetectionResult(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4)
    scores: torch.Tensor  # (B, D)
    classes: torch.Tensor  # (B, D) int32
    valid: torch.Tensor  # (B, D) bool


class FastRCNNOutputLayers(nn.Module):
    """Cosine classifier against frozen text embeddings plus the per-class
    box regressor (detectron2 `box_predictor.cls_score` / `bbox_pred` keys).
    The background logit is a zero embedding, so it is 0 before /T."""

    def __init__(self, num_classes: int, input_size: int, temperature: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.temperature = temperature
        self.cls_score = nn.Linear(input_size, num_classes, bias=False)
        self.bbox_pred = nn.Linear(input_size, num_classes * 4)

    def forward(self, x: torch.Tensor):
        """x (N, D) region features -> scores (N, K+1) fp32, deltas (N, K*4) fp32."""
        x = x.reshape(x.shape[0], -1)
        xn = x / torch.clamp(torch.linalg.vector_norm(x.float(), dim=1, keepdim=True), min=1e-12)
        w = self.cls_score.weight
        wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True), min=1e-12)
        cls_scores = xn @ wn.T
        bg = torch.zeros((x.shape[0], 1), dtype=cls_scores.dtype, device=x.device)
        scores = torch.cat([cls_scores, bg], dim=1) / self.temperature
        deltas = F.linear(x, self.bbox_pred.weight.to(x.dtype), self.bbox_pred.bias.to(x.dtype)).float()
        return scores, deltas


def fast_rcnn_inference(
    scores: torch.Tensor,  # (B, R, K+1) logits
    deltas: torch.Tensor,  # (B, R, K*4)
    proposal_boxes: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    image_hw: torch.Tensor,  # (B, 2)
    box2box: Box2BoxTransform,
    num_classes: int,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    topk_per_image: int = 100,
    max_candidates: int = 2048,
) -> DetectionResult:
    """`fast_rcnn_inference_single_image` over a batch: softmax, drop the
    background, per-class score threshold, top `max_candidates` candidates,
    class-aware NMS through the coordinate shift, top `topk_per_image`."""
    b, r = scores.shape[:2]
    probs = torch.softmax(scores, dim=-1)[..., :-1]  # (B, R, K)
    d = deltas.reshape(b, r, num_classes, 4)
    boxes = box2box.apply_deltas(d, proposal_boxes[:, :, None, :])  # (B, R, K, 4)
    hw = image_hw.to(boxes.device)
    boxes = box_ops.clip(boxes, (hw[:, 0, None, None], hw[:, 1, None, None]))

    cand_valid = (probs > score_thresh) & proposal_valid[:, :, None] & torch.all(torch.isfinite(boxes), dim=-1)
    flat_scores = torch.where(cand_valid, probs, torch.zeros_like(probs)).reshape(b, -1)
    flat_boxes = boxes.reshape(b, -1, 4)
    flat_classes = torch.arange(num_classes, device=scores.device).repeat(r)  # (R*K,)

    m = min(max_candidates, flat_scores.shape[1])
    top_scores, top_idx = torch.sort(flat_scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :m], top_idx[:, :m]
    top_boxes = torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = flat_classes[top_idx]
    top_valid = top_scores > max(score_thresh, 0.0)

    keep_idx, keep_valid = batched_nms(
        top_boxes, top_scores, top_classes, nms_thresh, max_out=topk_per_image, valid=top_valid
    )
    kept_scores = torch.gather(top_scores, 1, keep_idx)
    return DetectionResult(
        boxes=torch.gather(top_boxes, 1, keep_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, kept_scores, torch.zeros_like(kept_scores)),
        classes=torch.gather(top_classes, 1, keep_idx).to(torch.int32),
        valid=keep_valid,
    )
