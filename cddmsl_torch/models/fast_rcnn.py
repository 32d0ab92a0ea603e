"""Fast R-CNN output layers, losses and static-shape inference (counterpart
of cddmsl_tpu/models/fast_rcnn.py `FastRCNNOutputLayers`, `fast_rcnn_losses`,
`DetectionResult` and `fast_rcnn_inference_single_image`).

The classifier is the cosine against frozen text embeddings
(MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER) or a trainable linear layer of K + 1
logits, background last. The box regressor gives K boxes, or one that every
class shares (MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG). Inference ends in
the class-aware NMS (kernel K4), or with MODEL.ROI_HEADS.SOFT_NMS_ENABLED in
the class-aware soft-NMS, whose decayed scores are the detections'. Two
options of the open-vocabulary recipes change the candidates: with
MODEL.CLIP.NO_BOX_DELTA every class keeps the proposal's own box, and with
MULTIPLY_RPN_SCORE a class's score is sqrt(prob * the proposal's raw
objectness logit), NaN where the logit is negative, and such a candidate
drops out before the ranking, as in JAX.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_regression import Box2BoxTransform
from ..ops.nms import batched_nms
from ..ops.soft_nms import batched_soft_nms
from ..parallel import comm
from ..structures import boxes as box_ops
from .rpn import smooth_l1


class DetectionResult(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4)
    scores: torch.Tensor  # (B, D)
    classes: torch.Tensor  # (B, D) int32
    valid: torch.Tensor  # (B, D) bool


class FastRCNNOutputLayers(nn.Module):
    """The classifier and the box regressor (detectron2 `box_predictor.
    cls_score` / `bbox_pred` keys). With `use_text_emb` the classifier is the
    cosine against frozen text embeddings, (K, D) without a bias, and the
    background logit is a zero embedding, so it is 0 before /T; otherwise a
    trainable linear layer of K + 1 logits. `bbox_pred` gives 4 deltas per
    class, or 4 in all with `cls_agnostic_bbox_reg`."""

    def __init__(self, num_classes: int, input_size: int, temperature: float = 0.01, use_text_emb: bool = True,
                 cls_agnostic_bbox_reg: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.temperature = temperature
        self.use_text_emb = use_text_emb
        if use_text_emb:
            self.cls_score = nn.Linear(input_size, num_classes, bias=False)
        else:
            self.cls_score = nn.Linear(input_size, num_classes + 1)
        self.bbox_pred = nn.Linear(input_size, 4 if cls_agnostic_bbox_reg else num_classes * 4)

    @staticmethod
    def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype)).float()

    def forward(self, x: torch.Tensor):
        """x (N, D) region features -> scores (N, K+1) fp32, deltas (N, K*4)
        or (N, 4) fp32."""
        x = x.reshape(x.shape[0], -1)
        if self.use_text_emb:
            xn = x / torch.clamp(torch.linalg.vector_norm(x.float(), dim=1, keepdim=True), min=1e-12)
            w = self.cls_score.weight
            wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True), min=1e-12)
            cls_scores = xn @ wn.T
            bg = torch.zeros((x.shape[0], 1), dtype=cls_scores.dtype, device=x.device)
            scores = torch.cat([cls_scores, bg], dim=1) / self.temperature
        else:
            scores = self._linear(self.cls_score, x)
        return scores, self._linear(self.bbox_pred, x)


def fast_rcnn_losses(
    scores: torch.Tensor,  # (N, K+1) logits
    deltas: torch.Tensor,  # (N, K*4)
    proposal_boxes: torch.Tensor,  # (N, 4)
    gt_boxes: torch.Tensor,  # (N, 4) matched ground truth of each proposal
    gt_classes: torch.Tensor,  # (N,) in [0, K], K = background
    valid: torch.Tensor,  # (N,) sampled rows
    num_classes: int,
    box2box: Box2BoxTransform,
    focal_gamma: Optional[float] = None,
    bg_loss_weight: Optional[float] = None,
    smooth_l1_beta: float = 0.0,
    box_reg_loss_weight: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Focal-scaled cross-entropy with an optional background weight, and the
    smooth-L1 box loss (L1 at `smooth_l1_beta` 0), times
    `box_reg_loss_weight`, of the ground-truth class (of the one box when
    `deltas` has 4 columns) over foreground rows. Both are means over the valid rows, as the JAX package
    takes them; under a process group over the global batch's valid rows
    (a sampler that does not fill its quota leaves ranks with different
    counts), so that the ranks' mean is the global loss."""
    n = scores.shape[0]
    valid_f = valid.float()
    n_valid = comm.global_normalizer(valid_f.sum())

    gt_safe = torch.where(valid, gt_classes, torch.full_like(gt_classes, num_classes)).long()
    ce = -torch.gather(F.log_softmax(scores, dim=-1), 1, gt_safe[:, None])[:, 0]
    if focal_gamma is not None:
        ce = ce * (1.0 - torch.exp(-ce)) ** focal_gamma
    if bg_loss_weight is not None:
        ce = ce * torch.where(gt_safe == num_classes, bg_loss_weight, 1.0)
    loss_cls = (ce * valid_f).sum() / n_valid

    fg = valid & (gt_classes >= 0) & (gt_classes < num_classes)
    if deltas.shape[1] == 4:  # class-agnostic: one box for every class
        fg_deltas = deltas
    else:
        fg_cls = torch.clamp(gt_classes, 0, num_classes - 1).long()
        fg_deltas = torch.gather(deltas.reshape(n, num_classes, 4), 1, fg_cls[:, None, None].expand(-1, 1, 4))[:, 0]
    gt_deltas = box2box.get_deltas(proposal_boxes, gt_boxes)
    reg = smooth_l1(fg_deltas, gt_deltas, smooth_l1_beta).sum(dim=1)
    loss_box = (reg * fg.float()).sum() / n_valid * box_reg_loss_weight
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def detection_candidates(
    scores: torch.Tensor,  # (B, R, K+1) logits
    deltas: torch.Tensor,  # (B, R, K*4) or (B, R, 4)
    proposal_boxes: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    image_hw: torch.Tensor,  # (B, 2)
    box2box: Box2BoxTransform,
    num_classes: int,
    score_thresh: float = 0.05,
    max_candidates: int = 2048,
    no_box_delta: bool = False,
    rpn_scores: Optional[torch.Tensor] = None,  # (B, R) objectness logits
    multiply_rpn_score: bool = False,
):
    """What `fast_rcnn_inference` hands to the class-aware NMS: softmax, drop
    the background (then with `multiply_rpn_score` the geometric mean with
    `rpn_scores`), per-class score threshold, the top `max_candidates`
    candidates -> boxes (B, M, 4), scores (B, M), classes (B, M), valid
    (B, M). With `no_box_delta` the boxes are the proposals'."""
    b, r = scores.shape[:2]
    probs = torch.softmax(scores, dim=-1)[..., :-1]  # (B, R, K)
    if multiply_rpn_score and rpn_scores is not None:
        # the raw logit, not a probability: a negative one gives NaN, which
        # fails the threshold below and is zeroed before the sort
        probs = torch.sqrt(probs * rpn_scores.float()[:, :, None])
    if no_box_delta:
        boxes = proposal_boxes[:, :, None, :].expand(b, r, num_classes, 4)
    elif deltas.shape[-1] == 4:  # class-agnostic: one box, given to each class
        boxes = box2box.apply_deltas(deltas, proposal_boxes)[:, :, None, :].expand(b, r, num_classes, 4)
    else:
        boxes = box2box.apply_deltas(deltas.reshape(b, r, num_classes, 4), proposal_boxes[:, :, None, :])
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
    return top_boxes, top_scores, flat_classes[top_idx], top_scores > max(score_thresh, 0.0)


def fast_rcnn_inference(
    scores: torch.Tensor,  # (B, R, K+1) logits
    deltas: torch.Tensor,  # (B, R, K*4) or (B, R, 4)
    proposal_boxes: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    image_hw: torch.Tensor,  # (B, 2)
    box2box: Box2BoxTransform,
    num_classes: int,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    topk_per_image: int = 100,
    max_candidates: int = 2048,
    soft_nms: Optional[Tuple[str, float, float]] = None,
    no_box_delta: bool = False,
    rpn_scores: Optional[torch.Tensor] = None,
    multiply_rpn_score: bool = False,
) -> DetectionResult:
    """`fast_rcnn_inference_single_image` over a batch: the candidates of
    `detection_candidates`, class-aware NMS through the coordinate shift,
    top `topk_per_image`. With `soft_nms` = (method, sigma, prune) the
    class-aware soft-NMS replaces the NMS, `nms_thresh` as its linear
    threshold, and the detections carry its decayed scores. `no_box_delta`,
    `rpn_scores` and `multiply_rpn_score` go to `detection_candidates`."""
    top_boxes, top_scores, top_classes, top_valid = detection_candidates(
        scores, deltas, proposal_boxes, proposal_valid, image_hw, box2box, num_classes, score_thresh, max_candidates,
        no_box_delta, rpn_scores, multiply_rpn_score,
    )
    if soft_nms is not None:
        method, sigma, prune = soft_nms
        keep_idx, kept_scores, keep_valid = batched_soft_nms(
            top_boxes, top_scores, top_classes, method, sigma, nms_thresh, prune, topk_per_image, top_valid
        )
    else:
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
