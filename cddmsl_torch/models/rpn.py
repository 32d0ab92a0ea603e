"""Region Proposal Network (counterpart of cddmsl_tpu/models/rpn.py
`StandardRPNHead`, `RPN`, `FPNRPN` and `smooth_l1`): the head, the
proposals (kernel K4 for the NMS) and, in training, anchor matching (IoU
0.3 / 0.7 with low-quality matches), balanced sampling and the objectness
and smooth-L1 box losses (L1 at beta 0).

With `box_reg_loss_type` "giou" the box loss decodes each positive
anchor's deltas and takes 1 - GIoU against its matched ground truth
(MODEL.RPN.BBOX_REG_LOSS_TYPE); BBOX_REG_LOSS_WEIGHT scales it either way.

`FPNRPN` runs one shared head on every FPN level, each with its own anchor
grid, takes each level's pre-NMS top-k, matches the anchors of all levels
jointly, and keeps the post-NMS top-k of one NMS over all levels' candidates,
each level moved apart by lvl * (max(h, w) + 1) in float32 so that boxes of
different levels never overlap (detectron2's batched_nms by level)."""

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.anchors import anchor_grid, generate_cell_anchors
from ..ops.box_regression import Box2BoxTransform
from ..ops.nms import nms
from ..structures import boxes as box_ops
from .matcher import Matcher
from .sampling import Draw, subsample_labels


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1; beta 0 is L1 (fvcore's rule)."""
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, K, 4)
    scores: torch.Tensor  # (B, K) objectness logits, -inf where invalid
    valid: torch.Tensor  # (B, K) bool


class StandardRPNHead(nn.Module):
    """3x3 conv + two sibling 1x1 convs (detectron2 `rpn_head` key names);
    the 3x3 has `conv_dim` outputs (in_channels unless given: the rotated
    RPN's is 1024 whatever its input, as in JAX)."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4, conv_dim: Optional[int] = None):
        super().__init__()
        conv_dim = conv_dim or in_channels
        self.conv = nn.Conv2d(in_channels, conv_dim, 3, padding=1)
        self.objectness_logits = nn.Conv2d(conv_dim, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(conv_dim, num_anchors * box_dim, 1)

    @staticmethod
    def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), padding=layer.padding)

    def forward(self, x: torch.Tensor):
        """x: (B, C, H, W) channels_last -> logits (B, A, H, W), deltas (B, A*box_dim, H, W)."""
        t = F.relu(self._conv(self.conv, x))
        return self._conv(self.objectness_logits, t), self._conv(self.anchor_deltas, t)


class RPN(nn.Module):
    """Single-level RPN (C4) at stride 16."""

    def __init__(
        self,
        in_channels: int,
        stride: int = 16,
        anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
        anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        anchor_offset: float = 0.0,
        batch_size_per_image: int = 256,
        positive_fraction: float = 0.5,
        bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
        loss_weight: float = 1.0,
        pre_nms_topk_train: int = 12000,
        pre_nms_topk_test: int = 6000,
        post_nms_topk_train: int = 2000,
        post_nms_topk_test: int = 1000,
        nms_thresh: float = 0.7,
        min_box_size: float = 0.0,
        smooth_l1_beta: float = 0.0,
        box_reg_loss_weight: float = 1.0,
        box_reg_loss_type: str = "smooth_l1",
    ):
        super().__init__()
        if box_reg_loss_type not in ("smooth_l1", "giou"):
            raise ValueError(f"box_reg_loss_type {box_reg_loss_type!r}: 'smooth_l1' or 'giou'")
        self.stride = stride
        self.anchor_offset = anchor_offset
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.loss_weight = loss_weight
        self.pre_nms_topk = {True: pre_nms_topk_train, False: pre_nms_topk_test}
        self.post_nms_topk = {True: post_nms_topk_train, False: post_nms_topk_test}
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_weight = box_reg_loss_weight
        self.box_reg_loss_type = box_reg_loss_type
        self.cell_anchors = generate_cell_anchors(anchor_sizes, anchor_aspect_ratios)
        self.rpn_head = StandardRPNHead(in_channels, self.cell_anchors.shape[0])
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.matcher = Matcher((0.3, 0.7), (0, -1, 1), allow_low_quality_matches=True)

    def forward(
        self,
        features: torch.Tensor,
        image_sizes: torch.Tensor,
        training: bool = False,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        draw: Optional[Draw] = None,
    ) -> Tuple[Proposals, Dict[str, torch.Tensor]]:
        """features (B, H, W, C) NHWC res4, image_sizes (B, 2) true (h, w) ->
        (proposals, losses). In training, gt_boxes (B, G, 4), gt_valid
        (B, G) and `draw` (sites "rpn_pos", "rpn_neg") give the losses; the
        proposals never carry a gradient."""
        anchors, logits, deltas = self._head(features)
        losses: Dict[str, torch.Tensor] = {}
        if training:
            if gt_boxes is None or gt_valid is None or draw is None:
                raise ValueError("RPN training needs gt_boxes, gt_valid and draw")
            losses = self._losses(anchors, logits, deltas, gt_boxes, gt_valid, draw)
        return self._predict_proposals(anchors, logits.detach(), deltas.detach(), image_sizes, training), losses

    def _head(self, features: torch.Tensor, stride: Optional[int] = None, cell_anchors=None):
        """One map (B, H, W, C) at `stride` with `cell_anchors` (by default
        the RPN's own) -> anchors (A_total, 4), logits (B, A_total) and
        deltas (B, A_total, 4) in float32, in HWA order."""
        stride = self.stride if stride is None else stride
        cell_anchors = self.cell_anchors if cell_anchors is None else cell_anchors
        b, h, w, _ = features.shape
        a = cell_anchors.shape[0]
        logits_map, deltas_map = self.rpn_head(features.permute(0, 3, 1, 2))
        # (B, A, H, W) -> (B, H, W, A) before flattening: anchors are HWA-ordered
        logits = logits_map.permute(0, 2, 3, 1).reshape(b, h * w * a).float()
        deltas = deltas_map.permute(0, 2, 3, 1).reshape(b, h * w * a, 4).float()
        anchors = anchor_grid(h, w, stride, cell_anchors, self.anchor_offset, device=features.device)
        return anchors, logits, deltas

    def _losses(self, anchors, logits, deltas, gt_boxes, gt_valid, draw: Draw) -> Dict[str, torch.Tensor]:
        """Matching, balanced sampling, BCE objectness and the smooth-L1 (or
        1 - GIoU) box loss, summed over the sampled anchors and normalized by
        batch_size_per_image * B."""
        b, n = logits.shape
        iou = box_ops.pairwise_iou(gt_boxes, anchors.expand(b, -1, -1))  # (B, G, A)
        matched_idxs, match_labels = self.matcher(iou, gt_valid)
        pos_sel, neg_sel = subsample_labels(
            match_labels == 1, match_labels == 0, self.batch_size_per_image, self.positive_fraction,
            draw("rpn_pos", (b, n)), draw("rpn_neg", (b, n)),
        )
        matched_gt = torch.gather(gt_boxes, 1, matched_idxs[..., None].expand(-1, -1, 4))  # (B, A, 4)
        if self.box_reg_loss_type == "giou":
            pred = self.box2box.apply_deltas(deltas, anchors.expand(b, -1, -1))
            loc = ((1.0 - box_ops.pairwise_giou(pred, matched_gt)) * pos_sel).sum()
        else:
            gt_deltas = self.box2box.get_deltas(anchors.expand(b, -1, -1), matched_gt)
            loc = (smooth_l1(deltas, gt_deltas, self.smooth_l1_beta) * pos_sel[..., None]).sum()
        target = pos_sel.float()
        bce = torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
        cls = (bce * (pos_sel | neg_sel)).sum()
        # a count per image, the same on every rank: the ranks' mean of this
        # loss is the global batch's without a global count
        normalizer = self.batch_size_per_image * b
        return {
            "loss_rpn_cls": cls / normalizer * self.loss_weight,
            "loss_rpn_loc": loc / normalizer * self.loss_weight * self.box_reg_loss_weight,
        }

    @torch.no_grad()
    def _nms_inputs(self, anchors, logits, deltas, image_sizes, training: bool):
        """The pre-NMS top-k: decoded boxes clipped to the image (B, k, 4),
        their logits (B, k) and which of them may be kept (B, k)."""
        pre_k = min(self.pre_nms_topk[training], anchors.shape[0])
        top_scores, top_idx = torch.sort(logits, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :pre_k], top_idx[:, :pre_k]
        top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4))
        top_boxes = self.box2box.apply_deltas(top_deltas, anchors[top_idx])
        hw = image_sizes.to(top_boxes.device)
        top_boxes = box_ops.clip(top_boxes, (hw[:, 0, None], hw[:, 1, None]))
        ok = box_ops.nonempty(top_boxes, self.min_box_size)
        # NaN/Inf guard: non-finite proposals are dropped
        ok &= torch.all(torch.isfinite(top_boxes), dim=-1) & torch.isfinite(top_scores)
        return top_boxes, top_scores, ok

    @torch.no_grad()
    def _predict_proposals(self, anchors, logits, deltas, image_sizes, training: bool) -> Proposals:
        top_boxes, top_scores, ok = self._nms_inputs(anchors, logits, deltas, image_sizes, training)
        idx, valid = nms(top_boxes, top_scores, self.nms_thresh, self.post_nms_topk[training], valid=ok)
        boxes = torch.gather(top_boxes, 1, idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(top_scores, 1, idx)
        scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        return Proposals(boxes=boxes, scores=scores, valid=valid)


class FPNRPN(RPN):
    """The RPN over FPN levels (or, with one level, the DC5 map): `strides`
    and `anchor_sizes` give one entry per level, a size or a tuple of sizes,
    each with every aspect ratio; every level must have the same number of
    anchors per cell (the head is shared). `pre_nms_topk_*` is per level."""

    def __init__(self, in_channels: int, strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes: Sequence = (32, 64, 128, 256, 512),
                 anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0), **kw):
        sizes = [tuple(s) if isinstance(s, (tuple, list)) else (s,) for s in anchor_sizes]
        if len(sizes) != len(strides):
            raise ValueError(f"FPNRPN wants one anchor-size entry per level: {len(sizes)} for {len(strides)} levels")
        super().__init__(in_channels, stride=strides[0], anchor_sizes=sizes[0],
                         anchor_aspect_ratios=anchor_aspect_ratios, **kw)
        self.strides = tuple(strides)
        self.level_cell_anchors = [generate_cell_anchors(s, anchor_aspect_ratios) for s in sizes]
        counts = {c.shape[0] for c in self.level_cell_anchors}
        if len(counts) != 1:
            raise ValueError(f"per-level anchor counts must match, got {counts}")

    def _levels(self, features: Sequence[torch.Tensor]):
        """Per level: anchors (A_l, 4), logits (B, A_l) and deltas (B, A_l, 4)
        in float32, HWA order."""
        return [self._head(f, s, c) for f, s, c in zip(features, self.strides, self.level_cell_anchors)]

    def forward(
        self,
        features: Sequence[torch.Tensor],
        image_sizes: torch.Tensor,
        training: bool = False,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        draw: Optional[Draw] = None,
    ) -> Tuple[Proposals, Dict[str, torch.Tensor]]:
        """features: per level (B, H_l, W_l, C) NHWC -> (proposals, losses),
        as `RPN.forward`; the losses match the anchors of all levels at
        once (draw sites "rpn_pos", "rpn_neg" over all of them)."""
        levels = self._levels(features)
        losses: Dict[str, torch.Tensor] = {}
        if training:
            if gt_boxes is None or gt_valid is None or draw is None:
                raise ValueError("RPN training needs gt_boxes, gt_valid and draw")
            anchors, logits, deltas = (torch.cat(t, dim=0 if i == 0 else 1) for i, t in enumerate(zip(*levels)))
            losses = self._losses(anchors, logits, deltas, gt_boxes, gt_valid, draw)
        return self._predict_levels(levels, image_sizes, training), losses

    @torch.no_grad()
    def nms_inputs(self, levels, image_sizes, training: bool):
        """What the cross-level NMS gets: each level's pre-NMS top-k boxes
        (B, N, 4), moved apart by level, their logits (B, N), -inf where a
        box may not be kept, and which may be kept (B, N); with the boxes
        unmoved."""
        boxes, scores, level_ids = [], [], []
        for lvl, (anchors, logits, deltas) in enumerate(levels):
            top_boxes, top_scores, ok = self._nms_inputs(anchors, logits.detach(), deltas.detach(), image_sizes,
                                                         training)
            boxes.append(top_boxes)
            scores.append(torch.where(ok, top_scores, torch.full_like(top_scores, float("-inf"))))
            level_ids.append(torch.full(top_scores.shape, lvl, dtype=torch.float32, device=top_scores.device))
        boxes, scores, level_ids = torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(level_ids, 1)
        hw = image_sizes.to(boxes.device)
        offset = level_ids * (torch.amax(hw, dim=1).float() + 1.0)[:, None]
        return boxes + offset[..., None], scores, scores > float("-inf"), boxes

    @torch.no_grad()
    def _predict_levels(self, levels, image_sizes, training: bool) -> Proposals:
        shifted, scores, ok, boxes = self.nms_inputs(levels, image_sizes, training)
        idx, valid = nms(shifted, scores, self.nms_thresh, self.post_nms_topk[training], valid=ok)
        boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(scores, 1, idx)
        return Proposals(boxes=boxes, scores=torch.where(valid, scores, torch.full_like(scores, float("-inf"))),
                         valid=valid)
