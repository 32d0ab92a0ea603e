"""Region Proposal Network, inference half (counterpart of
cddmsl_tpu/models/rpn.py `StandardRPNHead` and `RPN`). Training (matching,
sampling, losses) is not ported yet."""

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.anchors import anchor_grid, generate_cell_anchors
from ..ops.box_regression import Box2BoxTransform
from ..ops.nms import nms
from ..structures import boxes as box_ops


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, K, 4)
    scores: torch.Tensor  # (B, K) objectness logits, -inf where invalid
    valid: torch.Tensor  # (B, K) bool


class StandardRPNHead(nn.Module):
    """3x3 conv + two sibling 1x1 convs (detectron2 `rpn_head` key names)."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * box_dim, 1)

    @staticmethod
    def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), padding=layer.padding)

    def forward(self, x: torch.Tensor):
        """x: (B, C, H, W) channels_last -> logits (B, A, H, W), deltas (B, A*4, H, W)."""
        t = F.relu(self._conv(self.conv, x))
        return self._conv(self.objectness_logits, t), self._conv(self.anchor_deltas, t)


class RPN(nn.Module):
    """Single-level RPN (C4) at stride 16; inference only."""

    def __init__(
        self,
        in_channels: int,
        stride: int = 16,
        anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
        anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        anchor_offset: float = 0.0,
        bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
        pre_nms_topk_test: int = 6000,
        post_nms_topk_test: int = 1000,
        nms_thresh: float = 0.7,
        min_box_size: float = 0.0,
    ):
        super().__init__()
        self.stride = stride
        self.anchor_offset = anchor_offset
        self.pre_nms_topk_test = pre_nms_topk_test
        self.post_nms_topk_test = post_nms_topk_test
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.cell_anchors = generate_cell_anchors(anchor_sizes, anchor_aspect_ratios)
        self.rpn_head = StandardRPNHead(in_channels, self.cell_anchors.shape[0])
        self.box2box = Box2BoxTransform(bbox_reg_weights)

    def forward(self, features: torch.Tensor, image_sizes: torch.Tensor, training: bool = False) -> Proposals:
        """features (B, H, W, C) NHWC res4, image_sizes (B, 2) true (h, w)."""
        if training:
            raise NotImplementedError("RPN training (matching, sampling, losses) is not ported")
        b, h, w, _ = features.shape
        a = self.cell_anchors.shape[0]
        logits_map, deltas_map = self.rpn_head(features.permute(0, 3, 1, 2))
        # (B, A, H, W) -> (B, H, W, A) before flattening: anchors are HWA-ordered
        logits = logits_map.permute(0, 2, 3, 1).reshape(b, h * w * a).float()
        deltas = deltas_map.permute(0, 2, 3, 1).reshape(b, h * w * a, 4).float()
        anchors = anchor_grid(h, w, self.stride, self.cell_anchors, self.anchor_offset, device=features.device)
        return self._predict_proposals(anchors, logits, deltas, image_sizes)

    @torch.no_grad()
    def _predict_proposals(self, anchors, logits, deltas, image_sizes) -> Proposals:
        pre_k = min(self.pre_nms_topk_test, anchors.shape[0])
        post_k = self.post_nms_topk_test
        top_scores, top_idx = torch.sort(logits, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :pre_k], top_idx[:, :pre_k]
        top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4))
        top_boxes = self.box2box.apply_deltas(top_deltas, anchors[top_idx])
        hw = image_sizes.to(top_boxes.device)
        top_boxes = box_ops.clip(top_boxes, (hw[:, 0, None], hw[:, 1, None]))
        ok = box_ops.nonempty(top_boxes, self.min_box_size)
        # NaN/Inf guard: non-finite proposals are dropped
        ok &= torch.all(torch.isfinite(top_boxes), dim=-1) & torch.isfinite(top_scores)
        idx, valid = nms(top_boxes, top_scores, self.nms_thresh, post_k, valid=ok)
        boxes = torch.gather(top_boxes, 1, idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(top_scores, 1, idx)
        scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        return Proposals(boxes=boxes, scores=scores, valid=valid)
