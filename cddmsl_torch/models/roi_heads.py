"""C4 RoI heads for the CLIP ResNet, inference half (counterpart of
cddmsl_tpu/models/roi_heads.py `CLIPRes5ROIHeads`): RoIAlign 14x14 at 1/16
on res4 (kernel K1 on the card) -> the backbone's res5 on every crop ->
AttentionPool2d -> cosine classifier -> class-aware NMS (kernel K4)."""

from typing import Callable, Sequence

import torch
from torch import nn

from ..ops.box_regression import Box2BoxTransform
from ..ops.roi_align import roi_align_batched
from .fast_rcnn import DetectionResult, FastRCNNOutputLayers, fast_rcnn_inference
from .rpn import Proposals


class CLIPRes5ROIHeads(nn.Module):
    def __init__(
        self,
        num_classes: int = 20,
        emb_dim: int = 1024,
        temperature: float = 0.01,
        pooler_resolution: int = 14,
        pooler_scale: float = 1.0 / 16,
        pooler_sampling_ratio: int = 0,
        bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.box_predictor = FastRCNNOutputLayers(num_classes, emb_dim, temperature)
        self.box2box = Box2BoxTransform(bbox_reg_weights)

    def pool(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """features (B, H, W, C), boxes (B, S, 4) -> (B*S, P, P, C)."""
        b, s = boxes.shape[:2]
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(s)
        p = self.pooler_resolution
        return roi_align_batched(
            features.contiguous(), batch_idx, boxes.reshape(b * s, 4).float().contiguous(),
            (p, p), self.pooler_scale, self.pooler_sampling_ratio, True,
        )

    def _region_embed(self, features, boxes, res5_fn: Callable, attnpool_fn: Callable) -> torch.Tensor:
        """(B,H,W,C) x (B,S,4) -> (B*S, emb): pool -> res5 -> attention pool."""
        return attnpool_fn(res5_fn(self.pool(features, boxes)))

    def forward(
        self,
        features: torch.Tensor,
        proposals: Proposals,
        image_sizes: torch.Tensor,
        res5_fn: Callable,
        attnpool_fn: Callable,
        training: bool = False,
    ) -> DetectionResult:
        if training:
            raise NotImplementedError("RoI-head training (sampling, losses) is not ported")
        b, k = proposals.boxes.shape[:2]
        region_feats = self._region_embed(features, proposals.boxes, res5_fn, attnpool_fn)
        scores, deltas = self.box_predictor(region_feats)
        return fast_rcnn_inference(
            scores.reshape(b, k, -1),
            deltas.reshape(b, k, -1),
            proposals.boxes,
            proposals.valid,
            image_sizes,
            self.box2box,
            self.num_classes,
            score_thresh=self.score_thresh_test,
            nms_thresh=self.nms_thresh_test,
            topk_per_image=self.detections_per_image,
        )
