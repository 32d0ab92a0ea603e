"""GeneralizedRCNN, inference path (counterpart of
cddmsl_tpu/models/rcnn.py `GeneralizedRCNN._normalize` and `inference`).

Only the modules inference runs are built: the backbone, the RPN and the
RoI heads. The offline backbone, the v2l mapper and the projectors of the
CDDMSL training branches are not.
"""

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..structures import boxes as box_ops
from .backbone.clip_resnet import ModifiedResNet
from .fast_rcnn import DetectionResult
from .roi_heads import CLIPRes5ROIHeads
from .rpn import RPN


class DetBatch(NamedTuple):
    """The fields of cddmsl_tpu's DetBatch that inference reads."""

    image: torch.Tensor  # (B, H, W, 3) float in [0, 255]
    image_sizes: torch.Tensor  # (B, 2) true (h, w) in the padded canvas
    orig_sizes: torch.Tensor  # (B, 2) original (h, w) for rescaling


class GeneralizedRCNN(nn.Module):
    def __init__(
        self,
        backbone_layers: Sequence[int] = (3, 4, 6, 3),
        backbone_width: int = 64,
        embed_dim: int = 1024,
        input_resolution: int = 224,
        anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
        anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        rpn_pre_nms_topk_test: int = 6000,
        rpn_post_nms_topk_test: int = 1000,
        rpn_nms_thresh: float = 0.7,
        num_classes: int = 20,
        pooler_resolution: int = 14,
        pooler_sampling_ratio: int = 0,
        temperature: float = 0.01,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        pixel_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
        pixel_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.backbone = ModifiedResNet(
            layers=backbone_layers,
            output_dim=embed_dim,
            heads=backbone_width * 32 // 64,
            width=backbone_width,
            input_resolution=input_resolution,
        )
        self.proposal_generator = RPN(
            in_channels=backbone_width * 16,
            stride=16,
            anchor_sizes=anchor_sizes,
            anchor_aspect_ratios=anchor_aspect_ratios,
            pre_nms_topk_test=rpn_pre_nms_topk_test,
            post_nms_topk_test=rpn_post_nms_topk_test,
            nms_thresh=rpn_nms_thresh,
        )
        self.roi_heads = CLIPRes5ROIHeads(
            num_classes=num_classes,
            emb_dim=embed_dim,
            temperature=temperature,
            pooler_resolution=pooler_resolution,
            pooler_sampling_ratio=pooler_sampling_ratio,
            score_thresh_test=score_thresh_test,
            nms_thresh_test=nms_thresh_test,
            detections_per_image=detections_per_image,
        )

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.pixel_mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(self.pixel_std, dtype=torch.float32, device=images.device)
        x = images.float()
        if float(sum(self.pixel_mean)) < 3.0:  # CLIP stats: inputs scaled to [0, 1]
            x = x / 255.0
        return ((x - mean) / std).to(self.dtype)

    @torch.no_grad()
    def proposals(self, batch: DetBatch):
        """Backbone and RPN: (res4 (B, H/16, W/16, C) NHWC, Proposals)."""
        features = self.backbone(self._normalize(batch.image))["res4"]
        return features, self.proposal_generator(features, batch.image_sizes)

    @torch.no_grad()
    def inference(self, batch: DetBatch) -> DetectionResult:
        """normalize -> res4 -> RPN -> RoI heads -> rescale to orig_sizes."""
        features, proposals = self.proposals(batch)
        detections = self.roi_heads(
            features, proposals, batch.image_sizes,
            res5_fn=self.backbone.res5_forward, attnpool_fn=self.backbone.attnpool_forward,
        )
        # detector_postprocess: rescale to the original image size
        orig = batch.orig_sizes.to(detections.boxes.device)
        sizes = batch.image_sizes.to(detections.boxes.device)
        scale = (orig / torch.clamp(sizes, min=1)).float()
        sxy = torch.stack([scale[:, 1], scale[:, 0], scale[:, 1], scale[:, 0]], dim=-1)
        boxes = box_ops.clip(detections.boxes * sxy[:, None, :], (orig[:, 0, None], orig[:, 1, None]))
        return detections._replace(boxes=boxes)

