"""Panoptic FPN (counterpart of cddmsl_tpu/models/panoptic_fpn.py
`PanopticFPN` and `combine_semantic_and_instance_outputs`).

One FPN tower (detectron2's ResNet, p2..p5) feeds the instance branch and
the semantic branch. The tower takes RESNETS.NORM (FrozenBN, or GN),
FPN.NORM and the deformable stages (RESNETS.DEFORM_ON_PER_STAGE,
DEFORM_MODULATED), as JAX's module builds them for
Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x:
- the RPN on p2 alone, as JAX's module runs it: one anchor size (32) and
  three aspect ratios at stride 4, pre-NMS top-k 256 in training and 128 at
  test, post-NMS 64 and 32 (kernel K4 for its NMS);
- the FPN family's `StandardROIHeads` (JAX's `CLIPStandardROIHeads` with
  the linear classifier): 7x7 pools of p2..p5 (K1, and K3 in the
  backward), two fcs of 1024, 64 sampled rows an image, and with `mask_on`
  the mask head on its 14x14 pools; or with `cascade` (ROI_HEADS.NAME
  CascadeROIHeads) models/cascade_rcnn.py's three stages on p2..p5, 64
  sampled rows an image, with the mask branch under `mask_on`;
- `SemSegFPNHead` on p2..p5, its logits resized to the padded image.

The losses are the RPN's and the heads', each times `instance_loss_weight`,
and "loss_sem_seg", the per-pixel cross entropy over the pixels not
labelled 255, times `sem_seg_loss_weight`. Draw sites as FPNRCNN's. The
caption gates change nothing, as in JAX. `inference` returns the
detections in the padded frame (with the mask probabilities under
`mask_on`) and the argmax class map of the padded image; the evaluator
rescales, crops and combines them on the host
(`combine_semantic_and_instance_outputs`, numpy).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..evaluation.masks import paste_masks_np
from ..ops.resize import resize_bilinear_nchw
from .backbone.resnet import FPN, D2ResNet
from .cascade_rcnn import CascadeROIHeads
from .fast_rcnn import DetectionResult
from .fpn_rcnn import FPN_SCALES
from .rcnn import DetBatch, normalize
from .roi_heads import StandardROIHeads
from .rpn import RPN
from .sampling import Draw
from .semantic_seg import SemSegFPNHead, sem_seg_loss


class PanopticFPN(nn.Module):
    use_text_emb = False  # the linear classifier: nothing for the optimizer to freeze

    def __init__(self, num_classes: int = 20, sem_seg_classes: int = 54, depth: int = 50,
                 instance_loss_weight: float = 1.0, sem_seg_loss_weight: float = 0.5,
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675), pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 sem_seg_norm: str = "", stride_in_1x1: bool = True, backbone_width: int = 64, mask_on: bool = False,
                 mask_num_conv: int = 4, mask_conv_dim: int = 256, mask_canvas_stride: float = 4.0,
                 backbone_norm: str = "FrozenBN", fpn_norm: str = "", deform_on_per_stage: Sequence[bool] = (False,) * 4,
                 deform_modulated: bool = False, cascade: bool = False, dtype: torch.dtype = torch.float32):
        """The fields of JAX's `build_panoptic_fpn`: the thing and stuff
        classes, the tower's depth, stride placement, bottleneck width
        (TPU.BACKBONE_WIDTH), norm (RESNETS.NORM) and deformable stages,
        the FPN's norm, both loss weights, the head's norm ("" or "GN"), the
        cascade heads (`cascade`), the mask head's (MASK_ON,
        ROI_MASK_HEAD.NUM_CONV, CONV_DIM, TPU.MASK_CANVAS_STRIDE), the pixel
        statistics and the compute dtype."""
        super().__init__()
        self.dtype = dtype
        self.instance_loss_weight = instance_loss_weight
        self.sem_seg_loss_weight = sem_seg_loss_weight
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        tower = D2ResNet(depth, width_per_group=backbone_width, stride_in_1x1=stride_in_1x1, norm=backbone_norm,
                         deform_on_per_stage=tuple(deform_on_per_stage), deform_modulated=deform_modulated)
        self.backbone = FPN(tower, 256, norm=fpn_norm)
        self.proposal_generator = RPN(256, stride=4, anchor_sizes=(32,), pre_nms_topk_train=256,
                                      pre_nms_topk_test=128, post_nms_topk_train=64, post_nms_topk_test=32)
        mask_head = dict(num_conv=mask_num_conv, conv_dim=mask_conv_dim, cls_agnostic=False,
                         canvas_stride=mask_canvas_stride) if mask_on else None
        heads = CascadeROIHeads if cascade else StandardROIHeads
        self.roi_heads = heads(num_classes=num_classes, in_channels=256, pooler_scales=FPN_SCALES,
                               batch_size_per_image=64, mask_head=mask_head)
        self.sem_seg_head = SemSegFPNHead(sem_seg_classes, norm=sem_seg_norm)

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Raw images (B, H, W, 3) -> p2..p5, NHWC."""
        feats = self.backbone(normalize(images, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False))
        return [feats[f"p{i}"] for i in range(2, 6)]

    def sem_seg_logits(self, levels: Sequence[torch.Tensor], hw) -> torch.Tensor:
        """float32 logits (B, K, H, W) of the padded image."""
        return resize_bilinear_nchw(self.sem_seg_head(levels), tuple(hw))

    def losses(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """The instance losses times `instance_loss_weight` and
        "loss_sem_seg" times `sem_seg_loss_weight`."""
        if batch.sem_seg is None:
            raise ValueError("PanopticFPN training needs DetBatch.sem_seg: use a panoptic dataset (the loader then "
                             "maps it with PanopticDatasetMapper)")
        levels = self.features(batch.image)
        proposals, rpn_losses = self.proposal_generator(
            levels[0], batch.image_sizes, training=True, gt_boxes=batch.gt_boxes, gt_valid=batch.gt_valid, draw=draw)
        det_losses = self.roi_heads(levels, proposals, batch.image_sizes, training=True, gt_boxes=batch.gt_boxes,
                                    gt_classes=batch.gt_classes, gt_valid=batch.gt_valid, draw=draw,
                                    gt_masks=batch.gt_masks)
        losses = {k: v * self.instance_loss_weight for k, v in {**rpn_losses, **det_losses}.items()}
        logits = self.sem_seg_logits(levels, batch.image.shape[1:3])
        losses["loss_sem_seg"] = sem_seg_loss(logits, batch.sem_seg.to(logits.device)) * self.sem_seg_loss_weight
        return losses

    def cddmsl_losses(self, batch: DetBatch, draw: Draw, caption_on: bool = False, kd_regularization: bool = True,
                      enable_caption: bool = True) -> Dict[str, torch.Tensor]:
        return self.losses(batch, draw)

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> Tuple[DetectionResult, torch.Tensor]:
        """(the detections in the padded frame, the argmax class map (B, H,
        W) of the padded image); `do_postprocess` changes nothing: the
        evaluator rescales and combines."""
        levels = self.features(batch.image)
        proposals = self.proposal_generator(levels[0], batch.image_sizes)[0]
        detections = self.roi_heads(levels, proposals, batch.image_sizes)
        return detections, torch.argmax(self.sem_seg_logits(levels, batch.image.shape[1:3]), dim=1)


def combine_semantic_and_instance_outputs(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    det_classes: np.ndarray,
    det_valid: np.ndarray,
    sem_seg: np.ndarray,
    overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096,
    instances_score_thresh: float = 0.5,
    det_masks: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, list]:
    """One image's detections ((D, 4) XYXY in the image of `sem_seg`, scores,
    classes, valid; with `det_masks` (D, m, m) box-frame probabilities) and
    its (H, W) argmax map -> (the (H, W) int32 segment ids, 0 unassigned;
    segments_info). In score order, each valid detection scored at least
    `instances_score_thresh` paints its pasted mask (its box without masks)
    where nothing is painted yet, unless more than `overlap_threshold` of
    it is painted already; then each class of the map paints what is left
    of it if that is at least `stuff_area_limit` pixels."""
    H, W = sem_seg.shape
    panoptic = np.zeros((H, W), np.int32)
    segments = []
    current_id = 0
    order = np.argsort(-det_scores)
    for i in order:
        if not det_valid[i] or det_scores[i] < instances_score_thresh:
            continue
        x1, y1, x2, y2 = det_boxes[i].astype(int)
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, W), min(y2, H)
        if det_masks is not None:
            mask = paste_masks_np(det_masks[i : i + 1], det_boxes[i : i + 1], (H, W))[0].astype(bool)
        else:
            mask = np.zeros((H, W), bool)
            mask[y1:y2, x1:x2] = True
        area = mask.sum()
        if area == 0:
            continue
        intersect = (mask & (panoptic > 0)).sum()
        if intersect / max(area, 1) > overlap_threshold:
            continue
        mask &= panoptic == 0
        current_id += 1
        panoptic[mask] = current_id
        segments.append({"id": current_id, "isthing": True, "category_id": int(det_classes[i]),
                         "score": float(det_scores[i])})
    for cat in np.unique(sem_seg):
        mask = (sem_seg == cat) & (panoptic == 0)
        if mask.sum() < stuff_area_limit:
            continue
        current_id += 1
        panoptic[mask] = current_id
        segments.append({"id": current_id, "isthing": False, "category_id": int(cat)})
    return panoptic, segments
