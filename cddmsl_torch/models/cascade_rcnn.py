"""Cascade R-CNN (counterpart of cddmsl_tpu/models/cascade_rcnn.py
`CascadeROIHeads` and `CascadeRCNN`).

`CascadeROIHeads`: one stage per IoU of ROI_BOX_CASCADE_HEAD.IOUS (0.5,
0.6, 0.7), each a 7x7 aligned RoIAlign with 2x2 samples over the heads'
levels (models/poolers.py: K1 once per level, K3 for its gradient), two
ReLU fcs of 1024 (fc1 reading the pooled map in HWC order, as
`FastRCNNFCHead`), a linear classifier of K + 1 logits and one
class-agnostic box (detectron2's names: box_head.{i}.fc1/fc2,
box_predictor.{i}.cls_score/bbox_pred). The stages' box transforms weigh
(10,10,5,5), (20,20,10,10) and (30,30,15,15).

Training samples the proposals once, with the ground truth appended, as the
other heads do (the draw sites "roi_pos", "roi_neg", "roi_gather"); each
stage matches the same rows again at its own IoU, without resampling,
takes the cross-entropy and the smooth-L1 (beta 0) box loss over the
valid rows ("loss_cls_stage{i}", "loss_box_reg_stage{i}"), and hands the
next stage its boxes refined by its own deltas, detached and clipped to the
image. With a mask head the mask branch trains on the first stage's
samples (their leading foreground rows, as the other heads' do) with a
14x14 pooler of 2x2 samples.

Inference runs every stage on the proposals, refining the boxes between
stages, averages the stages' softmaxes, and hands log(max(p, 1e-12)) with
the last stage's deltas, boxes and transform to `fast_rcnn_inference`
(class-aware NMS, kernel K4); the mask head runs on the final boxes.

`CascadeRCNN` is JAX's C4 cascade: the detectron2 ResNet to res4, an RPN of
the module's defaults at stride 16, and the cascade heads on res4 (128
samples an image), built from RESNETS.DEPTH, NUM_CLASSES,
ROI_BOX_CASCADE_HEAD.IOUS and the pixel statistics alone.
"""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.box_regression import Box2BoxTransform
from ..structures import boxes as box_ops
from .backbone.resnet import D2ResNet
from .fast_rcnn import DetectionResult, FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .matcher import Matcher
from .poolers import ROIPooler
from .rcnn import DetBatch, normalize, rescale_detections
from .roi_heads import FastRCNNFCHead, ProposalSampling
from .rpn import RPN, Proposals
from .sampling import Draw

STAGE_WEIGHTS = ((10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0))


class CascadeROIHeads(ProposalSampling):
    def __init__(
        self,
        num_classes: int = 20,
        in_channels: int = 1024,
        pooler_scales: Sequence[float] = (1.0 / 16,),
        batch_size_per_image: int = 128,
        positive_fraction: float = 0.25,
        stage_ious: Sequence[float] = (0.5, 0.6, 0.7),
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        fc_dim: int = 1024,
        mask_head: Optional[dict] = None,
    ):
        """`pooler_scales`: one per level (one for C4's res4). `mask_head`
        (`_init_mask_branch`) adds the mask branch."""
        super().__init__()
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.pooler_resolution = 7
        self.pooler = ROIPooler(7, pooler_scales, sampling_ratio=2, min_level=2)
        n = len(stage_ious)
        self.box_head = nn.ModuleList(FastRCNNFCHead(7 * 7 * in_channels, fc_dim, fc_dim) for _ in range(n))
        self.box_predictor = nn.ModuleList(
            FastRCNNOutputLayers(num_classes, fc_dim, use_text_emb=False, cls_agnostic_bbox_reg=True)
            for _ in range(n))
        # JAX's module keeps all three transforms; inference decodes with the last
        self.box2box = [Box2BoxTransform(w) for w in STAGE_WEIGHTS]
        self.matchers = [Matcher((t,), (0, 1), allow_low_quality_matches=False) for t in stage_ious]
        self.matcher = self.matchers[0]  # the sampler's
        self._init_mask_branch(mask_head, in_channels)
        self.keypoint_head = None
        if self.mask_head is not None:
            self.mask_pooler = ROIPooler(14, pooler_scales, sampling_ratio=2, min_level=2)

    def stage(self, i: int, features: Sequence[torch.Tensor], boxes: torch.Tensor):
        """Stage i on boxes (B, S, 4) -> scores (B*S, K+1), deltas (B*S, 4)."""
        return self.box_predictor[i](self.box_head[i](self.pooler(features, boxes)))

    def refine(self, i: int, deltas: torch.Tensor, boxes: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
        """The boxes (B, S, 4) moved by stage i's deltas (B*S, 4) and clipped
        to each image."""
        b, s = boxes.shape[:2]
        new = self.box2box[i].apply_deltas(deltas, boxes.reshape(b * s, 4)).reshape(b, s, 4)
        hw = image_sizes.to(new.device)
        return box_ops.clip(new, (hw[:, 0, None], hw[:, 1, None]))

    @torch.no_grad()
    def match(self, i: int, boxes, valid, gt_boxes, gt_classes, gt_valid):
        """Stage i's labels of the sampled rows (B, S): classes in [0, K], -1
        where not valid, and each row's matched ground-truth box."""
        iou = box_ops.pairwise_iou(gt_boxes, boxes)
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        matched_idxs, labels = self.matchers[i](iou, gt_valid)
        classes = torch.where(labels == 1, torch.gather(gt_classes.long(), 1, matched_idxs), self.num_classes)
        classes = torch.where(valid, classes, -1)
        return classes, torch.gather(gt_boxes, 1, matched_idxs[..., None].expand(-1, -1, 4))

    def forward(
        self,
        features: Sequence[torch.Tensor],
        proposals: Proposals,
        image_sizes: torch.Tensor,
        training: bool = False,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_classes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        draw: Optional[Draw] = None,
        gt_masks: Optional[torch.Tensor] = None,
        gt_keypoints: Optional[torch.Tensor] = None,
    ):
        """Inference: the detections (with masks where the heads have a
        mask head). Training: each stage's "loss_cls_stage{i}" and
        "loss_box_reg_stage{i}", and "loss_mask". There is no keypoint
        branch: `gt_keypoints` is not read."""
        n_stages = len(self.box_head)
        if training:
            if gt_boxes is None or gt_classes is None or gt_valid is None or draw is None:
                raise ValueError("RoI-head training needs gt_boxes, gt_classes, gt_valid and draw")
            sampled, cls0, _, valid, midx0 = self.label_and_sample_proposals(
                proposals, gt_boxes, gt_classes, gt_valid, draw)
            boxes = sampled
            b, s = boxes.shape[:2]
            losses: Dict[str, torch.Tensor] = {}
            for i in range(n_stages):
                classes, matched_gt = self.match(i, boxes, valid, gt_boxes, gt_classes, gt_valid)
                scores, deltas = self.stage(i, features, boxes)
                stage = fast_rcnn_losses(scores, deltas, boxes.reshape(b * s, 4), matched_gt.reshape(b * s, 4),
                                         classes.reshape(b * s), valid.reshape(b * s), self.num_classes,
                                         self.box2box[i])
                losses[f"loss_cls_stage{i}"] = stage["loss_cls"]
                losses[f"loss_box_reg_stage{i}"] = stage["loss_box_reg"]
                if i + 1 < n_stages:
                    boxes = self.refine(i, deltas.detach(), boxes, image_sizes)
            return self._branch_losses(losses, lambda bx: self.mask_pooler(features, bx), None, sampled, cls0,
                                       valid, midx0, gt_masks, None)
        boxes = proposals.boxes
        b, k = boxes.shape[:2]
        probs = []
        for i in range(n_stages):
            scores, deltas = self.stage(i, features, boxes)
            probs.append(torch.softmax(scores, dim=-1))
            if i + 1 < n_stages:
                boxes = self.refine(i, deltas, boxes, image_sizes)
        mean = torch.stack(probs).mean(dim=0).reshape(b, k, -1)
        detections = fast_rcnn_inference(
            torch.log(torch.clamp(mean, min=1e-12)), deltas.reshape(b, k, 4), boxes, proposals.valid, image_sizes,
            self.box2box[-1], self.num_classes, score_thresh=self.score_thresh_test,
            nms_thresh=self.nms_thresh_test, topk_per_image=self.detections_per_image,
        )
        if self.mask_head is not None:
            detections = self._with_masks(detections, self.mask_pooler(features, detections.boxes))
        return detections


class CascadeRCNN(nn.Module):
    use_text_emb = False  # a linear classifier: nothing for the optimizer to freeze there

    def __init__(self, num_classes: int = 80, depth: int = 50, stage_ious: Sequence[float] = (0.5, 0.6, 0.7),
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.backbone = D2ResNet(depth, res5=False)
        self.proposal_generator = RPN(in_channels=1024, stride=16)
        self.roi_heads = CascadeROIHeads(num_classes=num_classes, in_channels=1024, stage_ious=tuple(stage_ious))

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Raw images (B, H, W, 3) -> res4 (B, H/16, W/16, 1024) NHWC."""
        x = normalize(images, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False)
        return self.backbone(x)["res4"]

    @torch.no_grad()
    def proposals(self, batch: DetBatch):
        """(res4, the test Proposals)."""
        f = self.features(batch.image)
        return f, self.proposal_generator(f, batch.image_sizes)[0]

    def losses(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """The RPN's and the stages' losses; draw sites as GeneralizedRCNN's."""
        f = self.features(batch.image)
        proposals, rpn_losses = self.proposal_generator(
            f, batch.image_sizes, training=True, gt_boxes=batch.gt_boxes, gt_valid=batch.gt_valid, draw=draw)
        det_losses = self.roi_heads([f], proposals, batch.image_sizes, training=True, gt_boxes=batch.gt_boxes,
                                    gt_classes=batch.gt_classes, gt_valid=batch.gt_valid, draw=draw)
        return {**det_losses, **rpn_losses}

    def cddmsl_losses(self, batch: DetBatch, draw: Draw, caption_on: bool = False, kd_regularization: bool = True,
                      enable_caption: bool = True) -> Dict[str, torch.Tensor]:
        """The trainer's loss set: `losses`, whatever the caption gates say."""
        return self.losses(batch, draw)

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> DetectionResult:
        """res4 -> RPN -> the stages -> with `do_postprocess` (JAX's module
        always rescales) the boxes rescaled to orig_sizes."""
        f, proposals = self.proposals(batch)
        detections = self.roi_heads([f], proposals, batch.image_sizes)
        return rescale_detections(detections, batch) if do_postprocess else detections
