"""The FPN family's Faster R-CNN (counterpart of cddmsl_tpu/models/fpn_rcnn.py
`FPNRCNN`, box path): detectron2's Base-RCNN-FPN (ResNet or ResNeXt + FPN,
the RPN over p2..p6, `StandardROIHeads` pooling 7x7 from p2..p5) and, with
`dc5`, Base-RCNN-DilatedC5 (the dilated res5 as the one map of the RPN,
all anchor sizes on it, and of the heads). With `load_proposals` there is
no RPN: the proposals are the batch's precomputed ones
(MODEL.LOAD_PROPOSALS, PROPOSAL_GENERATOR.NAME PrecomputedProposals).

It keeps the trainer's protocol: `cddmsl_losses` returns the supervised
losses whatever the caption gates say (this family has no language
branch), `inference` rescales the boxes to the original sizes."""

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .backbone.resnet import FPN, D2ResNet
from .fast_rcnn import DetectionResult
from .rcnn import DetBatch, normalize, rescale_detections
from .roi_heads import StandardROIHeads
from .rpn import FPNRPN, Proposals
from .sampling import Draw

FPN_STRIDES = (4, 8, 16, 32, 64)
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


class FPNRCNN(nn.Module):
    def __init__(
        self,
        num_classes: int = 80,
        depth: int = 50,
        anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
        anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        rpn_batch_size_per_image: int = 256,
        rpn_positive_fraction: float = 0.5,
        rpn_pre_nms_topk: Tuple[int, int] = (2000, 1000),
        rpn_post_nms_topk: Tuple[int, int] = (1000, 1000),
        rpn_nms_thresh: float = 0.7,
        rpn_loss_weight: float = 1.0,
        rpn_smooth_l1_beta: float = 0.0,
        rpn_box_reg_loss_weight: float = 1.0,
        roi_smooth_l1_beta: float = 0.0,
        roi_batch_size_per_image: int = 512,
        roi_positive_fraction: float = 0.25,
        fc_dim: int = 1024,
        emb_dim: int = 1024,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        use_text_emb: bool = False,
        temperature: float = 0.01,
        pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
        pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        backbone_width: int = 64,
        num_groups: int = 1,
        stride_in_1x1: bool = True,
        box_reg_loss_weight: float = 1.0,
        cls_agnostic_bbox_reg: bool = False,
        dc5: bool = False,
        load_proposals: bool = False,
        fpn_out_channels: int = 256,
        res2_out_channels: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        """`backbone_width` is WIDTH_PER_GROUP (TPU.BACKBONE_WIDTH where
        set); `emb_dim` the second fc's width (1024 in JAX's builds);
        `res2_out_channels` and `fpn_out_channels` narrow the towers for
        tests."""
        super().__init__()
        self.dtype = dtype
        self.dc5 = dc5
        self.load_proposals = load_proposals
        self.use_text_emb = use_text_emb
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        tower = D2ResNet(depth, num_groups=num_groups, width_per_group=backbone_width, stride_in_1x1=stride_in_1x1,
                         res5_dilation=2 if dc5 else 1, res2_out_channels=res2_out_channels)
        self.backbone = tower if dc5 else FPN(tower, fpn_out_channels)
        channels = res2_out_channels * 8 if dc5 else fpn_out_channels
        if not load_proposals:
            self.proposal_generator = FPNRPN(
                channels,
                strides=(16,) if dc5 else FPN_STRIDES,
                anchor_sizes=(tuple(anchor_sizes),) if dc5 else tuple(anchor_sizes),
                anchor_aspect_ratios=tuple(anchor_aspect_ratios),
                batch_size_per_image=rpn_batch_size_per_image,
                positive_fraction=rpn_positive_fraction,
                pre_nms_topk_train=rpn_pre_nms_topk[0],
                pre_nms_topk_test=rpn_pre_nms_topk[1],
                post_nms_topk_train=rpn_post_nms_topk[0],
                post_nms_topk_test=rpn_post_nms_topk[1],
                nms_thresh=rpn_nms_thresh,
                loss_weight=rpn_loss_weight,
                smooth_l1_beta=rpn_smooth_l1_beta,
                box_reg_loss_weight=rpn_box_reg_loss_weight,
            )
        self.roi_heads = StandardROIHeads(
            num_classes=num_classes,
            in_channels=channels,
            pooler_scales=(1 / 16,) if dc5 else FPN_SCALES,
            fc_dim=fc_dim,
            emb_dim=emb_dim,
            use_text_emb=use_text_emb,
            temperature=temperature,
            batch_size_per_image=roi_batch_size_per_image,
            positive_fraction=roi_positive_fraction,
            score_thresh_test=score_thresh_test,
            nms_thresh_test=nms_thresh_test,
            detections_per_image=detections_per_image,
            cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
            smooth_l1_beta=roi_smooth_l1_beta,
            box_reg_loss_weight=box_reg_loss_weight,
        )

    def features(self, images: torch.Tensor):
        """Raw images (B, H, W, 3) -> (the heads' levels, the RPN's levels),
        NHWC: p2..p5 and p2..p6, or [res5] and [res5] under DC5."""
        x = normalize(images, self.pixel_mean, self.pixel_std, self.dtype)
        if self.dc5:
            res5 = self.backbone(x, ("res5",))["res5"]
            return [res5], [res5]
        feats = self.backbone(x)
        head = [feats[f"p{i}"] for i in range(2, 6)]
        return head, head + [feats["p6"]]

    @staticmethod
    def batch_proposals(batch: DetBatch) -> Proposals:
        """The batch's precomputed proposals (boxes clipped and ranked by the
        mapper); scores 0 where the batch has none, -inf where not valid."""
        if batch.proposal_boxes is None:
            raise ValueError("load_proposals needs DetBatch.proposal_boxes: set MODEL.LOAD_PROPOSALS and "
                             "DATASETS.PROPOSAL_FILES_*")
        valid = batch.proposal_valid
        scores = batch.proposal_scores if batch.proposal_scores is not None else torch.zeros(valid.shape)
        scores = scores.to(valid.device).float()
        return Proposals(boxes=batch.proposal_boxes.float(),
                         scores=torch.where(valid, scores, torch.full_like(scores, float("-inf"))), valid=valid)

    @torch.no_grad()
    def proposals(self, batch: DetBatch):
        """(the heads' levels, the test Proposals)."""
        head, rpn_levels = self.features(batch.image)
        if self.load_proposals:
            return head, self.batch_proposals(batch)
        return head, self.proposal_generator(rpn_levels, batch.image_sizes)[0]

    def supervised_losses(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """The RPN's losses (none with precomputed proposals) and the box
        head's, on the training proposals; draw sites as GeneralizedRCNN's."""
        head, rpn_levels = self.features(batch.image)
        rpn_losses = {}
        if self.load_proposals:
            proposals = self.batch_proposals(batch)
        else:
            proposals, rpn_losses = self.proposal_generator(
                rpn_levels, batch.image_sizes, training=True, gt_boxes=batch.gt_boxes, gt_valid=batch.gt_valid,
                draw=draw,
            )
        det_losses = self.roi_heads(head, proposals, batch.image_sizes, training=True, gt_boxes=batch.gt_boxes,
                                    gt_classes=batch.gt_classes, gt_valid=batch.gt_valid, draw=draw)
        return {**det_losses, **rpn_losses}

    def cddmsl_losses(self, batch: DetBatch, draw: Draw, caption_on: bool = False, kd_regularization: bool = True,
                      enable_caption: bool = True) -> Dict[str, torch.Tensor]:
        """The trainer's loss set: the supervised losses; the caption gates
        change nothing here, as in JAX."""
        return self.supervised_losses(batch, draw)

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> DetectionResult:
        """normalize -> backbone -> RPN (or the batch's proposals) -> box
        heads -> with `do_postprocess` the boxes rescaled to orig_sizes."""
        head, proposals = self.proposals(batch)
        detections = self.roi_heads(head, proposals, batch.image_sizes)
        return rescale_detections(detections, batch) if do_postprocess else detections
