"""RoI heads (counterpart of cddmsl_tpu/models/roi_heads.py
`CLIPRes5ROIHeads` and, box path only, `CLIPStandardROIHeads`).

`StandardROIHeads`, the FPN family's: the 7x7 multi-level pooler
(models/poolers.py: K1 once per level, K3 for its gradient), two ReLU fcs,
fc1 reading the pooled map flattened in HWC order (JAX's; a detectron2
file's CHW fc1 is permuted when it loads), and the box predictor; training
samples proposals as the C4 heads do and takes the smooth-L1 box loss.

`CLIPRes5ROIHeads`, the C4 heads: RoIAlign 14x14 at 1/16 on res4 (kernels K1 and, for its
gradient, K3 on the card) -> the backbone's res5 on every crop -> the
attention pool and the cosine classifier, or with the linear classifier
(`attnpool_fn` None) the mean over the crop. Inference ends in class-aware
NMS (kernel K4) or soft-NMS; training matches and samples the proposals
(with the ground truth appended) and returns the Fast R-CNN losses.
`forward_get_features` pools the same boxes from two maps for the
region-level consistency loss."""

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_regression import Box2BoxTransform
from ..ops.roi_align import roi_align_batched
from ..structures import boxes as box_ops
from .fast_rcnn import DetectionResult, FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .matcher import Matcher
from .poolers import ROIPooler
from .rpn import Proposals
from .sampling import Draw, gather_selected, subsample_labels


def pool_boxes(features: torch.Tensor, boxes: torch.Tensor, resolution: int = 14, scale: float = 1.0 / 16,
               sampling_ratio: int = 0) -> torch.Tensor:
    """Aligned RoIAlign of each image's boxes from its own map: features
    (B, H, W, C), boxes (B, S, 4) -> (B*S, P, P, C), image-major."""
    b, s = boxes.shape[:2]
    batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(s)
    return roi_align_batched(
        features.contiguous(), batch_idx, boxes.reshape(b * s, 4).float().contiguous(),
        (resolution, resolution), scale, sampling_ratio, True,
    )


class ProposalSampling(nn.Module):
    """`label_and_sample_proposals` of both heads: they set num_classes,
    batch_size_per_image, positive_fraction and an IoU-0.5 `matcher`."""

    @torch.no_grad()
    def label_and_sample_proposals(
        self, proposals: Proposals, gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
        draw: Draw,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Proposals (B, P) with the ground truth (B, G) appended
        (PROPOSAL_APPEND_GT) -> per image `batch_size_per_image` samples,
        positives first: boxes (B, S, 4), classes (B, S) in [0, K], matched
        ground-truth boxes (B, S, 4) and valid (B, S). Draw sites "roi_pos",
        "roi_neg", "roi_gather", each (B, P+G)."""
        pboxes = torch.cat([proposals.boxes, gt_boxes], dim=1)
        pvalid = torch.cat([proposals.valid, gt_valid], dim=1)
        b, n = pvalid.shape
        k = self.num_classes
        iou = box_ops.pairwise_iou(gt_boxes, pboxes)  # (B, G, P+G)
        iou = torch.where(pvalid[:, None, :], iou, torch.full_like(iou, -1.0))
        matched_idxs, match_labels = self.matcher(iou, gt_valid)
        classes = torch.where(match_labels == 1, torch.gather(gt_classes.long(), 1, matched_idxs), k)
        classes = torch.where(gt_valid.any(dim=1, keepdim=True), classes, k)
        classes = torch.where(pvalid, classes, -1)  # padded proposals are ignored

        pos_sel, neg_sel = subsample_labels(
            (classes >= 0) & (classes < k), classes == k, self.batch_size_per_image, self.positive_fraction,
            draw("roi_pos", (b, n)), draw("roi_neg", (b, n)),
        )
        idx, valid = gather_selected(pos_sel, neg_sel, self.batch_size_per_image, draw("roi_gather", (b, n)))
        take = lambda t: torch.gather(t, 1, idx[..., None].expand(-1, -1, 4))
        matched_gt = torch.gather(gt_boxes, 1, torch.gather(matched_idxs, 1, idx)[..., None].expand(-1, -1, 4))
        sampled_classes = torch.where(valid, torch.gather(classes, 1, idx), k)
        return take(pboxes), sampled_classes, matched_gt, valid


class CLIPRes5ROIHeads(ProposalSampling):
    def __init__(
        self,
        num_classes: int = 20,
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        emb_dim: int = 1024,
        temperature: float = 0.01,
        pooler_resolution: int = 14,
        pooler_scale: float = 1.0 / 16,
        pooler_sampling_ratio: int = 0,
        bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
        focal_gamma: Optional[float] = None,
        bg_loss_weight: Optional[float] = None,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        use_text_emb: bool = True,
        cls_agnostic_bbox_reg: bool = False,
        soft_nms: Optional[Tuple[str, float, float]] = None,
        no_box_delta: bool = False,
        multiply_rpn_score: bool = False,
    ):
        """`emb_dim` is the width of the classifier's input: the attention
        pool's output with `use_text_emb`, else res5's channels. `soft_nms`
        = (method, sigma, prune) replaces the detection NMS. `no_box_delta`
        keeps the proposal boxes; `multiply_rpn_score` folds each
        proposal's objectness logit into its class scores."""
        super().__init__()
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.focal_gamma = focal_gamma
        self.bg_loss_weight = bg_loss_weight
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.soft_nms = soft_nms
        self.no_box_delta = no_box_delta
        self.multiply_rpn_score = multiply_rpn_score
        self.box_predictor = FastRCNNOutputLayers(num_classes, emb_dim, temperature, use_text_emb,
                                                  cls_agnostic_bbox_reg)
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.matcher = Matcher((0.5,), (0, 1), allow_low_quality_matches=False)

    def pool(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """features (B, H, W, C), boxes (B, S, 4) -> (B*S, P, P, C)."""
        return pool_boxes(features, boxes, self.pooler_resolution, self.pooler_scale, self.pooler_sampling_ratio)

    def _region_embed(self, features, boxes, res5_fn: Callable, attnpool_fn: Optional[Callable]) -> torch.Tensor:
        """(B,H,W,C) x (B,S,4) -> (B*S, emb): pool -> res5 -> the attention
        pool, or without one the mean over the crop."""
        x = res5_fn(self.pool(features, boxes))
        return attnpool_fn(x) if attnpool_fn is not None else x.mean(dim=(1, 2))

    def forward_get_features(
        self, features_src: torch.Tensor, features_trgt: torch.Tensor, boxes: torch.Tensor,
        res5_fn: Callable, attnpool_fn: Callable,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same boxes (B, S, 4) pooled from both views' maps -> two
        (B*S, emb) region embeddings."""
        return (
            self._region_embed(features_src, boxes, res5_fn, attnpool_fn),
            self._region_embed(features_trgt, boxes, res5_fn, attnpool_fn),
        )

    def forward(
        self,
        features: torch.Tensor,
        proposals: Proposals,
        image_sizes: torch.Tensor,
        res5_fn: Callable,
        attnpool_fn: Optional[Callable],
        training: bool = False,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_classes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        draw: Optional[Draw] = None,
    ):
        """Inference: the detections (DetectionResult). Training: the losses
        {"loss_cls", "loss_box_reg"} over the sampled proposals."""
        if training:
            if gt_boxes is None or gt_classes is None or gt_valid is None or draw is None:
                raise ValueError("RoI-head training needs gt_boxes, gt_classes, gt_valid and draw")
            boxes, classes, matched_gt, valid = self.label_and_sample_proposals(
                proposals, gt_boxes, gt_classes, gt_valid, draw
            )
            scores, deltas = self.box_predictor(self._region_embed(features, boxes, res5_fn, attnpool_fn))
            n = boxes.shape[0] * boxes.shape[1]
            return fast_rcnn_losses(
                scores, deltas, boxes.reshape(n, 4), matched_gt.reshape(n, 4), classes.reshape(n),
                valid.reshape(n), self.num_classes, self.box2box, focal_gamma=self.focal_gamma,
                bg_loss_weight=self.bg_loss_weight,
            )
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
            soft_nms=self.soft_nms,
            no_box_delta=self.no_box_delta,
            rpn_scores=proposals.scores,
            multiply_rpn_score=self.multiply_rpn_score,
        )


class FastRCNNFCHead(nn.Module):
    """Two ReLU fcs on the flattened pooled map (detectron2's box_head.fc1,
    fc2): fc1 reads it in HWC order."""

    def __init__(self, in_features: int, fc_dim: int = 1024, out_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_features, fc_dim)
        self.fc2 = nn.Linear(fc_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for fc in (self.fc1, self.fc2):
            x = F.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
        return x


class StandardROIHeads(ProposalSampling):
    """The FPN family's box heads: `pooler_scales` one per level (one level
    for DC5), a 2-fc head of `fc_dim` then `emb_dim`, the linear or
    text-embedding predictor; smooth-L1 at `smooth_l1_beta`."""

    def __init__(
        self,
        num_classes: int = 80,
        in_channels: int = 256,
        pooler_scales: Sequence[float] = (1 / 4, 1 / 8, 1 / 16, 1 / 32),
        pooler_resolution: int = 7,
        fc_dim: int = 1024,
        emb_dim: int = 1024,
        use_text_emb: bool = False,
        temperature: float = 0.01,
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        cls_agnostic_bbox_reg: bool = False,
        smooth_l1_beta: float = 0.0,
        box_reg_loss_weight: float = 1.0,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_weight = box_reg_loss_weight
        self.pooler_resolution = pooler_resolution
        self.pooler = ROIPooler(pooler_resolution, pooler_scales, sampling_ratio=0, min_level=2)
        self.box_head = FastRCNNFCHead(pooler_resolution * pooler_resolution * in_channels, fc_dim, emb_dim)
        self.box_predictor = FastRCNNOutputLayers(num_classes, emb_dim, temperature, use_text_emb,
                                                  cls_agnostic_bbox_reg)
        self.box2box = Box2BoxTransform((10.0, 10.0, 5.0, 5.0))
        self.matcher = Matcher((0.5,), (0, 1), allow_low_quality_matches=False)

    def box_features(self, features: Sequence[torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """Per level (B, H_l, W_l, C), boxes (B, S, 4) -> (B*S, emb_dim)."""
        return self.box_head(self.pooler(features, boxes))

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
    ):
        """Inference: the detections (DetectionResult). Training: the losses
        {"loss_cls", "loss_box_reg"} over the sampled proposals."""
        if training:
            if gt_boxes is None or gt_classes is None or gt_valid is None or draw is None:
                raise ValueError("RoI-head training needs gt_boxes, gt_classes, gt_valid and draw")
            boxes, classes, matched_gt, valid = self.label_and_sample_proposals(
                proposals, gt_boxes, gt_classes, gt_valid, draw
            )
            scores, deltas = self.box_predictor(self.box_features(features, boxes))
            n = boxes.shape[0] * boxes.shape[1]
            return fast_rcnn_losses(
                scores, deltas, boxes.reshape(n, 4), matched_gt.reshape(n, 4), classes.reshape(n),
                valid.reshape(n), self.num_classes, self.box2box, smooth_l1_beta=self.smooth_l1_beta,
                box_reg_loss_weight=self.box_reg_loss_weight,
            )
        b, k = proposals.boxes.shape[:2]
        scores, deltas = self.box_predictor(self.box_features(features, proposals.boxes))
        return fast_rcnn_inference(
            scores.reshape(b, k, -1), deltas.reshape(b, k, -1), proposals.boxes, proposals.valid, image_sizes,
            self.box2box, self.num_classes, score_thresh=self.score_thresh_test, nms_thresh=self.nms_thresh_test,
            topk_per_image=self.detections_per_image,
        )
