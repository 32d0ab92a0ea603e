"""RoI heads (counterpart of cddmsl_tpu/models/roi_heads.py
`CLIPRes5ROIHeads` and, box and mask paths, `CLIPStandardROIHeads`).

`StandardROIHeads`, the FPN family's: the 7x7 multi-level pooler
(models/poolers.py: K1 once per level, K3 for its gradient), two ReLU fcs,
fc1 reading the pooled map flattened in HWC order (JAX's; a detectron2
file's CHW fc1 is permuted when it loads), and the box predictor; training
samples proposals as the C4 heads do and takes the smooth-L1 (or GIoU) box
loss. With a mask head (MODEL.MASK_ON) a second pooler pools 14x14 from the
same levels (K1 once per level again, K3 for its gradient) for
models/mask_head.py's head.

`CLIPRes5ROIHeads`, the C4 heads: RoIAlign 14x14 at 1/16 on res4 (kernels K1 and, for its
gradient, K3 on the card) -> the backbone's res5 on every crop -> the
attention pool and the cosine classifier, or with the linear classifier
(`attnpool_fn` None) the mean over the crop. Inference ends in class-aware
NMS (kernel K4) or soft-NMS; training matches and samples the proposals
(with the ground truth appended) and returns the Fast R-CNN losses.
`forward_get_features` pools the same boxes from two maps for the
region-level consistency loss. With a mask head the training mask loss
reads the same res5 crops the box head reads, and inference pools the final
boxes again (one more K1 launch), runs res5 on them and the head.

With a keypoint head (MODEL.KEYPOINT_ON, models/keypoint_head.py) the C4
heads pool res4 again at the box pooler's resolution with 2x2 samples (one
more K1 launch, K3 for its gradient) for the sampled boxes in training and
for the final boxes at inference; the FPN heads have a 14x14 keypoint
pooler over the same levels. The keypoints are decoded on the final boxes.

In training the mask and keypoint branches run on the leading rows of each
image's samples, where the sampler packs its foreground rows: the
`mask_head.foreground_rows` of its quota, or more where keys tied at the
quota's threshold kept more positives (`_fg_rows`). JAX runs the heads on
all of them and masks the losses to the foreground, with the same losses
and gradients.
"""

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_regression import Box2BoxTransform
from ..ops.roi_align import roi_align_batched
from ..structures import boxes as box_ops
from .fast_rcnn import DetectionResult, FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .keypoint_head import KRCNNConvDeconvUpsampleHead, decode_keypoint_heatmaps, keypoint_branch_losses
from .mask_head import MaskRCNNConvUpsampleHead, foreground_rows, mask_branch_losses, mask_rcnn_inference
from .matcher import Matcher
from .poolers import ROIPooler
from .backbone.resnet import NormConv2d
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
    """`label_and_sample_proposals` of both heads, and their mask branch's
    loss and inference: they set num_classes, batch_size_per_image,
    positive_fraction, an IoU-0.5 `matcher` and call `_init_mask_branch`."""

    @torch.no_grad()
    def label_and_sample_proposals(
        self, proposals: Proposals, gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
        draw: Draw,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Proposals (B, P) with the ground truth (B, G) appended
        (PROPOSAL_APPEND_GT) -> per image `batch_size_per_image` samples,
        positives first: boxes (B, S, 4), classes (B, S) in [0, K], matched
        ground-truth boxes (B, S, 4), valid (B, S) and the index of each
        sample's matched ground truth (B, S). Draw sites "roi_pos",
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
        sampled_idx = torch.gather(matched_idxs, 1, idx)
        matched_gt = torch.gather(gt_boxes, 1, sampled_idx[..., None].expand(-1, -1, 4))
        sampled_classes = torch.where(valid, torch.gather(classes, 1, idx), k)
        return take(pboxes), sampled_classes, matched_gt, valid, sampled_idx

    def _fg_rows(self, classes, valid) -> int:
        """F, the leading samples of each image that hold every foreground
        sample: the sampler's quota of positives
        (`mask_head.foreground_rows`), unless a tie at the quota's threshold
        kept more (the sampler keeps every tied key, as JAX's does), and
        then the most that an image kept (reading the count is one host sync
        a step)."""
        fg = valid & (classes >= 0) & (classes < self.num_classes)
        return max(foreground_rows(self.batch_size_per_image, self.positive_fraction), int(fg.sum(1).max()))

    def _mask_losses(self, regions_fn: Callable, boxes, classes, valid, matched_idx, gt_masks,
                     f: int) -> torch.Tensor:
        """`loss_mask` over the leading `f` (`_fg_rows`) samples of each
        image. `regions_fn(boxes (B, F, 4))` gives their pooled regions."""
        boxes = boxes[:, :f]
        return mask_branch_losses(self.mask_head, regions_fn(boxes), gt_masks, boxes, classes[:, :f], valid[:, :f],
                                  matched_idx[:, :f], self.num_classes, self.mask_canvas_stride)

    def _keypoint_losses(self, regions_fn: Callable, boxes, classes, valid, matched_idx, gt_keypoints,
                         f: int) -> torch.Tensor:
        """`loss_keypoint` over the leading `f` (`_fg_rows`) samples of each
        image; `regions_fn(boxes (B, F, 4))` gives their pooled regions."""
        boxes = boxes[:, :f]
        return keypoint_branch_losses(self.keypoint_head, regions_fn(boxes), gt_keypoints, boxes, classes[:, :f],
                                      valid[:, :f], matched_idx[:, :f], self.num_classes,
                                      self.keypoint_loss_weight, self.keypoint_loss_normalizer)

    def _branch_losses(self, losses, mask_regions_fn, kp_regions_fn, boxes, classes, valid, matched_idx,
                       gt_masks, gt_keypoints):
        """Adds "loss_mask" and "loss_keypoint" where the heads have those
        branches, each on the same leading rows."""
        if self.mask_head is None and self.keypoint_head is None:
            return losses
        # a SyncBN mask head takes its batch statistics over every sampled
        # row, as JAX's head runs on them all
        all_rows = self.mask_head is not None and self.mask_head.conv_norm == "SyncBN"
        f = boxes.shape[1] if all_rows else self._fg_rows(classes, valid)
        if self.mask_head is not None:
            losses["loss_mask"] = self._mask_losses(mask_regions_fn, boxes, classes, valid, matched_idx, gt_masks, f)
        if self.keypoint_head is not None:
            losses["loss_keypoint"] = self._keypoint_losses(kp_regions_fn, boxes, classes, valid, matched_idx,
                                                            gt_keypoints, f)
        return losses

    def _with_keypoints(self, detections: DetectionResult, regions: torch.Tensor) -> DetectionResult:
        """The detections with their keypoints (B, D, K, 3) decoded from the
        head's heatmaps on `regions`, pooled for their boxes."""
        return detections._replace(keypoints=decode_keypoint_heatmaps(self.keypoint_head(regions), detections.boxes))

    def _with_masks(self, detections: DetectionResult, regions: torch.Tensor) -> DetectionResult:
        """The detections with the head's probabilities of their classes on
        `regions`, pooled for their boxes: masks (B, D, M, M)."""
        b, d = detections.boxes.shape[:2]
        probs = mask_rcnn_inference(self.mask_head(regions), detections.classes.reshape(b * d))
        return detections._replace(masks=probs.reshape(b, d, *probs.shape[1:]))

    def _init_mask_branch(self, mask_head: Optional[dict], in_channels: int) -> None:
        """`mask_head`: None, or the head's num_conv, conv_dim, cls_agnostic
        and canvas_stride (TPU.MASK_CANVAS_STRIDE)."""
        self.mask_head = None
        if mask_head is not None:
            mask_head = dict(mask_head)
            self.mask_canvas_stride = float(mask_head.pop("canvas_stride", 4.0))
            self.mask_head = MaskRCNNConvUpsampleHead(in_channels, self.num_classes, **mask_head)

    def _init_keypoint_branch(self, keypoint_head: Optional[dict], in_channels: int) -> None:
        """`keypoint_head`: None, or the head's num_keypoints, conv_dims,
        loss_weight and loss_normalizer (`keypoint_branch_losses`)."""
        self.keypoint_head = None
        if keypoint_head is not None:
            keypoint_head = dict(keypoint_head)
            self.keypoint_loss_weight = float(keypoint_head.pop("loss_weight", 1.0))
            self.keypoint_loss_normalizer = float(keypoint_head.pop("loss_normalizer", -1.0))
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(in_channels, **keypoint_head)


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
        mask_head: Optional[dict] = None,
        res5_channels: int = 2048,
        keypoint_head: Optional[dict] = None,
        res4_channels: int = 1024,
    ):
        """`emb_dim` is the width of the classifier's input: the attention
        pool's output with `use_text_emb`, else res5's channels. `soft_nms`
        = (method, sigma, prune) replaces the detection NMS. `no_box_delta`
        keeps the proposal boxes; `multiply_rpn_score` folds each
        proposal's objectness logit into its class scores. `mask_head`
        (`_init_mask_branch`) adds the mask head on res5's `res5_channels`;
        `keypoint_head` (`_init_keypoint_branch`) the keypoint head on res4's
        `res4_channels`, pooled again with 2x2 samples."""
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
        self._init_mask_branch(mask_head, res5_channels)
        self._init_keypoint_branch(keypoint_head, res4_channels)

    def keypoint_pool(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """The keypoint branch's regions: res4 pooled at the box pooler's
        resolution and scale with 2x2 samples (JAX's `KeypointROIHeads`)."""
        return pool_boxes(features, boxes, self.pooler_resolution, self.pooler_scale, 2)

    def pool(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """features (B, H, W, C), boxes (B, S, 4) -> (B*S, P, P, C)."""
        return pool_boxes(features, boxes, self.pooler_resolution, self.pooler_scale, self.pooler_sampling_ratio)

    def _region_embed(self, features, boxes, res5_fn: Callable, attnpool_fn: Optional[Callable]) -> torch.Tensor:
        """(B,H,W,C) x (B,S,4) -> (B*S, emb): pool -> res5 -> the attention
        pool, or without one the mean over the crop."""
        return self._embed(res5_fn(self.pool(features, boxes)), attnpool_fn)

    @staticmethod
    def _embed(r5: torch.Tensor, attnpool_fn: Optional[Callable]) -> torch.Tensor:
        return attnpool_fn(r5) if attnpool_fn is not None else r5.mean(dim=(1, 2))

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
        gt_masks: Optional[torch.Tensor] = None,
        gt_keypoints: Optional[torch.Tensor] = None,
    ):
        """Inference: the detections (DetectionResult, with masks and
        keypoints where the heads have those heads). Training: the losses
        {"loss_cls", "loss_box_reg"} over the sampled proposals,
        "loss_mask" against the canvases `gt_masks` (B, G, H/s, W/s) and
        "loss_keypoint" against `gt_keypoints` (B, G, K, 3)."""
        if training:
            if gt_boxes is None or gt_classes is None or gt_valid is None or draw is None:
                raise ValueError("RoI-head training needs gt_boxes, gt_classes, gt_valid and draw")
            boxes, classes, matched_gt, valid, matched_idx = self.label_and_sample_proposals(
                proposals, gt_boxes, gt_classes, gt_valid, draw
            )
            r5 = res5_fn(self.pool(features, boxes))  # the box and mask heads share res5's crops
            scores, deltas = self.box_predictor(self._embed(r5, attnpool_fn))
            b, s = boxes.shape[:2]
            n = b * s
            losses = fast_rcnn_losses(
                scores, deltas, boxes.reshape(n, 4), matched_gt.reshape(n, 4), classes.reshape(n),
                valid.reshape(n), self.num_classes, self.box2box, focal_gamma=self.focal_gamma,
                bg_loss_weight=self.bg_loss_weight,
            )
            crops = r5.reshape(b, s, *r5.shape[1:])
            return self._branch_losses(
                losses, lambda bx: crops[:, : bx.shape[1]].reshape(-1, *r5.shape[1:]),
                lambda bx: self.keypoint_pool(features, bx), boxes, classes, valid, matched_idx, gt_masks,
                gt_keypoints)
        b, k = proposals.boxes.shape[:2]
        region_feats = self._region_embed(features, proposals.boxes, res5_fn, attnpool_fn)
        scores, deltas = self.box_predictor(region_feats)
        detections = fast_rcnn_inference(
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
        if self.mask_head is not None:  # the final boxes pooled again, res5 on them
            detections = self._with_masks(detections, res5_fn(self.pool(features, detections.boxes)))
        if self.keypoint_head is not None:
            detections = self._with_keypoints(detections, self.keypoint_pool(features, detections.boxes))
        return detections


class FastRCNNFCHead(nn.Module):
    """detectron2's FastRCNNConvFCHead as JAX's `CLIPStandardROIHeads`
    builds it: `num_conv` 3x3 ReLU convs of `conv_dim` on the pooled map
    (box_head.conv{i}, each followed by `conv_norm`, GN or SyncBN, and then
    without a bias; ROI_BOX_HEAD.NUM_CONV / CONV_DIM / NORM), then `num_fc`
    ReLU fcs (box_head.fc1 of `fc_dim`, and with 2 fc2 of `out_dim`); fc1
    reads the map flattened in HWC order. The output is `out_dim` wide with
    two fcs, else `fc_dim`."""

    def __init__(self, in_features: int, fc_dim: int = 1024, out_dim: int = 1024, num_conv: int = 0,
                 conv_dim: int = 256, num_fc: int = 2, conv_norm: str = "", in_channels: int = 0):
        super().__init__()
        if num_fc not in (1, 2):
            raise ValueError(f"ROI_BOX_HEAD.NUM_FC {num_fc}: 1 or 2")
        self.num_conv, self.num_fc = num_conv, num_fc
        c = in_channels
        for i in range(num_conv):
            setattr(self, f"conv{i + 1}", NormConv2d(c, conv_dim, 3, padding=1, norm=conv_norm))
            c = conv_dim
        if num_conv:
            in_features = in_features // in_channels * conv_dim
        self.fc1 = nn.Linear(in_features, fc_dim)
        self.fc2 = nn.Linear(fc_dim, out_dim) if num_fc == 2 else None
        self.out_dim = out_dim if num_fc == 2 else fc_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, P, P, C) pooled regions -> (N, out_dim)."""
        if self.num_conv:
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_conv):
                x = F.relu(getattr(self, f"conv{i + 1}")(x))
            x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)
        for fc in (self.fc1, self.fc2)[:self.num_fc]:
            x = F.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
        return x


class StandardROIHeads(ProposalSampling):
    """The FPN family's box heads: `pooler_scales` one per level (one level
    for DC5), a 2-fc head of `fc_dim` then `emb_dim` (or `FastRCNNFCHead`'s
    convs and one fc: `box_num_conv`, `box_conv_dim`, `box_num_fc`,
    `box_conv_norm`), the linear or text-embedding predictor; smooth-L1 at `smooth_l1_beta`, or 1 - GIoU
    (`box_reg_loss_type`). `mask_head` (`_init_mask_branch`) adds the mask
    branch and `keypoint_head` (`_init_keypoint_branch`) the keypoint
    branch, each with its own 14x14 pooler over the same levels."""

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
        box_reg_loss_type: str = "smooth_l1",
        mask_head: Optional[dict] = None,
        keypoint_head: Optional[dict] = None,
        box_num_conv: int = 0,
        box_conv_dim: int = 256,
        box_num_fc: int = 2,
        box_conv_norm: str = "",
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
        self.box_reg_loss_type = box_reg_loss_type
        self.pooler_resolution = pooler_resolution
        self.pooler = ROIPooler(pooler_resolution, pooler_scales, sampling_ratio=0, min_level=2)
        self.box_head = FastRCNNFCHead(pooler_resolution * pooler_resolution * in_channels, fc_dim, emb_dim,
                                       box_num_conv, box_conv_dim, box_num_fc, box_conv_norm, in_channels)
        self.box_predictor = FastRCNNOutputLayers(num_classes, self.box_head.out_dim, temperature, use_text_emb,
                                                  cls_agnostic_bbox_reg)
        self.box2box = Box2BoxTransform((10.0, 10.0, 5.0, 5.0))
        self.matcher = Matcher((0.5,), (0, 1), allow_low_quality_matches=False)
        self._init_mask_branch(mask_head, in_channels)
        if self.mask_head is not None:
            self.mask_pooler = ROIPooler(14, pooler_scales, sampling_ratio=0, min_level=2)
        self._init_keypoint_branch(keypoint_head, in_channels)
        if self.keypoint_head is not None:
            self.keypoint_pooler = ROIPooler(14, pooler_scales, sampling_ratio=0, min_level=2)

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
        gt_masks: Optional[torch.Tensor] = None,
        gt_keypoints: Optional[torch.Tensor] = None,
    ):
        """Inference: the detections (DetectionResult, with masks and
        keypoints where the heads have those heads). Training: the losses
        {"loss_cls", "loss_box_reg"} over the sampled proposals,
        "loss_mask" against the canvases `gt_masks` and "loss_keypoint"
        against `gt_keypoints`."""
        if training:
            if gt_boxes is None or gt_classes is None or gt_valid is None or draw is None:
                raise ValueError("RoI-head training needs gt_boxes, gt_classes, gt_valid and draw")
            boxes, classes, matched_gt, valid, matched_idx = self.label_and_sample_proposals(
                proposals, gt_boxes, gt_classes, gt_valid, draw
            )
            scores, deltas = self.box_predictor(self.box_features(features, boxes))
            n = boxes.shape[0] * boxes.shape[1]
            losses = fast_rcnn_losses(
                scores, deltas, boxes.reshape(n, 4), matched_gt.reshape(n, 4), classes.reshape(n),
                valid.reshape(n), self.num_classes, self.box2box, smooth_l1_beta=self.smooth_l1_beta,
                box_reg_loss_weight=self.box_reg_loss_weight, box_reg_loss_type=self.box_reg_loss_type,
            )
            return self._branch_losses(
                losses, lambda bx: self.mask_pooler(features, bx), lambda bx: self.keypoint_pooler(features, bx),
                boxes, classes, valid, matched_idx, gt_masks, gt_keypoints)
        b, k = proposals.boxes.shape[:2]
        scores, deltas = self.box_predictor(self.box_features(features, proposals.boxes))
        detections = fast_rcnn_inference(
            scores.reshape(b, k, -1), deltas.reshape(b, k, -1), proposals.boxes, proposals.valid, image_sizes,
            self.box2box, self.num_classes, score_thresh=self.score_thresh_test, nms_thresh=self.nms_thresh_test,
            topk_per_image=self.detections_per_image,
        )
        if self.mask_head is not None:
            detections = self._with_masks(detections, self.mask_pooler(features, detections.boxes))
        if self.keypoint_head is not None:
            detections = self._with_keypoints(detections, self.keypoint_pooler(features, detections.boxes))
        return detections
