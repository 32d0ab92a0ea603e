"""Rotated Faster R-CNN (counterpart of cddmsl_tpu/models/rotated_rcnn.py):
`RRPN`, an RPN over (cx, cy, w, h, angle) anchors matched by rotated IoU
and pruned by rotated NMS, `RROIHeads`, rotated RoIAlign into a 2-FC head
with 5-d class-specific deltas and a class-aware rotated NMS, and
`RotatedFastRCNN`, both over the plain ResNet's res4 at stride 16.

As in JAX: the RPN head's 3x3 conv has res2_out_channels x 4 = 1024
outputs whatever the tower's res4 width (256 at depth 18, 1024 at 10);
the RPN neither clips its proposals to the image nor drops small ones; the
class-aware NMS moves each box's cx by class * 10000.0 in float32 (at cx
near 7e4 the IoUs of the moved boxes round differently from the unmoved
ones, so the offset is JAX's own); fc1 reads the pooled map in HWC order.
The rotated geometry is ops/rotated.py, plain torch on every device (JAX
computes it in XLA, not in Pallas). The samplers take their uniforms from a
`Draw` at the sites "rpn_pos", "rpn_neg" (B, anchors) and "roi_pos",
"roi_neg", "roi_gather" (B, proposals + ground truth), the sites and key
tree of the C4 detector.

JAX's trainer cannot train this arch (it has no `init_all` or
`cddmsl_losses`, and no mapper makes a `RotatedDetBatch`), so neither does
`train_net`: `models.build.build_rotated_fast_rcnn` builds it, and a step
is `forward(batch, draw)`'s four losses through the port's optimizer.
"""

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_regression import Box2BoxTransformRotated
from ..ops.rotated import nms_rotated, pairwise_iou_rotated, roi_align_rotated
from .backbone.resnet import D2ResNet
from .matcher import Matcher
from .rcnn import normalize
from .rpn import StandardRPNHead, smooth_l1
from .sampling import Draw, gather_selected, subsample_labels


class RotatedProposals(NamedTuple):
    boxes: torch.Tensor  # (B, K, 5) XYWHA
    scores: torch.Tensor  # (B, K) objectness logits, -inf where invalid
    valid: torch.Tensor  # (B, K) bool


class RotatedDetBatch(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) float in [0, 255]
    image_sizes: torch.Tensor  # (B, 2)
    gt_boxes: Optional[torch.Tensor] = None  # (B, G, 5) XYWHA, degrees
    gt_classes: Optional[torch.Tensor] = None  # (B, G) int
    gt_valid: Optional[torch.Tensor] = None  # (B, G) bool


class RotatedDetectionResult(NamedTuple):
    boxes: torch.Tensor  # (B, D, 5)
    scores: torch.Tensor  # (B, D), 0 where invalid
    classes: torch.Tensor  # (B, D) int32
    valid: torch.Tensor  # (B, D) bool


def rotated_anchor_grid(h: int, w: int, stride: int, sizes: Sequence[float], aspect_ratios: Sequence[float],
                        angles: Sequence[float]) -> np.ndarray:
    """(H*W*A, 5) anchors: sizes x ratios x angles at every cell's center
    ((i + 0.5) * stride), in HWA order."""
    cell = []
    for size in sizes:
        area = size ** 2
        for ar in aspect_ratios:
            cw = np.sqrt(area / ar)
            ch = ar * cw
            for a in angles:
                cell.append([0.0, 0.0, cw, ch, a])
    cell = np.asarray(cell, np.float32)
    ys = (np.arange(h) + 0.5) * stride
    xs = (np.arange(w) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)
    centers = np.stack([cx.ravel(), cy.ravel()], axis=1)
    out = np.zeros((len(centers), len(cell), 5), np.float32)
    out[:, :, :2] = centers[:, None, :]
    out[:, :, 2:] = cell[None, :, 2:]
    return out.reshape(-1, 5)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class RRPN(nn.Module):
    """The rotated RPN on one map at `stride`: sizes x ratios x angles
    anchors, IoU 0.3 / 0.7 with low-quality matches, 256 samples an image
    half positive, L1 box loss (beta 0), pre-NMS top 512 and post-NMS top
    128 at IoU 0.7, the same in training and at test."""

    def __init__(self, in_channels: int, conv_dim: int = 1024, stride: int = 16,
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_angles: Sequence[float] = (-90.0, -30.0, 30.0, 90.0),
                 batch_size_per_image: int = 256, positive_fraction: float = 0.5, pre_nms_topk: int = 512,
                 post_nms_topk: int = 128, nms_thresh: float = 0.7, smooth_l1_beta: float = 0.0,
                 loss_weight: float = 1.0):
        super().__init__()
        self.stride = stride
        self.anchor_args = (tuple(anchor_sizes), tuple(anchor_aspect_ratios), tuple(anchor_angles))
        self.num_anchors = len(anchor_sizes) * len(anchor_aspect_ratios) * len(anchor_angles)
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.nms_thresh = nms_thresh
        self.smooth_l1_beta = smooth_l1_beta
        self.loss_weight = loss_weight
        self.rpn_head = StandardRPNHead(in_channels, self.num_anchors, box_dim=5, conv_dim=conv_dim)
        self.box2box = Box2BoxTransformRotated((1.0, 1.0, 1.0, 1.0, 1.0))
        self.matcher = Matcher((0.3, 0.7), (0, -1, 1), allow_low_quality_matches=True)

    def anchors(self, h: int, w: int, device) -> torch.Tensor:
        return torch.from_numpy(rotated_anchor_grid(h, w, self.stride, *self.anchor_args)).to(device)

    def match(self, gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor):
        """Each anchor's ground truth and label (B, A): rotated IoU of every
        valid ground-truth box with every anchor, image by image."""
        iou = torch.stack([pairwise_iou_rotated(g, anchors) for g in gt_boxes])
        iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
        return self.matcher(iou, gt_valid)

    def forward(self, features: torch.Tensor, training: bool = False, gt_boxes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                draw: Optional[Draw] = None) -> Tuple[RotatedProposals, Dict[str, torch.Tensor]]:
        """features (B, H, W, C) NHWC -> (proposals, losses); in training
        gt_boxes (B, G, 5), gt_valid (B, G) and `draw` give the losses."""
        b, h, w, _ = features.shape
        logits_map, deltas_map = self.rpn_head(features.permute(0, 3, 1, 2))
        logits = logits_map.permute(0, 2, 3, 1).reshape(b, -1).float()
        deltas = deltas_map.permute(0, 2, 3, 1).reshape(b, -1, 5).float()
        anchors = self.anchors(h, w, features.device)
        n = anchors.shape[0]
        losses: Dict[str, torch.Tensor] = {}
        if training:
            if gt_boxes is None or gt_valid is None or draw is None:
                raise ValueError("RRPN training needs gt_boxes, gt_valid and draw")
            matched_idxs, match_labels = self.match(gt_boxes, gt_valid, anchors)
            pos_sel, neg_sel = subsample_labels(match_labels == 1, match_labels == 0, self.batch_size_per_image,
                                                self.positive_fraction, draw("rpn_pos", (b, n)),
                                                draw("rpn_neg", (b, n)))
            gt_deltas = self.box2box.get_deltas(anchors.expand(b, -1, -1), _take(gt_boxes, matched_idxs))
            loc = (smooth_l1(deltas, gt_deltas, self.smooth_l1_beta) * pos_sel[..., None]).sum()
            t = pos_sel.float()
            bce = torch.clamp(logits, min=0) - logits * t + torch.log1p(torch.exp(-torch.abs(logits)))
            norm = self.batch_size_per_image * b
            losses = {"loss_rpn_cls": (bce * (pos_sel | neg_sel)).sum() / norm * self.loss_weight,
                      "loss_rpn_loc": loc / norm * self.loss_weight}
        return self._proposals(anchors, logits.detach(), deltas.detach()), losses

    @torch.no_grad()
    def _proposals(self, anchors, logits, deltas) -> RotatedProposals:
        pre_k = min(self.pre_nms_topk, anchors.shape[0])
        top_scores, top_idx = torch.sort(logits, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :pre_k], top_idx[:, :pre_k]
        top_boxes = self.box2box.apply_deltas(_take(deltas, top_idx), anchors[top_idx])
        ok = torch.all(torch.isfinite(top_boxes), dim=-1) & torch.isfinite(top_scores)
        picks = [nms_rotated(top_boxes[i], top_scores[i], self.nms_thresh, self.post_nms_topk, valid=ok[i])
                 for i in range(logits.shape[0])]
        idx = torch.stack([p[0] for p in picks])
        valid = torch.stack([p[1] for p in picks])
        scores = _take(top_scores, idx)
        return RotatedProposals(_take(top_boxes, idx), torch.where(valid, scores, torch.full_like(scores, -np.inf)),
                                valid)


class RROIHeads(nn.Module):
    """Rotated RoIAlign (7x7 at 1/16, 2x2 samples) into fc1, fc2 (256, ReLU),
    a linear classifier over num_classes + background and 5-d deltas per
    class (weights 10, 10, 5, 5, 1); 64 sampled rows an image, a quarter
    positive at IoU 0.5 without low-quality matches; at test 256
    candidates above 0.05, a class-aware rotated NMS at 0.5, 32 kept."""

    def __init__(self, in_channels: int, num_classes: int = 8, batch_size_per_image: int = 64,
                 positive_fraction: float = 0.25, pooler_resolution: int = 7, pooler_scale: float = 1.0 / 16,
                 fc_dim: int = 256, score_thresh_test: float = 0.05, nms_thresh_test: float = 0.5,
                 detections_per_image: int = 32, max_candidates: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.max_candidates = max_candidates
        self.box_head = nn.Module()
        self.box_head.fc1 = nn.Linear(in_channels * pooler_resolution ** 2, fc_dim)
        self.box_head.fc2 = nn.Linear(fc_dim, fc_dim)
        self.box_predictor = nn.Module()
        self.box_predictor.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.box_predictor.bbox_pred = nn.Linear(fc_dim, num_classes * 5)
        self.box2box = Box2BoxTransformRotated((10.0, 10.0, 5.0, 5.0, 1.0))
        self.matcher = Matcher((0.5,), (0, 1), allow_low_quality_matches=False)

    @staticmethod
    def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))

    def _box_feats(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        b, s = boxes.shape[:2]
        p = self.pooler_resolution
        pooled = roi_align_rotated(features, boxes, (p, p), self.pooler_scale)
        x = pooled.reshape(b * s, -1).to(features.dtype)
        x = F.relu(self._linear(self.box_head.fc1, x))
        return F.relu(self._linear(self.box_head.fc2, x))

    def sample(self, proposals: RotatedProposals, gt_boxes, gt_classes, gt_valid, draw: Draw):
        """The sampled rows (B, S): boxes, classes (num_classes for
        background and padding), matched ground truth, valid."""
        b = gt_boxes.shape[0]
        nc = self.num_classes
        pboxes = torch.cat([proposals.boxes, gt_boxes], dim=1)
        pvalid = torch.cat([proposals.valid, gt_valid], dim=1)
        iou = torch.stack([pairwise_iou_rotated(g, p) for g, p in zip(gt_boxes, pboxes)])
        iou = torch.where(pvalid[:, None, :] & gt_valid[..., None], iou, torch.full_like(iou, -1.0))
        matched_idxs, match_labels = self.matcher(iou, gt_valid)
        classes = torch.where(match_labels == 1, torch.gather(gt_classes.long(), 1, matched_idxs),
                              torch.full_like(matched_idxs, nc))
        classes = torch.where(pvalid, classes, torch.full_like(classes, -1))
        n = pboxes.shape[1]
        pos_sel, neg_sel = subsample_labels((classes >= 0) & (classes < nc), classes == nc,
                                            self.batch_size_per_image, self.positive_fraction,
                                            draw("roi_pos", (b, n)), draw("roi_neg", (b, n)))
        idx, valid = gather_selected(pos_sel, neg_sel, self.batch_size_per_image, draw("roi_gather", (b, n)))
        cls = torch.where(valid, torch.gather(classes, 1, idx), torch.full_like(idx, nc))
        return _take(pboxes, idx), cls, _take(gt_boxes, torch.gather(matched_idxs, 1, idx)), valid

    def losses(self, features, proposals: RotatedProposals, gt_boxes, gt_classes, gt_valid,
               draw: Draw) -> Dict[str, torch.Tensor]:
        boxes, classes, matched_gt, valid = self.sample(proposals, gt_boxes, gt_classes, gt_valid, draw)
        b, s = boxes.shape[:2]
        nc = self.num_classes
        x = self._box_feats(features, boxes)
        scores = self._linear(self.box_predictor.cls_score, x).float()
        deltas = self._linear(self.box_predictor.bbox_pred, x).float()
        flat_cls, flat_valid = classes.reshape(-1), valid.reshape(-1)
        n_valid = torch.clamp(flat_valid.sum().float(), min=1.0)
        safe = torch.where(flat_valid, flat_cls, torch.full_like(flat_cls, nc))
        ce = -torch.gather(F.log_softmax(scores, -1), 1, safe[:, None])[:, 0]
        loss_cls = (ce * flat_valid).sum() / n_valid
        fg = flat_valid & (flat_cls < nc)
        d = deltas.reshape(b * s, nc, 5)
        sel = torch.gather(d, 1, torch.clamp(flat_cls, 0, nc - 1)[:, None, None].expand(-1, 1, 5))[:, 0]
        gt_deltas = self.box2box.get_deltas(boxes.reshape(-1, 5), matched_gt.reshape(-1, 5))
        reg = smooth_l1(sel, gt_deltas, 0.0).sum(dim=1)
        return {"loss_cls": loss_cls, "loss_box_reg": (reg * fg).sum() / n_valid}

    @torch.no_grad()
    def inference(self, features, proposals: RotatedProposals) -> RotatedDetectionResult:
        b, k = proposals.boxes.shape[:2]
        nc = self.num_classes
        x = self._box_feats(features, proposals.boxes)
        scores = F.softmax(self._linear(self.box_predictor.cls_score, x).float(), -1)[:, :-1].reshape(b, k, nc)
        deltas = self._linear(self.box_predictor.bbox_pred, x).float().reshape(b, k, nc * 5)
        boxes_all = self.box2box.apply_deltas(deltas, proposals.boxes).reshape(b, k * nc, 5)
        cand = (scores > self.score_thresh_test) & proposals.valid[..., None]
        flat_scores = torch.where(cand, scores, torch.zeros_like(scores)).reshape(b, -1)
        flat_classes = torch.arange(nc, device=scores.device).repeat(k)
        m = min(self.max_candidates, k * nc)
        top_scores, top_idx = torch.sort(flat_scores, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :m], top_idx[:, :m]
        tb, tc = _take(boxes_all, top_idx), flat_classes[top_idx]
        tv = top_scores > self.score_thresh_test
        off = tb.clone()
        off[..., 0] += tc.to(tb.dtype) * 10000.0
        picks = [nms_rotated(off[i], top_scores[i], self.nms_thresh_test, self.detections_per_image, valid=tv[i])
                 for i in range(b)]
        idx = torch.stack([p[0] for p in picks])
        valid = torch.stack([p[1] for p in picks])
        return RotatedDetectionResult(_take(tb, idx), torch.where(valid, _take(top_scores, idx), torch.zeros_like(
            valid, dtype=top_scores.dtype)), _take(tc, idx).to(torch.int32), valid)


class RotatedFastRCNN(nn.Module):
    """The plain ResNet of `depth` to res4 (FrozenBN), `RRPN` and
    `RROIHeads` on its res4, from MODEL.ROI_HEADS.NUM_CLASSES,
    RESNETS.DEPTH, PIXEL_MEAN / PIXEL_STD and TPU.COMPUTE_DTYPE alone, as
    JAX's `build_rotated_fast_rcnn` reads the tree."""

    use_text_emb = False  # the linear classifier trains

    def __init__(self, num_classes: int = 8, depth: int = 10, pixel_mean=(103.53, 116.28, 123.675),
                 pixel_std=(1.0, 1.0, 1.0), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pixel_mean, self.pixel_std, self.dtype = tuple(pixel_mean), tuple(pixel_std), dtype
        self.backbone = D2ResNet(depth, res5=False)
        ch = self.backbone.out_channels["res4"]
        self.proposal_generator = RRPN(ch)  # its 3x3 of 1024 outputs, JAX's res2_out_channels x 4
        self.roi_heads = RROIHeads(ch, num_classes=num_classes)

    def _features(self, image: torch.Tensor) -> torch.Tensor:
        x = normalize(image, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False)
        return self.backbone(x)["res4"]

    def forward(self, batch: RotatedDetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """The four losses: loss_rpn_cls, loss_rpn_loc, loss_cls, loss_box_reg."""
        f = self._features(batch.image)
        proposals, rpn_losses = self.proposal_generator(f, True, batch.gt_boxes, batch.gt_valid, draw)
        det_losses = self.roi_heads.losses(f, proposals, batch.gt_boxes, batch.gt_classes, batch.gt_valid, draw)
        return {**rpn_losses, **det_losses}

    @torch.no_grad()
    def inference(self, batch: RotatedDetBatch) -> RotatedDetectionResult:
        f = self._features(batch.image)
        proposals, _ = self.proposal_generator(f, False)
        return self.roi_heads.inference(f, proposals)
