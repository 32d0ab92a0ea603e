"""RetinaNet (counterpart of cddmsl_tpu/models/retinanet.py `RetinaNetHead`
and `RetinaNet`): detectron2's single-stage detector over p3..p7.

The tower is the plain detectron2 ResNet to res3..res5 (FrozenBN) under the
FPN with RetinaNet's learned p6/p7 top block fed from res5
(models/backbone/resnet.py `FPN`, `top_block` "p6p7"); JAX names the five
maps p2..p6 by position, here they are named by stride, p3..p7 (8..128).
`RetinaNetHead` runs two towers of 3x3 ReLU convs shared over the levels
(head.cls_subnet.{0,2,4,6} and head.bbox_subnet.*, detectron2's names: the
odd entries are the ReLUs) and the 3x3 `cls_score` (A x K logits, its bias
at the prior -log((1 - p) / p)) and `bbox_pred` (A x 4 deltas). Each cell
has A = 3 sizes x 3 ratios anchors of its level's size group.

Training matches every anchor to the ground truth at IoU [0.4, 0.5) ->
labels (0, -1, 1) with the low-quality matches kept, and takes the sigmoid
focal loss of every anchor not ignored and the smooth-L1 (or 1 - GIoU of the
decoded boxes) of the foreground anchors. Both are divided by the EMA
normalizer `loss_normalizer`: in the mutable apply
(models/backbone/batch_norm.py `updating_running_state`, the train step) it
first moves to m * old + (1 - m) * max(foreground anchors, 1) (m = 0.9,
from 100) and then divides; elsewhere it divides as moved. Under a process
group the foreground count is the global batch's (summed over the ranks)
and each rank's loss is its share, so the ranks' mean is the global loss.

Inference, per level: the top min(TOPK_CANDIDATES_TEST, H*W*A*K) of the
sigmoid scores flattened anchor-major with the class fastest (the NHWC
order JAX reshapes; the NCHW map is permuted to it first), ties to the lower
index as `lax.top_k` breaks them; only then the scores at or under
SCORE_THRESH_TEST are zeroed; the boxes are decoded without clipping. The
five levels' candidates go through one class-aware `batched_nms` (kernel K4
on the card) with `valid = score > 0`, and the detections are rescaled to
the original size and clipped only then.

It keeps the trainer's protocol: `cddmsl_losses` returns the losses
whatever the caption gates say; the sampler's draws are not read.
"""

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.anchors import anchor_grid, generate_cell_anchors
from ..ops.box_regression import Box2BoxTransform
from ..ops.nms import batched_nms
from ..parallel import comm
from ..structures import boxes as box_ops
from .backbone.batch_norm import RunningState
from .backbone.clip_resnet import _nchw
from .backbone.resnet import FPN, D2ResNet, _conv
from .fast_rcnn import DetectionResult
from .matcher import Matcher
from .rcnn import DetBatch, normalize, rescale_detections
from .rpn import smooth_l1
from .sampling import Draw

# [x, x*2^(1/3), x*2^(2/3)] per octave (Base-RetinaNet.yaml's expression, expanded)
OCTAVE_SIZES = tuple(tuple(s * 2.0 ** (k / 3.0) for k in range(3)) for s in (32, 64, 128, 256, 512))
LEVELS = ("p3", "p4", "p5", "p6", "p7")
STRIDES = (8, 16, 32, 64, 128)
NORMALIZER_MOMENTUM = 0.9  # the EMA loss normalizer's, from 100


class RetinaNetHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_anchors: int, conv_dims: Sequence[int] = (256,) * 4,
                 prior_prob: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        for name in ("cls_subnet", "bbox_subnet"):
            mods, c = [], in_channels
            for dim in conv_dims:
                mods += [nn.Conv2d(c, dim, 3, padding=1), nn.ReLU()]
                c = dim
            setattr(self, name, nn.Sequential(*mods))
        self.cls_score = nn.Conv2d(c, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = nn.Conv2d(c, num_anchors * 4, 3, padding=1)
        # the classifier's prior, which `init_random_` keeps
        self.cls_score.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        with torch.no_grad():
            self.cls_score.bias.fill_(self.cls_score.prior_bias)

    @staticmethod
    def _tower(subnet: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for m in subnet:
            x = _conv(m, x) if isinstance(m, nn.Conv2d) else F.relu(x)
        return x

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """NHWC levels -> (logits (B, H, W, A*K), deltas (B, H, W, A*4)) per
        level, NHWC, in the input's dtype."""
        logits, deltas = [], []
        for f in features:
            x = _nchw(f)
            logits.append(_conv(self.cls_score, self._tower(self.cls_subnet, x)).permute(0, 2, 3, 1))
            deltas.append(_conv(self.bbox_pred, self._tower(self.bbox_subnet, x)).permute(0, 2, 3, 1))
        return logits, deltas


def sigmoid_focal_loss(logits: torch.Tensor, onehot: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """Elementwise focal loss of float32 logits against {0, 1} targets, as
    JAX writes it (the stable BCE, p_t, alpha_t)."""
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * onehot + torch.log1p(torch.exp(-torch.abs(logits)))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) -> the k largest per row and their indices, descending, equal
    scores in index order (`lax.top_k`'s order)."""
    values, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


class RetinaNet(RunningState):
    def __init__(
        self,
        num_classes: int = 80,
        depth: int = 50,
        anchor_sizes: Sequence[Sequence[float]] = OCTAVE_SIZES,
        aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        iou_thresholds: Sequence[float] = (0.4, 0.5),
        iou_labels: Sequence[int] = (0, -1, 1),
        focal_alpha: float = 0.25,
        focal_gamma: float = 2.0,
        smooth_l1_beta: float = 0.1,
        box_reg_loss_type: str = "smooth_l1",
        score_thresh: float = 0.05,
        nms_thresh: float = 0.5,
        topk_candidates: int = 1000,
        detections_per_image: int = 100,
        pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
        pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        backbone_width: int = 64,
        res2_out_channels: int = 256,
        fpn_out_channels: int = 256,
        head_conv_dims: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
    ):
        """JAX's fields (MODEL.RETINANET.*, the anchor groups, the pixel
        statistics, TEST.DETECTIONS_PER_IMAGE); `backbone_width`,
        `res2_out_channels`, `fpn_out_channels` and `head_conv_dims` (four
        convs of the FPN's width when empty) narrow the towers for tests."""
        super().__init__()
        if box_reg_loss_type not in ("smooth_l1", "giou"):
            raise ValueError(f"RETINANET.BBOX_REG_LOSS_TYPE {box_reg_loss_type!r}: smooth_l1 or giou")
        if len(anchor_sizes) != len(STRIDES):
            raise ValueError(f"{len(anchor_sizes)} anchor size groups for {len(STRIDES)} levels")
        self.num_classes = num_classes
        self.anchor_sizes = tuple(tuple(float(s) for s in g) for g in anchor_sizes)
        self.aspect_ratios = tuple(float(a) for a in aspect_ratios)
        self.focal_alpha, self.focal_gamma = focal_alpha, focal_gamma
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_type = box_reg_loss_type
        self.score_thresh, self.nms_thresh = score_thresh, nms_thresh
        self.topk_candidates = topk_candidates
        self.detections_per_image = detections_per_image
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.dtype = dtype
        tower = D2ResNet(depth, width_per_group=backbone_width, res2_out_channels=res2_out_channels)
        self.backbone = FPN(tower, fpn_out_channels, in_levels=(3, 4, 5), top_block="p6p7")
        num_anchors = len(self.anchor_sizes[0]) * len(self.aspect_ratios)
        self.head = RetinaNetHead(fpn_out_channels, num_classes, num_anchors,
                                  tuple(head_conv_dims) or (fpn_out_channels,) * 4)
        self.box2box = Box2BoxTransform((1.0, 1.0, 1.0, 1.0))
        self.matcher = Matcher(tuple(iou_thresholds), tuple(iou_labels), allow_low_quality_matches=True)
        self.register_buffer("loss_normalizer", torch.tensor(100.0))

    def running_state_names(self):
        return ("loss_normalizer",)

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Raw images (B, H, W, 3) -> p3..p7, NHWC."""
        x = normalize(images, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False)
        feats = self.backbone(x)
        return [feats[k] for k in LEVELS]

    def level_anchors(self, shapes, device) -> List[torch.Tensor]:
        """Per level (H*W*A, 4) anchors, cells row-major, anchors fastest."""
        return [anchor_grid(h, w, stride, generate_cell_anchors(sizes, self.aspect_ratios), device=device)
                for (h, w), stride, sizes in zip(shapes, STRIDES, self.anchor_sizes)]

    def head_outputs(self, images: torch.Tensor):
        """(per-level logits (B, H*W*A, K) and deltas (B, H*W*A, 4) in
        float32, the levels' (H, W))."""
        levels = self.features(images)
        logits_l, deltas_l = self.head(levels)
        b, k = images.shape[0], self.num_classes
        logits = [lg.reshape(b, -1, k).float() for lg in logits_l]
        deltas = [d.reshape(b, -1, 4).float() for d in deltas_l]
        return logits, deltas, [tuple(lv.shape[1:3]) for lv in levels]

    def losses(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        """{"loss_cls", "loss_box_reg"}, each divided by the normalizer
        (moved first in the mutable apply)."""
        logits_l, deltas_l, shapes = self.head_outputs(batch.image)
        logits, deltas = torch.cat(logits_l, dim=1), torch.cat(deltas_l, dim=1)
        anchors = torch.cat(self.level_anchors(shapes, logits.device), dim=0)
        b, n = logits.shape[:2]
        gt_boxes, gt_valid = batch.gt_boxes.float(), batch.gt_valid
        iou = box_ops.pairwise_iou(gt_boxes, anchors.expand(b, n, 4))  # (B, G, N)
        matched_idxs, match_labels = self.matcher(iou, gt_valid)
        fg, valid = match_labels == 1, match_labels != -1
        gt_cls = torch.where(fg, torch.gather(batch.gt_classes.long(), 1, matched_idxs), self.num_classes)
        # the background's and any class out of range one-hot to zeros, as jax.nn.one_hot gives them
        onehot = (gt_cls[..., None] == torch.arange(self.num_classes, device=gt_cls.device)).float()
        focal = sigmoid_focal_loss(logits, onehot, self.focal_alpha, self.focal_gamma)
        cls_loss = torch.sum(focal * valid[..., None])
        matched = torch.gather(gt_boxes, 1, matched_idxs[..., None].expand(-1, -1, 4))
        if self.box_reg_loss_type == "giou":
            pred = self.box2box.apply_deltas(deltas, anchors.expand(b, n, 4))
            reg = torch.sum((1.0 - box_ops.pairwise_giou(pred, matched)) * fg)
        else:
            gt_deltas = self.box2box.get_deltas(anchors.expand(b, n, 4), matched)
            reg = torch.sum(smooth_l1(deltas, gt_deltas, self.smooth_l1_beta) * fg[..., None])
        nfg = fg.sum().float()
        world = comm.get_world_size()
        if world > 1:
            nfg = nfg.clone()
            torch.distributed.all_reduce(nfg)
        m = NORMALIZER_MOMENTUM
        norm = m * self.loss_normalizer + (1.0 - m) * torch.clamp(nfg, min=1.0)
        if self.updating:
            with torch.no_grad():
                self.loss_normalizer.copy_(norm)
        share = norm / world
        return {"loss_cls": cls_loss / share, "loss_box_reg": reg / share}

    def cddmsl_losses(self, batch: DetBatch, draw: Draw = None, caption_on: bool = False,
                      kd_regularization: bool = True, enable_caption: bool = True) -> Dict[str, torch.Tensor]:
        """The trainer's loss set: the focal and box losses."""
        return self.losses(batch)

    @torch.no_grad()
    def candidates(self, batch: DetBatch):
        """Per level, the top-k candidates: boxes (B, k, 4) decoded without
        clipping, scores (B, k) zeroed at or under the threshold, classes
        (B, k) int32."""
        logits_l, deltas_l, shapes = self.head_outputs(batch.image)
        out = []
        k_cls = self.num_classes
        for logit, delta, anchors in zip(logits_l, deltas_l, self.level_anchors(shapes, batch.image.device)):
            b = logit.shape[0]
            k = min(self.topk_candidates, logit.shape[1] * k_cls)
            top_p, top_i = stable_topk(torch.sigmoid(logit).reshape(b, -1), k)
            a_idx = torch.div(top_i, k_cls, rounding_mode="floor")
            cls = (top_i % k_cls).to(torch.int32)
            d = torch.gather(delta, 1, a_idx[..., None].expand(-1, -1, 4))
            boxes = self.box2box.apply_deltas(d, anchors[a_idx])
            out.append((boxes, torch.where(top_p > self.score_thresh, top_p, torch.zeros_like(top_p)), cls))
        return out

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> DetectionResult:
        """The five levels' candidates -> one class-aware NMS per image ->
        with `do_postprocess` the boxes rescaled to orig_sizes and clipped."""
        cands = self.candidates(batch)
        boxes = torch.cat([c[0] for c in cands], dim=1)
        scores = torch.cat([c[1] for c in cands], dim=1)
        classes = torch.cat([c[2] for c in cands], dim=1)
        idx, valid = batched_nms(boxes, scores, classes, self.nms_thresh, self.detections_per_image,
                                 valid=scores > 0)
        take = lambda t: torch.gather(t, 1, idx if t.dim() == 2 else idx[..., None].expand(-1, -1, 4))  # noqa: E731
        det = DetectionResult(take(boxes), torch.where(valid, take(scores), torch.zeros_like(take(scores))),
                              take(classes), valid)
        return rescale_detections(det, batch) if do_postprocess else det
