"""RegionCLIP's two meta-architectures (counterpart of
cddmsl_tpu/models/clip_rcnn.py: `CLIPFastRCNN`, `soft_target_cross_entropy`,
`mil_cross_entropy` and `PretrainFastRCNN`).

`CLIPFastRCNN` is the open-vocabulary detector: a frozen offline RPN (a
plain detectron2 ResNet that ends at res4, `D2ResNet`, on BGR 0..255 inputs minus the
detectron2 means, and its own single-level RPN at NMS
`offline_rpn_nms_thresh`, kernel K4) proposes the regions; the CLIP tower
pools them from its res4 map (K1, and K3 for the gradient), runs res5 and
the attention pool on the crops and classifies them against frozen text
embeddings. Training (`supervised_losses`) samples the proposals with the
ground truth and returns the Fast R-CNN losses of the recognition branch
alone: the offline modules run without a gradient and hold no trainable
parameter. Its RPN takes JAX's module defaults, never MODEL.RPN.

A student CLIP ResNet and a frozen teacher of the same shape each pool the
same regions of a batch of 224x224 images from their res4 maps (RoIAlign
14x14 at 1/16: kernel K1 on the card, and K3 for the student's gradient),
run res5 and the attention pool, and give one embedding per region. Three
losses, in this order, all in float32:

- `img_txt_loss`: the mean of each image's unit region embeddings,
  normalised, against the frozen text tower's caption embeddings, a
  symmetric InfoNCE over the batch at the learned `logit_scale`;
- `region_txt_mil_loss`: each region against every caption at the same
  scale, a multiple-instance cross entropy whose bag is its own image's
  caption;
- `concept_distill_loss`: the teacher's softmax over the frozen concept
  pool (temperature 0.01) as the student's soft target, over the regions
  whose teacher score peaks above `concept_thresh`, divided by their count
  (at least 1).

The teacher and the text tower run without a gradient, as JAX's
`stop_gradient` has them.
"""

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from .backbone.clip_resnet import ModifiedResNet
from .backbone.resnet import D2ResNet
from .backbone.text_encoder import CLIPTextEncoder
from .fast_rcnn import DetectionResult
from .rcnn import DetBatch
from .roi_heads import CLIPRes5ROIHeads, pool_boxes
from .rpn import RPN, Proposals
from .sampling import Draw

D2_PIXEL_MEAN = (103.53, 116.28, 123.675)


class CLIPFastRCNN(nn.Module):
    """The offline RPN and the CLIP recognition branch. The constructor
    takes the fields of JAX's module, with their defaults."""

    def __init__(
        self,
        backbone_layers: Sequence[int] = (3, 4, 6, 3),
        backbone_width: int = 64,
        embed_dim: int = 1024,
        num_classes: int = 80,
        offline_depth: int = 50,
        rpn_post_nms_topk: Tuple[int, int] = (2000, 1000),
        offline_rpn_nms_thresh: float = 0.9,
        temperature: float = 0.01,
        focal_gamma: Optional[float] = None,
        bg_loss_weight: Optional[float] = None,
        no_box_delta: bool = False,
        cls_agnostic_bbox_reg: bool = False,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        pixel_mean: Sequence[float] = CLIP_PIXEL_MEAN,
        pixel_std: Sequence[float] = CLIP_PIXEL_STD,
        offline_pixel_mean: Sequence[float] = D2_PIXEL_MEAN,
        offline_pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        offline_input_bgr: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.offline_rpn_nms_thresh = offline_rpn_nms_thresh
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.offline_pixel_mean, self.offline_pixel_std = tuple(offline_pixel_mean), tuple(offline_pixel_std)
        self.offline_input_bgr = offline_input_bgr
        self.dtype = dtype
        self.offline_backbone = D2ResNet(offline_depth, res5=False).requires_grad_(False)
        self.offline_proposal_generator = RPN(
            in_channels=1024, stride=16, nms_thresh=offline_rpn_nms_thresh,
            post_nms_topk_train=rpn_post_nms_topk[0], post_nms_topk_test=rpn_post_nms_topk[1],
        ).requires_grad_(False)
        self.backbone = ModifiedResNet(backbone_layers, embed_dim, backbone_width * 32 // 64, backbone_width)
        self.roi_heads = CLIPRes5ROIHeads(
            num_classes=num_classes, emb_dim=embed_dim, temperature=temperature, focal_gamma=focal_gamma,
            bg_loss_weight=bg_loss_weight, score_thresh_test=score_thresh_test, nms_thresh_test=nms_thresh_test,
            detections_per_image=detections_per_image, use_text_emb=True,
            cls_agnostic_bbox_reg=cls_agnostic_bbox_reg, no_box_delta=no_box_delta,
        )

    def _norm(self, images: torch.Tensor, mean, std, bgr: bool = False) -> torch.Tensor:
        """(B, H, W, 3) RGB 0..255 -> channels flipped to BGR with `bgr`,
        /255 where the means are CLIP's (their sum below 3), normalised, in
        the compute dtype."""
        x = images.float()
        if bgr:
            x = x.flip(-1)
        if float(sum(mean)) < 3.0:
            x = x / 255.0
        m = torch.tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.tensor(std, dtype=torch.float32, device=x.device)
        return ((x - m) / s).to(self.dtype)

    @torch.no_grad()
    def offline_proposals(self, batch: DetBatch, training: bool = False) -> Proposals:
        """The frozen offline RPN's proposals: the training or the test
        top-k, NMS at `offline_rpn_nms_thresh`."""
        x = self._norm(batch.image, self.offline_pixel_mean, self.offline_pixel_std, self.offline_input_bgr)
        rpn = self.offline_proposal_generator
        return rpn._predict_proposals(*rpn._head(self.offline_backbone(x)["res4"]), batch.image_sizes, training)

    def _features(self, batch: DetBatch) -> torch.Tensor:
        return self.backbone(self._norm(batch.image, self.pixel_mean, self.pixel_std))["res4"]

    def supervised_losses(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """{"loss_cls", "loss_box_reg"} of the recognition branch on the
        offline RPN's training proposals. `draw` gives the RoI heads' sites
        ("roi_pos", "roi_neg", "roi_gather"); JAX hands this arch's key to
        the RoI heads whole, without the split `cddmsl_losses` makes."""
        proposals = self.offline_proposals(batch, training=True)
        return self.roi_heads(
            self._features(batch), proposals, batch.image_sizes, self.backbone.res5_forward,
            self.backbone.attnpool_forward, training=True, gt_boxes=batch.gt_boxes, gt_classes=batch.gt_classes,
            gt_valid=batch.gt_valid, draw=draw,
        )

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> DetectionResult:
        """Offline proposals -> CLIP res4 -> RoI heads. The boxes stay in the
        resized frame, as JAX's CLIPFastRCNN leaves them (it has no
        postprocess; `do_postprocess` changes nothing): they are the
        original image's only where orig_sizes equal image_sizes."""
        return self.roi_heads(
            self._features(batch), self.offline_proposals(batch), batch.image_sizes, self.backbone.res5_forward,
            self.backbone.attnpool_forward,
        )


def soft_target_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """mean over rows of sum(-target * log_softmax(logits))."""
    return torch.mean(torch.sum(-soft_targets * F.log_softmax(logits, dim=-1), dim=-1))


def mil_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Multiple-instance cross entropy: the softmax's mass on each row's
    positives, clipped to [1e-6, 1], its negative log, averaged."""
    pos = torch.sum(torch.softmax(logits, dim=-1) * targets, dim=-1)
    return torch.mean(-torch.log(torch.clamp(pos, 1e-6, 1.0)))


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class PretrainFastRCNN(nn.Module):
    def __init__(
        self,
        backbone_layers: Sequence[int] = (3, 4, 6, 3),
        backbone_width: int = 64,
        embed_dim: int = 1024,
        concept_dim: int = 1024,
        num_concepts: int = 1000,
        num_regions: int = 36,
        concept_thresh: float = 0.1,
        distill_temp: float = 0.01,
        text_vocab_size: int = 49408,
        text_context_length: int = 77,
        text_width: int = 512,
        text_heads: int = 8,
        text_layers: int = 12,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_regions = num_regions  # MODEL.CLIP.PRETRAIN_SAMPLE_REGIONS: kept, not read, as in JAX
        self.concept_thresh = concept_thresh
        self.distill_temp = distill_temp
        self.text_context_length = text_context_length

        def clip_resnet():
            return ModifiedResNet(backbone_layers, embed_dim, backbone_width * 32 // 64, backbone_width)

        self.backbone = clip_resnet()
        self.teacher_backbone = clip_resnet()
        self.concept_emb = nn.Parameter(torch.zeros(num_concepts, concept_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.lang_encoder = CLIPTextEncoder(embed_dim, text_context_length, text_vocab_size, text_width, text_heads,
                                            text_layers, dtype=dtype)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, context_length) token ids -> (B, embed_dim) float32."""
        return self.lang_encoder(tokens)

    def _region_embed(self, backbone: ModifiedResNet, images224: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        feats = backbone(images224.to(self.dtype))["res4"]
        return backbone.attnpool_forward(backbone.res5_forward(pool_boxes(feats, boxes)))

    def pretrain_losses_with_text(self, images224: torch.Tensor, region_boxes: torch.Tensor,
                                  text_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, S, S, 3) normalised, boxes (B, R, 4), caption tokens
        (B, context_length): the captions go through the frozen text tower
        first."""
        with torch.no_grad():
            text_embs = self.encode_text(text_tokens)
        return self.pretrain_losses(images224, region_boxes, text_embs)

    def pretrain_losses(self, images224: torch.Tensor, region_boxes: torch.Tensor,
                        text_embs: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, r = region_boxes.shape[:2]
        region_feats = _unit(self._region_embed(self.backbone, images224, region_boxes))  # (B*R, D)
        text = _unit(text_embs)
        img_emb = _unit(region_feats.reshape(b, r, -1).mean(dim=1))
        scale = torch.exp(self.logit_scale)
        logits = scale * img_emb @ text.T
        ce_a = -torch.diagonal(F.log_softmax(logits, dim=1)).mean()
        ce_b = -torch.diagonal(F.log_softmax(logits.T, dim=1)).mean()
        losses = {"img_txt_loss": (ce_a + ce_b) / 2.0}

        region_text_logits = scale * region_feats @ text.T  # (B*R, B)
        bag = torch.eye(b, device=text.device).repeat_interleave(r, dim=0)
        losses["region_txt_mil_loss"] = mil_cross_entropy(region_text_logits, bag)

        temp = torch.full((), self.distill_temp, dtype=torch.float32, device=text.device)
        concepts = _unit(self.concept_emb)
        with torch.no_grad():
            teacher_feats = _unit(self._region_embed(self.teacher_backbone, images224, region_boxes))
            teacher_scores = torch.softmax(teacher_feats @ concepts.T / temp, dim=-1)
        keep = (teacher_scores.max(dim=-1).values > self.concept_thresh).float()
        student_logits = region_feats @ concepts.T / temp
        per_region = torch.sum(-teacher_scores * F.log_softmax(student_logits, dim=-1), dim=-1)
        losses["concept_distill_loss"] = torch.sum(per_region * keep) / torch.clamp(keep.sum(), min=1.0)
        return losses
