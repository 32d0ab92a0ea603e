"""RegionCLIP's region-language pretraining model (counterpart of
cddmsl_tpu/models/clip_rcnn.py: `soft_target_cross_entropy`,
`mil_cross_entropy` and `PretrainFastRCNN`).

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
`stop_gradient` has them. `CLIPFastRCNN` is not ported.
"""

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .backbone.clip_resnet import ModifiedResNet
from .backbone.text_encoder import CLIPTextEncoder
from .roi_heads import pool_boxes


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
