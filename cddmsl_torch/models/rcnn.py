"""GeneralizedRCNN with the CDDMSL training branches (counterpart of
cddmsl_tpu/models/rcnn.py `GeneralizedRCNN`: `_normalize`, `inference`,
`extract_res4`, `supervised_losses`, `_v2l_preprocess`,
`caption_consistency`, `_random_region_boxes`, `image_consistency`,
`image_consistency_region`, `caption_pl_prefixes`,
`caption_pl_region_prefixes` and `cddmsl_losses`, and of
`infonce_bidirectional`).

The tower is CLIP's ModifiedResNet or, with `backbone_type` "d2_resnet",
the plain detectron2 ResNet of the R50-C4 baselines; the classifier is the
cosine against text embeddings (`use_text_emb`), whose box head pools res5
with the attention pool, or a linear layer on res5 mean-pooled over the
crop. The region branches keep the attention pool, as JAX's do. The plain
tower has no attention pool, CLIP embedding or offline copy, so its
training build is the detector alone and only the supervised losses run.

`cddmsl_losses` is the training step's loss set: the supervised RPN and RoI
losses on the source view and, past burn-up, the image-level caption
consistency (224^2 bicubic view -> `global_embed` -> frozen ClipCap mapper
-> `v2l` -> projector -> InfoNCE) with the KD L1 against the frozen offline
backbone, and the region-level consistency over random proposals pooled from
both views. The burn-up gate is a host `if`. The modules only those
branches read (the offline backbone, the mapper, the projectors) are built
with `training_modules=True`.

MODEL.CONSISTENCY_BRANCH adds a branch. "image" and "image_region" are the
language-free InfoNCE over `image_projector`: of the two views' CLIP
embeddings, or of region embeddings of the same random proposals pooled from
both views' res4 maps. The training build holds the image projector whatever
the branch, as JAX's parameter tree does, so a save of one branch restores
under any other. "caption_pl_img" and "caption_pl_region" give the prefixes
of the pseudo-label caption step (engine/train_loop.py
`make_caption_pl_step`): the source view's, without a gradient, and the
target view's. The region branches recompute both views'
res4 and the training proposals (no losses), as the JAX package does, and
draw their boxes at sites of their own ("image_region",
"caption_pl_region").
"""

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bicubic
from ..parallel import comm
from ..structures import boxes as box_ops
from .backbone.clip_resnet import ModifiedResNet
from .backbone.resnet import D2ResNet
from .clipcap import Projector, TransformerMapper, v2l
from .fast_rcnn import DetectionResult
from .roi_heads import CLIPRes5ROIHeads
from .rpn import RPN, Proposals
from .sampling import Draw


class DetBatch(NamedTuple):
    """The fields of cddmsl_tpu's DetBatch that the port reads; inference
    needs only the first three."""

    image: torch.Tensor  # (B, H, W, 3) float in [0, 255]
    image_sizes: torch.Tensor  # (B, 2) true (h, w) in the padded canvas
    orig_sizes: torch.Tensor  # (B, 2) original (h, w) for rescaling
    gt_boxes: Optional[torch.Tensor] = None  # (B, G, 4) XYXY in canvas coords
    gt_classes: Optional[torch.Tensor] = None  # (B, G) int
    gt_valid: Optional[torch.Tensor] = None  # (B, G) bool
    image_trgt: Optional[torch.Tensor] = None  # (B, H, W, 3) the translated twin
    # precomputed proposals (MODEL.LOAD_PROPOSALS), top-k by objectness per image
    proposal_boxes: Optional[torch.Tensor] = None  # (B, K, 4) XYXY in canvas coords
    proposal_scores: Optional[torch.Tensor] = None  # (B, K) objectness logits, -inf where padded
    proposal_valid: Optional[torch.Tensor] = None  # (B, K) bool


def normalize(images: torch.Tensor, pixel_mean, pixel_std, dtype, unit_range: bool = True) -> torch.Tensor:
    """(x - mean) / std in float32, then `dtype`; with `unit_range` and
    CLIP's statistics (their sum below 3) x is first divided by 255."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=images.device)
    x = images.float()
    if unit_range and float(sum(pixel_mean)) < 3.0:
        x = x / 255.0
    return ((x - mean) / std).to(dtype)


def rescale_detections(detections: DetectionResult, batch: DetBatch) -> DetectionResult:
    """detector_postprocess: the boxes scaled from the resized frame to
    orig_sizes and clipped to it."""
    orig = batch.orig_sizes.to(detections.boxes.device)
    sizes = batch.image_sizes.to(detections.boxes.device)
    scale = (orig / torch.clamp(sizes, min=1)).float()
    sxy = torch.stack([scale[:, 1], scale[:, 0], scale[:, 1], scale[:, 0]], dim=-1)
    boxes = box_ops.clip(detections.boxes * sxy[:, None, :], (orig[:, 0, None], orig[:, 1, None]))
    return detections._replace(boxes=boxes)


def infonce_bidirectional(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L2-normalize, cosine logits without a temperature, cross-entropy both
    ways, averaged; in float32. Under a process group over every rank's
    rows, in rank order (`comm.all_gather_with_grad`): each rank computes the
    global batch's loss, as JAX's one program over the mesh does."""
    a = comm.all_gather_with_grad(a.float())
    b = comm.all_gather_with_grad(b.float())
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-12)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-12)
    logits = a @ b.T
    ce_ab = -torch.diagonal(F.log_softmax(logits, dim=1)).mean()
    ce_ba = -torch.diagonal(F.log_softmax(logits.T, dim=1)).mean()
    return (ce_ab + ce_ba) / 2.0


class GeneralizedRCNN(nn.Module):
    def __init__(
        self,
        backbone_type: str = "clip",
        backbone_depth: int = 50,
        backbone_layers: Sequence[int] = (3, 4, 6, 3),
        backbone_width: int = 64,
        embed_dim: int = 1024,
        input_resolution: int = 224,
        anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
        anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        rpn_batch_size_per_image: int = 256,
        rpn_positive_fraction: float = 0.5,
        rpn_pre_nms_topk_train: int = 12000,
        rpn_pre_nms_topk_test: int = 6000,
        rpn_post_nms_topk_train: int = 2000,
        rpn_post_nms_topk_test: int = 1000,
        rpn_nms_thresh: float = 0.7,
        rpn_loss_weight: float = 1.0,
        num_classes: int = 20,
        roi_batch_size_per_image: int = 512,
        roi_positive_fraction: float = 0.25,
        pooler_resolution: int = 14,
        pooler_sampling_ratio: int = 0,
        temperature: float = 0.01,
        focal_gamma: Optional[float] = None,
        bg_loss_weight: Optional[float] = None,
        use_text_emb: bool = True,
        cls_agnostic_bbox_reg: bool = False,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        soft_nms: Optional[Tuple[str, float, float]] = None,
        no_box_delta: bool = False,
        multiply_rpn_score: bool = False,
        pixel_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
        pixel_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
        region_consistency_boxes: int = 16,
        v2l_image_size: int = 224,
        v2l_mapper_layers: int = 8,
        v2l_mapper_tokens: int = 40,
        dtype: torch.dtype = torch.float32,
        training_modules: bool = False,
    ):
        super().__init__()
        if backbone_type not in ("clip", "d2_resnet"):
            raise ValueError(f"backbone_type {backbone_type!r}: 'clip' or 'd2_resnet'")
        self.dtype = dtype
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.region_consistency_boxes = region_consistency_boxes
        self.v2l_image_size = v2l_image_size
        self.use_text_emb = use_text_emb

        def clip_resnet():
            return ModifiedResNet(
                layers=backbone_layers,
                output_dim=embed_dim,
                heads=backbone_width * 32 // 64,
                width=backbone_width,
                input_resolution=input_resolution,
            )

        self.backbone = clip_resnet() if backbone_type == "clip" else D2ResNet(backbone_depth)
        self.proposal_generator = RPN(
            in_channels=backbone_width * 16,
            stride=16,
            anchor_sizes=anchor_sizes,
            anchor_aspect_ratios=anchor_aspect_ratios,
            batch_size_per_image=rpn_batch_size_per_image,
            positive_fraction=rpn_positive_fraction,
            pre_nms_topk_train=rpn_pre_nms_topk_train,
            pre_nms_topk_test=rpn_pre_nms_topk_test,
            post_nms_topk_train=rpn_post_nms_topk_train,
            post_nms_topk_test=rpn_post_nms_topk_test,
            nms_thresh=rpn_nms_thresh,
            loss_weight=rpn_loss_weight,
        )
        self.roi_heads = CLIPRes5ROIHeads(
            num_classes=num_classes,
            batch_size_per_image=roi_batch_size_per_image,
            positive_fraction=roi_positive_fraction,
            emb_dim=embed_dim if use_text_emb else backbone_width * 32,  # the linear head reads res5
            temperature=temperature,
            pooler_resolution=pooler_resolution,
            pooler_sampling_ratio=pooler_sampling_ratio,
            focal_gamma=focal_gamma,
            bg_loss_weight=bg_loss_weight,
            score_thresh_test=score_thresh_test,
            nms_thresh_test=nms_thresh_test,
            detections_per_image=detections_per_image,
            use_text_emb=use_text_emb,
            cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
            soft_nms=soft_nms,
            no_box_delta=no_box_delta,
            multiply_rpn_score=multiply_rpn_score,
        )
        if training_modules and backbone_type == "clip":
            # frozen second copy: the KD teacher of the caption branch
            self.offline_backbone = clip_resnet().requires_grad_(False)
            # frozen ClipCap mapper: its parameters do not train, but
            # gradients flow through it into the student backbone
            self.v2l_mapper = TransformerMapper(
                dim_clip=embed_dim,
                prefix_length=v2l_mapper_tokens,
                clip_length=v2l_mapper_tokens,
                num_layers=v2l_mapper_layers,
            ).requires_grad_(False)
            self.projector = Projector(in_dim=768)
            self.image_projector = Projector(in_dim=embed_dim)

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        return normalize(images, self.pixel_mean, self.pixel_std, self.dtype)

    def _v2l_preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """/255, bicubic short-side resize of the padded canvas to
        v2l_image_size, center crop, CLIP normalization."""
        b, h, w, _ = images.shape
        size = self.v2l_image_size
        scale = size / min(h, w)
        nh, nw = (size, max(size, int(round(w * scale)))) if h <= w else (max(size, int(round(h * scale))), size)
        x = resize_bicubic(images.float() / 255.0, (nh, nw))
        top, left = (nh - size) // 2, (nw - size) // 2
        x = x[:, top : top + size, left : left + size]
        mean = torch.tensor(self.pixel_mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(self.pixel_std, dtype=torch.float32, device=images.device)
        return ((x - mean) / std).to(self.dtype)

    def _res4(self, x: torch.Tensor) -> torch.Tensor:
        # res5 runs on the crops alone: XLA drops JAX's unread full-image res5 too
        return self.backbone(x)["res4"]

    @property
    def _box_pool(self) -> Optional[Callable]:
        """The box head's pool over res5: the attention pool with the text
        classifier, none (the mean) with the linear one."""
        return self.backbone.attnpool_forward if self.use_text_emb else None

    @torch.no_grad()
    def proposals(self, batch: DetBatch):
        """Backbone and RPN: (res4 (B, H/16, W/16, C) NHWC, Proposals)."""
        features = self.extract_res4(batch.image)
        return features, self.proposal_generator(features, batch.image_sizes)[0]

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> DetectionResult:
        """normalize -> res4 -> RPN -> RoI heads -> with `do_postprocess`
        rescale to orig_sizes; without it the boxes stay in the padded
        input frame."""
        features, proposals = self.proposals(batch)
        detections = self.roi_heads(
            features, proposals, batch.image_sizes, res5_fn=self.backbone.res5_forward, attnpool_fn=self._box_pool,
        )
        return rescale_detections(detections, batch) if do_postprocess else detections

    def extract_res4(self, images: torch.Tensor) -> torch.Tensor:
        """Raw images (B, H, W, 3) -> the res4 map (B, H/16, W/16, C)."""
        return self._res4(self._normalize(images))

    # ---------------- training ----------------
    def _student_v2l(self, images224: torch.Tensor) -> torch.Tensor:
        return v2l(self.v2l_mapper(self.backbone.global_embed(images224)))

    def caption_consistency(self, batch: DetBatch, kd_regularization: bool = True) -> Dict[str, torch.Tensor]:
        """Image-level caption-consistency InfoNCE, and with
        `kd_regularization` the KD L1 between the student's and the frozen
        offline backbone's source features."""
        src = self._v2l_preprocess(batch.image)
        trgt = self._v2l_preprocess(batch.image_trgt)
        feats_trgt = self._student_v2l(trgt)
        feats_src = self._student_v2l(src)
        losses = {}
        if kd_regularization:
            with torch.no_grad():
                teacher = v2l(self.v2l_mapper(self.offline_backbone.global_embed(src)))
            # a mean over the same count on every rank: the ranks' mean is the global one
            losses["kd_loss"] = torch.mean(torch.abs(teacher.float() - feats_src.float()))
        losses["cont_loss"] = infonce_bidirectional(self.projector(feats_trgt), self.projector(feats_src))
        return losses

    def _random_region_boxes(self, proposals: Proposals, draw: Draw, site: str = "region") -> torch.Tensor:
        """region_consistency_boxes random valid proposals per image: the
        largest uniforms among the valid rows (draw `site`, (B, K)), ties to
        the lower index -> (B, n, 4)."""
        b, k, _ = proposals.boxes.shape
        u = draw(site, (b, k))
        scores = torch.where(proposals.valid, u, torch.full_like(u, float("-inf")))
        idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, : self.region_consistency_boxes]
        return torch.gather(proposals.boxes, 1, idx[..., None].expand(-1, -1, 4))

    def _branch_region_boxes(self, f_src: torch.Tensor, batch: DetBatch, draw: Draw, site: str) -> torch.Tensor:
        """Random proposals of a region branch: the training RPN's proposals
        on the source map, without losses or gradient."""
        rpn = self.proposal_generator
        with torch.no_grad():
            proposals = rpn._predict_proposals(*rpn._head(f_src), batch.image_sizes, True)
        return self._random_region_boxes(proposals, draw, site)

    def image_consistency(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        """InfoNCE of the two views' CLIP embeddings through the image projector."""
        src = self._v2l_preprocess(batch.image)
        trgt = self._v2l_preprocess(batch.image_trgt)
        p_trgt = self.image_projector(self.backbone.global_embed(trgt))
        p_src = self.image_projector(self.backbone.global_embed(src))
        return {"cont_loss": infonce_bidirectional(p_trgt, p_src)}

    def image_consistency_region(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """InfoNCE of region embeddings of the same random proposals (site
        "image_region") pooled from both views' res4 maps, through the image
        projector."""
        f_src = self._res4(self._normalize(batch.image))
        f_trgt = self._res4(self._normalize(batch.image_trgt))
        boxes = self._branch_region_boxes(f_src, batch, draw, "image_region")
        r_src, r_trgt = self.roi_heads.forward_get_features(
            f_src, f_trgt, boxes, self.backbone.res5_forward, self.backbone.attnpool_forward)
        return {"cont_loss": infonce_bidirectional(self.image_projector(r_src), self.image_projector(r_trgt))}

    def caption_pl_prefixes(self, batch: DetBatch):
        """(source prefix without a gradient, target prefix): the two views'
        CLIP embeddings (B, embed_dim)."""
        with torch.no_grad():
            p_src = self.backbone.global_embed(self._v2l_preprocess(batch.image))
        return p_src, self.backbone.global_embed(self._v2l_preprocess(batch.image_trgt))

    def caption_pl_region_prefixes(self, batch: DetBatch, draw: Draw):
        """(source prefixes without a gradient, target prefixes): region
        embeddings (B * region_consistency_boxes, embed_dim) of the same
        random proposals (site "caption_pl_region") from both views."""
        backbone, rh = self.backbone, self.roi_heads
        with torch.no_grad():
            f_src = self._res4(self._normalize(batch.image))
        f_trgt = self._res4(self._normalize(batch.image_trgt))
        boxes = self._branch_region_boxes(f_src, batch, draw, "caption_pl_region")
        with torch.no_grad():
            r_src = rh._region_embed(f_src, boxes, backbone.res5_forward, backbone.attnpool_forward)
        return r_src, rh._region_embed(f_trgt, boxes, backbone.res5_forward, backbone.attnpool_forward)

    def supervised(self, batch: DetBatch, draw: Draw):
        """The supervised RPN and RoI losses on the source view, with the
        res4 map and the training proposals they came from: (losses, res4,
        Proposals)."""
        f_src = self.extract_res4(batch.image)
        proposals, rpn_losses = self.proposal_generator(
            f_src, batch.image_sizes, training=True, gt_boxes=batch.gt_boxes, gt_valid=batch.gt_valid, draw=draw
        )
        det_losses = self.roi_heads(
            f_src, proposals, batch.image_sizes, self.backbone.res5_forward, self._box_pool, training=True,
            gt_boxes=batch.gt_boxes, gt_classes=batch.gt_classes, gt_valid=batch.gt_valid, draw=draw,
        )
        return {**det_losses, **rpn_losses}, f_src, proposals

    def supervised_losses(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """The supervised RPN and RoI losses on the source view."""
        return self.supervised(batch, draw)[0]

    def cddmsl_losses(
        self, batch: DetBatch, draw: Draw, caption_on: bool, kd_regularization: bool = True,
        enable_caption: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """The CDDMSL loss set of one step (bench.py runs it with both
        switches on). The source view's res4 map is shared by the supervised
        branch and the region-level branch. Without `enable_caption` only the
        supervised losses are returned; otherwise the caption branches run
        when `caption_on` (past burn-up) and give zeros before, and
        `kd_loss` is present only with `kd_regularization`, as in JAX."""
        losses, f_src, proposals = self.supervised(batch, draw)
        if not enable_caption:
            return losses
        if not caption_on:
            zero = torch.zeros((), dtype=torch.float32, device=f_src.device)
            off = {"cont_loss": zero, "kd_loss": zero} if kd_regularization else {"cont_loss": zero}
            return {**losses, **off, "cont_loss_region": zero}
        cc = self.caption_consistency(batch, kd_regularization)
        f_trgt = self._res4(self._normalize(batch.image_trgt))
        boxes = self._random_region_boxes(proposals, draw)
        r_src, r_trgt = self.roi_heads.forward_get_features(
            f_src, f_trgt, boxes, self.backbone.res5_forward, self.backbone.attnpool_forward)
        p_src = self.projector(v2l(self.v2l_mapper(r_src)))
        p_trgt = self.projector(v2l(self.v2l_mapper(r_trgt)))
        losses["cont_loss"] = cc["cont_loss"]
        if kd_regularization:
            losses["kd_loss"] = cc["kd_loss"]
        losses["cont_loss_region"] = infonce_bidirectional(p_src, p_trgt)
        return losses
