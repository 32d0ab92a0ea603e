"""Config -> model (counterpart of cddmsl_tpu/models/build.py `build_model`
with `build_generalized_rcnn`, `build_fpn_rcnn`, `build_cascade_rcnn`,
`build_proposal_network`, `build_panoptic_fpn` and
`build_semantic_segmentor`, `build_retinanet`, and of `build_clip_fast_rcnn` and
`build_pretrain_fast_rcnn`).

`build_detector` dispatches as JAX's `build_model` does
(`config.model_family`): the C4 GeneralizedRCNN, FPNRCNN when
MODEL.BACKBONE.NAME names an fpn_backbone (with the cascade heads at
ROI_HEADS.NAME CascadeROIHeads) or, with RESNETS.RES5_DILATION 2, in its
single-level DC5 form, CascadeRCNN on res4 (ROI_HEADS.NAME
CascadeROIHeads without an fpn_backbone, or META_ARCHITECTURE
CascadeRCNN), ProposalNetwork (META_ARCHITECTURE) on res4 or on the
FPN, PanopticFPN and SemanticSegmentor (META_ARCHITECTURE; JAX's
`build_panoptic_fpn` and `build_semantic_segmentor`), RetinaNet
(META_ARCHITECTURE; `build_retinanet`) and RotatedFastRCNN
(META_ARCHITECTURE; `build_rotated_fast_rcnn`, which `check_supported`
does not pass: JAX's trainer cannot build it)."""

from typing import Any, Dict

import torch

from ..config import (
    D2_RESNET_SPECS, EMBED_DIMS, RESNET_SPECS, ModelConfig, check_clip_fast_rcnn_supported, check_pretrain_supported, check_supported,
    keypoint_loss_normalizer, model_config_from_cfg, model_family,
)
from ..device import compute_dtype, resolve_device
from .cascade_rcnn import CascadeRCNN
from .clip_rcnn import CLIPFastRCNN, PretrainFastRCNN
from .extra_meta_archs import FPNProposalNetwork, ProposalNetwork
from .fpn_rcnn import FPNRCNN
from .panoptic_fpn import PanopticFPN
from .rcnn import GeneralizedRCNN
from .retinanet import RetinaNet
from .rotated_rcnn import RotatedFastRCNN
from .semantic_seg import SemanticSegmentor


def build_model(config: ModelConfig, device="cuda", training: bool = False) -> GeneralizedRCNN:
    """Builds the detector on `device` (CUDA unless the caller asks for the
    CPU) in eval mode; `training=True` adds, on the CLIP tower, the modules
    that only the CDDMSL losses read (offline backbone, ClipCap mapper,
    projector and image projector). Its weights are the modules' defaults: load a state dict
    (checkpoint/convert_jax.py) or call `init_random_` next."""
    device = resolve_device(device)
    soft_nms = (config.soft_nms_method, config.soft_nms_sigma, config.soft_nms_prune)
    model = GeneralizedRCNN(
        backbone_type=config.backbone_type,
        backbone_depth=config.backbone_depth,
        backbone_layers=tuple(config.backbone_layers),
        backbone_width=config.backbone_width,
        embed_dim=config.embed_dim,
        input_resolution=config.input_resolution,
        anchor_sizes=tuple(config.anchor_sizes),
        anchor_aspect_ratios=tuple(config.anchor_aspect_ratios),
        rpn_batch_size_per_image=config.rpn_batch_size_per_image,
        rpn_positive_fraction=config.rpn_positive_fraction,
        rpn_pre_nms_topk_train=config.rpn_pre_nms_topk_train,
        rpn_pre_nms_topk_test=config.rpn_pre_nms_topk_test,
        rpn_post_nms_topk_train=config.rpn_post_nms_topk_train,
        rpn_post_nms_topk_test=config.rpn_post_nms_topk_test,
        rpn_nms_thresh=config.rpn_nms_thresh,
        rpn_loss_weight=config.rpn_loss_weight,
        num_classes=config.num_classes,
        roi_batch_size_per_image=config.roi_batch_size_per_image,
        roi_positive_fraction=config.roi_positive_fraction,
        pooler_resolution=config.pooler_resolution,
        pooler_sampling_ratio=config.pooler_sampling_ratio,
        temperature=config.temperature,
        focal_gamma=config.focal_gamma,
        bg_loss_weight=config.bg_loss_weight,
        use_text_emb=config.use_text_emb,
        cls_agnostic_bbox_reg=config.cls_agnostic_bbox_reg,
        score_thresh_test=config.score_thresh_test,
        nms_thresh_test=config.nms_thresh_test,
        detections_per_image=config.detections_per_image,
        soft_nms=soft_nms if config.soft_nms_enabled else None,
        no_box_delta=config.no_box_delta,
        multiply_rpn_score=config.multiply_rpn_score,
        pixel_mean=tuple(config.pixel_mean),
        pixel_std=tuple(config.pixel_std),
        region_consistency_boxes=config.region_consistency_boxes,
        v2l_image_size=config.v2l_image_size,
        v2l_mapper_layers=config.v2l_mapper_layers,
        v2l_mapper_tokens=config.v2l_mapper_tokens,
        dtype=compute_dtype(config.compute_dtype),
        training_modules=training,
        mask_head=dict(num_conv=config.mask_num_conv, conv_dim=config.mask_conv_dim,
                       cls_agnostic=config.mask_cls_agnostic, canvas_stride=config.mask_canvas_stride)
        if config.mask_on else None,
        keypoint_head=dict(num_keypoints=config.num_keypoints, conv_dims=tuple(config.keypoint_conv_dims),
                           loss_weight=config.keypoint_loss_weight, loss_normalizer=config.keypoint_loss_normalizer)
        if config.keypoint_on else None,
    )
    return model.to(device).eval()


def build_pretrain_fast_rcnn(cfg, device="cuda") -> PretrainFastRCNN:
    """The pretraining model from the yacs tree, as the JAX build reads it:
    the CLIP ResNet of MODEL.RESNETS.DEPTH (TPU.BACKBONE_LAYERS,
    BACKBONE_WIDTH and EMBED_DIM override it) for the student and the
    teacher, MODEL.CLIP.PRETRAIN_NUM_CONCEPTS concepts of the embedding
    width, CONCEPT_THRES (0.1 when unset), the caption tower of
    MODEL.CLIP.TEXT_* (not MODEL.TEXT_ENCODER), TPU.COMPUTE_DTYPE; after
    `check_pretrain_supported`. Its weights are the modules' defaults: call
    `init_random_` or load a state dict next."""
    check_pretrain_supported(cfg)
    device = resolve_device(device)
    depth = cfg.MODEL.RESNETS.DEPTH
    layers, width = RESNET_SPECS[depth]
    embed_dim = cfg.TPU.EMBED_DIM or EMBED_DIMS[depth]
    clip = cfg.MODEL.CLIP
    model = PretrainFastRCNN(
        backbone_layers=tuple(cfg.TPU.BACKBONE_LAYERS) or layers,
        backbone_width=cfg.TPU.BACKBONE_WIDTH or width,
        embed_dim=embed_dim,
        concept_dim=embed_dim,
        num_concepts=clip.PRETRAIN_NUM_CONCEPTS,
        num_regions=clip.PRETRAIN_SAMPLE_REGIONS or 36,
        concept_thresh=clip.CONCEPT_THRES or 0.1,
        text_vocab_size=clip.TEXT_VOCAB_SIZE,
        text_context_length=clip.TEXT_CONTEXT_LENGTH,
        text_width=clip.TEXT_WIDTH,
        text_heads=clip.TEXT_HEADS,
        text_layers=clip.TEXT_LAYERS,
        dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE),
    )
    return model.to(device).eval()


def clip_fast_rcnn_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_clip_fast_rcnn` gives `CLIPFastRCNN`, from
    the yacs tree, after `check_clip_fast_rcnn_supported`: the CLIP tower of
    MODEL.RESNETS.DEPTH (TPU.BACKBONE_* are not read; the offline tower is
    always a ResNet-50), the classes, the offline RPN's NMS, the classifier's
    temperature, focal and background weights, the box options, the test
    thresholds, the pixel statistics and the compute dtype."""
    check_clip_fast_rcnn_supported(cfg)
    m = cfg.MODEL
    layers, width = RESNET_SPECS[m.RESNETS.DEPTH]
    return dict(
        backbone_layers=tuple(layers),
        backbone_width=width,
        embed_dim=EMBED_DIMS[m.RESNETS.DEPTH],
        num_classes=m.ROI_HEADS.NUM_CLASSES,
        offline_rpn_nms_thresh=m.CLIP.OFFLINE_RPN_NMS_THRESH,
        temperature=m.CLIP.CLSS_TEMP,
        focal_gamma=m.CLIP.FOCAL_SCALED_LOSS,
        bg_loss_weight=m.CLIP.BG_CLS_LOSS_WEIGHT,
        no_box_delta=m.CLIP.NO_BOX_DELTA,
        cls_agnostic_bbox_reg=m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
        score_thresh_test=m.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=m.ROI_HEADS.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE),
    )


def build_clip_fast_rcnn(cfg, device="cuda") -> CLIPFastRCNN:
    """The open-vocabulary detector (MODEL.META_ARCHITECTURE CLIPFastRCNN)
    from the yacs tree, as JAX's builder reads it (`clip_fast_rcnn_fields`),
    on `device` (CUDA unless the caller asks for the CPU) in eval mode. Its
    weights are the modules' defaults: call `init_random_`, or load
    MODEL.CLIP.BB_RPN_WEIGHTS (`load_bb_rpn_weights`), MODEL.WEIGHTS and
    MODEL.CLIP.TEXT_EMB_PATH next."""
    device = resolve_device(device)
    return CLIPFastRCNN(**clip_fast_rcnn_fields(cfg)).to(device).eval()


def rotated_fast_rcnn_fields(cfg) -> Dict[str, Any]:
    """What JAX's `build_rotated_fast_rcnn` reads: ROI_HEADS.NUM_CLASSES,
    RESNETS.DEPTH, PIXEL_MEAN / PIXEL_STD and TPU.COMPUTE_DTYPE (every other
    key is left to the module's defaults, as in JAX)."""
    m = cfg.MODEL
    if m.META_ARCHITECTURE != "RotatedFastRCNN":
        raise ValueError(f"MODEL.META_ARCHITECTURE = {m.META_ARCHITECTURE!r}: this builder takes RotatedFastRCNN")
    if m.RESNETS.DEPTH not in D2_RESNET_SPECS:
        raise NotImplementedError(f"MODEL.RESNETS.DEPTH = {m.RESNETS.DEPTH!r} is not ported for RotatedFastRCNN")
    return dict(num_classes=m.ROI_HEADS.NUM_CLASSES, depth=m.RESNETS.DEPTH, pixel_mean=tuple(m.PIXEL_MEAN),
                pixel_std=tuple(m.PIXEL_STD), dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE))


def build_rotated_fast_rcnn(cfg, device="cuda") -> RotatedFastRCNN:
    """The rotated Faster R-CNN (MODEL.META_ARCHITECTURE RotatedFastRCNN)
    from the tree (`rotated_fast_rcnn_fields`) on `device` (CUDA unless the
    caller asks for the CPU) in eval mode, with the modules' default
    weights (`init_random_` or a converted JAX tree next)."""
    return RotatedFastRCNN(**rotated_fast_rcnn_fields(cfg)).to(resolve_device(device)).eval()


def fpn_anchor_sizes(cfg) -> tuple:
    """ANCHOR_GENERATOR.SIZES as JAX's `build_fpn_rcnn` spreads them over the
    five levels: with five groups each group's first size; otherwise the
    first five sizes of the flattened list, or with fewer the first one
    doubled per level."""
    groups = list(cfg.MODEL.ANCHOR_GENERATOR.SIZES)
    if len(groups) == 5:
        return tuple(g[0] if isinstance(g, (list, tuple)) else g for g in groups)
    flat = [s for g in groups for s in (g if isinstance(g, (list, tuple)) else [g])]
    return tuple(flat[:5]) if len(flat) >= 5 else tuple(flat[0] * 2 ** i for i in range(5))


def fpn_rcnn_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_fpn_rcnn` gives `FPNRCNN`, from the yacs tree,
    after `check_supported`: the per-level anchor sizes, the RPN's keys
    (smooth-L1 beta and loss weight too), the heads' (FC_DIM, the box
    loss's beta and weight, class-agnostic boxes, the classifier), the
    tower's (DEPTH, NUM_GROUPS, WIDTH_PER_GROUP or TPU.BACKBONE_WIDTH,
    STRIDE_IN_1X1), DC5 at RES5_DILATION 2, precomputed proposals at
    PROPOSAL_GENERATOR.NAME PrecomputedProposals, both box losses' types,
    the mask head's (MASK_ON, ROI_MASK_HEAD.{NUM_CONV, CONV_DIM,
    CLS_AGNOSTIC_MASK}, TPU.MASK_CANVAS_STRIDE), the keypoint head's
    (KEYPOINT_ON, ROI_KEYPOINT_HEAD.{NUM_KEYPOINTS, CONV_DIMS, LOSS_WEIGHT},
    the normaliser), the cascade (ROI_HEADS.NAME CascadeROIHeads), the CLIP
    bottom-up (BACKBONE.NAME build_clip_resnet_fpn_backbone), the norms
    (RESNETS.NORM, FPN.NORM, ROI_BOX_HEAD.NORM, ROI_MASK_HEAD.NORM), the
    conv box head (ROI_BOX_HEAD.NUM_CONV, CONV_DIM, NUM_FC or 2), the
    deformable stages (RESNETS.DEFORM_ON_PER_STAGE, DEFORM_MODULATED) and
    the compute dtype."""
    check_supported(cfg)
    m = cfg.MODEL
    return dict(
        num_classes=m.ROI_HEADS.NUM_CLASSES,
        depth=m.RESNETS.DEPTH,
        anchor_sizes=fpn_anchor_sizes(cfg),
        anchor_aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        rpn_batch_size_per_image=m.RPN.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=m.RPN.POSITIVE_FRACTION,
        rpn_pre_nms_topk=(m.RPN.PRE_NMS_TOPK_TRAIN, m.RPN.PRE_NMS_TOPK_TEST),
        rpn_post_nms_topk=(m.RPN.POST_NMS_TOPK_TRAIN, m.RPN.POST_NMS_TOPK_TEST),
        rpn_nms_thresh=m.RPN.NMS_THRESH,
        rpn_loss_weight=m.RPN.LOSS_WEIGHT,
        rpn_smooth_l1_beta=m.RPN.SMOOTH_L1_BETA,
        rpn_box_reg_loss_weight=m.RPN.BBOX_REG_LOSS_WEIGHT,
        roi_smooth_l1_beta=m.ROI_BOX_HEAD.SMOOTH_L1_BETA,
        roi_batch_size_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
        fc_dim=m.ROI_BOX_HEAD.FC_DIM,
        score_thresh_test=m.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=m.ROI_HEADS.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        use_text_emb=m.CLIP.USE_TEXT_EMB_CLASSIFIER,
        temperature=m.CLIP.CLSS_TEMP,
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        backbone_width=cfg.TPU.BACKBONE_WIDTH or m.RESNETS.WIDTH_PER_GROUP,
        num_groups=m.RESNETS.NUM_GROUPS,
        stride_in_1x1=m.RESNETS.STRIDE_IN_1X1,
        box_reg_loss_weight=m.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT,
        box_reg_loss_type=m.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE,
        rpn_box_reg_loss_type=m.RPN.BBOX_REG_LOSS_TYPE,
        cls_agnostic_bbox_reg=m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
        mask_on=m.MASK_ON,
        mask_num_conv=m.ROI_MASK_HEAD.NUM_CONV,
        mask_conv_dim=m.ROI_MASK_HEAD.CONV_DIM,
        mask_cls_agnostic=m.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK,
        mask_canvas_stride=float(cfg.TPU.MASK_CANVAS_STRIDE),
        keypoint_on=m.KEYPOINT_ON,
        num_keypoints=m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS,
        keypoint_conv_dims=tuple(m.ROI_KEYPOINT_HEAD.CONV_DIMS),
        keypoint_loss_weight=m.ROI_KEYPOINT_HEAD.LOSS_WEIGHT,
        keypoint_loss_normalizer=keypoint_loss_normalizer(cfg),
        cascade=m.ROI_HEADS.NAME == "CascadeROIHeads",
        backbone_type="clip" if "clip" in m.BACKBONE.NAME else "d2_resnet",
        backbone_norm=m.RESNETS.NORM,
        fpn_norm=m.FPN.NORM,
        box_num_conv=m.ROI_BOX_HEAD.NUM_CONV,
        box_conv_dim=m.ROI_BOX_HEAD.CONV_DIM,
        box_num_fc=m.ROI_BOX_HEAD.NUM_FC or 2,
        box_conv_norm=m.ROI_BOX_HEAD.NORM,
        mask_conv_norm=m.ROI_MASK_HEAD.NORM,
        deform_on_per_stage=tuple(m.RESNETS.DEFORM_ON_PER_STAGE),
        deform_modulated=m.RESNETS.DEFORM_MODULATED,
        dc5=m.RESNETS.RES5_DILATION == 2,
        load_proposals=m.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals",
        dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE),
    )


def proposal_network_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_proposal_network` gives `FPNProposalNetwork`
    (DEPTH, five groups of anchor sizes or 32..512, the RPN's pre- and
    post-NMS top-k, the pixel statistics, TPU.BACKBONE_WIDTH) or
    `ProposalNetwork` (DEPTH and the pixel statistics), after
    `check_supported`."""
    check_supported(cfg)
    m = cfg.MODEL
    fields = dict(depth=m.RESNETS.DEPTH, pixel_mean=tuple(m.PIXEL_MEAN), pixel_std=tuple(m.PIXEL_STD),
                  dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE))
    if model_family(cfg) == "proposal_fpn":
        groups = list(m.ANCHOR_GENERATOR.SIZES)
        fields.update(
            anchor_sizes=tuple(g[0] if isinstance(g, (list, tuple)) else g for g in groups) if len(groups) == 5
            else (32, 64, 128, 256, 512),
            pre_nms_topk=(m.RPN.PRE_NMS_TOPK_TRAIN, m.RPN.PRE_NMS_TOPK_TEST),
            post_nms_topk=(m.RPN.POST_NMS_TOPK_TRAIN, m.RPN.POST_NMS_TOPK_TEST),
            backbone_width=cfg.TPU.BACKBONE_WIDTH or 64,
        )
    return fields


def cascade_rcnn_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_cascade_rcnn` gives `CascadeRCNN` (DEPTH,
    NUM_CLASSES, ROI_BOX_CASCADE_HEAD.IOUS, the pixel statistics, the
    compute dtype), after `check_supported`."""
    check_supported(cfg)
    m = cfg.MODEL
    return dict(num_classes=m.ROI_HEADS.NUM_CLASSES, depth=m.RESNETS.DEPTH,
                stage_ious=tuple(m.ROI_BOX_CASCADE_HEAD.IOUS), pixel_mean=tuple(m.PIXEL_MEAN),
                pixel_std=tuple(m.PIXEL_STD), dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE))


def panoptic_fpn_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_panoptic_fpn` gives `PanopticFPN` (the thing
    and stuff classes, DEPTH, the two loss weights, the head's NORM,
    RESNETS.NORM, FPN.NORM, STRIDE_IN_1X1, the deformable stages, the
    cascade at ROI_HEADS.NAME CascadeROIHeads, TPU.BACKBONE_WIDTH, the mask
    head's, the pixel statistics, the compute dtype), after
    `check_supported`."""
    check_supported(cfg)
    m = cfg.MODEL
    return dict(
        num_classes=m.ROI_HEADS.NUM_CLASSES,
        sem_seg_classes=m.SEM_SEG_HEAD.NUM_CLASSES,
        depth=m.RESNETS.DEPTH,
        instance_loss_weight=m.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT,
        sem_seg_loss_weight=m.SEM_SEG_HEAD.LOSS_WEIGHT,
        sem_seg_norm=m.SEM_SEG_HEAD.NORM,
        backbone_norm=m.RESNETS.NORM,
        fpn_norm=m.FPN.NORM,
        stride_in_1x1=m.RESNETS.STRIDE_IN_1X1,
        deform_on_per_stage=tuple(m.RESNETS.DEFORM_ON_PER_STAGE),
        deform_modulated=m.RESNETS.DEFORM_MODULATED,
        cascade=m.ROI_HEADS.NAME == "CascadeROIHeads",
        backbone_width=cfg.TPU.BACKBONE_WIDTH or 64,
        mask_on=m.MASK_ON,
        mask_num_conv=m.ROI_MASK_HEAD.NUM_CONV,
        mask_conv_dim=m.ROI_MASK_HEAD.CONV_DIM,
        mask_canvas_stride=float(cfg.TPU.MASK_CANVAS_STRIDE),
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE),
    )


def semantic_segmentor_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_semantic_segmentor` gives
    `SemanticSegmentor` (the classes, DEPTH, IGNORE_VALUE, IN_FEATURES, the
    head's NORM, the pixel statistics, the compute dtype), after
    `check_supported`."""
    check_supported(cfg)
    m = cfg.MODEL
    return dict(num_classes=m.SEM_SEG_HEAD.NUM_CLASSES, depth=m.RESNETS.DEPTH,
                ignore_value=m.SEM_SEG_HEAD.IGNORE_VALUE, in_features=tuple(m.SEM_SEG_HEAD.IN_FEATURES),
                head_norm=m.SEM_SEG_HEAD.NORM, pixel_mean=tuple(m.PIXEL_MEAN), pixel_std=tuple(m.PIXEL_STD),
                dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE))


def retinanet_fields(cfg) -> Dict[str, Any]:
    """The fields JAX's `build_retinanet` gives `RetinaNet`, after
    `check_supported`: RETINANET.NUM_CLASSES, DEPTH, the anchor size groups
    (one group broadcast over the five levels), the first aspect ratios,
    the matcher's thresholds and labels, the focal loss's alpha and gamma,
    the smooth-L1 beta, the box loss's type, the test's threshold, NMS and
    top-k, TEST.DETECTIONS_PER_IMAGE, the pixel statistics and the compute
    dtype."""
    check_supported(cfg)
    m, r = cfg.MODEL, cfg.MODEL.RETINANET
    sizes = tuple(tuple(float(x) for x in (g if isinstance(g, (list, tuple)) else [g])) for g in m.ANCHOR_GENERATOR.SIZES)
    return dict(
        num_classes=r.NUM_CLASSES,
        depth=m.RESNETS.DEPTH,
        anchor_sizes=sizes * 5 if len(sizes) == 1 else sizes,
        aspect_ratios=tuple(float(a) for a in m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        iou_thresholds=tuple(r.IOU_THRESHOLDS),
        iou_labels=tuple(r.IOU_LABELS),
        focal_alpha=r.FOCAL_LOSS_ALPHA,
        focal_gamma=r.FOCAL_LOSS_GAMMA,
        smooth_l1_beta=r.SMOOTH_L1_LOSS_BETA,
        box_reg_loss_type=r.BBOX_REG_LOSS_TYPE,
        score_thresh=r.SCORE_THRESH_TEST,
        nms_thresh=r.NMS_THRESH_TEST,
        topk_candidates=r.TOPK_CANDIDATES_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        dtype=compute_dtype(cfg.TPU.COMPUTE_DTYPE),
    )


def build_detector(cfg, device="cuda", training: bool = False):
    """The detector of the tree (`model_family`) on `device` (CUDA unless
    the caller asks for the CPU) in eval mode; `training` adds the C4
    detector's training modules (`build_model`). Weights as `build_model`
    leaves them."""
    if cfg.MODEL.META_ARCHITECTURE == "RotatedFastRCNN":
        return build_rotated_fast_rcnn(cfg, device)
    family = model_family(cfg)
    if family == "c4":
        return build_model(model_config_from_cfg(cfg), device=device, training=training)
    if family in ("fpn", "dc5"):
        model = FPNRCNN(**fpn_rcnn_fields(cfg))
    elif family == "cascade_c4":
        model = CascadeRCNN(**cascade_rcnn_fields(cfg))
    elif family == "proposal_fpn":
        model = FPNProposalNetwork(**proposal_network_fields(cfg))
    elif family == "panoptic":
        model = PanopticFPN(**panoptic_fpn_fields(cfg))
    elif family == "semantic":
        model = SemanticSegmentor(**semantic_segmentor_fields(cfg))
    elif family == "retinanet":
        model = RetinaNet(**retinanet_fields(cfg))
    else:
        model = ProposalNetwork(**proposal_network_fields(cfg))
    return model.to(resolve_device(device)).eval()
