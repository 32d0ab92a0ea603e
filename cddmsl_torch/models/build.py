"""Config -> model (counterpart of cddmsl_tpu/models/build.py
`build_generalized_rcnn`, `build_clip_fast_rcnn` and
`build_pretrain_fast_rcnn`)."""

from typing import Any, Dict

import torch

from ..config import (
    EMBED_DIMS, RESNET_SPECS, ModelConfig, check_clip_fast_rcnn_supported, check_pretrain_supported,
)
from ..device import compute_dtype, resolve_device
from .clip_rcnn import CLIPFastRCNN, PretrainFastRCNN
from .rcnn import GeneralizedRCNN


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
