"""Config -> model (counterpart of cddmsl_tpu/models/build.py
`build_generalized_rcnn`)."""

import torch

from ..config import ModelConfig
from ..device import compute_dtype, resolve_device
from .rcnn import GeneralizedRCNN


def build_model(config: ModelConfig, device="cuda", training: bool = False) -> GeneralizedRCNN:
    """Builds the detector on `device` (CUDA unless the caller asks for the
    CPU) in eval mode; `training=True` adds the modules that only the CDDMSL
    losses read (offline backbone, ClipCap mapper, projector and image
    projector). Its weights are the modules' defaults: load a state dict
    (checkpoint/convert_jax.py) or call `init_random_` next."""
    device = resolve_device(device)
    if not config.use_text_emb:
        raise NotImplementedError("only the text-embedding classifier (MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER) is ported")
    if config.soft_nms_enabled:
        raise NotImplementedError("soft-NMS (MODEL.ROI_HEADS.SOFT_NMS_ENABLED) is not ported")
    model = GeneralizedRCNN(
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
        score_thresh_test=config.score_thresh_test,
        nms_thresh_test=config.nms_thresh_test,
        detections_per_image=config.detections_per_image,
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
