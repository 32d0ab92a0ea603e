"""The port's own copy of the configuration that the inference path reads.

`ModelConfig` holds the fields of `GeneralizedRCNN` that inference touches,
already mapped from the yacs keys as `cddmsl_tpu/models/build.py`
(`build_generalized_rcnn`) maps them. Its defaults are the defaults of
`cddmsl_tpu/config/defaults.py`; `flagship_config` applies the flagship
overrides of `__graft_entry__._flagship_cfg`.
"""

import dataclasses
from typing import Tuple

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # backbone: CLIP RN50 (MODEL.RESNETS.DEPTH=50; TPU.BACKBONE_LAYERS,
    # TPU.BACKBONE_WIDTH and TPU.EMBED_DIM override it)
    backbone_layers: Tuple[int, ...] = (3, 4, 6, 3)
    backbone_width: int = 64
    embed_dim: int = 1024
    input_resolution: int = 224
    # MODEL.ANCHOR_GENERATOR (single level, stride 16, offset 0)
    anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    anchor_aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # MODEL.RPN.*_TEST
    rpn_pre_nms_topk_test: int = 6000
    rpn_post_nms_topk_test: int = 1000
    rpn_nms_thresh: float = 0.7
    # MODEL.ROI_HEADS / ROI_BOX_HEAD / CLIP / TEST
    num_classes: int = 80
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 0
    use_text_emb: bool = False
    temperature: float = 0.01
    score_thresh_test: float = 0.05
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    soft_nms_enabled: bool = False
    # MODEL.PIXEL_MEAN / PIXEL_STD (detectron2 BGR defaults)
    pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    # TPU.COMPUTE_DTYPE
    compute_dtype: str = "bfloat16"


def flagship_config(tiny: bool = False) -> ModelConfig:
    """The flagship CLIP-RN50 C4 detector with the text-embedding classifier;
    `tiny=True` is the compile-light variant the tests use."""
    cfg = ModelConfig(
        num_classes=20,
        use_text_emb=True,
        pixel_mean=CLIP_PIXEL_MEAN,
        pixel_std=CLIP_PIXEL_STD,
    )
    if tiny:
        cfg = dataclasses.replace(
            cfg,
            backbone_layers=(1, 1, 1, 1),
            backbone_width=16,
            embed_dim=128,
            rpn_pre_nms_topk_test=128,
            rpn_post_nms_topk_test=32,
            compute_dtype="float32",
        )
    return cfg
