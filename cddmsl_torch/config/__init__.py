"""The port's own copy of the configuration that the port reads.

`ModelConfig` holds the fields of `GeneralizedRCNN`, already mapped from the
yacs keys as `cddmsl_tpu/models/build.py` (`build_generalized_rcnn`) maps
them; `SolverConfig` the SOLVER keys of the optimizer, the LR schedule and
the burn-up, and MODEL.BACKBONE.FREEZE_AT. Their defaults are the defaults of
`cddmsl_tpu/config/defaults.py`; `flagship_config` and
`flagship_solver_config` apply the flagship overrides of
`__graft_entry__._flagship_cfg`.

The yacs tree itself is `cfg_node.CfgNode` with the defaults of
`defaults.get_cfg`; `model_config_from_cfg` and `solver_config_from_cfg`
map it to the two dataclasses, and `check_supported` raises for any value
the port does not implement. The loaders and the trainer read the data,
test and loop keys from the tree, as the JAX package's do;
`add_ateacher_config` adds the mean-teacher block.
"""

import dataclasses
import logging
from typing import Any, Callable, Optional, Tuple

from ..parallel import comm
from .ateacher import add_ateacher_config
from .cfg_node import CfgNode
from .defaults import get_cfg

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)

# MODEL.RESNETS.DEPTH -> (blocks per stage, width), embed dim, input size
# (cddmsl_tpu/models/backbone/clip_resnet.py)
RESNET_SPECS = {50: ((3, 4, 6, 3), 64), 101: ((3, 4, 23, 3), 64), 200: ((4, 6, 10, 6), 80)}
EMBED_DIMS = {50: 1024, 101: 512, 200: 640}
IMAGE_RESOLUTIONS = {50: 224, 101: 224, 200: 288}
# MODEL.CONSISTENCY_BRANCH values, as the JAX DefaultTrainer asserts them
CONSISTENCY_BRANCHES = ("", "image", "image_region", "caption_pl_img", "caption_pl_region")


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
    # MODEL.RPN
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_pre_nms_topk_train: int = 12000
    rpn_pre_nms_topk_test: int = 6000
    rpn_post_nms_topk_train: int = 2000
    rpn_post_nms_topk_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_loss_weight: float = 1.0
    # MODEL.ROI_HEADS / ROI_BOX_HEAD / CLIP / TEST
    num_classes: int = 80
    roi_batch_size_per_image: int = 512
    roi_positive_fraction: float = 0.25
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 0
    use_text_emb: bool = False
    temperature: float = 0.01
    focal_gamma: Optional[float] = None  # MODEL.CLIP.FOCAL_SCALED_LOSS
    bg_loss_weight: Optional[float] = None  # MODEL.CLIP.BG_CLS_LOSS_WEIGHT
    score_thresh_test: float = 0.05
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    soft_nms_enabled: bool = False
    # MODEL.PIXEL_MEAN / PIXEL_STD (detectron2 BGR defaults)
    pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    # TPU.REGION_CONSISTENCY_BOXES / V2L_IMAGE_SIZE / V2L_MAPPER_*
    region_consistency_boxes: int = 16
    v2l_image_size: int = 224
    v2l_mapper_layers: int = 8
    v2l_mapper_tokens: int = 40
    # TPU.COMPUTE_DTYPE
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 1e-4
    gamma: float = 0.1
    steps: Tuple[int, ...] = (30000,)  # WarmupMultiStepLR milestones
    lr_scheduler_name: str = "WarmupMultiStepLR"  # or "WarmupCosineLR"
    max_iter: int = 40000  # the cosine schedule's length
    warmup_factor: float = 1.0 / 1000
    warmup_iters: int = 1000
    warmup_method: str = "linear"  # or "constant"
    # SOLVER.CLIP_GRADIENTS: off by default; "value" clamps each gradient
    # element to [-clip_value, clip_value], "norm" scales the trainable
    # gradients by clip_value / (their global norm) when that norm is at
    # least clip_value
    clip_enabled: bool = False
    clip_type: str = "value"
    clip_value: float = 1.0
    caption_burnup_iters: int = 10000
    freeze_at: int = 2  # MODEL.BACKBONE.FREEZE_AT


def flagship_config(tiny: bool = False) -> ModelConfig:
    """The flagship CLIP-RN50 C4 detector with the text-embedding classifier;
    `tiny=True` is the compile-light variant the tests use."""
    cfg = ModelConfig(
        num_classes=20,
        use_text_emb=True,
        focal_gamma=0.5,
        bg_loss_weight=0.2,
        pixel_mean=CLIP_PIXEL_MEAN,
        pixel_std=CLIP_PIXEL_STD,
    )
    if tiny:
        cfg = dataclasses.replace(
            cfg,
            backbone_layers=(1, 1, 1, 1),
            backbone_width=16,
            embed_dim=128,
            v2l_mapper_layers=2,
            v2l_mapper_tokens=8,
            rpn_pre_nms_topk_train=256,
            rpn_post_nms_topk_train=64,
            rpn_pre_nms_topk_test=128,
            rpn_post_nms_topk_test=32,
            roi_batch_size_per_image=32,
            region_consistency_boxes=4,
            compute_dtype="float32",
        )
    return cfg


def flagship_solver_config(tiny: bool = False) -> SolverConfig:
    """The flagship's SOLVER overrides: base LR 0.002 and clipping at 5.0
    (by value: `_flagship_cfg` keeps the default CLIP_TYPE). `tiny=True`
    drops the warmup, as the JAX tiny config does."""
    cfg = SolverConfig(base_lr=0.002, clip_enabled=True, clip_value=5.0)
    if tiny:
        cfg = dataclasses.replace(cfg, warmup_iters=0)
    return cfg


def _falsy(v) -> bool:
    return not v


# (key, the values the port implements); every other value raises
_SUPPORTED: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.META_ARCHITECTURE", lambda v: v == "GeneralizedRCNN"),
    ("MODEL.BACKBONE.NAME", lambda v: v == "build_clip_resnet_backbone"),
    ("MODEL.RESNETS.DEPTH", lambda v: v in RESNET_SPECS),
    ("MODEL.RESNETS.OUT_FEATURES", lambda v: list(v) == ["res4"]),
    ("MODEL.RESNETS.NORM", lambda v: v == "FrozenBN"),
    ("MODEL.MASK_ON", _falsy),
    ("MODEL.KEYPOINT_ON", _falsy),
    ("MODEL.LOAD_PROPOSALS", _falsy),
    ("MODEL.CONSISTENCY_BRANCH", lambda v: v in CONSISTENCY_BRANCHES),
    ("MODEL.CAPTION_PL_LOSS", lambda v: v in ("pseudo_label", "kl")),
    ("MODEL.ROI_HEADS.NAME", lambda v: v == "CLIPRes5ROIHeads"),
    ("MODEL.ROI_HEADS.SOFT_NMS_ENABLED", _falsy),
    ("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", _falsy),
    ("MODEL.CLIP.CROP_REGION_TYPE", lambda v: v == "RPN"),
    ("MODEL.CLIP.BB_RPN_WEIGHTS", _falsy),
    ("MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER", bool),
    ("MODEL.CLIP.NO_BOX_DELTA", _falsy),
    ("MODEL.CLIP.MULTIPLY_RPN_SCORE", _falsy),
    ("MODEL.CLIP.OPENSET_TEST_NUM_CLASSES", _falsy),
    ("INPUT.MIN_SIZE_TRAIN_SAMPLING", lambda v: v in ("choice", "range")),
    ("INPUT.CROP.ENABLED", _falsy),
    ("INPUT.FORMAT", lambda v: v in ("RGB", "BGR")),
    ("DATALOADER.SAMPLER_TRAIN", lambda v: v == "TrainingSampler"),
    ("SOLVER.NESTEROV", _falsy),
    ("SOLVER.LR_SCHEDULER_NAME", lambda v: v in ("WarmupMultiStepLR", "WarmupCosineLR")),
    ("SOLVER.WARMUP_METHOD", lambda v: v in ("linear", "constant")),
    ("SOLVER.CLIP_GRADIENTS.CLIP_TYPE", lambda v: v in ("value", "norm")),
    ("TEST.AUG.ENABLED", _falsy),
    ("TEST.PRECISE_BN.ENABLED", _falsy),
    ("TPU.SPATIAL_PARTITION", _falsy),
    ("TPU.FSDP", _falsy),
    ("TPU.PIPELINE_AXIS", _falsy),
    ("TPU.MOE.NUM_EXPERTS", _falsy),
    ("TPU.QUANT_EVAL", _falsy),
    ("TPU.ASYNC_CHECKPOINT", _falsy),
    ("TPU.PAD_BUCKETS", _falsy),
    ("TPU.COMPUTE_DTYPE", lambda v: v in ("bfloat16", "float32")),
)


def _lookup(cfg, key: str):
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


# the keys of `add_ateacher_config` that the mean-teacher trainer reads, with
# the values it implements (checked when the tree holds the block)
_SUPPORTED_SEMISUP: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("SEMISUPNET.Trainer", lambda v: v in ("default", "ateacher")),
    ("SEMISUPNET.DIS_TYPE", lambda v: v == "res4"),
    ("SEMISUPNET.PSEUDO_BBOX_SAMPLE", lambda v: v == "thresholding"),
    ("SEMISUPNET.LOSS_WEIGHT_TYPE", lambda v: v == "standard"),
    ("MODEL.RPN.LOSS", lambda v: v == "CrossEntropy"),
    ("MODEL.ROI_HEADS.LOSS", lambda v: v == "CrossEntropy"),
)


def check_supported(cfg, world: Optional[int] = None) -> None:
    """Raises NotImplementedError naming the first key set to a value the
    port does not implement. The port's only mesh is data parallelism over
    the processes: TPU.MESH_SHAPE is [-1] (every rank) or [world], `world`
    being the process group's size unless given."""
    checks = _SUPPORTED + (_SUPPORTED_SEMISUP if "SEMISUPNET" in cfg else ())
    for key, ok in checks:
        value = _lookup(cfg, key)
        if not ok(value):
            raise NotImplementedError(f"{key} = {value!r} is not ported")
    world = comm.get_world_size() if world is None else world
    mesh = list(cfg.TPU.MESH_SHAPE)
    if mesh not in ([-1], [world]):
        raise NotImplementedError(f"TPU.MESH_SHAPE = {mesh!r} is not ported for a world of {world} "
                                  f"process(es): it is [-1] or [{world}]")


def model_config_from_cfg(cfg) -> ModelConfig:
    """cfg -> ModelConfig, as `build_generalized_rcnn` reads it for the CLIP
    backbone (TPU.BACKBONE_LAYERS / BACKBONE_WIDTH / EMBED_DIM override the
    depth's spec), after `check_supported`. It reads the JAX package's tree
    as well as the port's."""
    check_supported(cfg)
    m, tpu = cfg.MODEL, cfg.TPU
    depth = m.RESNETS.DEPTH
    layers, width = RESNET_SPECS[depth]
    sizes = tuple(s for group in m.ANCHOR_GENERATOR.SIZES for s in (group if isinstance(group, (list, tuple)) else [group]))
    return ModelConfig(
        backbone_layers=tuple(tpu.BACKBONE_LAYERS) or layers,
        backbone_width=tpu.BACKBONE_WIDTH or width,
        embed_dim=tpu.EMBED_DIM or EMBED_DIMS[depth],
        input_resolution=IMAGE_RESOLUTIONS[depth],
        anchor_sizes=sizes,
        anchor_aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        rpn_batch_size_per_image=m.RPN.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=m.RPN.POSITIVE_FRACTION,
        rpn_pre_nms_topk_train=m.RPN.PRE_NMS_TOPK_TRAIN,
        rpn_pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
        rpn_post_nms_topk_train=m.RPN.POST_NMS_TOPK_TRAIN,
        rpn_post_nms_topk_test=m.RPN.POST_NMS_TOPK_TEST,
        rpn_nms_thresh=m.RPN.NMS_THRESH,
        rpn_loss_weight=m.RPN.LOSS_WEIGHT,
        num_classes=m.ROI_HEADS.NUM_CLASSES,
        roi_batch_size_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
        pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
        use_text_emb=m.CLIP.USE_TEXT_EMB_CLASSIFIER,
        temperature=m.CLIP.CLSS_TEMP,
        focal_gamma=m.CLIP.FOCAL_SCALED_LOSS,
        bg_loss_weight=m.CLIP.BG_CLS_LOSS_WEIGHT,
        score_thresh_test=m.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=m.ROI_HEADS.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        soft_nms_enabled=m.ROI_HEADS.SOFT_NMS_ENABLED,
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        region_consistency_boxes=tpu.REGION_CONSISTENCY_BOXES,
        v2l_image_size=tpu.V2L_IMAGE_SIZE,
        v2l_mapper_layers=tpu.V2L_MAPPER_LAYERS,
        v2l_mapper_tokens=tpu.V2L_MAPPER_TOKENS,
        compute_dtype=tpu.COMPUTE_DTYPE,
    )


def solver_config_from_cfg(cfg) -> SolverConfig:
    """cfg -> SolverConfig (the SOLVER keys of `build_lr_schedule` and
    `build_optimizer`, the burn-up and FREEZE_AT)."""
    s, clip = cfg.SOLVER, cfg.SOLVER.CLIP_GRADIENTS
    if s.WEIGHT_DECAY and s.WEIGHT_DECAY_BIAS is not None and s.WEIGHT_DECAY_BIAS != s.WEIGHT_DECAY:
        logging.getLogger(__name__).warning(
            "SOLVER.WEIGHT_DECAY_BIAS=%s differs from WEIGHT_DECAY=%s; uniform decay is applied, "
            "as in the JAX package", s.WEIGHT_DECAY_BIAS, s.WEIGHT_DECAY,
        )
    return SolverConfig(
        base_lr=s.BASE_LR,
        momentum=s.MOMENTUM,
        weight_decay=s.WEIGHT_DECAY,
        gamma=s.GAMMA,
        steps=tuple(s.STEPS),
        lr_scheduler_name=s.LR_SCHEDULER_NAME,
        max_iter=s.MAX_ITER,
        warmup_factor=s.WARMUP_FACTOR,
        warmup_iters=s.WARMUP_ITERS,
        warmup_method=s.WARMUP_METHOD,
        clip_enabled=clip.ENABLED,
        clip_type=clip.CLIP_TYPE,
        clip_value=clip.CLIP_VALUE,
        caption_burnup_iters=s.CAPTION_BURNUP_ITERS,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
    )
