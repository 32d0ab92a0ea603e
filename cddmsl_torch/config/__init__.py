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
`add_ateacher_config` adds the mean-teacher block. `check_pretrain_supported`
is the pretraining entry's check (MODEL.META_ARCHITECTURE PretrainFastRCNN,
which `check_supported` refuses), and `check_clip_fast_rcnn_supported` the
check of `models.build.build_clip_fast_rcnn` (MODEL.META_ARCHITECTURE
CLIPFastRCNN, the open-vocabulary detector, which `check_supported` refuses
too: JAX's trainer cannot build it).

MODEL.BACKBONE.NAME picks the tower as the JAX build does:
build_clip_resnet_backbone is CLIP's ModifiedResNet, build_resnet_backbone
the plain detectron2 ResNet (`D2ResNet`) of the R50-C4 baselines, built
from RESNETS.DEPTH alone with a res5 of 2048 channels, no offline backbone
and no caption branches.

`model_family` names the detector JAX's `build_model` assembles: the C4
GeneralizedRCNN above (`ModelConfig`), or the FPN family, which
`models.build.build_detector` builds from the tree: FPNRCNN on
build_resnet_fpn_backbone, its DC5 form at RESNETS.RES5_DILATION 2, and
MODEL.META_ARCHITECTURE ProposalNetwork on res4 or on the FPN.
`check_supported` holds that family to `_family_checks` (FPNRCNN takes
RESNETS/FPN/ROI_BOX_HEAD/ROI_MASK_HEAD.NORM GN or SyncBN, the conv box
head, the deformable stages (RESNETS.DEFORM_ON_PER_STAGE, DEFORM_MODULATED)
and, at MODEL.BACKBONE.NAME build_clip_resnet_fpn_backbone, CLIP's tower),
PanopticFPN and the SemanticSegmentor (MODEL.META_ARCHITECTURE) to
`_segmentation_checks` (PanopticFPN takes the GN tower and FPN, the
deformable stages and the cascade heads), and RetinaNet to
`_retinanet_checks`. A deformable stage with RESNETS.NUM_GROUPS above 1
is refused naming NUM_GROUPS: JAX's block asserts one group there.
RESNETS.DEPTH 18 and 34 build BasicBlock towers (`BASIC_BLOCK_DEPTHS`)
for the detectors that read the tower's widths from it (the FPN family,
RetinaNet, PanopticFPN, the semantic segmentor); the detectors on res4 or
res5 at fixed widths (the C4 heads, ProposalNetwork and the cascade on
res4, DC5) take the bottleneck depths alone (`BOTTLENECK_DEPTHS`).
MODEL.META_ARCHITECTURE RotatedFastRCNN is refused as CLIPFastRCNN is:
JAX's trainer cannot build it; `models.build.build_rotated_fast_rcnn`
builds it from the tree.
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
# MODEL.RESNETS.DEPTH -> bottleneck blocks per stage of the plain tower
# (cddmsl_tpu/models/backbone/resnet.py; 10 is the tests' depth); depths 18
# and 34 stack BasicBlocks (`BASIC_BLOCK_DEPTHS`)
D2_RESNET_SPECS = {10: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                   152: (3, 8, 36, 3)}
BASIC_BLOCK_DEPTHS = (18, 34)
# the depths of the detectors that read res4 or res5 at fixed widths (1024
# into the C4 RPN, 2048 into the C4 heads): BasicBlock towers are not
# ported there
BOTTLENECK_DEPTHS = tuple(d for d in D2_RESNET_SPECS if d not in BASIC_BLOCK_DEPTHS)
CLIP_TOWER, D2_TOWER = "build_clip_resnet_backbone", "build_resnet_backbone"
# MODEL.CONSISTENCY_BRANCH values, as the JAX DefaultTrainer asserts them
CONSISTENCY_BRANCHES = ("", "image", "image_region", "caption_pl_img", "caption_pl_region")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # backbone: CLIP RN50 (MODEL.RESNETS.DEPTH=50; TPU.BACKBONE_LAYERS,
    # TPU.BACKBONE_WIDTH and TPU.EMBED_DIM override it), or with
    # backbone_type "d2_resnet" the plain ResNet of backbone_depth
    backbone_type: str = "clip"
    backbone_depth: int = 50
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
    cls_agnostic_bbox_reg: bool = False
    soft_nms_enabled: bool = False
    soft_nms_method: str = "gaussian"
    soft_nms_sigma: float = 0.5
    soft_nms_prune: float = 0.001
    # MODEL.CLIP.NO_BOX_DELTA (the proposal box for every class) and
    # MULTIPLY_RPN_SCORE (score sqrt(prob * objectness logit))
    no_box_delta: bool = False
    multiply_rpn_score: bool = False
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
    # MODEL.MASK_ON and MODEL.ROI_MASK_HEAD.{NUM_CONV, CONV_DIM,
    # CLS_AGNOSTIC_MASK}, TPU.MASK_CANVAS_STRIDE
    mask_on: bool = False
    mask_num_conv: int = 0
    mask_conv_dim: int = 256
    mask_cls_agnostic: bool = False
    mask_canvas_stride: float = 4.0
    # MODEL.KEYPOINT_ON and MODEL.ROI_KEYPOINT_HEAD.{NUM_KEYPOINTS,
    # CONV_DIMS, LOSS_WEIGHT}; the normaliser is -1 (the visible keypoints)
    # or NUM_KEYPOINTS x BATCH_SIZE_PER_IMAGE x POSITIVE_FRACTION per image
    keypoint_on: bool = False
    num_keypoints: int = 17
    keypoint_conv_dims: Tuple[int, ...] = (512,) * 8
    keypoint_loss_weight: float = 1.0
    keypoint_loss_normalizer: float = -1.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 0.001
    momentum: float = 0.9
    nesterov: bool = False  # SOLVER.NESTEROV
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


# RandomCrop's INPUT.CROP.TYPE (data/transforms.py)
CROP_TYPES = ("relative", "relative_range", "absolute", "absolute_range")


# (key, the values the port implements); every other value raises
_SUPPORTED_BACKBONE: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.BACKBONE.NAME", lambda v: v == CLIP_TOWER),
    ("MODEL.RESNETS.DEPTH", lambda v: v in RESNET_SPECS),
    ("MODEL.RESNETS.OUT_FEATURES", lambda v: list(v) == ["res4"]),
    ("MODEL.RESNETS.NORM", lambda v: v == "FrozenBN"),
)
# the detector's towers. The detector reads res4 alone (the C4 head runs res5
# on the crops), so OUT_FEATURES [res4, res5] changes nothing it computes, as
# in JAX. The shape keys hold the one value either tower is built with (the
# JAX build reads none of them, nor the deformable stages).
_SUPPORTED_TOWERS: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.BACKBONE.NAME", lambda v: v in (CLIP_TOWER, D2_TOWER)),
    ("MODEL.RESNETS.OUT_FEATURES", lambda v: list(v) in (["res4"], ["res4", "res5"])),
    ("MODEL.RESNETS.NORM", lambda v: v == "FrozenBN"),
    ("MODEL.RESNETS.STEM_OUT_CHANNELS", lambda v: v == 64),
    ("MODEL.RESNETS.RES2_OUT_CHANNELS", lambda v: v == 256),
    ("MODEL.RESNETS.STRIDE_IN_1X1", lambda v: v is True),
    ("MODEL.RESNETS.NUM_GROUPS", lambda v: v == 1),
    ("MODEL.RESNETS.WIDTH_PER_GROUP", lambda v: v == 64),
    ("MODEL.RESNETS.RES5_DILATION", lambda v: v == 1),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", lambda v: not any(v)),
)
# what the plain tower does not have or take: its depth's own widths, no
# attention pool, no CLIP embedding, no offline copy
_SUPPORTED_D2: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.RESNETS.DEPTH", lambda v: v in BOTTLENECK_DEPTHS),
    ("TPU.BACKBONE_LAYERS", _falsy),
    ("TPU.BACKBONE_WIDTH", _falsy),
    ("TPU.EMBED_DIM", _falsy),
    ("TPU.ENABLE_CAPTION_CONSISTENCY", _falsy),
    ("MODEL.CONSISTENCY_BRANCH", _falsy),
    ("MODEL.PRE_TRAINED_RCLIP_PATH", _falsy),
    ("MODEL.VISION_TO_LANG_PATH", _falsy),
)
_SUPPORTED_SOLVER: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("SOLVER.LR_SCHEDULER_NAME", lambda v: v in ("WarmupMultiStepLR", "WarmupCosineLR")),
    ("SOLVER.WARMUP_METHOD", lambda v: v in ("linear", "constant")),
    ("SOLVER.CLIP_GRADIENTS.CLIP_TYPE", lambda v: v in ("value", "norm")),
)
_SUPPORTED_DTYPE = (("TPU.COMPUTE_DTYPE", lambda v: v in ("bfloat16", "float32")),)
# the keys of a run whatever the detector: the loaders, the solver, the test
# and the TPU switches
_SUPPORTED_RUN: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("INPUT.MIN_SIZE_TRAIN_SAMPLING", lambda v: v in ("choice", "range")),
    ("INPUT.CROP.TYPE", lambda v: v in CROP_TYPES),
    ("INPUT.FORMAT", lambda v: v in ("RGB", "BGR")),
    # JAX's deformable blocks take one offset group whatever the tree says
    ("MODEL.RESNETS.DEFORM_NUM_GROUPS", lambda v: v == 1),
    ("DATALOADER.SAMPLER_TRAIN", lambda v: v in ("TrainingSampler", "RepeatFactorTrainingSampler")),
    *_SUPPORTED_SOLVER,
    ("TEST.AUG.ENABLED", _falsy),
    ("TPU.SPATIAL_PARTITION", _falsy),
    ("TPU.FSDP", _falsy),
    ("TPU.PIPELINE_AXIS", _falsy),
    ("TPU.MOE.NUM_EXPERTS", _falsy),
    ("TPU.QUANT_EVAL", _falsy),
    ("TPU.ASYNC_CHECKPOINT", _falsy),
    # a ladder of (h, w) pad sizes for the train loader (data/build.py `_bucket_for`)
    ("TPU.PAD_BUCKETS", lambda v: all(len(b) == 2 and min(b) > 0 for b in v)),
    *_SUPPORTED_DTYPE,
)
_SUPPORTED: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.META_ARCHITECTURE", lambda v: v == "GeneralizedRCNN"),
    *_SUPPORTED_TOWERS,
    ("MODEL.LOAD_PROPOSALS", _falsy),
    ("MODEL.CONSISTENCY_BRANCH", lambda v: v in CONSISTENCY_BRANCHES),
    ("MODEL.CAPTION_PL_LOSS", lambda v: v in ("pseudo_label", "kl")),
    ("MODEL.ROI_HEADS.NAME", lambda v: v == "CLIPRes5ROIHeads"),
    ("MODEL.ROI_HEADS.SOFT_NMS_METHOD", lambda v: v in ("gaussian", "linear", "hard")),
    ("MODEL.CLIP.CROP_REGION_TYPE", lambda v: v == "RPN"),
    ("MODEL.ROI_BOX_HEAD.NUM_FC", lambda v: v == 0),
    # JAX's loader asserts an offline detectron2 tower, which this arch lacks
    ("MODEL.CLIP.BB_RPN_WEIGHTS", _falsy),
    *_SUPPORTED_RUN,
)


# with MODEL.MASK_ON: the keys of the mask head that JAX's modules leave
# unread, at the values they compute with (a 14x14 aligned pool with 2x2
# samples, the conv-upsample head without a norm)
_SUPPORTED_MASK: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.ROI_MASK_HEAD.NAME", lambda v: v == "MaskRCNNConvUpsampleHead"),
    ("MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", lambda v: v == 14),
    ("MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO", lambda v: v == 0),
    ("MODEL.ROI_MASK_HEAD.POOLER_TYPE", lambda v: v == "ROIAlignV2"),
    ("TPU.MASK_CANVAS_STRIDE", lambda v: v >= 1),
)


def _mask_checks(cfg) -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """With MODEL.MASK_ON; ROI_MASK_HEAD.NORM only FPNRCNN's head reads
    (`_family_checks`; its cascade's does not, `_cascade_checks`):
    elsewhere it is held at ""."""
    if not cfg.MODEL.MASK_ON:
        return ()
    # the mean-teacher trainer's batches carry no canvases
    semisup = (("SEMISUPNET.Trainer", lambda v: v == "default"),) if "SEMISUPNET" in cfg else ()
    norm = () if model_family(cfg) in ("fpn", "dc5") else (("MODEL.ROI_MASK_HEAD.NORM", _falsy),)
    return _SUPPORTED_MASK + norm + semisup


def _keypoint_checks(cfg, family: str) -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """With MODEL.KEYPOINT_ON: the keypoint head's keys that JAX's modules
    leave unread, at the values they compute with. The FPN branch pools
    14x14 (its own pooler, sampling ratio 0); the C4 branch pools res4 at
    the box pooler's resolution with 2x2 samples whatever
    POOLER_SAMPLING_RATIO says (ROADMAP C). The mean-teacher trainer's
    batches carry no keypoints."""
    if not cfg.MODEL.KEYPOINT_ON:
        return ()
    resolution = 14 if family == "fpn" else cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    checks = (
        ("MODEL.ROI_KEYPOINT_HEAD.NAME", lambda v: v == "KRCNNConvDeconvUpsampleHead"),
        ("MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE", lambda v: v == "ROIAlignV2"),
        ("MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO", lambda v: v == 0),
        ("MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION", lambda v: v == resolution),
    )
    return checks + ((("SEMISUPNET.Trainer", lambda v: v == "default"),) if "SEMISUPNET" in cfg else ())


_DEFAULT_CASCADE_IOUS = [0.5, 0.6, 0.7]
_DEFAULT_CASCADE_WEIGHTS = [[10.0, 10.0, 5.0, 5.0], [20.0, 20.0, 10.0, 10.0], [30.0, 30.0, 15.0, 15.0]]


def _cascade_checks(family: str) -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """What the cascade heads take. Their stages are fixed in JAX's
    modules: 2 fcs of 1024, a linear classifier, class-agnostic smooth-L1
    (beta 0) boxes, weights (10,10,5,5), (20,20,10,10), (30,30,15,15),
    which no builder reads from ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS. The
    FPN build passes no ROI_BOX_CASCADE_HEAD.IOUS either (the stages match
    at 0.5, 0.6, 0.7) and no keypoint head (JAX asserts); the C4 build
    (CascadeRCNN) reads IOUS, one stage for each of up to three."""
    checks = [
        ("MODEL.KEYPOINT_ON", _falsy),
        ("MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS", lambda v: [list(w) for w in v] == _DEFAULT_CASCADE_WEIGHTS),
        ("MODEL.ROI_BOX_CASCADE_HEAD.IOUS", (lambda v: 1 <= len(v) <= 3) if family == "cascade_c4"
         else (lambda v: list(v) == _DEFAULT_CASCADE_IOUS)),
        ("MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER", _falsy),
    ]
    if family == "fpn":
        checks += [("MODEL.ROI_BOX_HEAD.FC_DIM", lambda v: v == 1024),
                   ("MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA", lambda v: v == 0.0),
                   ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", lambda v: v == "smooth_l1"),
                   ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT", lambda v: v == 1.0),
                   ("MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK", _falsy),
                   ("MODEL.ROI_BOX_HEAD.NUM_CONV", lambda v: v == 0),
                   ("MODEL.ROI_BOX_HEAD.NUM_FC", lambda v: v in (0, 2)),
                   ("MODEL.ROI_BOX_HEAD.NORM", _falsy),
                   ("MODEL.ROI_MASK_HEAD.NORM", _falsy)]
    return tuple(checks)


FPN_TOWER = "build_resnet_fpn_backbone"
CLIP_FPN_TOWER = "build_clip_resnet_fpn_backbone"
RETINANET_TOWER = "build_retinanet_resnet_fpn_backbone"
# the norms JAX's `_make_norm` builds: FrozenBN ("BN" and "" too), GN, SyncBN
TRAINABLE_NORMS = ("FrozenBN", "BN", "", "GN", "SyncBN")
HEAD_NORMS = ("", "GN", "SyncBN")
FPN_IN_FEATURES = ["res2", "res3", "res4", "res5"]
FPN_RPN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
FPN_HEAD_FEATURES = ["p2", "p3", "p4", "p5"]


def model_family(cfg) -> str:
    """The detector JAX's `build_model` assembles from the tree: "c4"
    (GeneralizedRCNN, every other meta-architecture too, which
    `check_supported` refuses), "fpn" (FPNRCNN: BACKBONE.NAME names an
    fpn_backbone), "dc5" (FPNRCNN on the one dilated res5 map:
    RESNETS.RES5_DILATION 2), "proposal_fpn" or "proposal_c4"
    (ProposalNetwork on the FPN or on res4) or "cascade_c4" (CascadeRCNN on
    res4: MODEL.META_ARCHITECTURE CascadeRCNN, or ROI_HEADS.NAME
    CascadeROIHeads without an fpn_backbone), "panoptic" (PanopticFPN) or
    "semantic" (SemanticSegmentor), "retinanet" (RetinaNet)."""
    m = cfg.MODEL
    fpn = "fpn_backbone" in m.BACKBONE.NAME
    if m.META_ARCHITECTURE == "RetinaNet":
        return "retinanet"
    if m.META_ARCHITECTURE in SEGMENTATION_ARCHS:
        return SEGMENTATION_ARCHS[m.META_ARCHITECTURE]
    if m.META_ARCHITECTURE == "ProposalNetwork":
        return "proposal_fpn" if fpn else "proposal_c4"
    if m.META_ARCHITECTURE == "CascadeRCNN" or (
            m.META_ARCHITECTURE == "GeneralizedRCNN" and m.ROI_HEADS.NAME == "CascadeROIHeads" and not fpn):
        return "cascade_c4"
    if m.META_ARCHITECTURE == "GeneralizedRCNN":
        if fpn:
            return "fpn"
        if m.RESNETS.RES5_DILATION == 2:
            return "dc5"
    return "c4"


def _describe(cfg, family: str) -> str:
    m = cfg.MODEL
    return {
        "fpn": f"the FPN detector (MODEL.BACKBONE.NAME = {m.BACKBONE.NAME!r}: JAX's FPNRCNN)",
        "dc5": "the DC5 detector (MODEL.RESNETS.RES5_DILATION = 2: JAX's FPNRCNN on the one res5 map)",
        "proposal_fpn": f"ProposalNetwork on the FPN (MODEL.BACKBONE.NAME = {m.BACKBONE.NAME!r})",
        "proposal_c4": f"ProposalNetwork on res4 (MODEL.BACKBONE.NAME = {m.BACKBONE.NAME!r})",
        "cascade_c4": "the C4 cascade (JAX's CascadeRCNN on res4)",
        "panoptic": "Panoptic FPN (JAX's PanopticFPN)",
        "semantic": "the semantic segmentor (JAX's SemanticSegmentor)",
        "retinanet": "RetinaNet (JAX's RetinaNet)",
    }[family]


def _family_checks(family: str) -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """What the FPN family (`models.build.fpn_rcnn_fields`,
    `proposal_network_fields`) implements: the keys JAX's builders read, at
    any value or at the ones ported, and the keys they leave unread at the
    value JAX's modules compute with. ProposalNetwork on res4 builds its
    tower and RPN from RESNETS.DEPTH and the RPN's module defaults alone
    (MODEL.RPN.*, ANCHOR_GENERATOR.* and BACKBONE.NAME are not read), as
    JAX's does. The feature lists, ROI_HEADS.NAME and POOLER_RESOLUTION,
    which JAX's modules do not read either, are taken at the family's value
    or at the tree's default (the quick schedules leave them unset). The C4
    cascade, like ProposalNetwork on res4, builds its RPN from the module's
    defaults, its tower from RESNETS.DEPTH and its heads from NUM_CLASSES
    and ROI_BOX_CASCADE_HEAD.IOUS (`_cascade_checks`)."""
    fpn, proposal = family in ("fpn", "proposal_fpn"), family.startswith("proposal")
    rpn_only_c4 = family in ("proposal_c4", "cascade_c4")

    def eq(*wants):
        return lambda v: (list(v) if isinstance(v, (list, tuple)) else v) in wants

    tower = {"fpn": eq(FPN_TOWER, CLIP_FPN_TOWER), "proposal_fpn": eq(FPN_TOWER), "dc5": eq(D2_TOWER),
             "proposal_c4": lambda v: "fpn_backbone" not in v, "cascade_c4": lambda v: "fpn_backbone" not in v}[family]
    # FPNRCNN builds its tower with RESNETS.NORM and the deformable stages,
    # the others with FrozenBN and none
    norms = TRAINABLE_NORMS if family in ("fpn", "dc5") else ("FrozenBN",)
    checks = [
        ("MODEL.BACKBONE.NAME", tower),
        ("MODEL.RESNETS.DEPTH", lambda v: v in (D2_RESNET_SPECS if fpn else BOTTLENECK_DEPTHS)),
        ("MODEL.RESNETS.NORM", eq(*norms)),
        ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", (lambda v: len(v) == 4) if family in ("fpn", "dc5")
         else (lambda v: not any(v))),
        ("MODEL.RESNETS.STEM_OUT_CHANNELS", eq(64)),
        ("MODEL.RESNETS.RES2_OUT_CHANNELS", eq(256)),
        ("MODEL.RESNETS.RES5_DILATION", eq(2 if family == "dc5" else 1)),
        ("MODEL.RESNETS.OUT_FEATURES", eq(FPN_IN_FEATURES if fpn else ["res5"] if family == "dc5" else ["res4"],
                                          ["res4"])),
        ("MODEL.RPN.IN_FEATURES", eq(FPN_RPN_FEATURES if fpn else ["res5"] if family == "dc5" else ["res4"],
                                     ["res4"])),
        ("MODEL.RPN.BBOX_REG_LOSS_TYPE", eq("smooth_l1") if proposal or rpn_only_c4 else eq("smooth_l1", "giou")),
        ("MODEL.CONSISTENCY_BRANCH", _falsy),
        ("MODEL.PRE_TRAINED_RCLIP_PATH", _falsy),
        ("MODEL.VISION_TO_LANG_PATH", _falsy),
        ("MODEL.ROI_HEADS.SOFT_NMS_ENABLED", _falsy),
        ("MODEL.CLIP.FOCAL_SCALED_LOSS", lambda v: v is None),
        ("MODEL.CLIP.BG_CLS_LOSS_WEIGHT", lambda v: v is None),
        ("MODEL.CLIP.NO_BOX_DELTA", _falsy),
        ("MODEL.CLIP.MULTIPLY_RPN_SCORE", _falsy),
        ("MODEL.CLIP.OPENSET_TEST_NUM_CLASSES", lambda v: v is None),
        ("MODEL.CLIP.BB_RPN_WEIGHTS", _falsy),
        ("MODEL.CLIP.CROP_REGION_TYPE", eq("RPN")),
        ("TPU.BACKBONE_LAYERS", _falsy),
        ("TPU.EMBED_DIM", _falsy),
    ]
    if fpn:
        checks += [("MODEL.FPN.IN_FEATURES", eq(FPN_IN_FEATURES, [])),
                   ("MODEL.FPN.NORM", eq(*HEAD_NORMS) if family == "fpn" else _falsy),
                   ("MODEL.FPN.FUSE_TYPE", eq("sum"))]
    if family != "fpn":
        checks += [("MODEL.KEYPOINT_ON", _falsy)]
    if proposal or rpn_only_c4:
        checks += [("MODEL.MASK_ON", _falsy), ("MODEL.PROPOSAL_GENERATOR.NAME", eq("RPN")),
                   ("MODEL.LOAD_PROPOSALS", _falsy),
                   ("MODEL.RESNETS.NUM_GROUPS", eq(1)), ("MODEL.RESNETS.WIDTH_PER_GROUP", eq(64)),
                   ("MODEL.RESNETS.STRIDE_IN_1X1", lambda v: v is True)]
        checks += [("MODEL.FPN.OUT_CHANNELS", eq(256))] if fpn else [("TPU.BACKBONE_WIDTH", _falsy)]
    else:
        heads = ("StandardROIHeads", "CLIPStandardROIHeads", "CLIPRes5ROIHeads") + (("CascadeROIHeads",) if fpn else ())
        checks += [
            ("MODEL.ROI_HEADS.NAME", eq(*heads)),
            ("MODEL.ROI_HEADS.IN_FEATURES", eq(FPN_HEAD_FEATURES if fpn else ["res5"], ["res4"])),
            ("MODEL.ROI_BOX_HEAD.NAME", eq("", "FastRCNNConvFCHead")),
            ("MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", eq(7, 14)),
            ("MODEL.ROI_BOX_HEAD.NUM_FC", lambda v: v in (0, 1, 2)),
            ("MODEL.ROI_BOX_HEAD.NORM", eq(*HEAD_NORMS)),
            ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", eq("smooth_l1", "giou")),
            ("MODEL.PROPOSAL_GENERATOR.NAME", lambda v: v in ("RPN", "PrecomputedProposals")),
        ]
    if family in ("fpn", "dc5"):
        checks += [("MODEL.ROI_MASK_HEAD.NORM", eq(*HEAD_NORMS))]
    return tuple(checks)


def _clip_fpn_checks(cfg) -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """Under BACKBONE.NAME build_clip_resnet_fpn_backbone JAX's FPNRCNN
    builds CLIP's ModifiedResNet (3, 4, 6, 3) of width TPU.BACKBONE_WIDTH
    or WIDTH_PER_GROUP: it reads no other tower key, so DEPTH is held at 50
    and the plain tower's keys at what the CLIP tower is (no deformable
    stage)."""
    if cfg.MODEL.BACKBONE.NAME != CLIP_FPN_TOWER:
        return ()
    return (
        ("MODEL.RESNETS.DEPTH", lambda v: v == 50),
        ("MODEL.RESNETS.NORM", lambda v: v in ("FrozenBN", "BN", "")),
        ("MODEL.RESNETS.NUM_GROUPS", lambda v: v == 1),
        ("MODEL.RESNETS.STRIDE_IN_1X1", lambda v: v is True),
        ("MODEL.RESNETS.RES5_DILATION", lambda v: v == 1),
        ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", lambda v: not any(v)),
    )


def _retinanet_checks() -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """What `models.build.retinanet_fields` implements, as JAX's
    `build_retinanet` reads the tree: RETINANET.{NUM_CLASSES,
    IOU_THRESHOLDS, IOU_LABELS, FOCAL_LOSS_*, SMOOTH_L1_LOSS_BETA,
    BBOX_REG_LOSS_TYPE, *_TEST}, RESNETS.DEPTH, the anchor sizes (one group
    broadcast over the five levels, or five groups of one length) and the
    first aspect ratios, the pixel statistics, TEST.DETECTIONS_PER_IMAGE.
    The keys it does not read are accepted at the value its module computes
    with (or the tree's default): the five levels p3..p7, four head convs,
    the prior 0.01, unit box weights, the plain tower of width 64 with
    FrozenBN on res3..res5 and the FPN of 256 without a norm. RETINANET.NORM
    GN is refused: JAX's head names one GroupNorm per level under one name
    and fails at init."""

    def eq(*wants):
        return lambda v: (list(v) if isinstance(v, (list, tuple)) else v) in wants

    def sizes_ok(groups):
        groups = [list(g) if isinstance(g, (list, tuple)) else [g] for g in groups]
        return len(groups) in (1, 5) and len({len(g) for g in groups}) == 1

    return (
        ("MODEL.BACKBONE.NAME", eq(RETINANET_TOWER, CLIP_TOWER)),
        ("MODEL.RESNETS.DEPTH", lambda v: v in D2_RESNET_SPECS),
        ("MODEL.RESNETS.OUT_FEATURES", eq(["res3", "res4", "res5"], ["res4"])),
        ("MODEL.RESNETS.NORM", eq("FrozenBN")),
        ("MODEL.RESNETS.STRIDE_IN_1X1", lambda v: v is True),
        ("MODEL.RESNETS.NUM_GROUPS", eq(1)),
        ("MODEL.RESNETS.WIDTH_PER_GROUP", eq(64)),
        ("MODEL.RESNETS.STEM_OUT_CHANNELS", eq(64)),
        ("MODEL.RESNETS.RES2_OUT_CHANNELS", eq(256)),
        ("MODEL.RESNETS.RES5_DILATION", eq(1)),
        ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", lambda v: not any(v)),
        ("MODEL.FPN.IN_FEATURES", eq(["res3", "res4", "res5"], [])),
        ("MODEL.FPN.OUT_CHANNELS", eq(256)),
        ("MODEL.FPN.NORM", _falsy),
        ("MODEL.FPN.FUSE_TYPE", eq("sum")),
        ("MODEL.RETINANET.IN_FEATURES", eq(["p3", "p4", "p5", "p6", "p7"])),
        ("MODEL.RETINANET.NUM_CONVS", eq(4)),
        ("MODEL.RETINANET.PRIOR_PROB", eq(0.01)),
        ("MODEL.RETINANET.BBOX_REG_WEIGHTS", eq([1.0, 1.0, 1.0, 1.0])),
        ("MODEL.RETINANET.NORM", _falsy),
        ("MODEL.RETINANET.BBOX_REG_LOSS_TYPE", eq("smooth_l1", "giou")),
        ("MODEL.ANCHOR_GENERATOR.SIZES", sizes_ok),
        ("MODEL.MASK_ON", _falsy),
        ("MODEL.KEYPOINT_ON", _falsy),
        ("MODEL.LOAD_PROPOSALS", _falsy),
        ("MODEL.PROPOSAL_GENERATOR.NAME", eq("RPN")),
        ("MODEL.CONSISTENCY_BRANCH", _falsy),
        ("MODEL.PRE_TRAINED_RCLIP_PATH", _falsy),
        ("MODEL.VISION_TO_LANG_PATH", _falsy),
        ("MODEL.CLIP.OPENSET_TEST_NUM_CLASSES", lambda v: v is None),
        ("TPU.BACKBONE_LAYERS", _falsy),
        ("TPU.BACKBONE_WIDTH", _falsy),
        ("TPU.EMBED_DIM", _falsy),
    )


SEGMENTATION_ARCHS = {"PanopticFPN": "panoptic", "SemanticSegmentor": "semantic"}
SEM_SEG_FEATURES = ["p2", "p3", "p4", "p5"]


def _segmentation_checks(family: str, cascade: bool = False) -> Tuple[Tuple[str, Callable[[Any], bool]], ...]:
    """What `models.build.panoptic_fpn_fields` and `semantic_segmentor_fields`
    implement, as JAX's `build_panoptic_fpn` and `build_semantic_segmentor`
    read the tree. PanopticFPN computes with a tower of RESNETS.DEPTH,
    STRIDE_IN_1X1, TPU.BACKBONE_WIDTH, RESNETS.NORM (FrozenBN or GN) and
    the deformable stages, the FPN without p6 under FPN.NORM ("" or GN), an
    RPN on p2 alone (one anchor size, 32, at stride 4; pre-NMS top-k 256 /
    128, post-NMS 64 / 32), the standard heads or, at ROI_HEADS.NAME
    CascadeROIHeads, the cascade's three stages (class-agnostic boxes
    whatever ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG says), sampling 64 rows an
    image with the mask head under MASK_ON, and the semantic head on p2..p5
    (128 channels, common stride 4, ignore 255); a key it does not read is
    accepted at the tree's default or at the value JAX computes with, and
    any other value raises. COMBINE.ENABLED False is
    refused because JAX's test always combines. The semantic segmentor
    reads DEPTH, the head's classes, norm, ignore value and IN_FEATURES
    (any of p2..p5, in order) and nothing of the instance branch: its
    tower is FrozenBN without deformable stages."""

    def eq(*wants):
        return lambda v: (list(v) if isinstance(v, (list, tuple)) else v) in wants

    panoptic = family == "panoptic"
    checks = [
        ("MODEL.RESNETS.DEPTH", lambda v: v in D2_RESNET_SPECS),
        ("MODEL.RESNETS.NORM", eq("FrozenBN", "BN", "", "GN") if panoptic else eq("FrozenBN")),
        ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", (lambda v: len(v) == 4) if panoptic else (lambda v: not any(v))),
        ("MODEL.FPN.NORM", eq("", "GN") if panoptic else _falsy),
        ("MODEL.BACKBONE.NAME", eq(CLIP_TOWER, FPN_TOWER)),
        ("MODEL.RESNETS.OUT_FEATURES", eq(["res4"], FPN_IN_FEATURES)),
        ("MODEL.RESNETS.STEM_OUT_CHANNELS", eq(64)),
        ("MODEL.RESNETS.RES2_OUT_CHANNELS", eq(256)),
        ("MODEL.RESNETS.NUM_GROUPS", eq(1)),
        ("MODEL.RESNETS.WIDTH_PER_GROUP", eq(64)),
        ("MODEL.RESNETS.RES5_DILATION", eq(1)),
        ("MODEL.FPN.IN_FEATURES", eq([], FPN_IN_FEATURES)),
        ("MODEL.FPN.OUT_CHANNELS", eq(256)),
        ("MODEL.FPN.FUSE_TYPE", eq("sum")),
        ("MODEL.SEM_SEG_HEAD.NAME", eq("SemSegFPNHead")),
        ("MODEL.SEM_SEG_HEAD.NORM", eq("", "GN")),
        ("MODEL.SEM_SEG_HEAD.IGNORE_VALUE", eq(255)),
        ("MODEL.SEM_SEG_HEAD.CONVS_DIM", eq(128)),
        ("MODEL.SEM_SEG_HEAD.COMMON_STRIDE", eq(4)),
        ("MODEL.LOAD_PROPOSALS", _falsy),
        ("MODEL.KEYPOINT_ON", _falsy),
        ("MODEL.CONSISTENCY_BRANCH", _falsy),
        ("MODEL.PRE_TRAINED_RCLIP_PATH", _falsy),
        ("MODEL.VISION_TO_LANG_PATH", _falsy),
        ("MODEL.CLIP.OPENSET_TEST_NUM_CLASSES", lambda v: v is None),
        ("TPU.BACKBONE_LAYERS", _falsy),
        ("TPU.EMBED_DIM", _falsy),
    ]
    if family == "semantic":
        return tuple(checks + [
            ("MODEL.SEM_SEG_HEAD.IN_FEATURES",
             lambda v: len(v) > 0 and list(v) == [f for f in SEM_SEG_FEATURES if f in v]),
            ("MODEL.SEM_SEG_HEAD.LOSS_WEIGHT", eq(1.0)),
            ("MODEL.RESNETS.STRIDE_IN_1X1", lambda v: v is True),
            ("TPU.BACKBONE_WIDTH", _falsy),
            ("MODEL.MASK_ON", _falsy),
        ])
    return tuple(checks + [
        ("MODEL.SEM_SEG_HEAD.IN_FEATURES", eq(SEM_SEG_FEATURES)),
        ("MODEL.PANOPTIC_FPN.COMBINE.ENABLED", lambda v: v is True),
        ("MODEL.ROI_HEADS.NAME", eq("CLIPRes5ROIHeads", "StandardROIHeads", "CLIPStandardROIHeads",
                                    "CascadeROIHeads")),
        ("MODEL.ROI_HEADS.IN_FEATURES", eq(["res4"], FPN_HEAD_FEATURES)),
        ("MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", eq(512, 64)),
        ("MODEL.ROI_HEADS.POSITIVE_FRACTION", eq(0.25)),
        ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", eq(0.05)),
        ("MODEL.ROI_HEADS.NMS_THRESH_TEST", eq(0.5)),
        ("MODEL.ROI_HEADS.SOFT_NMS_ENABLED", _falsy),
        ("TEST.DETECTIONS_PER_IMAGE", eq(100)),
        ("MODEL.ROI_BOX_HEAD.NAME", eq("", "FastRCNNConvFCHead")),
        ("MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", eq(14, 7)),
        ("MODEL.ROI_BOX_HEAD.NUM_CONV", eq(0)),
        ("MODEL.ROI_BOX_HEAD.NUM_FC", eq(0, 2)),
        ("MODEL.ROI_BOX_HEAD.FC_DIM", eq(1024)),
        ("MODEL.ROI_BOX_HEAD.NORM", _falsy),
        ("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", (lambda v: True) if cascade else _falsy),
        ("MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA", eq(0.0)),
        ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", eq("smooth_l1")),
        ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT", eq(1.0)),
        ("MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK", _falsy),
        ("MODEL.PROPOSAL_GENERATOR.NAME", eq("RPN")),
        ("MODEL.RPN.IN_FEATURES", eq(["res4"], ["p2"])),
        ("MODEL.ANCHOR_GENERATOR.SIZES", eq([[32, 64, 128, 256, 512]], [[32]])),
        ("MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS", eq([[0.5, 1.0, 2.0]])),
        ("MODEL.RPN.BATCH_SIZE_PER_IMAGE", eq(256)),
        ("MODEL.RPN.POSITIVE_FRACTION", eq(0.5)),
        ("MODEL.RPN.PRE_NMS_TOPK_TRAIN", eq(12000, 256)),
        ("MODEL.RPN.PRE_NMS_TOPK_TEST", eq(6000, 128)),
        ("MODEL.RPN.POST_NMS_TOPK_TRAIN", eq(2000, 64)),
        ("MODEL.RPN.POST_NMS_TOPK_TEST", eq(1000, 32)),
        ("MODEL.RPN.NMS_THRESH", eq(0.7)),
        ("MODEL.RPN.LOSS_WEIGHT", eq(1.0)),
        ("MODEL.RPN.SMOOTH_L1_BETA", eq(0.0)),
        ("MODEL.RPN.BBOX_REG_LOSS_TYPE", eq("smooth_l1")),
        ("MODEL.RPN.BBOX_REG_LOSS_WEIGHT", eq(1.0)),
        ("MODEL.CLIP.FOCAL_SCALED_LOSS", lambda v: v is None),
        ("MODEL.CLIP.BG_CLS_LOSS_WEIGHT", lambda v: v is None),
        ("MODEL.CLIP.NO_BOX_DELTA", _falsy),
        ("MODEL.CLIP.MULTIPLY_RPN_SCORE", _falsy),
        ("MODEL.CLIP.BB_RPN_WEIGHTS", _falsy),
        ("MODEL.CLIP.CROP_REGION_TYPE", eq("RPN")),
    ])


def _check_family(cfg, family: str) -> None:
    if family == "retinanet":
        checks = _retinanet_checks() + _SUPPORTED_RUN
    elif family in ("panoptic", "semantic"):
        cascade = cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads"
        checks = _segmentation_checks(family, cascade) + _SUPPORTED_RUN + _mask_checks(cfg)
    else:
        checks = (_family_checks(family) + _clip_fpn_checks(cfg) + _SUPPORTED_RUN + _mask_checks(cfg)
                  + _keypoint_checks(cfg, family))
    if cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads" or family == "cascade_c4":
        checks += _cascade_checks(family)
    if "SEMISUPNET" in cfg:  # the mean teacher builds the C4 detector only
        checks += (("SEMISUPNET.Trainer", lambda v: v == "default"),)
    groups = cfg.MODEL.RESNETS.NUM_GROUPS
    if any(cfg.MODEL.RESNETS.DEFORM_ON_PER_STAGE) and groups != 1 and family in ("fpn", "dc5", "panoptic"):
        raise NotImplementedError(
            f"MODEL.RESNETS.NUM_GROUPS = {groups!r} is not ported with deformable stages for "
            f"{_describe(cfg, family)}: JAX's deformable block asserts NUM_GROUPS == 1 and its init fails")
    for key, ok in checks:
        value = _lookup(cfg, key)
        if not ok(value):
            raise NotImplementedError(f"{key} = {value!r} is not ported for {_describe(cfg, family)}")
    if cfg.MODEL.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals" and not cfg.MODEL.LOAD_PROPOSALS:
        raise NotImplementedError("MODEL.LOAD_PROPOSALS = False is not ported with PROPOSAL_GENERATOR.NAME "
                                  "'PrecomputedProposals': the batches would carry no proposals")


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
# the mean teacher's two-crop loader draws with TrainingSampler whatever
# DATALOADER.SAMPLER_TRAIN says
_SUPPORTED_ATEACHER = (("DATALOADER.SAMPLER_TRAIN", lambda v: v == "TrainingSampler"),)


def _global_batches(cfg) -> Tuple[Tuple[str, int], ...]:
    """The global batches a step splits over the ranks: the mean teacher's
    labeled and unlabeled batches, else SOLVER.IMS_PER_BATCH."""
    if "SEMISUPNET" in cfg and cfg.SEMISUPNET.Trainer == "ateacher":
        return tuple((k, cfg.SOLVER[k]) for k in ("IMG_PER_BATCH_LABEL", "IMG_PER_BATCH_UNLABEL"))
    return (("IMS_PER_BATCH", cfg.SOLVER.IMS_PER_BATCH),)


def check_supported(cfg, world: Optional[int] = None) -> None:
    """Raises NotImplementedError naming the first key set to a value the
    port does not implement (the plain tower's own refusals after the
    shared ones; for the FPN family `_family_checks`). The port's only mesh is data parallelism over the
    processes: TPU.MESH_SHAPE is one data axis, [-1] or [k] for any k, since
    a JAX mesh of k devices computes the global batch's step as one process
    does; it is refused unless the world (the process group's size unless
    given) divides every global batch of the step."""
    if cfg.MODEL.META_ARCHITECTURE == "CLIPFastRCNN":
        raise NotImplementedError(
            "MODEL.META_ARCHITECTURE = 'CLIPFastRCNN' is not ported for training or the tools: JAX's trainer "
            "cannot build this arch either (the module has no init_all or cddmsl_losses); build it with "
            "models.build.build_clip_fast_rcnn")
    if cfg.MODEL.META_ARCHITECTURE == "RotatedFastRCNN":
        raise NotImplementedError(
            "MODEL.META_ARCHITECTURE = 'RotatedFastRCNN' is not ported for training or the tools: JAX's trainer "
            "cannot build this arch either (the module has no init_all or cddmsl_losses, and no mapper makes a "
            "RotatedDetBatch); build it with models.build.build_rotated_fast_rcnn")
    family = model_family(cfg)
    if family != "c4":
        _check_family(cfg, family)
    else:
        semisup = _SUPPORTED_SEMISUP if "SEMISUPNET" in cfg else ()
        if semisup and cfg.SEMISUPNET.Trainer == "ateacher":
            semisup += _SUPPORTED_ATEACHER
        checks = _SUPPORTED + semisup + _mask_checks(cfg) + _keypoint_checks(cfg, family)
        if cfg.MODEL.BACKBONE.NAME == D2_TOWER:
            checks += _SUPPORTED_D2
        else:
            checks += (("MODEL.RESNETS.DEPTH", lambda v: v in RESNET_SPECS),)
        for key, ok in checks:
            value = _lookup(cfg, key)
            if not ok(value):
                raise NotImplementedError(f"{key} = {value!r} is not ported")
        openset = cfg.MODEL.CLIP.OPENSET_TEST_NUM_CLASSES
        if openset and not (cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG and cfg.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER):
            # JAX asserts the first; the open-set rows replace the text classifier's
            raise NotImplementedError(f"MODEL.CLIP.OPENSET_TEST_NUM_CLASSES = {openset!r} is not ported without "
                                      "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG and MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER")
    world = comm.get_world_size() if world is None else world
    mesh = list(cfg.TPU.MESH_SHAPE)
    if len(mesh) != 1 or not (mesh[0] == -1 or mesh[0] >= 1):
        raise NotImplementedError(f"TPU.MESH_SHAPE = {mesh!r} is not ported: one data axis, [-1] or [k]")
    for key, batch in _global_batches(cfg):
        if batch % world:
            raise NotImplementedError(f"TPU.MESH_SHAPE = {mesh!r} is not ported for a world of {world} "
                                      f"process(es): it does not divide SOLVER.{key} = {batch}")


# what the pretraining entry (pretrain_net) reads, with the values it
# implements. JAX's tools/pretrain_net.py never reads MODEL.WEIGHTS or
# MODEL.CLIP.CONCEPT_POOL_EMB (the student, the teacher and the concept pool
# start from random) nor SOLVER.ACCUM_STEPS, and always pools grid regions:
# the port raises where those are set otherwise. Pipelining the text tower
# (TPU.PIPELINE_AXIS) is not ported.
_SUPPORTED_PRETRAIN: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.META_ARCHITECTURE", lambda v: v == "PretrainFastRCNN"),
    *_SUPPORTED_BACKBONE,
    ("MODEL.WEIGHTS", _falsy),
    ("MODEL.CLIP.CONCEPT_POOL_EMB", _falsy),
    ("MODEL.CLIP.CROP_REGION_TYPE", lambda v: v == "GRID"),
    ("SOLVER.ACCUM_STEPS", lambda v: v == 1),
    *_SUPPORTED_SOLVER,
    ("TPU.PIPELINE_AXIS", _falsy),
    *_SUPPORTED_DTYPE,
)


def check_pretrain_supported(cfg) -> None:
    """Raises NotImplementedError naming the first key the pretraining
    entry does not implement at its value (MODEL.META_ARCHITECTURE must be
    PretrainFastRCNN)."""
    for key, ok in _SUPPORTED_PRETRAIN:
        value = _lookup(cfg, key)
        if not ok(value):
            raise NotImplementedError(f"{key} = {value!r} is not ported for pretraining")


# what `build_clip_fast_rcnn` reads (JAX's models/build.py `build_clip_fast_rcnn`)
# and the keys the loaders read; every other MODEL key, and the tower's TPU
# overrides, must hold the value JAX's CLIPFastRCNN computes with: its
# default, or the one of `_CLIP_FAST_RCNN_FIXED`
_CLIP_FAST_RCNN_READ = (
    "MODEL.RESNETS.DEPTH", "MODEL.ROI_HEADS.NUM_CLASSES", "MODEL.CLIP.OFFLINE_RPN_NMS_THRESH", "MODEL.CLIP.CLSS_TEMP",
    "MODEL.CLIP.FOCAL_SCALED_LOSS", "MODEL.CLIP.BG_CLS_LOSS_WEIGHT", "MODEL.CLIP.NO_BOX_DELTA",
    "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "MODEL.ROI_HEADS.NMS_THRESH_TEST",
    "MODEL.PIXEL_MEAN", "MODEL.PIXEL_STD",
    # the loaders': the weights, the offline tower's file, the classifier rows, the eval batch
    "MODEL.WEIGHTS", "MODEL.CLIP.BB_RPN_WEIGHTS", "MODEL.CLIP.TEXT_EMB_PATH", "MODEL.CLIP.IMS_PER_BATCH_TEST",
)
_CLIP_FAST_RCNN_FIXED: Tuple[Tuple[str, Callable[[Any], bool]], ...] = (
    ("MODEL.META_ARCHITECTURE", lambda v: v == "CLIPFastRCNN"),
    ("MODEL.RESNETS.DEPTH", lambda v: v in RESNET_SPECS),
    # the module's classifier is always the text embeddings'
    ("MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER", lambda v: v is True),
    ("TPU.BACKBONE_LAYERS", _falsy),
    ("TPU.BACKBONE_WIDTH", _falsy),
    ("TPU.EMBED_DIM", _falsy),
    *_SUPPORTED_DTYPE,
)


def _leaves(node, prefix: str):
    for key, val in node.items():
        if isinstance(val, CfgNode):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def check_clip_fast_rcnn_supported(cfg) -> None:
    """Raises NotImplementedError naming the first key that JAX's
    CLIPFastRCNN would not compute with at its value: the builder's keys
    are taken as they are; every other MODEL key (JAX ignores
    MULTIPLY_RPN_SCORE, SOFT_NMS_ENABLED, ROI_HEADS.BATCH_SIZE_PER_IMAGE,
    RPN.* and the rest on this arch), TPU.BACKBONE_LAYERS / BACKBONE_WIDTH /
    EMBED_DIM and TPU.COMPUTE_DTYPE only at the value the module uses: its
    default, a text-embedding classifier, a CLIP tower of a ported depth."""
    fixed = dict(_CLIP_FAST_RCNN_FIXED)
    for key, ok in _CLIP_FAST_RCNN_FIXED:
        value = _lookup(cfg, key)
        if not ok(value):
            raise NotImplementedError(f"{key} = {value!r} is not ported for CLIPFastRCNN")
    for key, default in _leaves(get_cfg().MODEL, "MODEL."):
        if key in _CLIP_FAST_RCNN_READ or key in fixed:
            continue
        value = _lookup(cfg, key)
        if value != default and not (isinstance(default, (list, tuple)) and list(value) == list(default)):
            raise NotImplementedError(f"{key} = {value!r} is not ported for CLIPFastRCNN: JAX's module ignores "
                                      f"it and computes as with {default!r}")


def model_config_from_cfg(cfg) -> ModelConfig:
    """cfg -> ModelConfig, as `build_generalized_rcnn` reads it for the CLIP
    backbone (TPU.BACKBONE_LAYERS / BACKBONE_WIDTH / EMBED_DIM override the
    depth's spec), after `check_supported`. It reads the JAX package's tree
    as well as the port's."""
    check_supported(cfg)
    if model_family(cfg) != "c4":
        raise ValueError(f"{_describe(cfg, model_family(cfg))} is not a GeneralizedRCNN: build it with "
                         "models.build.build_detector")
    m, tpu = cfg.MODEL, cfg.TPU
    depth = m.RESNETS.DEPTH
    if m.BACKBONE.NAME == D2_TOWER:
        # res5 has 2048 channels, mean-pooled by the linear head
        tower, layers, width, embed_dim, resolution = "d2_resnet", D2_RESNET_SPECS[depth], 64, 2048, 224
    else:
        (layers, width), embed_dim, resolution = RESNET_SPECS[depth], EMBED_DIMS[depth], IMAGE_RESOLUTIONS[depth]
        tower = "clip"
    sizes = tuple(s for group in m.ANCHOR_GENERATOR.SIZES for s in (group if isinstance(group, (list, tuple)) else [group]))
    return ModelConfig(
        backbone_type=tower,
        backbone_depth=depth,
        backbone_layers=tuple(tpu.BACKBONE_LAYERS) or layers,
        backbone_width=tpu.BACKBONE_WIDTH or width,
        embed_dim=tpu.EMBED_DIM or embed_dim,
        input_resolution=resolution,
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
        cls_agnostic_bbox_reg=m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
        soft_nms_enabled=m.ROI_HEADS.SOFT_NMS_ENABLED,
        soft_nms_method=m.ROI_HEADS.SOFT_NMS_METHOD,
        soft_nms_sigma=m.ROI_HEADS.SOFT_NMS_SIGMA,
        soft_nms_prune=m.ROI_HEADS.SOFT_NMS_PRUNE,
        no_box_delta=m.CLIP.NO_BOX_DELTA,
        multiply_rpn_score=m.CLIP.MULTIPLY_RPN_SCORE,
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        region_consistency_boxes=tpu.REGION_CONSISTENCY_BOXES,
        v2l_image_size=tpu.V2L_IMAGE_SIZE,
        v2l_mapper_layers=tpu.V2L_MAPPER_LAYERS,
        v2l_mapper_tokens=tpu.V2L_MAPPER_TOKENS,
        compute_dtype=tpu.COMPUTE_DTYPE,
        mask_on=m.MASK_ON,
        mask_num_conv=m.ROI_MASK_HEAD.NUM_CONV,
        mask_conv_dim=m.ROI_MASK_HEAD.CONV_DIM,
        mask_cls_agnostic=m.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK,
        mask_canvas_stride=float(tpu.MASK_CANVAS_STRIDE),
        keypoint_on=m.KEYPOINT_ON,
        num_keypoints=m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS,
        keypoint_conv_dims=tuple(m.ROI_KEYPOINT_HEAD.CONV_DIMS),
        keypoint_loss_weight=m.ROI_KEYPOINT_HEAD.LOSS_WEIGHT,
        keypoint_loss_normalizer=keypoint_loss_normalizer(cfg),
    )


def keypoint_loss_normalizer(cfg) -> float:
    """-1 (divide by the visible keypoints) with
    NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS, else NUM_KEYPOINTS x
    BATCH_SIZE_PER_IMAGE x POSITIVE_FRACTION, as JAX's builders read it."""
    m = cfg.MODEL
    if m.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS:
        return -1.0
    return m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS * m.ROI_HEADS.BATCH_SIZE_PER_IMAGE * m.ROI_HEADS.POSITIVE_FRACTION


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
        nesterov=s.NESTEROV,
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
