"""The port's default configuration tree: the keys of
cddmsl_tpu/config/defaults.py that the port reads or checks, with the same
defaults. `config.check_supported` raises for a value the port does not
implement; a key that is not here raises when a file or an override sets it
(`cfg_node.py`).

Two TPU keys are accepted with either value and change nothing here:
TPU.REMAT_BACKBONE (activation recomputation: memory, not results) and
TPU.FAST_INIT (how the JAX package fills its initial parameters; the port
always fills them with `init_random_`).
"""

from .cfg_node import CfgNode


def get_cfg() -> CfgNode:
    """A fresh copy of the default tree."""
    _C = CfgNode()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1

    _C.MODEL = CfgNode()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    _C.MODEL.KD_REGULRAZIATION = True  # (sic) the reference's key name
    _C.MODEL.PRE_TRAINED_RCLIP_PATH = ""
    _C.MODEL.VISION_TO_LANG_PATH = ""
    # "" or a branch: "image" / "image_region" add the language-free InfoNCE
    # to the step, "caption_pl_img" / "caption_pl_region" run the
    # pseudo-label caption step after it (a second update per iteration)
    _C.MODEL.CONSISTENCY_BRANCH = ""
    _C.MODEL.CONSISTENCY_LOSS_WEIGHT = 0.1
    _C.MODEL.CAPTION_PL_LOSS = "pseudo_label"  # or "kl"
    _C.MODEL.CAPTION_PL_MAX_LEN = 20
    _C.MODEL.CAPTION_GPT2_PATH = ""  # an HF GPT-2 state dict for the pl decoder

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_clip_resnet_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    # the plain tower's (build_resnet_backbone) shape keys: JAX's
    # GeneralizedRCNN builds D2ResNet from DEPTH alone, so each is accepted
    # only at the value that tower has
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
    # DCN v2 (a mask beside the offsets); JAX's deformable blocks take one
    # offset group, whatever DEFORM_NUM_GROUPS says
    _C.MODEL.RESNETS.DEFORM_MODULATED = False
    _C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

    # the FPN family (build_resnet_fpn_backbone): the lateral and output
    # convs' width; JAX's FPNRCNN always takes res2..res5 and adds p6
    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = []
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    # RetinaNet (MODEL.META_ARCHITECTURE RetinaNet): JAX's build_retinanet
    # reads all but IN_FEATURES, NUM_CONVS, PRIOR_PROB and BBOX_REG_WEIGHTS
    _C.MODEL.RETINANET = CfgNode()
    _C.MODEL.RETINANET.NUM_CLASSES = 80
    _C.MODEL.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    _C.MODEL.RETINANET.NUM_CONVS = 4
    _C.MODEL.RETINANET.IOU_THRESHOLDS = [0.4, 0.5]
    _C.MODEL.RETINANET.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RETINANET.PRIOR_PROB = 0.01
    _C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
    _C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
    _C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
    _C.MODEL.RETINANET.BBOX_REG_WEIGHTS = [1.0, 1.0, 1.0, 1.0]
    _C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
    _C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
    _C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1
    _C.MODEL.RETINANET.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RETINANET.NORM = ""

    # "RPN", or "PrecomputedProposals" (proposals from DATASETS.PROPOSAL_FILES_*)
    _C.MODEL.PROPOSAL_GENERATOR = CfgNode()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"

    _C.MODEL.ANCHOR_GENERATOR = CfgNode()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]

    _C.MODEL.RPN = CfgNode()
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0

    _C.MODEL.ROI_HEADS = CfgNode()
    _C.MODEL.ROI_HEADS.NAME = "CLIPRes5ROIHeads"
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.SOFT_NMS_ENABLED = False
    _C.MODEL.ROI_HEADS.SOFT_NMS_METHOD = "gaussian"  # or "linear", "hard"
    _C.MODEL.ROI_HEADS.SOFT_NMS_SIGMA = 0.5
    _C.MODEL.ROI_HEADS.SOFT_NMS_PRUNE = 0.001

    _C.MODEL.ROI_BOX_HEAD = CfgNode()
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    # the C4 head has no fc (NUM_FC 0); the FPN family's box head has
    # NUM_FC fcs (0 meaning 2, as JAX's builder reads it) of FC_DIM, then
    # one of 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    _C.MODEL.ROI_BOX_HEAD.NAME = ""
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.NORM = ""
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0

    # the mask head (MODEL.MASK_ON); JAX's modules pool 14x14 with 2x2
    # samples, aligned, whatever the pooler keys say
    _C.MODEL.ROI_MASK_HEAD = CfgNode()
    _C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_MASK_HEAD.NORM = ""
    _C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
    _C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"

    # the semantic head (PanopticFPN, SemanticSegmentor) and the panoptic
    # combine; NORM defaults to GN, as in JAX
    _C.MODEL.SEM_SEG_HEAD = CfgNode()
    _C.MODEL.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
    _C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
    _C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
    _C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
    _C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
    _C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0
    _C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    _C.MODEL.SEM_SEG_HEAD.NORM = "GN"
    _C.MODEL.PANOPTIC_FPN = CfgNode()
    _C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
    _C.MODEL.PANOPTIC_FPN.COMBINE = CfgNode()
    _C.MODEL.PANOPTIC_FPN.COMBINE.ENABLED = True
    _C.MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH = 0.5
    _C.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 4096
    _C.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5

    # the cascade's stages (ROI_HEADS.NAME CascadeROIHeads): the IoU each
    # stage matches at and its box transform's weights
    _C.MODEL.ROI_BOX_CASCADE_HEAD = CfgNode()
    _C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = [0.5, 0.6, 0.7]
    _C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = [
        [10.0, 10.0, 5.0, 5.0],
        [20.0, 20.0, 10.0, 10.0],
        [30.0, 30.0, 15.0, 15.0],
    ]

    # the keypoint head (MODEL.KEYPOINT_ON): CONV_DIMS 3x3 convs, a 4x4
    # stride-2 deconv and a 2x bilinear upsample; the loss divides by the
    # visible keypoints, or without NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS by
    # images x NUM_KEYPOINTS x BATCH_SIZE_PER_IMAGE x POSITIVE_FRACTION
    _C.MODEL.ROI_KEYPOINT_HEAD = CfgNode()
    _C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [512] * 8
    _C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
    _C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"
    # training images with fewer visible keypoints are dropped
    _C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
    _C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True

    _C.MODEL.CLIP = CfgNode()
    _C.MODEL.CLIP.CROP_REGION_TYPE = "RPN"
    _C.MODEL.CLIP.BB_RPN_WEIGHTS = None
    _C.MODEL.CLIP.IMS_PER_BATCH_TEST = 8
    _C.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER = False
    _C.MODEL.CLIP.TEXT_EMB_PATH = None
    _C.MODEL.CLIP.NO_BOX_DELTA = False
    _C.MODEL.CLIP.BG_CLS_LOSS_WEIGHT = None
    _C.MODEL.CLIP.MULTIPLY_RPN_SCORE = False
    # the open-set test head: evaluate with this many classes, their text
    # embeddings from OPENSET_TEST_TEXT_EMB_PATH (class-agnostic boxes only)
    _C.MODEL.CLIP.OPENSET_TEST_NUM_CLASSES = None
    _C.MODEL.CLIP.OPENSET_TEST_TEXT_EMB_PATH = None
    _C.MODEL.CLIP.CLSS_TEMP = 0.01
    _C.MODEL.CLIP.FOCAL_SCALED_LOSS = None
    # CLIPFastRCNN's frozen offline RPN: its NMS threshold
    _C.MODEL.CLIP.OFFLINE_RPN_NMS_THRESH = 0.9
    # region-language pretraining (PretrainFastRCNN, read by pretrain_net):
    # the concept pool, the grid regions' unused count, the distillation
    # threshold and the caption tower's dims
    _C.MODEL.CLIP.PRETRAIN_NUM_CONCEPTS = 1000
    _C.MODEL.CLIP.PRETRAIN_SAMPLE_REGIONS = None
    _C.MODEL.CLIP.CONCEPT_THRES = None
    _C.MODEL.CLIP.CONCEPT_POOL_EMB = None
    _C.MODEL.CLIP.TEXT_VOCAB_SIZE = 49408
    _C.MODEL.CLIP.TEXT_CONTEXT_LENGTH = 77
    _C.MODEL.CLIP.TEXT_WIDTH = 512
    _C.MODEL.CLIP.TEXT_HEADS = 8
    _C.MODEL.CLIP.TEXT_LAYERS = 12

    # the text tower of extract_concept_features (its width and heads
    # follow MODEL.RESNETS.DEPTH: WIDTH and HEADS are not read)
    _C.MODEL.TEXT_ENCODER = CfgNode()
    _C.MODEL.TEXT_ENCODER.CONTEXT_LENGTH = 77
    _C.MODEL.TEXT_ENCODER.VOCAB_SIZE = 49408
    _C.MODEL.TEXT_ENCODER.WIDTH = 512
    _C.MODEL.TEXT_ENCODER.HEADS = 8
    _C.MODEL.TEXT_ENCODER.LAYERS = 12

    _C.INPUT = CfgNode()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.CROP = CfgNode()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]
    _C.INPUT.FORMAT = "BGR"

    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()
    # precomputed proposals (MODEL.LOAD_PROPOSALS): one file per set, and
    # the top-k by objectness each image keeps
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000

    _C.DATALOADER = CfgNode()
    _C.DATALOADER.NUM_WORKERS = 4  # the prefetch depth of the train loader
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"  # or "RepeatFactorTrainingSampler" (LVIS)
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    _C.SOLVER = CfgNode()
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001  # decay stays uniform, as in the JAX package
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.CHECKPOINT_PERIOD = 1000
    _C.SOLVER.CHECKPOINT_MAX_TO_KEEP = 0
    _C.SOLVER.ACCUM_STEPS = 1
    _C.SOLVER.CLIP_GRADIENTS = CfgNode()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CAPTION_BURNUP_ITERS = 10000

    _C.TEST = CfgNode()
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.KEYPOINT_OKS_SIGMAS = []  # where set, over the test set's metadata sigmas
    _C.TEST.AUG = CfgNode()
    _C.TEST.AUG.ENABLED = False
    _C.TEST.PRECISE_BN = CfgNode()
    _C.TEST.PRECISE_BN.ENABLED = False
    _C.TEST.PRECISE_BN.NUM_ITER = 200

    _C.TPU = CfgNode()
    _C.TPU.MESH_SHAPE = [-1]
    _C.TPU.SPATIAL_PARTITION = False
    _C.TPU.FSDP = False
    _C.TPU.PIPELINE_AXIS = ""
    _C.TPU.MOE = CfgNode()
    _C.TPU.MOE.NUM_EXPERTS = 0
    _C.TPU.QUANT_EVAL = False
    _C.TPU.ASYNC_CHECKPOINT = False
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.MAX_GT_BOXES = 100
    _C.TPU.MASK_CANVAS_STRIDE = 4  # the ground-truth mask canvases' stride (MASK_ON)
    _C.TPU.PAD_SIZE_TRAIN = [800, 1344]
    _C.TPU.PAD_SIZE_TEST = [800, 1344]
    _C.TPU.PAD_BUCKETS = []
    _C.TPU.REGION_CONSISTENCY_BOXES = 16
    _C.TPU.V2L_IMAGE_SIZE = 224
    _C.TPU.ENABLE_CAPTION_CONSISTENCY = True
    _C.TPU.REMAT_BACKBONE = True
    _C.TPU.FAST_INIT = False
    _C.TPU.BACKBONE_LAYERS = []
    _C.TPU.BACKBONE_WIDTH = 0
    _C.TPU.EMBED_DIM = 0
    _C.TPU.V2L_MAPPER_LAYERS = 8
    _C.TPU.V2L_MAPPER_TOKENS = 40
    # GPT-2 of the caption_pl decoder: HF gpt2's dims
    _C.TPU.GPT2_VOCAB = 50257
    _C.TPU.GPT2_POSITIONS = 1024
    _C.TPU.GPT2_EMBD = 768
    _C.TPU.GPT2_LAYERS = 12
    _C.TPU.GPT2_HEADS = 12
    return _C
