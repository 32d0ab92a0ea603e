"""The mean-teacher configuration block (the port's copy of
cddmsl_tpu/config/ateacher.py `add_ateacher_config`): SEMISUPNET, the two
streams' batch sizes, the labeled and unlabeled dataset splits and the EMA
settings of the semi-supervised loop. `train_net.setup` adds it to the tree,
as the JAX package's does.

The keys the JAX trainer never reads (TEST.VAL_LOSS, TEST.EVALUATOR,
MODEL.RPN.UNSUP_LOSS_WEIGHT, SOLVER.FACTOR_LIST, SEMISUPNET.MLP_DIM,
EMAMODEL.SUP_CONSIST) are held so that a file naming them merges; a value of
a key the trainer reads that it does not implement raises in
`check_supported`.
"""

from .cfg_node import CfgNode


def add_ateacher_config(cfg: CfgNode) -> None:
    _C = cfg

    _C.TEST.VAL_LOSS = True

    _C.MODEL.RPN.UNSUP_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.LOSS = "CrossEntropy"
    _C.MODEL.ROI_HEADS.LOSS = "CrossEntropy"

    _C.SOLVER.IMG_PER_BATCH_LABEL = 1
    _C.SOLVER.IMG_PER_BATCH_UNLABEL = 1
    _C.SOLVER.FACTOR_LIST = (1,)

    _C.DATASETS.TRAIN_LABEL = ("coco_2017_train",)
    _C.DATASETS.TRAIN_UNLABEL = ("coco_2017_train",)
    _C.DATASETS.CROSS_DATASET = True
    _C.TEST.EVALUATOR = "COCOeval"

    _C.SEMISUPNET = CfgNode()
    _C.SEMISUPNET.MLP_DIM = 128
    # "default" selects DefaultTrainer; mean-teacher configs set "ateacher"
    _C.SEMISUPNET.Trainer = "default"
    _C.SEMISUPNET.BBOX_THRESHOLD = 0.8
    _C.SEMISUPNET.PSEUDO_BBOX_SAMPLE = "thresholding"
    _C.SEMISUPNET.TEACHER_UPDATE_ITER = 1
    _C.SEMISUPNET.BURN_UP_STEP = 12000
    _C.SEMISUPNET.EMA_KEEP_RATE = 0.9996
    _C.SEMISUPNET.UNSUP_LOSS_WEIGHT = 0.5
    _C.SEMISUPNET.SUP_LOSS_WEIGHT = 1.0
    _C.SEMISUPNET.LOSS_WEIGHT_TYPE = "standard"
    _C.SEMISUPNET.DIS_TYPE = "res4"
    _C.SEMISUPNET.DIS_LOSS_WEIGHT = 0.1
    # [count, precision, precision_tol]: the final teacher's pseudo-labels on
    # the first weak unlabeled batch, checked at the end of train()
    _C.SEMISUPNET.EXPECTED_PSEUDO = []

    _C.EMAMODEL = CfgNode()
    _C.EMAMODEL.SUP_CONSIST = True

    _C.DATALOADER.SUP_PERCENT = 100.0
    _C.DATALOADER.RANDOM_DATA_SEED = 0
    _C.DATALOADER.RANDOM_DATA_SEED_PATH = "dataseed/COCO_supervision.txt"
