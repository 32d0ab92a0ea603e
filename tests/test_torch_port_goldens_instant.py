"""The JAX package's CDDMSL instant schedules and its panoptic and semantic
ones through the port's `train_net` on the CPU
(configs/quick_schedules/*_instant_test.yaml): the six of the tiny CLIP
detector with the linear classifier, batch 8, TPU.MESH_SHAPE [8] in one
process (the plain step with the caption branches from step 3, the mean
teacher, the image and image_region branches, the caption pseudo-label
branches on a tiny GPT-2), Panoptic FPN at depth 10 over the synthetic
panoptic fixture (PQ), the semantic segmentor over the stripes fixture
(mIoU) and RetinaNet at depth 10 (VOC AP of its focal-loss detections). They pin no metric: each finishes with finite losses, saves
model_final and ends in a test pass; the panoptic and semantic schedules
then evaluate again with `--eval-only` from model_final, with the same
results. The port's own seeded weights and draws (no JAX program)."""

import json
import math

import pytest

from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.datasets.synthetic import register_synthetic_panoptic, register_synthetic_semseg
from torch_goldens import run_schedule, schedules_fixture

VOC = ("synthetic_voc_test", "bbox", ("loss_cls", "loss_rpn_cls"))
# schedule -> (its test set, its task, the losses it must log beside total_loss)
SCHEDULES = {
    "rcnn_instant_test.yaml": VOC[:2] + (VOC[2] + ("cont_loss", "cont_loss_region"),),  # the VOC recipe: KD off
    "mt_rcnn_instant_test.yaml": VOC[:2] + (VOC[2] + ("loss_cls_pseudo", "loss_rpn_cls_pseudo", "loss_D"),),
    "rcnn_consistency_image_instant_test.yaml": VOC[:2] + (VOC[2] + ("image_cont_loss",),),
    "rcnn_consistency_image_region_instant_test.yaml": VOC[:2] + (VOC[2] + ("image_region_cont_loss",),),
    "rcnn_caption_pl_instant_test.yaml": VOC[:2] + (VOC[2] + ("token-pl_loss",),),
    "rcnn_caption_pl_region_instant_test.yaml": VOC[:2] + (VOC[2] + ("token-pl-region_loss",),),
    "panoptic_fpn_instant_test.yaml": ("synthetic_panoptic_val", "panoptic_seg",
                                       ("loss_cls", "loss_rpn_cls", "loss_box_reg", "loss_sem_seg")),
    "semantic_R_50_FPN_instant_test.yaml": ("synthetic_semseg_val", "sem_seg", ("loss_sem_seg",)),
    "retinanet_R_50_FPN_instant_test.yaml": VOC[:2] + (("loss_cls", "loss_box_reg"),),
}
SEGMENTATION_SETS = [f"synthetic_{kind}_{split}" for kind in ("panoptic", "semseg") for split in ("train", "val")]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("instant")
    register_synthetic_panoptic(str(root / "segmentation"))
    register_synthetic_semseg(str(root / "segmentation"))
    try:
        with schedules_fixture(root / "fixture") as voc_root:
            yield voc_root
    finally:
        for name in SEGMENTATION_SETS:
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)


@pytest.mark.parametrize("name", SCHEDULES)
def test_instant_schedule_trains_and_tests(name, fixture_root, tmp_path):
    want_set, task, names = SCHEDULES[name]
    results = run_schedule(name, tmp_path)
    (test_set, res), = results.items()
    assert test_set == want_set and all(math.isfinite(v) for v in res[task].values())
    last = json.loads((tmp_path / "metrics.json").read_text().splitlines()[-1])
    losses = {k: v for k, v in last.items() if "loss" in k}
    assert set(names) | {"total_loss"} <= losses.keys()
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert (tmp_path / "model_final.pth").exists()
    if task != "bbox":
        again = run_schedule(name, tmp_path / "eval", "MODEL.WEIGHTS", str(tmp_path / "model_final.pth"),
                             eval_only=True)
        assert again == results
