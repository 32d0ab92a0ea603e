"""The JAX package's six CDDMSL instant schedules through the port's
`train_net` on the CPU (configs/quick_schedules/*_instant_test.yaml: the
tiny CLIP detector with the linear classifier, batch 8, TPU.MESH_SHAPE [8]
in one process; the plain step with the caption branches from step 3, the
mean teacher, the image and image_region branches, the caption
pseudo-label branches on a tiny GPT-2). They pin no metric: each finishes
with finite losses, saves model_final and ends in a test pass. The port's
own seeded weights and draws (no JAX program)."""

import json
import math

import pytest

from torch_goldens import run_schedule, schedules_fixture

SCHEDULES = {
    "rcnn_instant_test.yaml": ("cont_loss", "cont_loss_region"),  # the VOC recipe: KD off
    "mt_rcnn_instant_test.yaml": ("loss_cls_pseudo", "loss_rpn_cls_pseudo", "loss_D"),
    "rcnn_consistency_image_instant_test.yaml": ("image_cont_loss",),
    "rcnn_consistency_image_region_instant_test.yaml": ("image_region_cont_loss",),
    "rcnn_caption_pl_instant_test.yaml": ("token-pl_loss",),
    "rcnn_caption_pl_region_instant_test.yaml": ("token-pl-region_loss",),
}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    with schedules_fixture(tmp_path_factory.mktemp("instant") / "fixture") as root:
        yield root


@pytest.mark.parametrize("name", SCHEDULES)
def test_instant_schedule_trains_and_tests(name, fixture_root, tmp_path):
    results = run_schedule(name, tmp_path)
    (test_set, res), = results.items()
    assert test_set == "synthetic_voc_test" and all(math.isfinite(v) for v in res["bbox"].values())
    last = json.loads((tmp_path / "metrics.json").read_text().splitlines()[-1])
    losses = {k: v for k, v in last.items() if "loss" in k}
    assert set(SCHEDULES[name]) <= losses.keys() and {"loss_cls", "loss_rpn_cls", "total_loss"} <= losses.keys()
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert (tmp_path / "model_final.pth").exists()
