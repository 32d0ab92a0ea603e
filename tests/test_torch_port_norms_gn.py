"""The GN Mask R-CNN in the port against cddmsl_tpu on the CPU (the
companion of test_torch_port_norms.py, which holds its tolerances and the
SyncBN model): two steps of a narrow FPN Mask R-CNN with GN through the
tower, the FPN, the conv box head and the mask head against JAX's
`make_train_step` (one JAX program), inference reading no state, and the
GN and SyncBN recipes (Misc/mask_rcnn_R_50_FPN_3x_{gn,syncbn}.yaml) at a
CPU's size through `DefaultTrainer`, with PreciseBN before the SyncBN
recipe's test.
"""

from pathlib import Path

import pytest
import torch

from cddmsl_torch.config import get_cfg
from cddmsl_torch.models.backbone.batch_norm import running_state, update_bn_stats
from test_torch_port_norms import assert_norm_steps_equal_jax, norm_step_runs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", params=["GN"])
def norm_runs(request):
    return norm_step_runs(request.param)


def test_norm_mask_rcnn_steps_equal_jax(norm_runs):
    assert_norm_steps_equal_jax(norm_runs)


def test_gn_holds_no_running_state_and_inference_moves_nothing(norm_runs):
    """GN keeps no statistics (no running state, no running_* tensor), and
    inference leaves every tensor as it was."""
    from test_torch_port_fpn import make_batch, torch_batch

    model = norm_runs["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not running_state(model) and not any(k.endswith(("running_mean", "running_var")) for k in before)
    model.inference(torch_batch(make_batch(1, 96, 160, [[96, 160]], [[96, 160]], seed=7)))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# ---------------- the recipes through the trainer ----------------
TINY_RECIPE = ["MODEL.ROI_HEADS.NUM_CLASSES", "2", "MODEL.RESNETS.DEPTH", "10", "TPU.BACKBONE_WIDTH", "8",
               "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
               "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32", "MODEL.RPN.PRE_NMS_TOPK_TEST", "48",
               "MODEL.RPN.POST_NMS_TOPK_TEST", "24", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
               "SOLVER.BASE_LR", "0.001", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.PRECISE_BN.NUM_ITER", "2",
               "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "160", "INPUT.MIN_SIZE_TEST", "96",
               "INPUT.MAX_SIZE_TEST", "160", "TPU.PAD_SIZE_TRAIN", "[96, 160]", "TPU.PAD_SIZE_TEST", "[96, 160]",
               "TPU.COMPUTE_DTYPE", "float32", "MODEL.CLIP.IMS_PER_BATCH_TEST", "2",
               # the heads at a CPU's width too (the recipes' 256-channel convs are most of the time)
               "MODEL.ROI_BOX_HEAD.CONV_DIM", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]


@pytest.mark.parametrize("norm", ["gn", "syncbn"])
def test_the_norm_recipes_train_and_test_through_the_trainer(tmp_path, norm):
    """Misc/mask_rcnn_R_50_FPN_3x_{gn,syncbn}.yaml at a CPU's size through
    `DefaultTrainer`: two steps and the test (bbox and segm). SyncBN's
    recipe runs PreciseBN before its test: inside `_precise_bn` the running
    state is `update_bn_stats` over the loader seeded SEED + 777 with the
    draws of SEED + 778 (each rank's rows of them), and after it the
    trainer's own EMA is back."""
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader
    from cddmsl_torch.data.datasets.coco import register_coco_instances
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_coco
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from cddmsl_torch.models.sampling import generator_draw

    json_path, images = make_synthetic_coco(str(tmp_path / "coco"), n=4, hw=(96, 160))
    register_coco_instances("port_test_norm_coco", json_path, images)
    try:
        cfg = get_cfg()
        cfg.merge_from_file(str(REPO / "configs" / "Misc" / f"mask_rcnn_R_50_FPN_3x_{norm}.yaml"))
        cfg.merge_from_list(["DATASETS.TRAIN", "('port_test_norm_coco',)", "DATASETS.TEST", "('port_test_norm_coco',)",
                             "OUTPUT_DIR", str(tmp_path / "out"), *TINY_RECIPE])
        trainer = DefaultTrainer(cfg, device="cpu")
        trainer.resume_or_load(resume=False)
        results = trainer.train()["port_test_norm_coco"]
        assert set(results) == {"bbox", "segm"}
        state = running_state(trainer.model)
        assert bool(state) == (norm == "syncbn") == cfg.TEST.PRECISE_BN.ENABLED
        if not state:
            return
        kept = {k: v.clone() for k, v in state.items()}
        with build_detection_train_loader(cfg, seed=777) as loader:
            batches = [next(loader) for _ in range(2)]
        g = torch.Generator()

        def forward(batch):
            g.manual_seed(778)
            trainer.model.cddmsl_losses(batch, generator_draw(g), False, True, False)

        want = update_bn_stats(trainer.model, forward, batches)
        with trainer._precise_bn(cfg, trainer.model):
            for k, v in state.items():
                assert torch.equal(v, want[k]), k
        assert all(torch.equal(v, kept[k]) for k, v in state.items())
        assert any(not torch.equal(want[k], kept[k]) for k in kept)
    finally:
        DatasetCatalog._registry.pop("port_test_norm_coco", None)
        MetadataCatalog._registry.pop("port_test_norm_coco", None)
