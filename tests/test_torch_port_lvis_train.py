"""LVIS training in the port against cddmsl_tpu on the CPU: the
RepeatFactorTrainingSampler's index stream (DATALOADER.SAMPLER_TRAIN,
REPEAT_THRESHOLD) against JAX's, index for index; the Mask R-CNN over
CLIP's ModifiedResNet under the FPN (MODEL.BACKBONE.NAME
build_clip_resnet_fpn_backbone, the RegionCLIP LVIS transfer recipe):
its maps, losses and gradient against JAX's FPNRCNN, the frozen stem and
res2 (FREEZE_AT 2 reaches the CLIP tower under the FPN, as in JAX); and two
steps of LVISv1-InstanceSegmentation/mask_rcnn_CLIP_R_50_FPN_1x.yaml through
`train_net` on the CPU over a small LVIS fixture, ending in the LVIS box
evaluation.

One JAX program: the CLIP FPN detector's losses and gradient, and its
maps, at the tests' width (the CLIP tower of (1, 1, 1, 1) blocks and width
16 under an FPN of 32, 20 classes, a mask head of 2 convs of 16) on two
96x160 images (the second padded from 80x128), with JAX's draws.
Tolerances: the stream exactly; the maps within 1e-4 of their largest
magnitude and the losses within rtol 1e-5; the gradient within 1e-4 of
each tensor's largest (test_torch_port_fpn.py's GRAD_RTOL: the same
towers' float order), as the FPN tests hold the plain tower's.
"""

import json
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.data.build import RepeatFactorTrainingSampler as JaxRepeatFactorTrainingSampler
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_tpu.solver.build import trainable_mask
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import get_cfg, solver_config_from_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.build import RepeatFactorTrainingSampler, train_sampler
from cddmsl_torch.engine.defaults import default_argument_parser
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_fpn import BATCH_A, GRAD_RTOL, K, assert_grads_match, torch_batch
from test_torch_port_lvis import write_lvis_fixture
from test_torch_port_mask_rcnn import diamond_canvases
from test_torch_port_norms import filled_variables
from torch_goldens import supervised_draw, torch_threads

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CLIP_PIXELS = dict(pixel_mean=(0.48145466, 0.4578275, 0.40821073), pixel_std=(0.26862954, 0.26130258, 0.27577711))
CLIP_FPN = dict(num_classes=K, backbone_type="clip", clip_layers=(1, 1, 1, 1), backbone_width=16,
                fpn_out_channels=32, fc_dim=64, emb_dim=48, rpn_pre_nms_topk=(64, 48), rpn_post_nms_topk=(32, 24),
                roi_batch_size_per_image=32, mask_on=True, mask_num_conv=2, mask_conv_dim=16, **CLIP_PIXELS)
MAP_RTOL, LOSS_RTOL = 1e-4, 1e-5


# ---------------- the sampler ----------------
def skewed_dicts(n=40, cats=12, seed=0):
    """Dataset dicts whose categories follow a long tail: category c in
    about n / (c + 1) images, some images without annotations."""
    r = np.random.RandomState(seed)
    dicts = []
    for i in range(n):
        present = [c for c in range(cats) if r.rand() < 1.0 / (c + 1)]
        dicts.append({"image_id": i, "annotations": [{"category_id": 5 * c + 1} for c in present]})
    return dicts


@pytest.mark.parametrize("thresh, seed", [(0.001, 0), (0.3, 7), (1.0, 3)])
def test_repeat_factor_stream_equals_jax(thresh, seed):
    """The first 1000 indices of the stream (several epochs: one rand(n)
    for the rounding, then a permutation, per epoch, from one RandomState)
    and the repeat factors themselves."""
    dicts = skewed_dicts()
    ours, ref = RepeatFactorTrainingSampler(dicts, thresh, seed=seed), JaxRepeatFactorTrainingSampler(dicts, thresh,
                                                                                                     seed=seed)
    np.testing.assert_array_equal(ours.repeat_factors, ref._rep)
    got, want = iter(ours), iter(ref)
    assert [next(got) for _ in range(1000)] == [next(want) for _ in range(1000)]
    assert (ours.repeat_factors > 1).any() == (thresh > 0.03)


def test_the_config_picks_the_sampler():
    cfg = get_cfg()
    dicts = skewed_dicts()
    assert type(train_sampler(cfg, dicts, 0)).__name__ == "TrainingSampler"
    cfg.merge_from_list(["DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler", "DATALOADER.REPEAT_THRESHOLD",
                         "0.3"])
    sampler = train_sampler(cfg, dicts, 5)
    assert isinstance(sampler, RepeatFactorTrainingSampler) and sampler.seed == 5


# ---------------- the CLIP tower under the FPN ----------------
@pytest.fixture(scope="module")
def clip_fpn_runs():
    """JAX's gradient of `supervised_losses` on batch A with canvases and
    its p2..p6; the port's from the converted tree with JAX's draws."""
    jb = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)))
    model, ours = JaxFPNRCNN(**CLIP_FPN), FPNRCNN(**CLIP_FPN)
    variables = filled_variables(model, jb, seed=4)
    rng = jax.random.PRNGKey(13)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    def maps(m, b):
        return m._features(b.image)[1]

    (grads, losses), levels = jax.jit(lambda p, b, r: (jax.grad(total, has_aux=True)(p, b, r),
                                                        model.apply(p, b, method=maps)))(variables, jb, rng)
    ours.load_state_dict(convert_jax_params(variables), strict=True)
    tb = torch_batch(jb, gt_masks=torch.from_numpy(np.array(jb.gt_masks)))
    with torch.no_grad():
        got_levels = ours.features(tb.image)[1]
    with torch.enable_grad():
        got = ours.supervised_losses(tb, supervised_draw(rng))
        sum(got.values()).backward()
    return dict(levels=(levels, got_levels), losses=(losses, got), grads=convert_jax_params(grads), model=ours,
                variables=variables)


def test_clip_fpn_maps_equal_jax(clip_fpn_runs):
    """p2..p6 over the CLIP tower's res2..res5 (CLIP's pixel statistics on
    [0, 1]); the tower has no attention pool here, as JAX's tree."""
    want, got = clip_fpn_runs["levels"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=MAP_RTOL * np.abs(w).max())
    assert clip_fpn_runs["model"].backbone.bottom_up.attnpool is None
    assert "attnpool" not in clip_fpn_runs["variables"]["params"]["backbone"]


def test_clip_fpn_losses_and_gradient_equal_jax(clip_fpn_runs):
    want, got = clip_fpn_runs["losses"]
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=LOSS_RTOL, err_msg=k)
    assert_grads_match(clip_fpn_runs["model"], clip_fpn_runs["grads"], rtol=GRAD_RTOL)


def test_freeze_at_reaches_the_clip_tower_under_the_fpn(clip_fpn_runs):
    """FREEZE_AT 2 freezes the CLIP stem and layer1 under the FPN (JAX's
    `backbone` beside its `fpn`), as JAX's `trainable_mask` does."""
    variables = clip_fpn_runs["variables"]
    mask = trainable_mask({"params": variables["params"]}, freeze_at=2, use_text_emb=False)
    as_arrays = jax.tree_util.tree_map(lambda m, a: np.full(np.shape(a), m, np.float32), mask,
                                       {"params": variables["params"]})
    want = {k for k, v in convert_jax_params(as_arrays).items() if bool(v.flatten()[0])}
    ours = FPNRCNN(**CLIP_FPN)
    build_optimizer(ours, solver_config_from_cfg(get_cfg()))
    got = {n for n, p in ours.named_parameters() if p.requires_grad}
    assert got == want
    assert "backbone.bottom_up.layer1.0.conv1.weight" not in got and "backbone.bottom_up.layer2.0.conv1.weight" in got


# ---------------- the LVIS recipe through train_net ----------------
TINY_LVIS = [
    "TPU.BACKBONE_WIDTH", "16", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "16",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32", "MODEL.RPN.PRE_NMS_TOPK_TEST", "48", "MODEL.RPN.POST_NMS_TOPK_TEST", "24",
    "TEST.DETECTIONS_PER_IMAGE", "50", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2", "SOLVER.BASE_LR", "0.001",
    "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", "MODEL.CLIP.IMS_PER_BATCH_TEST", "2",
    "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "160", "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "160", "TPU.PAD_SIZE_TRAIN", "[96, 160]", "TPU.PAD_SIZE_TEST", "[96, 160]",
    "TPU.COMPUTE_DTYPE", "float32",
]


def test_two_lvis_steps_through_train_net(tmp_path, monkeypatch):
    """The CLIP FPN LVIS recipe at the tests' width (TPU.BACKBONE_WIDTH 16,
    the RegionCLIP tower's (3, 4, 6, 3) blocks, 1203 classes) over an LVIS
    fixture registered as lvis_v1_train / lvis_v1_val: two steps drawn by
    the RepeatFactor sampler at 0.001, finite losses with loss_mask, the
    save, and the LVIS evaluation (of the boxes: JAX's LVIS evaluator
    scores no masks, nor does the port's)."""
    root = tmp_path / "datasets"
    path, _ = write_lvis_fixture(root)
    (root / "lvis").mkdir()
    for split in ("train", "val"):
        shutil.copy(path, root / "lvis" / f"lvis_v1_{split}.json")
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    names = [f"lvis_v1_{s}" for s in ("train", "val")]
    for name in names:  # registered afresh from this root by train_net's register_all
        DatasetCatalog._registry.pop(name, None)
        MetadataCatalog._registry.pop(name, None)
    config = REPO / "configs" / "LVISv1-InstanceSegmentation" / "mask_rcnn_CLIP_R_50_FPN_1x.yaml"
    args = default_argument_parser().parse_args(
        ["--device", "cpu", "--config-file", str(config), "OUTPUT_DIR", str(tmp_path / "out"), *TINY_LVIS])
    try:
        with torch_threads(2):
            results = train_net.main(args)
    finally:
        for name in names:
            DatasetCatalog._registry.pop(name, None)
            MetadataCatalog._registry.pop(name, None)
    (test_set, res), = results.items()
    assert test_set == "lvis_v1_val" and set(res) == {"bbox"}  # both packages' LVIS evaluators score boxes only
    assert all(math.isnan(v) or math.isfinite(v) for task in res.values() for v in task.values())
    last = json.loads((tmp_path / "out" / "metrics.json").read_text().splitlines()[-1])
    assert {"loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls"} <= set(last)
    assert all(math.isfinite(v) for k, v in last.items() if "loss" in k)
    assert (tmp_path / "out" / "model_final.pth").exists()


# ---------------- the census ----------------
# the YAML files the port still refuses, with the key each names: CLIPFastRCNN (JAX's trainer cannot build
# it), the plain C4 files held by the caption consistency, the X-152 32x8d deformable tower (JAX's deformable
# block fails at init with 32 groups) and the rotated boxes (JAX's trainer cannot build RotatedFastRCNN)
CENSUS_REFUSED = {
    "COCO-Detection/faster_rcnn_R_50_C4_1x.yaml": "TPU.ENABLE_CAPTION_CONSISTENCY",
    "COCO-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_ovd.yaml": "MODEL.META_ARCHITECTURE",
    "COCO-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_ovd_coco80.yaml": "MODEL.META_ARCHITECTURE",
    "COCO-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_ovd_testb.yaml": "MODEL.META_ARCHITECTURE",
    "COCO-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_ovd_testt.yaml": "MODEL.META_ARCHITECTURE",
    "COCO-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_ovd_zsinf.yaml": "MODEL.META_ARCHITECTURE",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml": "TPU.ENABLE_CAPTION_CONSISTENCY",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x_ovd_FSD.yaml": "TPU.ENABLE_CAPTION_CONSISTENCY",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x_ovd_coco65.yaml": "TPU.ENABLE_CAPTION_CONSISTENCY",
    "COCO-Keypoints/keypoint_rcnn_R_50_C4_1x.yaml": "TPU.ENABLE_CAPTION_CONSISTENCY",
    "LVISv1-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4.yaml": "MODEL.META_ARCHITECTURE",
    "LVISv1-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_custom_img.yaml": "MODEL.META_ARCHITECTURE",
    "LVISv1-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_zsinf.yaml": "MODEL.META_ARCHITECTURE",
    "LVISv1-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml": "TPU.ENABLE_CAPTION_CONSISTENCY",
    "Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml": "MODEL.RESNETS.NUM_GROUPS",
    "Misc/rotated_faster_rcnn.yaml": "MODEL.META_ARCHITECTURE",
}
CENSUS = sorted(str(p.relative_to(REPO / "configs")) for p in (REPO / "configs").rglob("*.yaml"))


def test_the_census_is_100_of_120():
    """104 of the 120 since Cityscapes' instance sets (the name is the census's at its first count)."""
    assert len(CENSUS) == 120 and set(CENSUS_REFUSED) <= set(CENSUS) and len(CENSUS) - len(CENSUS_REFUSED) == 104


@pytest.mark.parametrize("path", CENSUS)
def test_each_config_is_accepted_or_refused_naming_its_key(path):
    """Every YAML file of configs/ through the port's check at world 1 (the
    pretraining entry's for PretrainFastRCNN; the mean-teacher block added
    as train_net adds it): accepted, or NotImplementedError naming its key."""
    from cddmsl_torch.config import add_ateacher_config, check_pretrain_supported, check_supported

    cfg = get_cfg()
    add_ateacher_config(cfg)

    def check():
        cfg.merge_from_file(str(REPO / "configs" / path))
        if cfg.MODEL.META_ARCHITECTURE == "PretrainFastRCNN":
            check_pretrain_supported(cfg)
        else:
            check_supported(cfg, world=1)

    if path in CENSUS_REFUSED:
        with pytest.raises(NotImplementedError, match=CENSUS_REFUSED[path].replace(".", r"\.")):
            check()
    else:
        check()
