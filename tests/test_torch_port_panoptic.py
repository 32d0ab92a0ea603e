"""Panoptic FPN in the port against cddmsl_tpu on the CPU: the whole
`PanopticFPN` (the tower, the RPN on p2, the standard heads with masks, the
semantic head with GN), the host combine, PQ, the panoptic loaders, the
head's GroupNorm, and the configs the port accepts and refuses for the
panoptic and semantic families.

One JAX program, compiled once for its module-scoped fixture: JAX's
`PanopticFPN` at RESNETS.DEPTH 10 with a bottleneck of 8 (TPU.BACKBONE_WIDTH;
JAX's module keeps the FPN at 256 and the head at 128 channels), MASK_ON (a
mask head of 2 convs of 16) and the head's GN, on two 96x160 images (the
second 80x128 inside the pad, originals twice the size) with stride-4
canvases of one diamond per box and labels in 8x8 blocks (255 on the pad),
JAX's draws replayed. Tolerances, and why:
- the losses (`loss_sem_seg` among them) within rtol 1e-4 and every
  parameter's gradient within 1e-4 of its tensor's largest (never less than
  1e-5), as test_torch_port_fpn.py holds them, at a fill where JAX's own
  gradient is continuous (FILL_SEED; `slow`: at other fills JAX's own
  moves by up to 6e-2 when its tree moves by 1e-7);
- the detections as test_torch_port_fpn.py ranks them, their masks within
  1e-4 (test_torch_port_mask_rcnn.py's), the semantic logits within 1e-5 of
  their largest magnitude and their argmax equal where the top two are
  further apart;
- the combine, PQ, rgb2id, the PNG's labels, the mapper, the collate and
  the loader exactly; the PQ dicts within 1e-9 (float64 numpy both);
- `GroupNorm32` within 1e-5 in float32 and to one bfloat16 step in
  bfloat16 (the statistics are float32 sums in another order).

Marked `slow`, outside Tier-1: the panoptic goldens
(panoptic_fpn_training_acc_test.yaml, then panoptic_fpn_inference_acc_test
from its save) from JAX's initial tree and draws, against the schedules'
own TEST.EXPECTED_RESULTS.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import convert_d2_fpn_rcnn
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data.build import build_detection_train_loader as jax_train_loader
from cddmsl_tpu.data.build import pad_and_collate as jax_pad_and_collate
from cddmsl_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data.dataset_mapper import PanopticDatasetMapper as JaxPanopticDatasetMapper
from cddmsl_tpu.data.datasets import coco_panoptic as jax_coco_panoptic
from cddmsl_tpu.data.datasets.synthetic import register_synthetic_panoptic as jax_register_synthetic_panoptic
from cddmsl_tpu.evaluation import panoptic_eval as jax_panoptic_eval
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.backbone.batch_norm import GroupNorm32 as JaxGroupNorm32
from cddmsl_tpu.models.panoptic_fpn import PanopticFPN as JaxPanopticFPN
from cddmsl_tpu.models.panoptic_fpn import combine_semantic_and_instance_outputs as jax_combine
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, model_family
from cddmsl_torch.data.build import build_detection_train_loader, pad_and_collate
from cddmsl_torch.data.catalog import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.dataset_mapper import PanopticDatasetMapper
from cddmsl_torch.data.datasets import coco_panoptic
from cddmsl_torch.data.datasets.synthetic import register_synthetic_panoptic
from cddmsl_torch.evaluation import panoptic_eval, verify_results
from cddmsl_torch.models.build import build_detector, panoptic_fpn_fields, semantic_segmentor_fields
from cddmsl_torch.models.panoptic_fpn import PanopticFPN, combine_semantic_and_instance_outputs
from cddmsl_torch.models.semantic_seg import GroupNorm32
from test_torch_port_fpn import (
    BATCH_A, D2_PIXELS, K, assert_grads_match, assert_rows_match, close_detection, filled, torch_batch,
)
from test_torch_port_inference import inference_and_head_inputs
from test_torch_port_mask_rcnn import assert_masks_match, diamond_canvases
from test_torch_port_semseg import assert_logits_and_argmax_match
from torch_goldens import QUICK, jax_initial_tree, quick_schedules_weights, replaying_trainers, run_schedule
from torch_goldens import supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STUFF = 6
PANOPTIC = dict(num_classes=K, sem_seg_classes=STUFF, depth=10, backbone_width=8, mask_on=True, mask_num_conv=2,
                mask_conv_dim=16, sem_seg_norm="GN", **D2_PIXELS)
NAMES = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask", "loss_sem_seg"}
# a fill at which JAX's own gradient is continuous: from its tree moved by 1e-7 JAX's gradient stays within
# 3.3e-6 of its largest; at fills 1, 2 and 23 it moves by 6.4e-2, 3.1e-3 and 3.1e-3 (a ReLU of the 1024-wide
# fcs or of the head at a float tie), and so does the port's (test_the_fill_is_away_from_jax_own_float_ties)
FILL_SEED = 3


def block_labels(jb, seed=5):
    """(B, H, W) int32 labels of STUFF classes in 8x8 blocks, 255 past each
    image's true size."""
    b, h, w = jb.image.shape[:3]
    r = np.random.RandomState(seed)
    labels = np.kron(r.randint(0, STUFF, (b, h // 8, w // 8)), np.ones((8, 8), np.int64)).astype(np.int32)
    for i, (th, tw) in enumerate(np.asarray(jb.image_sizes)):
        labels[i, th:], labels[i, :, tw:] = 255, 255
    return labels


def panoptic_params(model, jb, seed, port=None):
    """JAX's tree filled by `filled` (its shapes read off `port` where
    given), the classifier and the RPN's deltas at the 0.01 std of their
    own init (detectron2's): with He-normal fcs of 1024 on 7x7x256 pools
    the logits would saturate the softmax."""
    params = filled(model, jb, seed=seed, port=port)
    tree = params["params"]
    for node in (tree["roi_heads"]["box_predictor"]["cls_score"], tree["proposal_generator"]["head"]["anchor_deltas"]):
        node["kernel"] = node["kernel"] * (0.01 / node["kernel"].std())
    return params


@pytest.fixture(scope="module")
def panoptic_runs():
    """JAX's gradient of the losses on the batch with its canvases and
    labels, its inference (detections in the padded frame) and its semantic
    logits; the same in the port from the converted tree."""
    jb = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)), sem_seg=jnp.asarray(block_labels(BATCH_A)))
    model, ours = JaxPanopticFPN(**PANOPTIC), PanopticFPN(**PANOPTIC)
    params = panoptic_params(model, jb, FILL_SEED, port=ours)
    rng = jax.random.PRNGKey(11)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.cddmsl_losses)
        return sum(losses.values()), losses

    def infer(m, b):
        levels, _, (det, sem) = inference_and_head_inputs(m, b)
        return (det, sem), m._sem_logits(levels, b.image.shape[1:3])

    (grads, losses), ((det, sem), logits) = jax.jit(lambda p, b, r: (
        jax.grad(total, has_aux=True)(p, b, r), model.apply(p, b, method=infer)))(params, jb, rng)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    tb = torch_batch(jb, gt_masks=torch.from_numpy(np.array(jb.gt_masks)).to(torch.uint8),
                     sem_seg=torch.from_numpy(np.array(jb.sem_seg)))
    with torch.no_grad():
        got_det, got_sem = ours.inference(tb)
        got_logits = ours.sem_seg_logits(ours.features(tb.image), tb.image.shape[1:3])
    with torch.enable_grad():
        got_losses = ours.cddmsl_losses(tb, supervised_draw(rng))
        sum(got_losses.values()).backward()
    return dict(want=(losses, convert_jax_params(grads), det, np.asarray(sem), np.asarray(logits)),
                got=(got_losses, got_det, got_sem, got_logits), model=ours)


def test_panoptic_fpn_losses_and_gradients_equal_jax(panoptic_runs):
    """The six losses with JAX's draws replayed (`loss_sem_seg` times the
    loss weight 0.5) and every parameter's gradient, the head's GN
    included."""
    want_losses, want_grads = panoptic_runs["want"][:2]
    got_losses, model = panoptic_runs["got"][0], panoptic_runs["model"]
    assert set(got_losses) == set(want_losses) == NAMES
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    assert_grads_match(model, want_grads)
    gn = dict(model.sem_seg_head.named_parameters())
    assert "head_3_gn2.weight" in gn and "head_0_conv0.bias" not in gn


def test_panoptic_fpn_inference_equals_jax(panoptic_runs):
    """The detections in the padded frame from the RPN's 32 proposals an
    image, their 28x28 masks, the semantic logits and the argmax map."""
    _, _, want_det, want_sem, want_logits = panoptic_runs["want"]
    _, got_det, got_sem, got_logits = panoptic_runs["got"]
    assert_rows_match(got_det, want_det, "detection", close_detection(1))
    assert_masks_match(got_det, want_det, 1e-4)
    assert tuple(got_logits.shape) == (2, STUFF, 96, 160)
    assert_logits_and_argmax_match(got_logits, want_logits)
    assert torch.equal(got_sem, got_logits.argmax(1)) and want_sem.shape == tuple(got_sem.shape)


@pytest.mark.slow
def test_the_fill_is_away_from_jax_own_float_ties():
    """JAX's gradient from the fixture's tree and from the tree moved by
    1e-7 (multiplied by 1 + 1e-7 N(0, 1)): within 1e-5 of each tensor's
    largest at FILL_SEED; at fill 23 the same move changes fc2's gradient
    by more than 1e-3, as the port's differs from JAX's there (a float tie,
    not a fault)."""
    jb = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)), sem_seg=jnp.asarray(block_labels(BATCH_A)))
    model = JaxPanopticFPN(**PANOPTIC)
    grad = jax.jit(jax.grad(lambda p, b, r: sum(model.apply(p, b, r, method=model.cddmsl_losses).values())))

    def moved_apart(seed):
        params = panoptic_params(model, jb, seed)
        r = np.random.RandomState(0)
        moved = jax.tree_util.tree_map(lambda a: (a * (1 + 1e-7 * r.randn(*a.shape))).astype(np.float32), params)
        a, b = (convert_jax_params(jax.device_get(grad(p, jb, jax.random.PRNGKey(11)))) for p in (params, moved))
        return {n: (a[n] - b[n]).abs().max().item() / max(a[n].abs().max().item(), 1e-12) for n in a}

    assert max(moved_apart(FILL_SEED).values()) < 1e-5
    assert moved_apart(23)["roi_heads.box_head.fc2.weight"] > 1e-3


# ---------------- the combine and PQ ----------------
@pytest.mark.parametrize("with_masks", [False, True], ids=["boxes", "masks"])
def test_the_combine_equals_jax(with_masks):
    """Seeded detections (scores tied in pairs, some below the threshold,
    some not valid, boxes past the image) and a 60x80 map of 4 classes:
    the same segment ids and segments_info, with the boxes or with the
    pasted masks."""
    r = np.random.RandomState(7 + with_masks)
    d, (h, w) = 16, (60, 80)
    xy = r.rand(d, 2) * [w, h] - 8
    boxes = np.concatenate([xy, xy + 6 + r.rand(d, 2) * 40], 1).astype(np.float32)
    scores = np.round(r.rand(d), 1).astype(np.float32)
    valid = r.rand(d) > 0.15
    classes = r.randint(0, 5, d).astype(np.int32)
    sem = np.kron(r.randint(0, 4, (6, 8)), np.ones((10, 10), np.int64))
    masks = r.rand(d, 28, 28).astype(np.float32) if with_masks else None
    kw = dict(overlap_threshold=0.4, stuff_area_limit=300, instances_score_thresh=0.3, det_masks=masks)
    got = combine_semantic_and_instance_outputs(boxes, scores, classes, valid, sem, **kw)
    want = jax_combine(boxes, scores, classes, valid, sem, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32 and got[1] == want[1]
    assert any(s["isthing"] for s in got[1]) and any(not s["isthing"] for s in got[1])


def _crafted_pq():
    """Ground truth with VOID, a crowd region, thing and stuff ids that
    collide, and predictions matched, unmatched, mostly on VOID and mostly
    on a crowd of their class (image 3 has no prediction)."""
    gt = np.zeros((40, 60), np.int64)
    gt[:, :20] = 1  # stuff 0
    gt[:20, 20:40] = 2  # thing 0
    gt[20:, 20:40] = 3  # crowd thing 1
    gt[:10, 40:] = 4  # thing 1
    gt_segs = [{"id": 1, "category_id": 0, "isthing": False}, {"id": 2, "category_id": 0, "isthing": True},
               {"id": 3, "category_id": 1, "isthing": True, "iscrowd": 1},
               {"id": 4, "category_id": 1, "isthing": True}]
    pred = np.zeros_like(gt)
    pred[:, :18] = 5  # stuff 0, IoU 0.9
    pred[:20, 22:40] = 6  # thing 0, IoU 0.9
    pred[22:, 22:38] = 7  # thing 1 on the crowd: ignored
    pred[15:, 42:] = 8  # thing 1 mostly on VOID: ignored
    pred[:10, 40:45] = 9  # thing 1 a small part of gt 4: a false positive, gt 4 a false negative
    pred[:5, :5] = 10  # thing 0 inside the stuff: a false positive
    pred_segs = [{"id": 5, "category_id": 0, "isthing": False}, {"id": 6, "category_id": 0, "isthing": True},
                 {"id": 7, "category_id": 1, "isthing": True}, {"id": 8, "category_id": 1, "isthing": True},
                 {"id": 9, "category_id": 1, "isthing": True}, {"id": 10, "category_id": 0, "isthing": True}]
    return gt, gt_segs, pred, pred_segs


def test_pq_and_the_evaluator_equal_jax():
    gt, gt_segs, pred, pred_segs = _crafted_pq()
    got = panoptic_eval.pq_compute_single_image(gt, gt_segs, pred, pred_segs)
    want = jax_panoptic_eval.pq_compute_single_image(gt, gt_segs, pred, pred_segs)
    assert dict(got.stats) == dict(want.stats)
    assert got.stats[(0, True)][1:] == [1, 1, 0] and got.stats[(1, True)][1:] == [0, 1, 1]
    for flag in (None, True, False):
        assert got.average(flag) == want.average(flag)
    with pytest.raises(ValueError):
        panoptic_eval.pq_compute_single_image(gt, gt_segs, pred[:, :50], pred_segs)
    ours, theirs = panoptic_eval.COCOPanopticEvaluator("x"), jax_panoptic_eval.COCOPanopticEvaluator("x")
    for ev in (ours, theirs):
        ev.process(1, pred, pred_segs)
        ev.process_gt(1, gt, gt_segs)
        ev.process(2, gt, gt_segs)  # a perfect image
        ev.process_gt(2, gt, gt_segs)
        ev.process_gt(3, gt, gt_segs)  # no prediction: false negatives
    a, b = ours.evaluate(), theirs.evaluate()
    assert list(a["panoptic_seg"]) == list(b["panoptic_seg"]) == [
        f"{m}{s}" for s in ("", "_th", "_st") for m in ("PQ", "SQ", "RQ")]
    np.testing.assert_allclose(list(a["panoptic_seg"].values()), list(b["panoptic_seg"].values()), rtol=0, atol=1e-9)
    m = np.random.RandomState(0).randint(0, 9, (7, 11))
    for hw in ((7, 11), (20, 31), (3, 4)):
        np.testing.assert_array_equal(panoptic_eval.nearest_resize(m, hw), jax_panoptic_eval._nearest_resize(m, hw))


def test_rgb2id_and_the_png_labels_equal_jax():
    r = np.random.RandomState(3)
    png = r.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    np.testing.assert_array_equal(coco_panoptic.rgb2id(png), jax_coco_panoptic.rgb2id(png))
    ids = np.kron(r.randint(1, 5, (4, 6)), np.ones((5, 5), np.int64))
    png = np.stack([ids % 256, ids // 256, ids // 65536], -1).astype(np.uint8)
    segs = [{"id": 1, "category_id": 0, "stuff_category_id": 3}, {"id": 2, "category_id": 1},
            {"id": 3, "category_id": 2, "stuff_category_id": 0}]  # id 4: no segment, ignored
    got = coco_panoptic.panoptic_png_to_sem_seg(png, segs, 255)
    np.testing.assert_array_equal(got, jax_coco_panoptic.panoptic_png_to_sem_seg(png, segs, 255))
    assert got.dtype == np.int32 and set(np.unique(got)) <= {0, 1, 3, 255} and (got == 255).any()


# ---------------- data ----------------
@pytest.fixture(scope="module")
def panoptic_sets(tmp_path_factory):
    """The synthetic panoptic fixture registered in both packages' catalogs
    as port_panoptic_{train,val}, removed afterwards."""
    root = tmp_path_factory.mktemp("panoptic")
    register_synthetic_panoptic(str(root / "ours"), prefix="port_panoptic")
    jax_register_synthetic_panoptic(str(root / "jax"), prefix="port_panoptic")
    yield root
    for name in ("port_panoptic_train", "port_panoptic_val"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
        JaxDatasetCatalog._registry.pop(name, None)
        JaxMetadataCatalog._registry.pop(name, None)


def test_the_panoptic_mapper_collate_and_loader_give_jax_batches(panoptic_sets):
    """The fixture byte for byte and its records; the panoptic mapper
    (resize and flip, the labels and the segment ids NEAREST) with MASK_ON,
    its boxes, classes, labels and bitmasks; the collate's canvases (uint8
    here) and labels; the training loader's batches."""
    ours_root, jax_root = panoptic_sets / "ours" / "pan_synth", panoptic_sets / "jax" / "pan_synth"
    for p in sorted(ours_root.rglob("*.*")):
        assert p.read_bytes() == (jax_root / p.relative_to(ours_root)).read_bytes(), p
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(["MODEL.META_ARCHITECTURE", "PanopticFPN", "MODEL.MASK_ON", "True",
                           "DATASETS.TRAIN", "('port_panoptic_train',)", "INPUT.MIN_SIZE_TRAIN", "(96, 120)",
                           "INPUT.MAX_SIZE_TRAIN", "200", "INPUT.RANDOM_FLIP", "horizontal",
                           "TPU.PAD_SIZE_TRAIN", "[128, 224]", "SOLVER.IMS_PER_BATCH", "2"])
    dicts = DatasetCatalog.get("port_panoptic_train")
    want_dicts = JaxDatasetCatalog.get("port_panoptic_train")
    swap = lambda v: v.replace(str(panoptic_sets / "jax"), str(panoptic_sets / "ours")) if isinstance(v, str) else v
    assert dicts == [{k: swap(v) for k, v in d.items()} for d in want_dicts]
    assert MetadataCatalog.get("port_panoptic_train").thing_classes == ["thing_a", "thing_b"]
    ours, theirs = PanopticDatasetMapper(cfg, True), JaxPanopticDatasetMapper(ref, True)
    r1, r2 = np.random.RandomState(1), np.random.RandomState(1)
    samples, want = [ours(d, r1) for d in dicts], [theirs(d, r2) for d in dicts]
    for s, w in zip(samples, want):
        assert set(s) == set(w)
        for k in ("image", "hw", "orig_hw", "boxes", "classes", "sem_seg"):
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)
        assert len(s["bitmasks"]) == len(w["bitmasks"]) == len(s["boxes"]) == 1
        np.testing.assert_array_equal(s["bitmasks"][0], w["bitmasks"][0])
    got = pad_and_collate(samples[:4], (128, 224), 4, mask_stride=4)
    ref_batch = jax_pad_and_collate(want[:4], (128, 224), 4, mask_stride=4)
    assert got.gt_masks.dtype == torch.uint8 and got.gt_masks.sum() > 0
    np.testing.assert_array_equal(got.gt_masks.numpy(), np.asarray(ref_batch.gt_masks))
    np.testing.assert_array_equal(got.sem_seg.numpy(), np.asarray(ref_batch.sem_seg))
    with build_detection_train_loader(cfg, seed=2) as loader:
        batches = [next(loader) for _ in range(3)]
    jax_loader = jax_train_loader(ref, seed=2)
    for b in batches:
        w = next(jax_loader)
        for name in ("image", "gt_boxes", "gt_classes", "gt_valid", "gt_masks", "sem_seg"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(w, name)), err_msg=name)


def test_a_label_past_the_heads_classes_raises(panoptic_sets):
    """The loader maps every category into the stuff space, as JAX's (3 on
    the fixture): a head of 2 classes gets labels past its logits, which
    the mapper refuses naming the PNG."""
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.SEM_SEG_HEAD.NUM_CLASSES", "2"])
    d = DatasetCatalog.get("port_panoptic_train")[0]
    with pytest.raises(ValueError, match="NUM_CLASSES = 2"):
        PanopticDatasetMapper(cfg, True)(d, np.random.RandomState(0))
    cfg.merge_from_list(["MODEL.SEM_SEG_HEAD.NUM_CLASSES", "3"])
    assert PanopticDatasetMapper(cfg, True)(d, np.random.RandomState(0))["sem_seg"].max() == 2


def test_group_norm_equals_jax():
    """The head's GN on (2, 128, 6, 10) maps: float32 within 1e-5, bfloat16
    to one step of bfloat16 (float32 statistics, then the cast)."""
    r = np.random.RandomState(4)
    x = (r.randn(2, 6, 10, 128) * 3 + 1).astype(np.float32)
    jgn = JaxGroupNorm32(128)
    params = {"params": {"weight": r.uniform(0.5, 1.5, 128).astype(np.float32),
                         "bias": r.uniform(-0.1, 0.1, 128).astype(np.float32)}}
    ours = GroupNorm32(128)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(params["params"]["weight"]))
        ours.bias.copy_(torch.from_numpy(params["params"]["bias"]))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    want = np.moveaxis(np.asarray(jgn.apply(params, jnp.asarray(x))), -1, 1)
    got = ours(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    jbf = JaxGroupNorm32(128, dtype=jnp.bfloat16)
    want_b = np.moveaxis(np.asarray(jbf.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)), -1, 1)
    got_b = ours(xt.to(torch.bfloat16))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.detach().float().numpy(), want_b, rtol=2 ** -7, atol=1e-6)


# ---------------- configs, builders, loaders ----------------
OPENED = ["COCO-PanopticSegmentation/Base-Panoptic-FPN.yaml", "COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml",
          "COCO-PanopticSegmentation/panoptic_fpn_R_50_3x.yaml", "COCO-PanopticSegmentation/panoptic_fpn_R_101_3x.yaml",
          "Misc/semantic_R_50_FPN_1x.yaml", "quick_schedules/panoptic_fpn_instant_test.yaml",
          "quick_schedules/panoptic_fpn_training_acc_test.yaml", "quick_schedules/panoptic_fpn_inference_acc_test.yaml",
          "quick_schedules/semantic_R_50_FPN_instant_test.yaml", "quick_schedules/semantic_training_acc_test.yaml"]


def _cfgs(path):
    cfg, ref = get_cfg(), jax_get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / path))
    ref.merge_from_file(str(REPO / "configs" / path))
    return cfg, ref


@pytest.mark.parametrize("path", OPENED, ids=lambda p: Path(p).stem)
def test_the_segmentation_configs_are_accepted_with_the_jax_builders_fields(path):
    """Each of the 10 files passes `check_supported`, and the builder's
    fields are those JAX's `build_panoptic_fpn` / `build_semantic_segmentor`
    give their module (TPU.BACKBONE_WIDTH 0 meaning JAX's 64)."""
    cfg, ref = _cfgs(path)
    check_supported(cfg, world=1)
    want = jax_build_model(ref)
    if model_family(cfg) == "panoptic":
        fields = panoptic_fpn_fields(cfg)
        assert fields.pop("backbone_width") == (want.backbone_width or 64)
        assert fields.pop("dtype") == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[want.dtype]
        for name, value in fields.items():
            assert getattr(want, name) == value, name
        assert not want.cascade and want.backbone_norm == "FrozenBN" and want.fpn_norm == ""
    else:
        assert model_family(cfg) == "semantic"
        fields = semantic_segmentor_fields(cfg)
        fields.pop("dtype")
        for name, value in fields.items():
            assert getattr(want, name) == value, name


def test_the_full_width_builds():
    """R-50 Panoptic FPN (masks, GN head, 80 + 54 classes) and the R-50
    semantic segmentor build from their files."""
    for path, cls, n in (("COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml", "PanopticFPN", 54),
                         ("Misc/semantic_R_50_FPN_1x.yaml", "SemanticSegmentor", 54)):
        model = build_detector(_cfgs(path)[0], device="cpu")
        assert type(model).__name__ == cls and model.sem_seg_head.predictor.out_channels == n
    assert model_family(_cfgs(OPENED[1])[0]) == "panoptic"


@pytest.mark.parametrize("path, opts, key", [
    # the dconv-GN-cascade file, the cascade and FPN.NORM GN are ported (test_torch_port_dconv_panoptic.py):
    # a norm and heads the port's Panoptic FPN does not build, under the same ids
    ("Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml", ("MODEL.RESNETS.NORM", "SyncBN"), "MODEL.RESNETS.NORM"),
    (OPENED[1], ("MODEL.ROI_HEADS.NAME", "Res5ROIHeads"), "MODEL.ROI_HEADS.NAME"),
    (OPENED[1], ("MODEL.FPN.NORM", "SyncBN"), "MODEL.FPN.NORM"),
    (OPENED[1], ("MODEL.PANOPTIC_FPN.COMBINE.ENABLED", "False"), "MODEL.PANOPTIC_FPN.COMBINE.ENABLED"),
    (OPENED[1], ("MODEL.RPN.POST_NMS_TOPK_TRAIN", "500"), "MODEL.RPN.POST_NMS_TOPK_TRAIN"),
    (OPENED[1], ("MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128"), "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"),
    (OPENED[1], ("MODEL.SEM_SEG_HEAD.CONVS_DIM", "256"), "MODEL.SEM_SEG_HEAD.CONVS_DIM"),
    (OPENED[1], ("MODEL.SEM_SEG_HEAD.IN_FEATURES", "['p3', 'p4']"), "MODEL.SEM_SEG_HEAD.IN_FEATURES"),
    (OPENED[1], ("MODEL.KEYPOINT_ON", "True"), "MODEL.KEYPOINT_ON"),
    (OPENED[4], ("MODEL.SEM_SEG_HEAD.LOSS_WEIGHT", "0.5"), "MODEL.SEM_SEG_HEAD.LOSS_WEIGHT"),
    (OPENED[4], ("MODEL.SEM_SEG_HEAD.IN_FEATURES", "['p4', 'p3']"), "MODEL.SEM_SEG_HEAD.IN_FEATURES"),
    (OPENED[4], ("TPU.BACKBONE_WIDTH", "16"), "TPU.BACKBONE_WIDTH"),
    (OPENED[4], ("MODEL.MASK_ON", "True"), "MODEL.MASK_ON"),
    (OPENED[4], ("MODEL.SEM_SEG_HEAD.IGNORE_VALUE", "0"), "MODEL.SEM_SEG_HEAD.IGNORE_VALUE"),
], ids=lambda v: Path(v).stem if isinstance(v, str) and v.endswith(".yaml") else None)
def test_what_the_port_does_not_compute_is_refused_naming_the_key(path, opts, key):
    """The dconv/GN/cascade file and the keys JAX's modules compute with at
    one value (the RPN on p2, 64 rows an image, a head of 128 channels on
    p2..p5), set away from it; COMBINE.ENABLED False (JAX's test always
    combines); the semantic segmentor's unread keys."""
    cfg = _cfgs(path)[0]
    cfg.merge_from_list(list(opts))
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg, world=1)


def test_neither_packages_d2_loaders_take_the_semantic_head(tmp_path):
    """A detectron2 Panoptic FPN file (d2_fpn, its head under the
    reference's sem_seg_head.p{l}.{k} names): JAX's `convert_d2_fpn_rcnn`
    makes no sem_seg_head of it, and the port's loader leaves the head as
    it was; the tower, the RPN, the box and mask heads load."""
    model = init_random_(PanopticFPN(num_classes=3, sem_seg_classes=4, depth=10, backbone_width=8, mask_on=True,
                                     mask_num_conv=1, mask_conv_dim=8, sem_seg_norm="GN"),
                         torch.Generator().manual_seed(0))
    r = np.random.RandomState(1)
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in model.state_dict().items()
          if not k.startswith("sem_seg_head.")}
    for lvl, n in (("p2", 1), ("p3", 1), ("p4", 2), ("p5", 3)):
        for j in range(n):
            sd[f"sem_seg_head.{lvl}.{2 * j}.weight"] = torch.randn(128, 256 if j == 0 else 128, 3, 3)
            sd[f"sem_seg_head.{lvl}.{2 * j}.norm.weight"] = torch.rand(128)
    sd["sem_seg_head.predictor.weight"], sd["sem_seg_head.predictor.bias"] = torch.randn(4, 128, 1, 1), torch.randn(4)
    tree = convert_d2_fpn_rcnn({k: v.numpy() for k, v in sd.items()})
    assert "sem_seg_head" not in tree and "mask_head" in tree["roi_heads"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "panoptic.pth")
    assert load_rcnn_weights(model, str(tmp_path / "panoptic.pth")) == "d2_fpn"
    for name, value in model.state_dict().items():
        if name.startswith("sem_seg_head."):
            assert torch.equal(value, before[name]), name
        elif name != "roi_heads.box_head.fc1.weight":  # permuted from CHW to HWC
            assert torch.equal(value, sd[name]), name


@pytest.mark.slow
def test_the_panoptic_goldens_from_jax_initial_tree_and_draws(tmp_path, monkeypatch):
    """panoptic_fpn_training_acc_test.yaml (600 steps of PanopticFPN at
    depth 10 on the synthetic panoptic fixture, batch 2, clipping by norm)
    from JAX's initial tree with JAX's draws replayed, then
    panoptic_fpn_inference_acc_test.yaml from its model_final: PQ 91.876
    and PQ_th 88.07 within 0.05 each, as the schedules pin them."""
    training, inference = "panoptic_fpn_training_acc_test.yaml", "panoptic_fpn_inference_acc_test.yaml"
    default, _ = replaying_trainers(*jax_initial_tree(training), draw_of_step=supervised_draw)
    register_synthetic_panoptic(str(tmp_path / "fixture"))
    try:
        monkeypatch.setattr(train_net, "DefaultTrainer", default)
        trained = run_schedule(training, tmp_path / training, "TEST.EXPECTED_RESULTS", "[]")
        monkeypatch.undo()
        cfg = get_cfg()
        cfg.merge_from_file(str(QUICK / inference))
        weights = quick_schedules_weights(cfg.MODEL.WEIGHTS, tmp_path)
        evaluated = run_schedule(inference, tmp_path / inference, "MODEL.WEIGHTS", weights, "TEST.EXPECTED_RESULTS",
                                 "[]", eval_only=True)
    finally:
        for name in ("synthetic_panoptic_train", "synthetic_panoptic_val"):
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
    print(f"training: {trained['synthetic_panoptic_val']}\ninference: {evaluated['synthetic_panoptic_val']}")
    assert evaluated == trained
    assert verify_results(cfg, trained["synthetic_panoptic_val"]), trained


@pytest.mark.slow
@pytest.mark.parametrize("scale", [0.0, 1e-7], ids=["as_pinned", "moved"])
def test_jax_own_panoptic_golden_from_its_tree_and_from_a_moved_tree(scale, tmp_path):
    """JAX's own trainer on panoptic_fpn_training_acc_test.yaml from its
    initial tree, and from the tree with every leaf moved by one part in
    1e7: its PQ and PQ_th beside the goldens (91.876 and 88.07 +/- 0.05),
    printed; JAX's final tree through the port's `test()` gives JAX's own
    results within 1e-9."""
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from torch_goldens import jax_own_schedule

    name = "panoptic_fpn_training_acc_test.yaml"
    jax_register_synthetic_panoptic(str(tmp_path / "jax_fixture"))
    register_synthetic_panoptic(str(tmp_path / "fixture"))
    try:
        results, params = jax_own_schedule(name, tmp_path / "jax", scale)
        cfg = get_cfg()
        cfg.merge_from_file(str(QUICK / name))
        cfg.merge_from_list(["OUTPUT_DIR", str(tmp_path / "port")])
        ours = DefaultTrainer(cfg, device="cpu")
        ours.model.load_state_dict(convert_jax_params(params), strict=True)
        port = ours.test()["synthetic_panoptic_val"]["panoptic_seg"]
    finally:
        for set_name in ("synthetic_panoptic_train", "synthetic_panoptic_val"):
            DatasetCatalog.remove(set_name)
            MetadataCatalog.remove(set_name)
            JaxDatasetCatalog._registry.pop(set_name, None)
            JaxMetadataCatalog._registry.pop(set_name, None)
    want = results["synthetic_panoptic_val"]["panoptic_seg"]
    print(f"JAX from its tree moved by {scale:g}: PQ {want['PQ']}, PQ_th {want['PQ_th']} (goldens 91.876, 88.07)")
    np.testing.assert_allclose([port[k] for k in want], list(want.values()), rtol=1e-9)


@pytest.mark.slow
def test_every_panoptic_schedule_step_equals_jax_from_jax_state(tmp_path):
    """panoptic_fpn_training_acc_test.yaml's 600 steps, each taken by the
    port from JAX's state beside JAX's own step from that state moved by
    1e-7, with JAX's draws (`torch_goldens.schedule_lockstep`). A step
    where the port departs past 1e-4 (a loss) or 1e-3 (the update) and past
    10 times the control must be a float tie (`assert_departures_are_ties`:
    the RPN's proposals on p2, 64 of 2880 anchors' top 256, differ only
    where the two frameworks' objectness logits lie within 1e-4 of each
    other: near-equal candidates that trade places, cross the top-k cut or
    an NMS decision; or JAX's own moved step departs there past 1e-4 too);
    every other step within 3 times the control. (~35 minutes. Run once:
    15 such ties, 2 of them where JAX's own step departs too, the logits'
    gaps at most 6.3e-5; the other steps within the control.)"""
    import torch_goldens
    from test_torch_port_goldens_rcnn import assert_departures_are_ties, training_proposals_apart

    def jax_props(model, params, jb, k_rpn):
        def rpn(m, b):
            return m.proposal_generator(m._features(b.image)[0], b.image_sizes, training=True, gt_boxes=b.gt_boxes,
                                        gt_valid=b.gt_valid, rng=k_rpn)[0]

        return jax.jit(lambda p, b: model.apply(p, b, method=rpn))(params, jb)

    def port_props(ours, batch):
        rpn = ours.proposal_generator
        return rpn._predict_proposals(*rpn._head(ours.features(batch.image)[0]), batch.image_sizes, True)

    jax_register_synthetic_panoptic(str(tmp_path / "jax_fixture"), prefix="port_panoptic_lockstep")
    register_synthetic_panoptic(str(tmp_path / "fixture"))
    try:
        rows = torch_goldens.schedule_lockstep("panoptic_fpn_training_acc_test.yaml", "port_panoptic_lockstep_train",
                                               supervised_draw,
                                               explain=training_proposals_apart(jax_props, port_props))
    finally:
        for set_name in ("synthetic_panoptic_train", "synthetic_panoptic_val"):
            DatasetCatalog.remove(set_name)
            MetadataCatalog.remove(set_name)
        for set_name in ("port_panoptic_lockstep_train", "port_panoptic_lockstep_val"):
            JaxDatasetCatalog._registry.pop(set_name, None)
            JaxMetadataCatalog._registry.pop(set_name, None)
    assert len(rows) == 600
    assert_departures_are_ties(rows, max_gap=1e-4)
