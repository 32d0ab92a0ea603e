"""Mask R-CNN as whole detectors in the port against cddmsl_tpu on the CPU,
and the mask schedules through the port's `train_net`.

Two JAX programs, each compiled once for its module-scoped fixture:
- the FPN Mask R-CNN at RESNETS.DEPTH 10 (test_torch_port_fpn.py's narrow
  widths: bottleneck 8, res2 32 channels, FPN 32, fcs 64 and 48; a mask
  head of 2 convs of 16)
  with both GIoU losses (RPN weight 2, box head weight 10) and
  class-specific masks, on two 96x160 images (the second 80x128 inside the
  pad, their originals twice the size) with stride-4 canvases of one
  diamond per ground-truth box;
- the tiny CLIP C4 detector (`_flagship_cfg(tiny=True)`) with MODEL.MASK_ON,
  on two 64x96 images.
Each is held on its losses (`loss_mask` included) with JAX's draws
replayed, rtol 1e-4; on every parameter's gradient, within 1e-4 of its
tensor's largest gradient and never less than 1e-5 (as
test_torch_port_fpn.py holds them); and on its inference: the detections
as test_torch_port_fpn.py ranks them (scores 5e-5, boxes 1e-3 px, in the
resized frame) and each
detection's mask probabilities within 1e-5, except the FPN's, within 1e-4:
the mask pool reads the detection boxes, which differ by up to 1e-3 px,
through two 3x3 convolutions.

configs/quick_schedules/mask_rcnn_R_50_FPN_instant_test.yaml runs through
`train_net` and `--eval-only` from its model_final over the synthetic COCO
fixture, with bbox and segm AP. Marked `slow`, outside Tier-1: the segm
golden (segm_training_acc_test.yaml then segm_inference_acc_test.yaml)
from JAX's initial tree and draws, against the schedules' own
TEST.EXPECTED_RESULTS.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_goldens
from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.data.build import rasterize_polygons as jax_rasterize_polygons
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.config import SolverConfig, add_ateacher_config, get_cfg, model_config_from_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.datasets.synthetic import register_synthetic_coco
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.evaluation import verify_results
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.mask_head import foreground_rows
from cddmsl_torch.models.rcnn import DetBatch
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params, jax_param_shapes
from test_torch_port_fpn import (
    BATCH_A, BATCH_B, D2_PIXELS, NARROW, _same, assert_grads_match, assert_rows_match, close_detection, filled,
    torch_batch,
)
from test_torch_port_inference import BOX_ATOL
from torch_goldens import QUICK, jax_initial_tree, replaying_trainers, run_schedule, supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FPN_MASK = {**NARROW, **D2_PIXELS, "mask_on": True, "mask_num_conv": 2,
            "mask_conv_dim": 16, "box_reg_loss_type": "giou", "rpn_box_reg_loss_type": "giou",
            "box_reg_loss_weight": 10.0, "rpn_box_reg_loss_weight": 2.0}
NAMES = {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask"}


def diamond_canvases(jb, stride=4):
    """(B, G, H/stride, W/stride) float32 canvases of one diamond (the box's
    edge midpoints) per valid ground-truth box, rasterised by JAX's loader."""
    b, g = jb.gt_boxes.shape[:2]
    h, w = jb.image.shape[1:3]
    out = np.zeros((b, g, h // stride, w // stride), np.float32)
    for i in range(b):
        rings = []
        for j in range(g):
            x1, y1, x2, y2 = np.asarray(jb.gt_boxes[i, j], np.float64)
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            rings.append([np.array([[cx, y1], [x2, cy], [cx, y2], [x1, cy]])] if jb.gt_valid[i, j] else [])
        out[i] = jax_rasterize_polygons(rings, (h, w), stride)
    return out


def assert_masks_match(got, want, atol):
    """Per image, each valid detection's masks against JAX's detection of the
    same class and box (within BOX_ATOL): probabilities within `atol`."""
    assert got.masks is not None and got.masks.shape == np.asarray(want.masks).shape
    gm, wm = got.masks.numpy(), np.asarray(want.masks)
    matched = 0
    for i in range(gm.shape[0]):
        wb, wc = np.asarray(want.boxes[i]), np.asarray(want.classes[i])
        for d in np.nonzero(got.valid[i].numpy())[0]:
            same_box = np.abs(wb - got.boxes[i, d].numpy()).max(1) <= BOX_ATOL
            close = np.nonzero((wc == int(got.classes[i, d])) & same_box & np.asarray(want.valid[i]))[0]
            assert len(close), (i, d)
            np.testing.assert_allclose(gm[i, d], wm[i, close[0]], rtol=0, atol=atol, err_msg=f"image {i} row {d}")
            matched += 1
    assert matched > 0


# ---------------- the FPN program ----------------
@pytest.fixture(scope="module")
def fpn_mask_runs():
    """JAX's gradient of `supervised_losses` on batch A with its canvases,
    and the inference of both batches in the resized frame; the same in the
    port from the converted tree."""
    ba = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)))
    model, ours = JaxFPNRCNN(**FPN_MASK), FPNRCNN(**FPN_MASK)
    params = filled(model, ba, seed=21, port=ours)
    rng = jax.random.PRNGKey(9)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    def infer(m, b):
        return m.inference(b, do_postprocess=False)

    (grads, losses), out_a, out_b = jax.jit(lambda p, a, b, r: (
        jax.grad(total, has_aux=True)(p, a, r), model.apply(p, a, method=infer), model.apply(p, b, method=infer),
    ))(params, ba, BATCH_B, rng)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    got = []
    with torch.no_grad():
        for jb in (BATCH_A, BATCH_B):
            tb = torch_batch(jb)
            got.append(ours.inference(tb, do_postprocess=False))
    with torch.enable_grad():
        tb = torch_batch(BATCH_A, gt_masks=torch.from_numpy(np.asarray(ba.gt_masks)).to(torch.uint8))
        got_losses = ours.supervised_losses(tb, supervised_draw(rng))
        sum(got_losses.values()).backward()
    return dict(want=(out_a, out_b, losses, convert_jax_params(grads)), got=(*got, got_losses), model=ours)


def test_fpn_mask_rcnn_losses_and_gradients_equal_jax(fpn_mask_runs):
    """The five losses (both GIoU terms, `loss_mask` over the leading
    foreground rows where JAX masks all 32) and every parameter's gradient."""
    want_losses, want_grads = fpn_mask_runs["want"][2:]
    got_losses, model = fpn_mask_runs["got"][2], fpn_mask_runs["model"]
    assert set(got_losses) == set(want_losses) == NAMES
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    assert foreground_rows(NARROW["roi_batch_size_per_image"], model.roi_heads.positive_fraction) == 8 < \
        NARROW["roi_batch_size_per_image"]
    assert_grads_match(model, want_grads)


def test_fpn_mask_rcnn_inference_and_masks_equal_jax(fpn_mask_runs):
    """Both batches' detections in the resized frame and their 28x28 masks;
    the rescale to the originals leaves the box-frame masks as they are."""
    for want, got in zip(fpn_mask_runs["want"][:2], fpn_mask_runs["got"][:2]):
        assert_rows_match(got, want, "detection", close_detection(1))
        assert got.masks.shape[2:] == (28, 28)
        assert_masks_match(got, want, 1e-4)
    model, batch = fpn_mask_runs["model"], torch_batch(BATCH_A)
    with torch.no_grad():
        assert torch.equal(model.inference(batch).masks, fpn_mask_runs["got"][0].masks)


# ---------------- the C4 program ----------------
@pytest.fixture(scope="module")
def c4_mask_runs():
    cfg = _flagship_cfg(tiny=True)
    cfg.MODEL.MASK_ON = True
    model = jax_build_model(cfg)
    jb = _synthetic_batch(2, 64, 96, g=8, seed=2)
    jb = jb._replace(image_sizes=jnp.asarray([[64, 96], [56, 80]], jnp.int32),
                     gt_masks=jnp.asarray(diamond_canvases(jb)))
    config = model_config_from_cfg(cfg)
    params = fill_params(jax_param_shapes(config), seed=9)
    head = params["params"]["proposal_generator"]["head"]
    for name in ("objectness_logits", "anchor_deltas"):
        head[name]["kernel"] = head[name]["kernel"] / 4
    rng = jax.random.PRNGKey(3)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    (grads, losses), det = jax.jit(lambda p, b, r: (
        jax.grad(total, has_aux=True)(p, b, r), model.apply(p, b, False, method=model.inference)))(params, jb, rng)
    ours = build_model(config, device="cpu")
    state = convert_jax_params(params)
    ours.load_state_dict({k: v for k, v in state.items() if k in ours.state_dict()}, strict=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tb = DetBatch(t(jb.image), t(jb.image_sizes), t(jb.orig_sizes), t(jb.gt_boxes), t(jb.gt_classes), t(jb.gt_valid),
                  gt_masks=t(jb.gt_masks).to(torch.uint8))
    with torch.no_grad():
        got_det = ours.inference(tb, do_postprocess=False)
    with torch.enable_grad():
        got_losses = ours.supervised_losses(tb, supervised_draw(rng))
        sum(got_losses.values()).backward()
    grads = convert_jax_params(grads)
    return dict(want=(det, losses, {k: v for k, v in grads.items() if k in ours.state_dict()}),
                got=(got_det, got_losses), model=ours)


def test_c4_mask_rcnn_losses_and_gradients_equal_jax(c4_mask_runs):
    """The tiny CLIP C4 detector: the mask head reads the same res5 crops as
    the box head; five losses and every parameter's gradient."""
    _, want_losses, want_grads = c4_mask_runs["want"]
    got_losses, model = c4_mask_runs["got"][1], c4_mask_runs["model"]
    assert set(got_losses) == set(want_losses) == NAMES
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert model.roi_heads.mask_head.num_conv == 0
    assert_grads_match(model, want_grads)


def test_c4_mask_rcnn_inference_and_masks_equal_jax(c4_mask_runs):
    """The final boxes pooled again, res5 and the head on them: 14x14 masks."""
    want, got = c4_mask_runs["want"][0], c4_mask_runs["got"][0]
    assert_rows_match(got, want, "detection", close_detection(1))
    assert got.masks.shape[2:] == (14, 14)
    assert_masks_match(got, want, 1e-5)


# ---------------- chip_smoke.py's phase 17 ----------------
def test_mask_pool_calls_are_the_steps_own(monkeypatch):
    """Phase 17's rebuilt mask pool of a step (`mask_step_pool_calls`: the
    leading foreground rows of each image, one call per level) and of the
    final boxes (`level_pool_calls` with the mask pooler) are what the model hands to
    `roi_align_batched` after the box pooler's calls."""
    import chip_smoke
    from cddmsl_torch.models import poolers

    model = init_random_(FPNRCNN(**FPN_MASK), torch.Generator().manual_seed(6))
    trainer = Trainer(model, build_optimizer(model, SolverConfig(warmup_iters=0)), enable_caption=False)
    tb = torch_batch(BATCH_A, gt_masks=torch.from_numpy(diamond_canvases(BATCH_A)).to(torch.uint8))
    draw = chip_smoke.site_draw("cpu")
    with torch.no_grad():
        rebuilt = chip_smoke.mask_step_pool_calls(model, tb, draw)
    pools = []
    pool = poolers.roi_align_batched

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.detach().clone(), batch_idx.clone(), boxes.detach().clone(), *args))
        return pool(features, batch_idx, boxes, *args)

    monkeypatch.setattr(poolers, "roi_align_batched", pool_spy)
    trainer.train_step(tb, draw)
    assert len(pools) == 8 and [label for label, *_ in rebuilt] == [f"mask supervised p{i}" for i in range(2, 6)]
    for (_, feats, bidx, boxes, pooled, scale), (f, i, b, size, s, *_) in zip(rebuilt, pools[4:]):
        assert torch.equal(feats, f) and torch.equal(bidx, i) and _same(boxes, b)
        assert (pooled, pooled) == size == (14, 14)
        assert scale == s
    assert bidx.shape[0] == 2 * foreground_rows(NARROW["roi_batch_size_per_image"], model.roi_heads.positive_fraction)
    pools.clear()
    with torch.no_grad():
        det = model.inference(tb, do_postprocess=False)
        rh = model.roi_heads
        eval_calls = chip_smoke.level_pool_calls(rh, model.features(tb.image)[0], det.boxes, "e", rh.mask_pooler)
    assert len(pools) == 8 and len(eval_calls) == 4
    for (_, feats, bidx, boxes, *_), (f, i, b, *_) in zip(eval_calls, pools[4:]):
        assert torch.equal(feats, f) and torch.equal(bidx, i) and _same(boxes, b)


# ---------------- the schedules ----------------
@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("mask_schedules")
    register_synthetic_coco(str(root / "fixture"))
    try:
        yield root
    finally:
        for name in ("synthetic_coco_train", "synthetic_coco_val"):
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)


def test_the_instant_schedule_trains_and_evaluates_masks(coco_fixture, capsys):
    """mask_rcnn_R_50_FPN_instant_test.yaml: 2 steps with loss_mask in the
    metrics, model_final, and bbox and segm AP on synthetic_coco_val; then
    `--eval-only --resume` from the save gives the same AP dicts."""
    out = coco_fixture / "instant"
    results = run_schedule("mask_rcnn_R_50_FPN_instant_test.yaml", out)
    again = run_schedule("mask_rcnn_R_50_FPN_instant_test.yaml", out, eval_only=True)
    res = results["synthetic_coco_val"]
    print(f"instant schedule: bbox {res['bbox']}, segm {res['segm']}")
    assert set(res) == {"bbox", "segm"} and np.isfinite(res["segm"]["AP"])
    np.testing.assert_equal(again, results)
    assert (out / "model_final.pth").exists()
    metrics = (out / "metrics.json").read_text()
    assert "loss_mask" in metrics
    dumped = (out / "inference" / "coco_instances_results_synthetic_coco_val.json").read_text()
    assert dumped == "[]" or '"segmentation"' in dumped


def test_the_predictor_pastes_masks_into_the_original_image(coco_fixture):
    """`DefaultPredictor` on the instant schedule's detector: "masks" (N, H,
    W) of the original image, the paste of `inference`'s box-frame masks."""
    from cddmsl_torch.engine.defaults import DefaultPredictor
    from cddmsl_torch.evaluation.masks import paste_masks_np

    cfg = get_cfg()
    cfg.merge_from_file(str(QUICK / "mask_rcnn_R_50_FPN_instant_test.yaml"))
    cfg.merge_from_list(["SEED", "3", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0"])
    predictor = DefaultPredictor(cfg, device="cpu")
    image = (np.random.RandomState(4).rand(100, 140, 3) * 255).astype(np.uint8)
    out = predictor(image)
    n = len(out["boxes"])
    assert n > 0 and out["masks"].shape == (n, 100, 140) and out["masks"].dtype == bool
    captured = {}
    inference = predictor.model.inference
    predictor.model.inference = lambda batch: captured.setdefault("det", inference(batch))
    predictor(image)
    det = captured["det"]
    keep = det.valid[0]
    np.testing.assert_array_equal(out["masks"], paste_masks_np(det.masks[0][keep].numpy(), out["boxes"], (100, 140)))


@pytest.mark.slow
def test_the_segm_goldens_from_jax_initial_tree_and_draws(coco_fixture):
    """segm_training_acc_test.yaml (100 steps of the tiny CLIP C4 Mask R-CNN
    on the COCO fixture) from JAX's initial tree with JAX's draws replayed,
    then segm_inference_acc_test.yaml `--eval-only` from its model_final,
    each against the schedule's own TEST.EXPECTED_RESULTS."""
    training, inference = "segm_training_acc_test.yaml", "segm_inference_acc_test.yaml"
    default, _ = replaying_trainers(*jax_initial_tree(training))
    out = coco_fixture / "goldens"
    mp = pytest.MonkeyPatch()
    mp.setattr(train_net, "DefaultTrainer", default)
    try:
        results = run_schedule(training, out / training)["synthetic_coco_val"]
    finally:
        mp.undo()
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / training))
    print(f"segm training golden at {torch_goldens.THREADS} threads: bbox {results['bbox']}, segm {results['segm']}")
    assert verify_results(cfg, results), results
    weights = torch_goldens.quick_schedules_weights("quick_schedules://segm_training_acc_test.yaml/model_final",
                                                    out)
    again = run_schedule(inference, out / inference, "MODEL.WEIGHTS", weights, eval_only=True)["synthetic_coco_val"]
    cfg_inf = get_cfg()
    add_ateacher_config(cfg_inf)
    cfg_inf.merge_from_file(str(QUICK / inference))
    print(f"segm inference golden: bbox {again['bbox']}, segm {again['segm']}")
    assert verify_results(cfg_inf, again), again
