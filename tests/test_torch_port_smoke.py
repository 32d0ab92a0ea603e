"""The parts of chip_smoke.py that the CPU can check: the rebuilt RoIAlign
calls of a training step and the rebuilt RoIAlign and NMS calls of an eval
batch, which its kernel rows time, the bounds its kernels line reports
beside each time, and the NMS walk's blocks and kept rows it prints.

The rebuilt calls must be the step's own: one tiny CDDMSL step past burn-up
runs on the CPU with a spy on `roi_align_batched`, and the spy's record of
every call (map, image indices, boxes) must equal, exactly, what
`training_roi_align_calls` returns for the same weights and draws (the same
float32 operations on the same inputs, and draws that depend on the site
name alone). Likewise the eval batch's calls, rebuilt by
`eval_kernel_calls`, must equal what `model.inference` hands to
`roi_align_batched` and to `nms` (the RPN's and the detection NMS's, after
the class shift), and a region branch's, rebuilt by `branch_kernel_calls`,
what the branch hands to them; on the plain tower with the linear head
(phase 14), the supervised step's one pool (`supervised_roi_align_calls`)
and the eval batch's calls; on the open-vocabulary detector (phase 15), its
step's pool and offline RPN NMS (`ovd_training_calls`) and its eval batch's
calls (the offline RPN's NMS, the pool on the CLIP map, the detection NMS).
"""

import dataclasses
from pathlib import Path

import pytest
import torch

import chip_smoke
from cddmsl_torch.checkpoint.convert_jax import init_random_
from cddmsl_torch.config import add_ateacher_config, flagship_config, flagship_solver_config, get_cfg
from cddmsl_torch.engine.mean_teacher import MeanTeacherTrainer
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.entry import synthetic_batch
from cddmsl_torch.models import roi_heads, rpn
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.clip_rcnn import CLIPFastRCNN
from cddmsl_torch.ops import nms as nms_ops
from cddmsl_torch.ops import roi_align as roi_ops
from cddmsl_torch.solver.build import build_optimizer


def test_no_two_top_level_definitions_of_chip_smoke_share_a_name():
    """A later `def` of a name silently replaces the earlier one, which
    other phases may still call with its own arguments."""
    import ast
    import collections
    from pathlib import Path

    tree = ast.parse(Path(chip_smoke.__file__).read_text())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)]
    assert [k for k, v in collections.Counter(names).items() if v > 1] == []


@pytest.mark.parametrize("test", [True, False])
def test_train_cfg_is_a_probed_run_at_batch_8_with_its_options(tmp_path, test):
    cfg = chip_smoke.train_cfg(str(tmp_path), "Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml", ("a", "b"), 3,
                               "TEST.PRECISE_BN.NUM_ITER", "2", test=test)
    assert cfg.MODEL.RESNETS.NORM == "SyncBN" and cfg.TEST.PRECISE_BN.NUM_ITER == 2
    assert (cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.MAX_ITER, cfg.SOLVER.CHECKPOINT_PERIOD) == (8, 3, 0)
    assert cfg.DATASETS.TRAIN == ("a",) and cfg.DATASETS.TEST == (("b",) if test else ())
    assert cfg.OUTPUT_DIR == str(tmp_path / "out")
    with pytest.raises(AttributeError, match="frozen"):
        cfg.SEED = 1


def test_training_roi_align_calls_are_the_steps_own(monkeypatch):
    cfg, solver = flagship_config(tiny=True), flagship_solver_config(tiny=True)
    model = build_model(cfg, device="cpu", training=True)
    init_random_(model, torch.Generator().manual_seed(5))
    trainer = Trainer(model, build_optimizer(model, solver), caption_burnup_iters=solver.caption_burnup_iters,
                      iteration=solver.caption_burnup_iters + 1)
    batch = synthetic_batch(2, 128, 160, seed=2, device="cpu")
    draw = chip_smoke.site_draw("cpu")
    with torch.no_grad():
        rebuilt = chip_smoke.training_roi_align_calls(model, batch, draw)

    seen = []
    pool = roi_heads.roi_align_batched

    def spy(features, batch_idx, boxes, *args):
        seen.append((features.detach().clone(), batch_idx.clone(), boxes.detach().clone()))
        return pool(features, batch_idx, boxes, *args)

    monkeypatch.setattr(roi_heads, "roi_align_batched", spy)
    trainer.train_step(batch, draw)

    b = batch.image.shape[0]
    assert [label for label, *_ in rebuilt] == ["supervised", "region_src", "region_trgt"]
    assert [len(boxes) for _, _, _, boxes in rebuilt] == [
        b * cfg.roi_batch_size_per_image, b * cfg.region_consistency_boxes, b * cfg.region_consistency_boxes]
    assert len(seen) == len(rebuilt)
    for (label, features, batch_idx, boxes), (s_features, s_batch_idx, s_boxes) in zip(rebuilt, seen):
        assert features.shape == s_features.shape == (b, 8, 10, cfg.backbone_width * 16), label
        assert torch.equal(features, s_features), label
        assert torch.equal(batch_idx, s_batch_idx), label
        assert torch.equal(boxes, s_boxes), label
    # the region pools read the same boxes from the two views' maps
    assert torch.equal(rebuilt[1][3], rebuilt[2][3]) and not torch.equal(rebuilt[1][1], rebuilt[2][1])


@pytest.mark.parametrize("score_thresh", [0.0, 0.05])
def test_eval_kernel_calls_are_the_inference_batchs_own(monkeypatch, score_thresh):
    cfg = flagship_config(tiny=True)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(4))
    model.roi_heads.score_thresh_test = score_thresh
    batch = synthetic_batch(2, 128, 160, seed=3, device="cpu")
    (features, batch_idx, boxes), nms_calls = chip_smoke.eval_kernel_calls(model, batch)

    pools, nmss = [], []
    pool, nms = roi_heads.roi_align_batched, nms_ops.nms

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.clone(), batch_idx.clone(), boxes.clone()))
        return pool(features, batch_idx, boxes, *args)

    def nms_spy(boxes, scores, iou_threshold, max_out, valid=None):
        nmss.append((boxes.clone(), scores.clone(), valid.clone(), iou_threshold, max_out))
        return nms(boxes, scores, iou_threshold, max_out, valid=valid)

    monkeypatch.setattr(roi_heads, "roi_align_batched", pool_spy)
    monkeypatch.setattr(rpn, "nms", nms_spy)
    monkeypatch.setattr(nms_ops, "nms", nms_spy)  # batched_nms's
    model.inference(batch)

    assert len(pools) == 1 and len(nmss) == len(nms_calls) == 2
    for got, want in zip((features, batch_idx, boxes), pools[0]):
        assert torch.equal(got, want)
    assert boxes.shape == (2 * cfg.rpn_post_nms_topk_test, 4)
    for label, got, want in zip(("rpn", "detection"), nms_calls, nmss):
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(x, y), label
        assert got[3:] == want[3:], label
    assert nms_calls[0][4] == cfg.rpn_post_nms_topk_test and nms_calls[1][4] == cfg.detections_per_image
    if score_thresh == 0.0:  # every candidate kept: several classes, shifted apart past the image
        det_boxes, _, det_valid = nms_calls[1][:3]
        assert det_valid.all() and det_boxes.amax() > 160


def test_plain_tower_kernel_calls_are_its_steps_and_eval_batchs_own(monkeypatch):
    """Phase 14's rebuilt calls on the plain tower with the linear head: the
    supervised step's one pool (`supervised_roi_align_calls`), then the eval
    batch's pool and two NMS calls (`eval_kernel_calls`: the box head
    mean-pools res5, with no attention pool)."""
    cfg = dataclasses.replace(flagship_config(tiny=True), backbone_type="d2_resnet", backbone_depth=10,
                              backbone_width=64, embed_dim=2048, use_text_emb=False)
    solver = flagship_solver_config(tiny=True)
    model = init_random_(build_model(cfg, device="cpu", training=True), torch.Generator().manual_seed(6))
    trainer = Trainer(model, build_optimizer(model, solver), enable_caption=False)
    batch = synthetic_batch(2, 128, 160, seed=2, device="cpu")
    draw = chip_smoke.site_draw("cpu")
    with torch.no_grad():
        rebuilt = chip_smoke.supervised_roi_align_calls(model, batch, draw)
    pools, nmss = [], []
    pool, nms = roi_heads.roi_align_batched, nms_ops.nms

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.detach().clone(), batch_idx.clone(), boxes.detach().clone()))
        return pool(features, batch_idx, boxes, *args)

    def nms_spy(boxes, scores, iou_threshold, max_out, valid=None):
        nmss.append((boxes.clone(), scores.clone(), valid.clone(), iou_threshold, max_out))
        return nms(boxes, scores, iou_threshold, max_out, valid=valid)

    monkeypatch.setattr(roi_heads, "roi_align_batched", pool_spy)
    trainer.train_step(batch, draw)
    assert [label for label, *_ in rebuilt] == ["supervised"] and len(pools) == 1
    for got, want in zip(rebuilt[0][1:], pools[0]):
        assert torch.equal(got, want)
    assert rebuilt[0][1].shape == (2, 8, 10, 1024) and len(rebuilt[0][3]) == 2 * cfg.roi_batch_size_per_image

    (features, batch_idx, boxes), nms_calls = chip_smoke.eval_kernel_calls(model, batch)
    pools.clear()  # the rebuild's own pool
    monkeypatch.setattr(rpn, "nms", nms_spy)
    monkeypatch.setattr(nms_ops, "nms", nms_spy)
    model.inference(batch)
    assert len(pools) == 1 and len(nmss) == len(nms_calls) == 2
    for got, want in zip((features, batch_idx, boxes), pools[0]):
        assert torch.equal(got, want)
    for got, want in zip(nms_calls, nmss):
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])) and got[3:] == want[3:]


def test_ovd_kernel_calls_are_the_clip_fast_rcnn_steps_and_eval_batchs_own(monkeypatch):
    """Phase 15's rebuilt calls on a tiny CLIPFastRCNN (NO_BOX_DELTA, the
    offline RPN at 0.9): the step's pool and its offline RPN NMS
    (`ovd_training_calls`), then the eval batch's pool and two NMS calls
    (`eval_kernel_calls`), equal to what `supervised_losses` and
    `inference` hand to the kernels."""
    model = init_random_(CLIPFastRCNN((1, 1, 1, 1), 16, 64, 20, 10, (64, 32), no_box_delta=True,
                                      offline_pixel_std=(57.375, 57.12, 58.395)), torch.Generator().manual_seed(8))
    model.roi_heads.score_thresh_test = 0.0
    batch = synthetic_batch(2, 128, 160, seed=5, with_trgt=False, device="cpu")
    draw = chip_smoke.site_draw("cpu")
    train_pool, train_rpn = chip_smoke.ovd_training_calls(model, batch, draw)
    (features, batch_idx, boxes), nms_calls = chip_smoke.eval_kernel_calls(model, batch)
    pools, nmss = [], []
    pool, nms = roi_heads.roi_align_batched, nms_ops.nms

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.detach().clone(), batch_idx.clone(), boxes.detach().clone()))
        return pool(features, batch_idx, boxes, *args)

    def nms_spy(boxes, scores, iou_threshold, max_out, valid=None):
        nmss.append((boxes.clone(), scores.clone(), valid.clone(), iou_threshold, max_out))
        return nms(boxes, scores, iou_threshold, max_out, valid=valid)

    monkeypatch.setattr(roi_heads, "roi_align_batched", pool_spy)
    monkeypatch.setattr(rpn, "nms", nms_spy)
    monkeypatch.setattr(nms_ops, "nms", nms_spy)
    with torch.enable_grad():
        model.supervised_losses(batch, draw)
    model.inference(batch)
    assert len(pools) == 2 and len(nmss) == 3
    assert train_pool[0] == "train_pool" and len(train_pool[3]) == 2 * 512
    for got, want in zip((*train_pool[1:], features, batch_idx, boxes), (*pools[0], *pools[1])):
        assert torch.equal(got, want)
    assert train_rpn[3:] == (0.9, 64) and nms_calls[0][3:] == (0.9, 32) and nms_calls[1][3:] == (0.5, 100)
    for got, want in zip((train_rpn, *nms_calls), nmss):
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])) and got[3:] == want[3:]


def test_soft_nms_bound_counts_each_byte_once_and_each_rounds_row():
    """Phase 14's soft-NMS: 8 images of 2048 candidates keeping 100. Bytes:
    8 x 2048 x (16 + 4 + 4 + 1) read, 8 x 100 x 13 written; operations: 100
    rounds of one IoU row of 2048 a image, 19 flops a candidate."""
    bound_ms, by = chip_smoke.soft_nms_bound_ms(8, 2048, 100)
    t_bytes, t_ops = (8 * 2048 * 25 + 8 * 100 * 13) / 3.35e12, 8 * 100 * 2048 * 19 / 67e12
    assert by == "operations" and bound_ms == pytest.approx(t_ops * 1e3, rel=1e-12) and t_bytes < t_ops


def test_seeded_candidates_replace_only_the_detection_nms_scores():
    """With `candidates_seed`, `eval_kernel_calls` hands the detection NMS
    every candidate, valid, with the scores `soft_nms_on_card_and_cpu`
    draws (seeded uniforms in [0.05, 1)); the boxes, the RPN's call and the
    pool stay the batch's own."""
    cfg = dataclasses.replace(flagship_config(tiny=True), backbone_type="d2_resnet", backbone_depth=10,
                              backbone_width=64, embed_dim=2048, use_text_emb=False)
    model = init_random_(build_model(cfg, device="cpu"), torch.Generator().manual_seed(6))
    batch = synthetic_batch(2, 128, 160, seed=2, device="cpu")
    pool, (rpn_call, det_call) = chip_smoke.eval_kernel_calls(model, batch)
    seeded_pool, (seeded_rpn, seeded_det) = chip_smoke.eval_kernel_calls(model, batch, candidates_seed=14)
    assert all(torch.equal(x, y) for x, y in zip(pool, seeded_pool))
    assert all(torch.equal(x, y) for x, y in zip(rpn_call[:3], seeded_rpn[:3])) and rpn_call[3:] == seeded_rpn[3:]
    boxes, scores, valid = seeded_det[:3]
    want_scores, want_valid = chip_smoke.seeded_candidates(det_call[1], det_call[2], 14)
    assert torch.equal(scores, want_scores) and valid.all() and torch.equal(valid, want_valid)
    assert float(scores.min()) >= 0.05 and float(scores.max()) < 1.0 and seeded_det[3:] == det_call[3:]
    # every candidate valid: the class shift now moves the rows the test threshold dropped too
    assert torch.equal(boxes[det_call[2]], det_call[0][det_call[2]])


@pytest.mark.parametrize("R, want_bytes", [
    # the supervised pool: g (or the pooled values) 1024x14x14x1024 bf16 = 411,041,792 B, boxes and
    # indices 1024x20 = 20,480 B, dF (or the map, when K1 reads all of it) 2x50x84x1024 bf16 = 17,203,200 B
    (1024, 428_265_472),
    # a region pool: 32x14x14x1024 bf16 = 12,845,056 B, 32x20 = 640 B, the same map 17,203,200 B
    (32, 30_048_896),
])
def test_roi_bounds_count_each_byte_once_at_the_training_shape(R, want_bytes):
    feats = torch.empty((2, 50, 84, 1024), dtype=torch.bfloat16, device="meta")
    bound_ms, by = chip_smoke.roi_bounds_ms(feats, R, 2 * 50 * 84)
    assert bound_ms == pytest.approx(want_bytes / 3.35e12 * 1e3, rel=1e-12)
    assert by == "bytes"
    # 16 multiply-adds (32 flops) per pooled value at S = 2, below the bytes at 67 TFLOP/s
    flops_ms = 32 * R * 14 * 14 * 1024 / 67e12 * 1e3
    assert flops_ms < bound_ms


def test_read_map_pixels_are_those_the_plain_backward_reaches():
    """K1 reads exactly the pixels to which a positive gradient flows back:
    here ROIs on two of three images, one past every edge of its map."""
    gen = torch.Generator().manual_seed(0)
    B, H, W, C, R = 3, 20, 30, 4, 40
    rois = chip_smoke.random_boxes(gen, R, W * 16 * 0.7, H * 16 * 0.7, "cpu", max_size=150.0)
    rois[0] = torch.tensor([-50.0, -50.0, 1000.0, 1000.0])
    bidx = torch.randint(0, 2, (R,), generator=gen, dtype=torch.int32)
    g = torch.rand((R, 14, 14, C), generator=gen) + 0.1
    dF = roi_ops.roi_align_backward_plain(g, bidx, rois, (B, H, W, C), (14, 14), 1 / 16, 0, True)
    want = int((dF[..., 0] > 0).sum())
    assert 0 < want < 2 * H * W
    assert chip_smoke.read_map_pixels(torch.empty((B, H, W, C)), bidx, rois) == want


def _row_of_boxes(n):
    """n boxes of 10x10 on a row, 20 apart: no two overlap."""
    x = torch.arange(n, dtype=torch.float32) * 20
    return torch.stack([x, torch.zeros(n), x + 10, torch.full((n,), 10.0)], 1)


@pytest.mark.parametrize("n, max_out, want", [
    # rows 0 and 1 overlap (IoU 90/110 > 0.7): 1 is suppressed; the walk stops at row 2 with 2 kept,
    # 2 + 0 later boxes examined, 3 x 21 + 2 x 9 bytes
    (3, 2, (81, 14 * 2, 1, 2)),
    # no overlap: max_out reached at sorted row 99, in the second 64-row block
    (200, 100, (200 * 21 + 100 * 9, 14 * sum(range(100)), 2, 100)),
    # max_out above N: every row is kept and the walk visits all four blocks
    (200, 300, (200 * 21 + 300 * 9, 14 * sum(range(200)), 4, 200)),
])
def test_nms_work_counts_what_the_walk_needs(n, max_out, want):
    boxes = _row_of_boxes(n)
    if n == 3:
        boxes[1] = torch.tensor([1.0, 0.0, 11.0, 10.0])
    scores = torch.linspace(1.0, 0.5, n)
    bound_ms, by = chip_smoke.nms_work(nms_ops, boxes, scores, None, 0.7, max_out)
    blocks, kept = chip_smoke.walk_extent(nms_ops, *nms_ops.nms(boxes, scores, 0.7, max_out), scores, None, max_out)
    want_bytes, want_flops, want_blocks, want_kept = want
    t_bytes, t_ops = want_bytes / 3.35e12, want_flops / 67e12
    assert (blocks, kept) == (want_blocks, want_kept)
    assert bound_ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("case, passes", [
    ("equal", True), ("one value 5% off", False), ("a zero made nonzero", False), ("fp32 output", False),
])
def test_bf16_max_abs_err_holds_a_kernel_to_rtol_and_zeros(case, passes):
    want = torch.rand((4, 14, 14, 8), generator=torch.Generator().manual_seed(0)) + 0.5
    want[0] = 0.0
    got = want.bfloat16()
    if case == "one value 5% off":
        got[1, 2, 3, 4] *= 1.05
    elif case == "a zero made nonzero":
        got[0, 0, 0, 0] = 1e-3
    elif case == "fp32 output":
        got = want.clone()
    if passes:
        err = chip_smoke.bf16_max_abs_err(case, got, want)
        assert err == (want.bfloat16().float() - want).abs().max().item() and 0 < err < 2e-2 * 1.5
    else:
        with pytest.raises(SystemExit, match="chip_smoke FAILED"):
            chip_smoke.bf16_max_abs_err(case, got, want)


@pytest.mark.parametrize("case, passes", [
    ("5e-6 of the samples' magnitude where they cancel", True),
    ("2e-5 of the samples' magnitude where they cancel", False),
    ("1.5% of |want| where they partly cancel", True),
    ("3% of |want| where they partly cancel", False),
])
def test_k1_is_held_relative_to_the_samples_it_sums(case, passes):
    """On a map with negative values an output can cancel to near zero,
    where fp32 sums in another order part by far more than 2e-2 of |want|:
    K1's check allows 1e-5 of the samples' magnitude (`k1_scale`, the plain
    version on the map's absolute values) besides, and stays rtol 2e-2 of
    |want| where the samples cancel only in part, as most outputs of a
    signed map do (2e-2 of the samples' magnitude would pass 3% there). One
    output of channel 0 is made to cancel by shifting the channel (each
    output inside the map weighs its samples to a sum of one); the error is
    put there or at an output whose |want| is about 0.3 of its samples'."""
    g = torch.Generator().manual_seed(3)
    feats = torch.rand((1, 12, 16, 8), generator=g) - 0.5
    boxes = torch.tensor([[1.0, 1.0, 9.0, 7.0], [2.5, 0.5, 13.0, 11.0]])
    args = (torch.zeros(2, dtype=torch.int32), boxes, (7, 7), 1.0, 0, True)
    cancelled = (0, 3, 3, 0)
    feats[..., 0] -= roi_ops.roi_align_batched_plain(feats, *args)[cancelled] * (1 - 1e-4)
    want = roi_ops.roi_align_batched_plain(feats, *args)
    assert torch.equal(chip_smoke.k1_scale(roi_ops, feats.bfloat16(), *args),
                       roi_ops.roi_align_batched_plain(feats.bfloat16().float().abs(), *args))
    samples = chip_smoke.k1_scale(roi_ops, feats, *args)
    assert 0 < want[cancelled].abs() < 2e-4 * samples[cancelled]
    part = torch.unravel_index(torch.argmin((want.abs() / samples - 0.3).abs()), want.shape)
    assert 0.2 < want[part].abs() / samples[part] < 0.5
    got = want.clone()
    frac = float(case.split(" of ")[0].rstrip("%")) / (100 if "%" in case else 1)
    if "where they cancel" in case:
        got[cancelled] += frac * samples[cancelled]
    else:
        got[part] += frac * want[part].abs()
    got = got.bfloat16()
    if "where they cancel" in case:
        with pytest.raises(SystemExit, match="chip_smoke FAILED"):  # |want| alone fails it
            chip_smoke.bf16_max_abs_err("K1", got, want)
    if passes:
        assert chip_smoke.bf16_max_abs_err("K1", got, want, samples) > 0
    else:
        with pytest.raises(SystemExit, match="chip_smoke FAILED"):
            chip_smoke.bf16_max_abs_err("K1", got, want, samples)


@pytest.mark.parametrize("tamper, want_err", [(None, 0.0), ("an index moved by 3", 3.0), ("a row short", float("inf"))])
def test_nms_max_abs_err_compares_each_image_with_the_plain_version(tamper, want_err):
    boxes = torch.stack([_row_of_boxes(50), _row_of_boxes(50).flip(0)])
    scores = torch.stack([torch.linspace(1.0, 0.5, 50)] * 2)
    valid = torch.ones((2, 50), dtype=torch.bool)
    idx, ok = nms_ops.nms(boxes, scores, 0.7, 20, valid=valid)
    if tamper == "an index moved by 3":
        idx = idx.clone()
        idx[1, 5] += 3
    elif tamper == "a row short":
        idx, ok = idx[:, :-1], ok[:, :-1]
    assert chip_smoke.nms_max_abs_err(nms_ops, (idx, ok), boxes, scores, valid, 0.7, 20) == want_err
    assert chip_smoke.nms_equal(nms_ops, boxes, scores, valid, 0.7, 20) is not None


@pytest.mark.parametrize("branch", ["image_region", "caption_pl_region"])
def test_branch_kernel_calls_are_the_region_branchs_own(monkeypatch, branch):
    """`branch_kernel_calls` rebuilds what the region branch hands to
    `roi_align_batched` (the source pool, then the translated one) and to
    the RPN's `nms`, exactly, with the same draws."""
    cfg = flagship_config(tiny=True)
    model = build_model(cfg, device="cpu", training=True)
    init_random_(model, torch.Generator().manual_seed(6))
    batch = synthetic_batch(2, 128, 160, seed=4, device="cpu")
    draw = chip_smoke.site_draw("cpu")
    nms_call, pool_calls = chip_smoke.branch_kernel_calls(model, batch, draw, branch)

    pools, nmss = [], []
    pool, nms = roi_heads.roi_align_batched, rpn.nms

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.detach().clone(), batch_idx.clone(), boxes.clone()))
        return pool(features, batch_idx, boxes, *args)

    def nms_spy(boxes, scores, iou_threshold, max_out, valid=None):
        nmss.append((boxes.clone(), scores.clone(), valid.clone(), iou_threshold, max_out))
        return nms(boxes, scores, iou_threshold, max_out, valid=valid)

    monkeypatch.setattr(roi_heads, "roi_align_batched", pool_spy)
    monkeypatch.setattr(rpn, "nms", nms_spy)
    with torch.no_grad():
        if branch == "image_region":
            model.image_consistency_region(batch, draw)
        else:
            model.caption_pl_region_prefixes(batch, draw)

    assert len(nmss) == 1 and len(pools) == len(pool_calls) == 2
    for x, y in zip(nms_call[:3], nmss[0][:3]):
        assert torch.equal(x, y)
    assert nms_call[3:] == nmss[0][3:] == (cfg.rpn_nms_thresh, cfg.rpn_post_nms_topk_train)
    for (label, *got), want in zip(pool_calls, pools):
        assert got[2].shape == (2 * cfg.region_consistency_boxes, 4), label
        for x, y in zip(got, want):
            assert torch.equal(x, y), label
    assert torch.equal(pool_calls[0][3], pool_calls[1][3]) and not torch.equal(pool_calls[0][1], pool_calls[1][1])


def test_mean_teacher_kernel_calls_are_the_steps_own(monkeypatch, tmp_path):
    """`mean_teacher_kernel_calls` rebuilds what a mean-teacher step past
    burn-up hands to `roi_align_batched` (the teacher's pool, each student
    pass's) and to the RPN's `nms` (the teacher's, each student pass's),
    exactly, with the same draws; the teacher's detection NMS is
    `eval_kernel_calls`' (held against inference by its own test)."""
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(chip_smoke.__file__).replace("chip_smoke.py", "cddmsl_torch/configs/mt_tiny.yaml"))
    cfg.OUTPUT_DIR = str(tmp_path)
    trainer = MeanTeacherTrainer(cfg, device="cpu")
    trainer.bbox_threshold = 0.0  # every detection a pseudo-label: the pseudo pass samples some
    trainer.state.iteration = cfg.SEMISUPNET.BURN_UP_STEP + 1
    views = [synthetic_batch(2, 96, 160, seed=s, device="cpu") for s in range(4)]
    draws = (chip_smoke.site_draw("cpu"), chip_smoke.site_draw("cpu"))
    pool_calls, nms_calls = chip_smoke.mean_teacher_kernel_calls(trainer, ((views[0], views[1]),
                                                                           (views[2], views[3])), draws)

    pools, nmss = [], []
    pool, nms = roi_heads.roi_align_batched, rpn.nms

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.detach().clone(), batch_idx.clone(), boxes.detach().clone()))
        return pool(features, batch_idx, boxes, *args)

    def nms_spy(boxes, scores, iou_threshold, max_out, valid=None):
        nmss.append((boxes.clone(), scores.clone(), valid.clone(), iou_threshold, max_out))
        return nms(boxes, scores, iou_threshold, max_out, valid=valid)

    monkeypatch.setattr(roi_heads, "roi_align_batched", pool_spy)
    monkeypatch.setattr(rpn, "nms", nms_spy)
    trainer.mt_step(*views, *draws)
    assert [label for label, *_ in pool_calls] == ["teacher", "supervised", "pseudo"]
    # the step's order: the supervised pass, the teacher, the pseudo-labeled pass
    for (label, *got), want in zip([pool_calls[1], pool_calls[0], pool_calls[2]], pools, strict=True):
        for x, y in zip(got, want):
            assert torch.equal(x, y), label
    rpn_calls = [nms_calls[0], nms_calls[2], nms_calls[3]]  # the teacher's RPN, then the two student RPNs'
    for got, want in zip([rpn_calls[1], rpn_calls[0], rpn_calls[2]], nmss, strict=True):
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(x, y)
        assert got[3:] == want[3:]
    assert len(nms_calls) == 4 and nms_calls[1][3:] == (0.5, 100)  # the teacher's detection NMS (eval_kernel_calls)


# ---------------- phase 21: the deformable towers ----------------
@pytest.mark.parametrize("label, config, modulated, blocks", [
    ("dconv", chip_smoke.DCONV_CONFIG, True, 13), ("dconv_panoptic", chip_smoke.DCONV_PANOPTIC_CONFIG, False, 30),
])
def test_phase_21_trains_the_dconv_files_at_batch_8(tmp_path, label, config, modulated, blocks):
    """The files as phase 21 runs them: DCN v2 on R-50's res3..res5 (13
    blocks) and DCN v1 on R-101's (30, with GN, the stride in the 3x3 and
    the cascade), batch 8, no final test (an eval batch instead)."""
    from cddmsl_torch.config import check_supported
    from cddmsl_torch.models.build import build_detector

    steps = chip_smoke.DCONV_STEPS if label == "dconv" else chip_smoke.DCONV_PANOPTIC_STEPS
    cfg = chip_smoke.train_cfg(str(tmp_path), config, ("a", "b"), steps, test=False)
    check_supported(cfg, world=1)
    m = cfg.MODEL.RESNETS
    assert list(m.DEFORM_ON_PER_STAGE) == [False, True, True, True] and m.DEFORM_MODULATED is modulated
    assert (cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.MAX_ITER, cfg.DATASETS.TEST) == (8, steps, ())
    if label == "dconv_panoptic":
        assert (m.DEPTH, m.NORM, cfg.MODEL.FPN.NORM, m.STRIDE_IN_1X1) == (101, "GN", "GN", False)
        assert cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads" and cfg.MODEL.MASK_ON
    with torch.device("meta"):
        model = build_detector(cfg, device="meta")
    assert len(chip_smoke.deformable_blocks(model)) == blocks


@pytest.mark.parametrize("which", ["dconv", "dconv_panoptic"])
def test_seed_offsets_moves_every_tap_by_about_a_pixel(which):
    """A zero offset conv (the init) leaves the tower a plain one; after
    `seed_offsets` each block's offsets have an RMS of DCONV_OFFSET_PX over
    the images it was seeded on (the two passes agree within a few %), and
    the tower's output differs from the plain tower's."""
    batch = chip_smoke.tiny_unpadded_batch(5, stuff_classes=6)
    if which == "dconv":
        model = chip_smoke.narrow_dconv_model()
        init_random_(model, torch.Generator().manual_seed(1))
    else:
        model = chip_smoke.narrow_dconv_panoptic_model(batch)
        init_random_(model, torch.Generator().manual_seed(1))
    convs = [b.conv2_offset for b in chip_smoke.deformable_blocks(model)]
    assert len(convs) == 3 and all(not c.weight.any() for c in convs)
    def p2(images):  # FPNRCNN's features are (the heads' levels, the RPN's), Panoptic FPN's its levels
        levels = model.features(images)
        return levels[0][0] if isinstance(levels[0], list) else levels[0]

    with torch.no_grad():
        plain = p2(batch.image)
        mean_abs = chip_smoke.seed_offsets(model, batch.image, 7)
        with chip_smoke.recorded_deform_calls() as calls:
            moved = p2(batch.image)
    assert len(calls) == 3 and all(0.3 < v < 1.2 for v in mean_abs)
    for (args, kw) in calls:
        rms = float(args[1].float().pow(2).mean().sqrt())
        assert abs(rms - chip_smoke.DCONV_OFFSET_PX) < 0.1, rms
        assert kw["layout"] == "NCHW" and (args[3] is not None) == (which == "dconv")
    assert not torch.allclose(plain, moved)


@pytest.mark.parametrize("which", ["dconv", "dconv_panoptic"])
def test_kernel_calls_are_wired_on_both_deformable_paths(monkeypatch, which):
    """`KernelCalls` records a narrow deformable model's step and eval
    batch as phase 21's paths make them: the dconv Mask R-CNN's box and mask
    pools on four levels (8 a step, all with a gradient; 8 an eval batch)
    and its RPN and detection NMS; the panoptic dconv cascade's three stage
    pools and the mask pool (16 a step and an eval batch), its RPN on p2 and
    the detection NMS; each recorded call replays to what the model got."""
    from test_torch_port_cascade import recorded_kernel_calls

    from cddmsl_torch.config import SolverConfig
    from cddmsl_torch.models.fpn_rcnn import FPNRCNN
    from cddmsl_torch.models.panoptic_fpn import PanopticFPN

    batch = chip_smoke.tiny_unpadded_batch(5, stuff_classes=6)
    batch = batch._replace(proposal_boxes=None, proposal_scores=None, proposal_valid=None)
    common = dict(num_classes=20, depth=10, backbone_width=8, mask_on=True, mask_num_conv=2, mask_conv_dim=16,
                  pixel_mean=(103.53, 116.28, 123.675), pixel_std=(57.375, 57.12, 58.395),
                  deform_on_per_stage=(False, True, True, True))
    if which == "dconv":
        model = FPNRCNN(**common, res2_out_channels=32, fpn_out_channels=32, fc_dim=64, emb_dim=48,
                        rpn_pre_nms_topk=(64, 48), rpn_post_nms_topk=(32, 24), roi_batch_size_per_image=32,
                        deform_modulated=True)
        per_step = 8
    else:
        model = PanopticFPN(**common, sem_seg_classes=6, sem_seg_norm="GN", backbone_norm="GN", fpn_norm="GN",
                            stride_in_1x1=False, cascade=True)
        per_step = 16
    init_random_(model, torch.Generator().manual_seed(2))
    chip_smoke.seed_offsets(model, batch.image, 3)
    trainer = Trainer(model, build_optimizer(model, SolverConfig(base_lr=0.001, warmup_iters=0)),
                      enable_caption=False)
    step = recorded_kernel_calls(monkeypatch, "step", lambda: trainer.train_step(batch, chip_smoke.site_draw("cpu")))
    assert len(step.pools) == len(step.k3) == per_step and len(step.nms) == 1
    with torch.no_grad():
        ev = recorded_kernel_calls(monkeypatch, "eval", lambda: model.inference(batch))
    assert len(ev.pools) == per_step and not ev.k3 and len(ev.nms) == 2


def test_deform_bound_counts_each_byte_once_and_the_products_flops():
    """One res4 call of R-101 at batch 8 (50x84x256 -> 50x84x256, DCN v1):
    the im2col product's FLOPs over fp32's peak exceed the bytes' time."""
    n, c, h, w, cout = 8, 256, 50, 84, 256
    positions = n * h * w
    flops = 2 * positions * 9 * c * cout + 8 * positions * 9 * c
    moved = 4 * (n * c * h * w + positions * 18 + positions * cout)
    want = max(flops / chip_smoke.H100_FP32_FLOP_PER_S, moved / chip_smoke.H100_BYTES_PER_S) * 1e3
    assert chip_smoke.deform_bound_ms(n, c, h, w, h, w, cout, False) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(flops / chip_smoke.H100_FP32_FLOP_PER_S * 1e3)
    assert chip_smoke.deform_bound_ms(n, c, h, w, h, w, cout, True) >= chip_smoke.deform_bound_ms(
        n, c, h, w, h, w, cout, False)


def _update_under_noise(make_model, batch):
    """One fp32 step of `make_model()` on the CPU, and of the same model
    with every weight moved by 1e-7 of its value: the two updates apart,
    over the first update's norm."""
    import copy

    from cddmsl_torch.config import SolverConfig

    model = make_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moved = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    after = []
    for m in (model, moved):
        trainer = Trainer(m, build_optimizer(m, SolverConfig(base_lr=0.02, warmup_iters=0)), enable_caption=False)
        trainer.train_step(batch, chip_smoke.site_draw("cpu"))
        after.append(m.state_dict())
    keys = [k for k in before if before[k].is_floating_point()]
    num = sum(float(((after[1][k].double() - after[0][k].double()) ** 2).sum()) for k in keys)
    den = sum(float(((after[0][k].double() - before[k].double()) ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def test_the_narrow_panoptic_dconv_step_is_well_conditioned():
    """Phase 21 holds the narrow panoptic dconv step on the card to the
    CPU's within 1e-4 of the update's norm: at its bottleneck of 64 float
    noise (weights moved by 1e-7) moves the CPU's own update by well under
    that (at 8, where each of the tower's GN groups is one channel, it
    moves it by more)."""
    batch = chip_smoke.tiny_unpadded_batch(chip_smoke.DCONV_SEED + 1, stuff_classes=6)
    apart = _update_under_noise(lambda: chip_smoke.narrow_dconv_panoptic_model(batch), batch)
    assert apart < 5e-5, apart


# ---------------- phase 22 ----------------
def test_phase_22_runs_the_cityscapes_file_on_its_own_sets_at_the_1024x2048_pad(tmp_path):
    """(b)'s tree: the file's own set names, batch 8, the final test, the
    pad that holds Cityscapes' 1024x2048 images at MIN_SIZE_TRAIN up to 1024
    and MAX_SIZE 2048; (a)'s: the rotated file builds R-18 to a res4 of 256
    channels and an RPN head conv of 1024, as JAX's, and `check_supported`
    refuses it."""
    from cddmsl_torch.config import check_supported
    from cddmsl_torch.models.build import build_rotated_fast_rcnn

    pad = repr(list(chip_smoke.CITY_INST_HW))
    cfg = chip_smoke.train_cfg(str(tmp_path), chip_smoke.CITY_INST_CONFIG, chip_smoke.CITY_INST_NAMES,
                               chip_smoke.CITY_INST_STEPS, "TPU.PAD_SIZE_TRAIN", pad, "TPU.PAD_SIZE_TEST", pad)
    check_supported(cfg, world=1)
    assert list(cfg.DATASETS.TRAIN) == ["cityscapes_fine_instance_seg_train"]
    assert list(cfg.DATASETS.TEST) == ["cityscapes_fine_instance_seg_val"]
    assert max(cfg.INPUT.MIN_SIZE_TRAIN) == 1024 and cfg.INPUT.MAX_SIZE_TRAIN == 2048 and cfg.MODEL.MASK_ON
    assert list(cfg.TPU.PAD_SIZE_TRAIN) == list(cfg.TPU.PAD_SIZE_TEST) == [1024, 2048]
    rot = get_cfg()
    rot.merge_from_file(str(Path(chip_smoke.__file__).parent / "configs" / chip_smoke.ROTATED_CONFIG))
    with torch.device("meta"):
        model = build_rotated_fast_rcnn(rot, device="meta")
    assert model.backbone.out_channels["res4"] == 256 and model.proposal_generator.num_anchors == 60
    with pytest.raises(NotImplementedError, match="RotatedFastRCNN"):
        check_supported(rot, world=1)


def test_phase_22_records_and_checks_each_rotated_op_of_a_step(monkeypatch):
    """(a) on a narrow rotated model on the CPU: `recorded_rotated_calls`
    takes the RRPN match's, the RoI sampler's, both NMS's and both pools'
    inputs, and `rotated_ops_on_card` checks and prints each (here the
    "card" is the CPU and the timer runs a call once)."""
    from cddmsl_torch.models.rotated_rcnn import RotatedFastRCNN
    from cddmsl_torch.models.sampling import generator_draw

    dev = torch.device("cpu")
    model = RotatedFastRCNN(num_classes=8, depth=18, pixel_std=(57.0, 57.0, 57.0)).eval()  # res4 of 256
    init_random_(model, torch.Generator().manual_seed(0))
    batch = chip_smoke.rotated_batch(2, (64, 96), 10, 4, 0, dev)
    assert batch.gt_valid.sum(1).tolist() == [4, 4] and (batch.gt_boxes[~batch.gt_valid] == 0).all()
    with chip_smoke.recorded_rotated_calls() as calls, torch.enable_grad():
        losses = model(batch, generator_draw(torch.Generator().manual_seed(1)))
    with chip_smoke.recorded_rotated_calls() as infer:
        model.inference(batch)
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    anchors = 4 * 6 * 60
    assert [tuple(b.shape) for c in calls["iou"] for b in c] == [(10, 5), (anchors, 5)] * 2 + [(10, 5), (138, 5)] * 2
    assert [(c[0].shape[0], c[3]) for c in calls["nms"] + infer["nms"]] == [(512, 128)] * 4 + [(256, 32)] * 2
    assert [tuple(c[1].shape) for c in calls["pool"] + infer["pool"]] == [(2, 64, 5), (2, 128, 5)]
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=2: (fn(), 0.0)[1])
    chip_smoke.rotated_ops_on_card({k: calls[k] + infer[k] for k in calls}, "cpu")


def test_the_rotated_bounds_count_what_the_data_needs():
    """The IoU's clipped pairs are those `near_pairs` finds (a box and its
    far copy: 1 of 4 pairs each way), its clip work the vertices and
    crossings of each step (a square against itself: 4 read a step, no
    crossing; against its copy 2 px to the right: the left edge crosses it
    twice), and an axis-aligned 32x32 box pooled 7x7 at 1/16 reads the 2x2
    map pixels under its samples' corners."""
    from cddmsl_torch.ops.rotated import clip_work

    boxes = torch.tensor([[10.0, 10.0, 4.0, 4.0, 0.0], [100.0, 100.0, 4.0, 4.0, 30.0]])
    _, _, clipped = chip_smoke.rotated_iou_bound_ms(boxes, boxes)
    assert clipped == 2
    square, moved = boxes[:1], torch.tensor([[12.0, 10.0, 4.0, 4.0, 0.0]])
    assert clip_work(square, square) == (1, 16, 0, 4)
    assert clip_work(square, moved) == (1, 16, 2, 4)
    ms, by, _ = chip_smoke.rotated_iou_bound_ms(square.expand(64, 5), moved.expand(64, 5))
    flops = 64 * 64 * (10 + 14 + 16 * 5 + 2 * 8 + 4 * 4)  # every pair clipped
    t_ops, t_bytes = flops / chip_smoke.H100_FP32_FLOP_PER_S, (128 * 20 + 64 * 64 * 4) / chip_smoke.H100_BYTES_PER_S
    assert t_ops > t_bytes and by == "operations" and ms == pytest.approx(t_ops * 1e3)
    feats = torch.zeros(1, 8, 8, 4)
    box = torch.tensor([[[40.0, 40.0, 32.0, 32.0, 0.0]]])  # (24..56) px: (1.5..3.5) - 0.5 map px
    ms, by, pixels = chip_smoke.rotated_pool_bound_ms(feats, box, 7, 1 / 16)
    assert pixels == 9  # rows and columns 1..3
    # 9 pixels of 4 fp32 channels, the box, 7x7x4 fp32 values; 68 flops each
    assert by == "bytes" and ms == pytest.approx((9 * 16 + 20 + 196 * 4) / chip_smoke.H100_BYTES_PER_S * 1e3)


def test_the_tta_merge_gets_a_problem_that_keeps_about_max_det():
    """(c)'s merge candidates: 2 x 100 class-shifted boxes an image, the
    second hundred the first moved by at most 2 px a side, every one valid;
    the plain merge keeps at least `TTA_MIN_KEPT` of them an image."""
    boxes, scores, valid = chip_smoke.tta_merge_candidates((3, 200), 8, (1024, 2048), 0, torch.device("cpu"))
    assert boxes.shape == (3, 200, 4) and scores.shape == (3, 200) and bool(valid.all())
    assert float(scores.min()) >= 0.05 and float(scores.max()) < 1.0
    assert float((boxes[:, 100:] - boxes[:, :100]).abs().max()) <= 2.0 + 1e-3
    for i in range(3):
        kept = int(nms_ops.nms_plain(boxes[i], scores[i], 0.5, 100, valid=valid[i])[1].sum())
        assert chip_smoke.TTA_MIN_KEPT <= kept <= 100, kept
