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
what the branch hands to them.
"""

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
from cddmsl_torch.ops import nms as nms_ops
from cddmsl_torch.ops import roi_align as roi_ops
from cddmsl_torch.solver.build import build_optimizer


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
