"""The parts of chip_smoke.py that the CPU can check: the rebuilt RoIAlign
calls of a training step, which its training rows time, the bounds its
kernels line reports beside each time, and the NMS walk's blocks and kept
rows it prints.

The rebuilt calls must be the step's own: one tiny CDDMSL step past burn-up
runs on the CPU with a spy on `roi_align_batched`, and the spy's record of
every call (map, image indices, boxes) must equal, exactly, what
`training_roi_align_calls` returns for the same weights and draws (the same
float32 operations on the same inputs, and draws that depend on the site
name alone).
"""

import pytest
import torch

import chip_smoke
from cddmsl_torch.checkpoint.convert_jax import init_random_
from cddmsl_torch.config import flagship_config, flagship_solver_config
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.entry import synthetic_batch
from cddmsl_torch.models import roi_heads
from cddmsl_torch.models.build import build_model
from cddmsl_torch.ops import nms as nms_ops
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


@pytest.mark.parametrize("R, want_bytes", [
    # the supervised pool: g (or the pooled values) 1024x14x14x1024 bf16 = 411,041,792 B, boxes and
    # indices 1024x20 = 20,480 B, dF (or the map) 2x50x84x1024 bf16 = 17,203,200 B
    (1024, 428_265_472),
    # a region pool: 32x14x14x1024 bf16 = 12,845,056 B, 32x20 = 640 B, the same map 17,203,200 B
    (32, 30_048_896),
])
def test_roi_bounds_count_each_byte_once_at_the_training_shape(R, want_bytes):
    feats = torch.empty((2, 50, 84, 1024), dtype=torch.bfloat16, device="meta")
    bound_ms, by = chip_smoke.roi_bounds_ms(feats, R)
    assert bound_ms == pytest.approx(want_bytes / 3.35e12 * 1e3, rel=1e-12)
    assert by == "bytes"
    # 16 multiply-adds (32 flops) per pooled value at S = 2, below the bytes at 67 TFLOP/s
    flops_ms = 32 * R * 14 * 14 * 1024 / 67e12 * 1e3
    assert flops_ms < bound_ms


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
