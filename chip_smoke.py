"""Runs the cddmsl_torch port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. the card: its name, and its name and power limit from nvidia-smi;
  2. builds the kernels with nvcc for sm_90a, one process per source, in
     parallel: K1 (RoIAlign forward) and K3 (RoIAlign backward) in
     csrc/roi_align.cu, K4 (NMS) in csrc/nms.cu;
  3. holds each kernel against its plain PyTorch version on the card:
     K1 on 1000 ROIs over a 40x50x1024 map, fp32 (TF32 off) to atol 1e-4
     and bf16 (against the plain version in fp32 on the same bf16 inputs)
     to rtol 2e-2; K3 on two 50x84x1024 maps with heavily overlapping and
     partly outside boxes, aligned both ways, fp32 to 1e-4 of max |dF|
     (relative to the largest value: K3 sums in another order than the
     plain version) and bf16 to rtol 2e-2, bit for bit against a second call
     on the same inputs, and torch.autograd through `roi_align_batched`
     against autograd through the plain forward; K4 exactly, on 6000 boxes at IoU 0.7
     keeping 1000, on 12000 boxes keeping 2000 (the training RPN), on 2048
     class-shifted boxes at 0.5 keeping 100, on a cluster whose IoUs sit
     within a few ulps of the threshold, at the edges of its 64-row blocks,
     on tied duplicates, on dense boxes with heavy suppression, at a
     threshold of 0 (every pair divides), with no valid row, with valid
     rows scored -inf, and on a batch of three images (twice: the same
     result);
  4. the tiny configuration in fp32 on the card against the same model on
     the CPU (plain versions): inference on two 128x160 images, and one
     training step with the same weights and the same sampler draws (the 7
     losses to rtol 1e-4, the parameters after the step to atol 1e-5);
  5. the inference path: `entry()`'s full-width flagship detector
     (CLIP-RN50 C4, bf16, seeded random weights) on one 640x800 image
     through `model.inference`, with the launch counts read around that one
     call, then timed with CUDA events: ms per image, each stage, and K1
     and K4 at the path's shapes, each held against its plain version on
     the same inputs (K1 in bf16 to rtol 2e-2, K4 exactly) and timed beside
     it and its bound;
  6. the training path: `train_entry()`'s full-width flagship (bf16 compute,
     fp32 parameters) takes one CDDMSL step past burn-up on two 800x1344
     images, with the launch counts read around that step; all 7 losses
     finite, frozen parameters bit-for-bit unchanged; then 2 warm-up and 5
     timed steps (ms/step, images/s), after which every trainable parameter
     has moved, and K1, K3 and K4 at the step's own shapes, each held
     against its plain version on the same inputs (K1 and K3 in bf16 to rtol
     2e-2 with the same zeros, K4 exactly) and timed beside it and its
     bound: K1 and K3 at each of the step's three RoIAlign calls
     (`training_roi_align_calls`: the supervised pool and the region pool on
     the source and on the translated map), one line each;
  7. the train_net path: `DefaultTrainer` on the VOC recipe (batch 8, bf16,
     clip by norm 5.0, KD off, seeded random weights: the RegionCLIP and
     ClipCap files are not in the repository) with the synthetic VOC
     fixture (16 images) through `train()`: 12 steps, the caption branch on
     from step 5, checkpoints at steps 6 and 12, then the final `test()`.
     Per step: CUDA events, host wall, the wait on the loader and the
     K1/K3/K4 launches (3/3/1 with the caption branch, 1/1/1 before, or the
     run fails); launches per eval batch (1/0/2), eval ms per image through
     `inference_on_dataset`, the AP dict (printed, not judged); a new
     trainer resumed from model_final must hold iteration 12 and the saved
     parameters and momentum bit for bit; then 5 steps timed on one batch
     of the loop's loader already on the card, beside the loop's ms/step,
     2 more traced with torch.profiler for the device's busy and idle
     shares, and K1, K3 and K4 checked and timed at that batch's shapes as
     in phase 6, then K1 and K4 at the shapes of the test set's first batch
     (`eval_kernel_calls`: the RoI heads' pool, the RPN NMS and the
     detection NMS);
  8. the adverse-weather path: `DefaultTrainer` on the Cityscapes -> Foggy
     Cityscapes / BDD100k recipe (batch 8, bf16, KD on, clip by norm 5.0)
     with a fixture at the data's size: 16 Cityscapes train PNGs of
     2048x1024 with fog twins (one missing), 8 val PNGs and 8 BDD-style
     1280x720 JPEGs in a COCO json, registered under the fixture's own
     names in DATASETS.TRAIN and DATASETS.TEST. MODEL.WEIGHTS is a
     detectron2-style `model_final.pth` of a seeded full-width model in the
     d2_rcnn dialect (9-row cls_score, 36-output bbox_pred): after the load
     the backbone, the offline backbone, the RPN head and the box predictor
     must equal the file's tensors after the background-row surgery, bit
     for bit.
     `test()` of the loaded weights on the three test sets, then `train()`:
     8 steps, the caption branch on from step 5, launches checked per step
     as in phase 7, every loss finite (KD's too), the frozen parameters
     unchanged bit for bit, and the final test set by set (launches 1/0/2
     per batch, eval ms per image, AP dicts printed, not judged). Then
     `train_net.main --eval-only` from the same file must give the AP dicts
     of the first `test()`; last, the step timed on one batch of the loop's
     loader already on the card and K1, K3 and K4 checked and timed at its
     shapes as in phase 6, then K1 and K4 at the shapes of the first batch
     of a Cityscapes test set and of the BDD one, as in phase 7.
The line before the last is the kernels' JSON, one row per kernel and path
(`roi_align_fwd/inference`, ..., `nms/adverse_weather`). `launches` counts
that path's whole run (for train_net, 12 steps and the final test; for
adverse_weather, 8 steps and the final test);
`max_abs_err`, `ms`, `plain_ms` and `bound_ms` cover the `launches_timed`
launches checked and timed at the path's shapes (one inference; one
training step; for train_net and adverse_weather also K1 and K4 of one
eval batch per test set checked, 1 and 2 launches each): the largest error
and the sums of the times and bounds.
The last line is {"ok": true, "device": {...}}. Without a CUDA device it
exits 1 and prints no result.
"""

import collections
import json
import math
import subprocess
import sys
import time
import zlib

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_boxes(gen, n, w, h, dev, min_size=4.0, max_size=400.0):
    x1 = torch.rand(n, generator=gen, device=dev) * w
    y1 = torch.rand(n, generator=gen, device=dev) * h
    bw = min_size + torch.rand(n, generator=gen, device=dev) * max_size
    bh = min_size + torch.rand(n, generator=gen, device=dev) * max_size
    return torch.stack([x1, y1, x1 + bw, y1 + bh], 1)


def near_threshold_cluster(thr: float, n_pairs: int, dev) -> torch.Tensor:
    """Pairs (base, widened base) whose float32 IoU lands within a few ulps
    of `thr`, on both sides of it."""
    out = []
    for g in range(n_pairs):
        x, y = 13.0 * g, 7.0 * g
        w, h = 40.0 + g % 17, 30.0 + g % 11
        target = thr * (1.0 + (g % 7 - 3) * 6e-8)
        out += [[x, y, x + w, y + h], [x, y, x + w / target, y + h]]
    return torch.tensor(out, dtype=torch.float32, device=dev)


def check_k1(roi_ops, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    R, C = 1000, 1024
    feats = torch.rand((1, 40, 50, C), generator=gen, device=dev)
    boxes = random_boxes(gen, R, 800.0, 640.0, dev)
    boxes[:8] = torch.tensor([[0, 0, 800, 640], [-50, -40, 30, 20], [790, 630, 900, 700],
                              [100, 100, 100, 100], [300, 200, 301, 200.5], [0, 0, 16, 16],
                              [-10, 300, 810, 340], [400, -5, 420, 650]], device=dev)
    bidx = torch.zeros(R, dtype=torch.int32, device=dev)
    args = ((14, 14), 1 / 16, 0)
    errs = {}
    for aligned in (True, False):
        got = roi_ops.roi_align_batched(feats, bidx, boxes, *args, aligned)
        want = roi_ops.roi_align_batched_plain(feats, bidx, boxes, *args, aligned)
        errs[f"fp32_aligned={aligned}"] = (got - want).abs().max().item()
    fp32_err = max(errs.values())
    if not fp32_err <= 1e-4:
        fail(f"K1 fp32 disagrees with the plain version: {errs}")
    fb = feats.bfloat16()
    got = roi_ops.roi_align_batched(fb, bidx, boxes, *args, True).float()
    want = roi_ops.roi_align_batched_plain(fb.float(), bidx, boxes, *args, True)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[want != 0]
    bad = int(((got - want).abs() > 2e-2 * want.abs()).sum())
    if bad:
        fail(f"K1 bf16: {bad} values off by more than rtol 2e-2 (max rel {rel.max().item():.3g})")
    # a batch of two maps: each ROI must pool from its own image
    feats2 = torch.rand((2, 40, 50, C), generator=gen, device=dev)
    bidx2 = torch.randint(0, 2, (R,), generator=gen, device=dev, dtype=torch.int32)
    err2 = (roi_ops.roi_align_batched(feats2, bidx2, boxes, *args, True)
            - roi_ops.roi_align_batched_plain(feats2, bidx2, boxes, *args, True)).abs().max().item()
    if not err2 <= 1e-4:
        fail(f"K1 batched fp32 disagrees with the plain version: {err2}")
    print(f"K1 check: fp32 max abs err {errs} (tol 1e-4), batched {err2:.3g}, "
          f"bf16 max rel err {rel.max().item():.3g} (rtol 2e-2)")


def check_k3(roi_ops, dev):
    """K3 against `roi_align_backward_plain`, and the autograd of
    `roi_align_batched` against autograd through the plain forward."""
    gen = torch.Generator(device=dev).manual_seed(4)
    B, H, W, C, R = 2, 50, 84, 1024, 1024
    boxes = random_boxes(gen, R, 1344.0, 800.0, dev)
    # a quarter of the ROIs on almost the same pixels, and boxes partly outside the map
    boxes[:256] = torch.tensor([300.0, 200.0, 460.0, 330.0], device=dev) + torch.rand(
        (256, 4), generator=gen, device=dev) * 4
    boxes[256:264] = torch.tensor([[-60, -40, 100, 90], [1300, 760, 1500, 900], [-10, 300, 1400, 340],
                                   [500, -30, 540, 830], [0, 0, 1344, 800], [1330, 0, 1350, 20],
                                   [-100, -100, -1, -1], [700, 400, 700.5, 400.5]], device=dev)
    bidx = torch.randint(0, B, (R,), generator=gen, device=dev, dtype=torch.int32)
    shape = (B, H, W, C)
    errs = {}
    for aligned in (True, False):
        g = torch.randn((R, 14, 14, C), generator=gen, device=dev)
        got = roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, aligned)
        if not torch.equal(got, roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, aligned)):
            fail(f"K3 fp32 (aligned={aligned}) differs between two calls on the same inputs")
        want = roi_ops.roi_align_backward_plain(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, aligned)
        errs[f"fp32_aligned={aligned}"] = (got - want).abs().max().item() / want.abs().max().item()
    if not max(errs.values()) <= 1e-4:
        fail(f"K3 fp32 disagrees with the plain version (max abs err / max |dF|): {errs}")
    g = torch.rand((R, 14, 14, C), generator=gen, device=dev).bfloat16()
    got = roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, True)
    if got.dtype != torch.bfloat16 or not got.is_contiguous():
        fail(f"K3 bf16 returned a {got.dtype} tensor")
    if not torch.equal(got, roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, True)):
        fail("K3 bf16 differs between two calls on the same inputs")
    got = got.float()
    want = roi_ops.roi_align_backward_plain(g.float(), bidx, boxes, shape, (14, 14), 1 / 16, 0, True)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[want != 0]
    bad = int(((got - want).abs() > 2e-2 * want.abs()).sum())
    if bad or not torch.equal(got == 0, want == 0):
        fail(f"K3 bf16: {bad} values off by more than rtol 2e-2 (max rel {rel.max().item():.3g})")
    cluster_ms = cuda_ms(lambda: roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, True), 10)
    print(f"K3 bf16 on these boxes (256 of {R} on almost the same pixels): {cluster_ms:.4f} ms")
    feats = torch.rand(shape, generator=gen, device=dev)
    cot = torch.randn((R, 14, 14, C), generator=gen, device=dev)
    grads = []
    with torch.enable_grad():
        for fn in (roi_ops.roi_align_batched, roi_ops.roi_align_batched_plain):
            f = feats.clone().requires_grad_(True)
            (grad,) = torch.autograd.grad((fn(f, bidx, boxes, (14, 14), 1 / 16, 0, True) * cot).sum(), f)
            grads.append(grad)
    autograd_err = (grads[0] - grads[1]).abs().max().item() / grads[1].abs().max().item()
    if not autograd_err <= 1e-4 or not grads[0].is_contiguous():
        fail(f"autograd through roi_align_batched disagrees with the plain autograd: {autograd_err}")
    print(f"K3 check: fp32 max abs err / max |dF| {errs} (tol 1e-4), bf16 max rel err {rel.max().item():.3g} "
          f"(rtol 2e-2), autograd {autograd_err:.3g} (tol 1e-4), fp32 and bf16 bit-identical on a second call")


def nms_max_abs_err(nms_ops, got, boxes, scores, valid, thr, max_out) -> float:
    """K4's output `got` (idx, valid) on (B, N, 4) boxes against `nms_plain`
    image by image: the largest difference of a kept index or a validity
    flag (0 where they are equal, inf where their shapes differ)."""
    err = 0.0
    for i in range(boxes.shape[0]):
        want = nms_ops.nms_plain(boxes[i], scores[i], thr, max_out, valid=valid[i])
        for g, w in zip((got[0][i], got[1][i]), want):
            if g.shape != w.shape:
                return float("inf")
            if g.numel():
                err = max(err, (g.long() - w.long()).abs().max().item())
    return err


def nms_equal(nms_ops, boxes, scores, valid, thr, max_out):
    """K4 on (B, N, 4) boxes against `nms_plain` image by image; returns the
    kernel's (idx, valid) or None where they differ."""
    got = nms_ops.nms(boxes, scores, thr, max_out, valid=valid)
    return got if nms_max_abs_err(nms_ops, got, boxes, scores, valid, thr, max_out) == 0 else None


def bf16_max_abs_err(label, got, want) -> float:
    """A kernel's bf16 output against its plain version in fp32 on the same
    bf16 inputs: every value within rtol 2e-2 and the zeros in the same
    places, else the run fails; returns the max abs err."""
    if got.dtype != torch.bfloat16:
        fail(f"{label}: the kernel returned {got.dtype}, not bfloat16")
    got = got.float()
    diff = (got - want).abs()
    bad = int((diff > 2e-2 * want.abs()).sum())
    if bad or not torch.equal(got == 0, want == 0):
        rel = (diff / want.abs().clamp_min(1e-30))[want != 0]
        fail(f"{label}: {bad} values off by more than rtol 2e-2 (max rel {rel.max().item():.3g}), "
             f"or zeros in other places")
    return diff.max().item()


def check_k4(nms_ops, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    boxes = random_boxes(gen, 6000, 800.0, 640.0, dev, max_size=300.0)
    scores = torch.rand(6000, generator=gen, device=dev)
    valid = torch.rand(6000, generator=gen, device=dev) > 0.05
    cases["rpn_6000_0.7_1000"] = (boxes, scores, valid, 0.7, 1000)
    train = random_boxes(gen, 12000, 1344.0, 800.0, dev, max_size=400.0)
    cases["rpn_train_12000_0.7_2000"] = (train, torch.rand(12000, generator=gen, device=dev), None, 0.7, 2000)
    det = random_boxes(gen, 2048, 800.0, 640.0, dev, max_size=200.0)
    cls = torch.randint(0, 20, (2048,), generator=gen, device=dev)
    det_scores = torch.rand(2048, generator=gen, device=dev)
    det_valid = det_scores > 0.05
    shift = cls.float() * (torch.where(det_valid[:, None], det, torch.zeros_like(det)).max() + 1.0)
    cases["det_2048_0.5_100"] = (det + shift[:, None], det_scores, det_valid, 0.5, 100)
    cl = near_threshold_cluster(0.7, 300, dev)
    cases["cluster_600_0.7"] = (cl, torch.rand(len(cl), generator=gen, device=dev), None, 0.7, 600)
    # the edges of the walk's 64-row blocks: max_out reached inside a block, N below and just past 64,
    # max_out above N, tied duplicates across a block edge, no valid row
    for n, k in ((1, 1), (63, 20), (65, 37), (130, 200)):
        cases[f"edge_{n}_0.5_{k}"] = (boxes[:n], scores[:n], valid[:n], 0.5, k)
    dup_boxes, dup_scores = boxes[:300].clone(), torch.round(scores[:300] * 8) / 8
    dup_boxes[40:80], dup_scores[40:80] = dup_boxes[7], dup_scores[7]
    cases["ties_300_0.5_400"] = (dup_boxes, dup_scores, valid[:300], 0.5, 400)
    dense = random_boxes(gen, 3000, 300.0, 200.0, dev, max_size=150.0)  # the walk reads far past max_out rows
    cases["dense_3000_0.3_150"] = (dense, torch.rand(3000, generator=gen, device=dev), None, 0.3, 150)
    # below 2^-100 the threshold test always divides: any overlap suppresses
    cases["zero_thr_600_0.0_600"] = (boxes[:600], scores[:600], valid[:600], 0.0, 600)
    cases["no_valid_row_500_0.7_100"] = (boxes[:500], scores[:500], torch.zeros(500, dtype=torch.bool, device=dev),
                                        0.7, 100)
    # valid rows scored -inf: dropped from the output where max_out >= N, as JAX's nms drops them
    inf_scores = scores[:600].clone()
    inf_scores[1::7] = float("-inf")
    for k in (300, 600):
        cases[f"minus_inf_600_0.7_{k}"] = (boxes[:600], inf_scores, valid[:600], 0.7, k)
    for name, (b, s, v, thr, k) in cases.items():
        v = torch.ones(len(b), dtype=torch.bool, device=dev) if v is None else v
        got = nms_equal(nms_ops, b[None], s[None], v[None], thr, k)
        if got is None:
            fail(f"K4 {name}: kernel and plain version keep different boxes")
        if name.startswith("minus_inf") and k >= len(b) and not torch.isfinite(s[got[0][got[1]]]).all():
            fail(f"K4 {name}: a kept row scored -inf is marked valid")
        print(f"K4 check {name}: equal ({int(got[1].sum())} kept)")
    # a batch of three images in one launch, each with its own validity; a second call gives the same
    bb = torch.stack([boxes, boxes.flip(0), boxes.roll(100, 0)])
    bs = torch.stack([scores, scores.flip(0), scores.roll(100, 0)])
    bv = torch.stack([valid, torch.ones_like(valid), torch.arange(6000, device=dev) < 900])
    got = nms_equal(nms_ops, bb, bs, bv, 0.7, 1000)
    if got is None:
        fail("K4 batched: an image differs from its own plain run")
    again = nms_ops.nms(bb, bs, 0.7, 1000, valid=bv)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        fail("K4 batched: a second call on the same inputs differs")
    print(f"K4 check batched_3x6000_0.7_1000: equal, and equal on a second call ({got[1].sum(1).tolist()} kept)")
    return cases


def nms_work(nms_ops, boxes, scores, valid, thr, max_out):
    """What one image's NMS needs on this data, from the plain version:
    (bound ms, bound_by). Bytes: boxes, scores and valid read once, the
    indices and validity written once; the kernel's scratch (the suppression
    mask) is the design's, not the work's, and is not counted. Operations:
    the IoUs the greedy walk needs, each kept box against every later box up
    to the last row examined, ~14 flops each."""
    n = boxes.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=boxes.device) if valid is None else valid
    order = nms_ops._score_order(scores, valid).indices
    kept = torch.nonzero(nms_ops._greedy_keep(boxes[order], valid[order], thr, max_out)).squeeze(1)[:max_out]
    last = int(kept[-1]) if len(kept) == max_out else n - 1
    pairs = float((last - kept).clamp_min(0).sum())
    bytes_ = n * (16 + 4 + 1) + max_out * (8 + 1)
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, 14 * pairs / H100_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def walk_extent(nms_ops, idx, ok, scores, valid, max_out):
    """The 64-row blocks K4's walk visited and the rows it kept, read from
    one image's output (idx, ok): the walk stops at the block of its
    max_out-th kept row, else it visits every block."""
    n = scores.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=scores.device) if valid is None else valid
    kept = int(ok.sum())
    if kept < max_out:
        return -(-n // 64), kept
    rank = torch.empty(n, dtype=torch.int64, device=scores.device)
    rank[nms_ops._score_order(scores, valid).indices] = torch.arange(n, device=scores.device)
    return int(rank[idx[max_out - 1]]) // 64 + 1, kept


def new_row(launches):
    return {"launches": launches, "launches_timed": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": set()}


def add_to_row(row, err, ms, plain_ms, bound, by) -> None:
    """One timed launch of a path's kernel, added to its row."""
    row["launches_timed"] += 1
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += ms
    row["plain_ms"] += plain_ms
    row["bound_ms"] += bound
    row["bound_by"].add(by)


def close_row(row):
    row["bound_by"] = "bytes" if row["bound_by"] == {"bytes"} else "operations"
    return row


def nms_row(nms_ops, label, launches, calls):
    """K4 over `calls` ((B, N, 4) boxes, scores, valid, threshold, max_out),
    each held exactly against its plain version (one image at a time), then
    timed: the whole call, and apart from it the score order it starts with,
    beside the plain version and its bound, with the walk's blocks visited
    and rows kept per image (read from the kernel's output by
    `walk_extent`). Returns the path's row, with its `launches`."""
    row = new_row(launches)
    for boxes, scores, valid, thr, k in calls:
        b, n = scores.shape
        idx, ok = got = nms_ops.nms(boxes, scores, thr, k, valid=valid)
        err = nms_max_abs_err(nms_ops, got, boxes, scores, valid, thr, k)
        if err != 0:
            fail(f"K4 {label} {b}x{n} -> {k}: kernel and plain version keep different boxes (max abs err {err})")
        ms = cuda_ms(lambda: nms_ops.nms(boxes, scores, thr, k, valid=valid), 10)
        order_ms = cuda_ms(lambda: nms_ops._score_order(scores, valid), 10)
        plain = cuda_ms(lambda: [nms_ops.nms_plain(boxes[i], scores[i], thr, k, valid=valid[i]) for i in range(b)],
                        3, warmup=1)
        work = [nms_work(nms_ops, boxes[i], scores[i], valid[i], thr, k) for i in range(b)]
        bound = sum(x[0] for x in work)
        walk = [walk_extent(nms_ops, idx[i], ok[i], scores[i], valid[i], k) for i in range(b)]
        print(f"nms {label} {b}x{n} -> {k} at {thr}: equal to the plain version; {ms:.4f} ms kernel call "
              f"({order_ms:.4f} ms of it the score order), {plain:.4f} ms plain, bound {bound:.5f} ms; the "
              f"kernel's walk visited blocks {[x[0] for x in walk]} of {-(-n // 64)}, kept {[x[1] for x in walk]}")
        add_to_row(row, err, ms, plain, bound, "bytes" if all(x[1] == "bytes" for x in work) else "operations")
    return close_row(row)


def check_tiny_against_cpu(dev):
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import flagship_config
    from cddmsl_torch.models.build import build_model
    from cddmsl_torch.models.rcnn import DetBatch

    cpu = build_model(flagship_config(tiny=True), device="cpu")
    init_random_(cpu, torch.Generator().manual_seed(3))
    gpu = build_model(flagship_config(tiny=True), device=dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(11)
    image = torch.rand((2, 128, 160, 3), generator=g) * 255
    sizes = torch.tensor([[128, 160], [112, 144]], dtype=torch.int32)
    orig = torch.tensor([[256, 320], [224, 200]], dtype=torch.int32)
    want = cpu.inference(DetBatch(image, sizes, orig))
    got = gpu.inference(DetBatch(image.to(dev), sizes.to(dev), orig.to(dev)))
    got = type(got)(*(t.cpu() for t in got))
    ok = (torch.equal(got.valid, want.valid) and torch.equal(got.classes, want.classes)
          and (got.boxes - want.boxes).abs().max().item() <= 1e-2
          and (got.scores - want.scores).abs().max().item() <= 1e-4)
    if not ok:
        fail("tiny fp32 model on the card disagrees with the CPU run "
             f"(valid {int(got.valid.sum())} vs {int(want.valid.sum())})")
    print(f"tiny fp32 card vs CPU: equal valid/classes ({int(got.valid.sum())} detections), "
          f"box err {(got.boxes - want.boxes).abs().max().item():.3g} px (tol 1e-2), "
          f"score err {(got.scores - want.scores).abs().max().item():.3g} (tol 1e-4)")


def site_draw(device):
    """A sampler `Draw` whose uniforms depend on the site name alone, made on
    the CPU and moved to `device`, so two runs get the same draws."""

    def draw(site, shape):
        gen = torch.Generator().manual_seed(zlib.crc32(site.encode()))
        return torch.rand(shape, generator=gen).to(device)

    return draw


def check_tiny_train_against_cpu(dev):
    """One training step of the tiny fp32 flagship on the card (K1, K3, K4)
    and on the CPU (plain versions), same weights and draws."""
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import flagship_config, flagship_solver_config
    from cddmsl_torch.engine.train_loop import Trainer
    from cddmsl_torch.entry import synthetic_batch
    from cddmsl_torch.models.build import build_model
    from cddmsl_torch.solver.build import build_optimizer

    solver = flagship_solver_config(tiny=True)
    results = {}
    for device in ("cpu", dev):
        model = build_model(flagship_config(tiny=True), device="cpu", training=True)
        init_random_(model, torch.Generator().manual_seed(5))
        model = model.to(device)
        trainer = Trainer(model, build_optimizer(model, solver), caption_burnup_iters=solver.caption_burnup_iters,
                          iteration=solver.caption_burnup_iters + 1)
        batch = synthetic_batch(2, 128, 160, seed=2, device=device)
        metrics = trainer.train_step(batch, site_draw(device))
        results[str(device)] = ({k: v.item() for k, v in metrics.items()},
                                {k: v.cpu() for k, v in model.state_dict().items()})
    (want, want_p), (got, got_p) = results["cpu"], results[str(dev)]
    loss_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)
    param_err = max((got_p[k] - want_p[k]).abs().max().item() for k in want_p)
    if not (loss_err <= 1e-4 and param_err <= 1e-5):
        fail(f"tiny training step on the card disagrees with the CPU: loss rel err {loss_err}, "
             f"param err {param_err}; card {got}, CPU {want}")
    print(f"tiny fp32 training step card vs CPU: loss max rel err {loss_err:.3g} (tol 1e-4), "
          f"params max abs err {param_err:.3g} (tol 1e-5), losses {json.dumps(got)}")




def reset_launches(*kernels) -> None:
    for k in kernels:
        k.reset_launches()


def read_launches(roi_ops, nms_ops):
    return {"roi_align_fwd": roi_ops.KERNEL.launches["cddmsl_roi_align_fwd"],
            "roi_align_bwd": roi_ops.KERNEL.launches["cddmsl_roi_align_bwd"],
            "nms": nms_ops.KERNEL.launches["cddmsl_nms"]}


def roi_bounds_ms(feats, R):
    """(bound ms, bound_by) of K1 or K3 over the map `feats` and R 14x14
    ROIs; both move the same bytes and do the same work. Bytes: each input
    read once, each output written once, in the map's dtype: for K1 the map,
    the boxes and indices, and the pooled values; for K3 the gradient g, the
    boxes and indices, and dF. Operations: (2S)^2 = 16 multiply-adds, 32
    flops, per pooled value at the path's S = 2."""
    es = feats.element_size()
    values = R * 14 * 14 * feats.shape[-1]
    bytes_ = values * es + R * (4 + 16) + feats.numel() * es
    ops = 32 * values
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, ops / H100_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def inference_path(dev, smi, roi_ops, nms_ops, k4_cases):
    """The serving path at full width: launches, checks, timing, stages and
    K1/K4 at its shapes. Returns its rows {kernel: row}."""
    from cddmsl_torch.entry import entry
    from cddmsl_torch.models.fast_rcnn import fast_rcnn_inference

    model, batch = entry("cuda")
    for _ in range(2):  # warm up cuDNN and the allocator
        model.inference(batch)
    torch.cuda.synchronize()
    reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
    dets = model.inference(batch)
    torch.cuda.synchronize()
    launches = read_launches(roi_ops, nms_ops)
    print(f"inference path launches: {launches}")
    if launches["roi_align_fwd"] < 1 or launches["nms"] < 2:
        fail(f"the inference path did not go through the kernels: {launches}")
    features, proposals = model.proposals(batch)
    if tuple(dets.boxes.shape) != (1, 100, 4) or dets.classes.dtype != torch.int32:
        fail(f"detections have shape {tuple(dets.boxes.shape)}")
    if not (torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()):
        fail("non-finite detections")
    n_props, n_dets = int(proposals.valid.sum()), int(dets.valid.sum())
    if n_props < 1:
        fail("no valid proposal")
    print(f"flagship: res4 {tuple(features.shape)} {features.dtype}, {n_props} valid proposals, "
          f"{n_dets} valid detections")

    ms_image = cuda_ms(lambda: model.inference(batch), reps=10)
    t0 = time.perf_counter()
    for _ in range(5):
        model.inference(batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"flagship inference: {ms_image:.3f} ms/image (CUDA events), {host_ms:.3f} ms host wall, "
          f"1x640x800 bf16 on {smi}")

    x = model._normalize(batch.image)
    rh = model.roi_heads
    crops = rh.pool(features, proposals.boxes)
    r5 = model.backbone.res5_forward(crops)
    emb = model.backbone.attnpool_forward(r5)
    scores, deltas = rh.box_predictor(emb)
    stages = {
        "normalize": cuda_ms(lambda: model._normalize(batch.image), 10),
        "backbone_res4": cuda_ms(lambda: model.backbone(x), 10),
        "rpn": cuda_ms(lambda: model.proposal_generator(features, batch.image_sizes), 10),
        "roi_align": cuda_ms(lambda: rh.pool(features, proposals.boxes), 10),
        "res5": cuda_ms(lambda: model.backbone.res5_forward(crops), 5),
        "attnpool": cuda_ms(lambda: model.backbone.attnpool_forward(r5), 10),
        "box_predictor": cuda_ms(lambda: rh.box_predictor(emb), 10),
        "fast_rcnn_inference": cuda_ms(lambda: fast_rcnn_inference(
            scores[None], deltas[None], proposals.boxes, proposals.valid, batch.image_sizes,
            rh.box2box, rh.num_classes, rh.score_thresh_test, rh.nms_thresh_test,
            rh.detections_per_image), 10),
    }
    print("stages_ms " + json.dumps({k: round(v, 4) for k, v in stages.items()}))

    R = proposals.boxes.shape[1]
    k1_args = (features.contiguous(), torch.zeros(R, dtype=torch.int32, device=dev),
               proposals.boxes[0].contiguous(), (14, 14), 1 / 16, 0, True)
    k1_err = bf16_max_abs_err("K1 inference", roi_ops.roi_align_forward(*k1_args),
                              roi_ops.roi_align_batched_plain(k1_args[0].float(), *k1_args[1:]))
    k1_ms = cuda_ms(lambda: roi_ops.roi_align_forward(*k1_args), 20)
    k1_plain_ms = cuda_ms(lambda: roi_ops.roi_align_batched_plain(*k1_args), 3, warmup=1)
    k1_bound, k1_by = roi_bounds_ms(k1_args[0], R)
    print(f"roi_align_fwd inference {R}x14x14x{features.shape[-1]} {features.dtype}: max abs err {k1_err:.4g} "
          f"(rtol 2e-2), {k1_ms:.4f} ms kernel, {k1_plain_ms:.4f} ms plain, bound {k1_bound:.5f} ms ({k1_by})")
    k1_row = new_row(launches["roi_align_fwd"])
    add_to_row(k1_row, k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by)
    # the RPN's NMS on this image's own candidates; the detection NMS on
    # random class-shifted boxes at its shape (2048 -> 100 at 0.5)
    rpn = model.proposal_generator
    rpn_nms = (*rpn._nms_inputs(*rpn._head(features), batch.image_sizes, False),
               rpn.nms_thresh, rpn.post_nms_topk[False])
    db, ds, dv, dthr, dk = k4_cases["det_2048_0.5_100"]
    return {"roi_align_fwd": close_row(k1_row),
            "nms": nms_row(nms_ops, "inference", launches["nms"],
                           [rpn_nms, (db[None], ds[None], dv[None], dthr, dk)])}


def pool_args(features, boxes):
    """(features, batch_idx, boxes) as `roi_heads.pool` hands them to
    `roi_align_batched`, for boxes (B, S, 4) over the map (B, H, W, C)."""
    b, s = boxes.shape[:2]
    bidx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(s)
    return features.contiguous(), bidx, boxes.reshape(b * s, 4).float().contiguous()


@torch.no_grad()
def eval_kernel_calls(model, batch):
    """The kernel calls of `model.inference` on one eval batch, rebuilt on
    the model's device: K1's (features, batch_idx, boxes), the RoI heads'
    pool over the batch's proposals, and K4's (boxes, scores, valid,
    threshold, max_out) of the RPN NMS and of the detection NMS (its
    candidates shifted apart by class, as `batched_nms` shifts them), in
    the order inference makes them."""
    from cddmsl_torch.models.fast_rcnn import detection_candidates
    from cddmsl_torch.ops.nms import class_shifted

    rpn, rh, backbone = model.proposal_generator, model.roi_heads, model.backbone
    features = backbone(model._normalize(batch.image))["res4"]
    head = rpn._head(features)
    rpn_call = (*rpn._nms_inputs(*head, batch.image_sizes, False), rpn.nms_thresh, rpn.post_nms_topk[False])
    proposals = rpn._predict_proposals(*head, batch.image_sizes, False)
    b, s = proposals.boxes.shape[:2]
    scores, deltas = rh.box_predictor(rh._region_embed(features, proposals.boxes, backbone.res5_forward,
                                                       backbone.attnpool_forward))
    boxes, det_scores, classes, valid = detection_candidates(
        scores.reshape(b, s, -1), deltas.reshape(b, s, -1), proposals.boxes, proposals.valid, batch.image_sizes,
        rh.box2box, rh.num_classes, rh.score_thresh_test)
    det_call = (class_shifted(boxes, classes, valid), det_scores, valid, rh.nms_thresh_test, rh.detections_per_image)
    return pool_args(features, proposals.boxes), [rpn_call, det_call]


def training_roi_align_calls(model, batch, draw):
    """The RoIAlign calls of one CDDMSL training step past burn-up, rebuilt
    outside autograd on the model's device: [(label, features, batch_idx,
    boxes)] as `roi_heads.pool` hands them to `roi_align_batched`, in the
    step's order. The supervised pool (B x batch_size_per_image sampled
    ROIs) on the source res4 map, then the region-consistency pool (B x
    region_consistency_boxes random proposals) on the source and on the
    translated res4 map."""
    rpn, rh = model.proposal_generator, model.roi_heads
    f_src = model.backbone(model._normalize(batch.image))["res4"]
    proposals = rpn._predict_proposals(*rpn._head(f_src), batch.image_sizes, True)
    sampled = rh.label_and_sample_proposals(proposals, batch.gt_boxes, batch.gt_classes, batch.gt_valid, draw)[0]
    region = model._random_region_boxes(proposals, draw)
    f_trgt = model.backbone(model._normalize(batch.image_trgt))["res4"]
    return [("supervised", *pool_args(f_src, sampled)), ("region_src", *pool_args(f_src, region)),
            ("region_trgt", *pool_args(f_trgt, region))]


LOSS_NAMES = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "cont_loss", "kd_loss", "cont_loss_region")


def training_path(dev, smi, roi_ops, nms_ops):
    """The CDDMSL training step at full width: launches, checks, timing and
    K1, K3 and K4 at the step's shapes. Returns its rows {kernel: row}."""
    from cddmsl_torch.entry import train_entry
    from cddmsl_torch.solver.build import split_parameters

    model, optimizer, trainer, batch = train_entry("cuda")
    params = dict(model.named_parameters())
    trainable, frozen = split_parameters(model)
    before = {n: p.detach().clone() for n, p in params.items()}
    burnup = trainer.caption_burnup_iters
    torch.cuda.synchronize()
    reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = read_launches(roi_ops, nms_ops)
    print(f"training path launches: {launches}")
    if min(launches.values()) < 1:
        fail(f"the training path did not go through every kernel: {launches}")
    losses = {k: metrics[k].item() for k in LOSS_NAMES}
    if not all(torch.isfinite(torch.tensor(list(losses.values())))):
        fail(f"non-finite training losses: {losses}")
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    if changed:
        fail(f"frozen parameters changed: {changed[:5]}")
    moved = sum(not torch.equal(params[n], before[n]) for n in trainable)
    print(f"training step {burnup + 1} (caption and KD on): losses {json.dumps(losses)}, "
          f"total {metrics['total_loss'].item():.6g}, lr {metrics['lr'].item():.6g} reported "
          f"({optimizer.schedule(0):.6g} applied at the optimizer's count 0); {moved}/{len(trainable)} "
          f"trainable parameters moved, {len(frozen)} frozen ones bit-for-bit unchanged")

    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        trainer.train_step(batch)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    ms_step = start.elapsed_time(end) / reps
    n_img = batch.image.shape[0]
    print(f"flagship training: {ms_step:.3f} ms/step (CUDA events), {host_ms:.3f} ms host wall, "
          f"{n_img / ms_step * 1e3:.3f} images/s, {n_img}x800x1344 bf16, caption+KD on, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {smi}")
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    still = [n for n in trainable if torch.equal(params[n], before[n])]
    if changed or still:
        fail(f"after {reps + 3} steps: frozen changed {changed[:5]}, trainable unmoved {still[:5]}")
    print(f"after {reps + 3} steps: all {len(trainable)} trainable parameters moved, "
          f"all {len(frozen)} frozen parameters unchanged")

    return step_kernel_rows(dev, model, batch, trainer.draw, launches, roi_ops, nms_ops, "training")


def step_kernel_rows(dev, model, batch, draw, launches, roi_ops, nms_ops, label, eval_batches=None):
    """K1, K3 and K4 at one training step's own shapes: K1 and K3 at each of
    its three RoIAlign calls, K4 at its RPN NMS; then, for each of
    `eval_batches` ({name: batch on the card}), K1 and K4 at that eval
    batch's shapes (`eval_kernel_calls`: the RoI heads' pool, the RPN NMS
    and the detection NMS). Each is held against its plain version on the
    same inputs (K1 and K3 in bf16 to rtol 2e-2 with the same zeros, K4
    exactly), then timed beside the plain version and its bound. Returns
    the path's rows, with its `launches`; the times, bounds and errors are
    summed or maxed over the launches checked (`launches_timed`)."""
    rpn = model.proposal_generator
    f_src = model.backbone(model._normalize(batch.image))["res4"]
    nms_inputs = rpn._nms_inputs(*rpn._head(f_src), batch.image_sizes, True)
    rows = {name: new_row(launches[name]) for name in ("roi_align_fwd", "roi_align_bwd")}
    nms_calls = [(*nms_inputs, rpn.nms_thresh, rpn.post_nms_topk[True])]
    gen = torch.Generator(device=dev).manual_seed(6)
    for call, feats, bidx, rois in training_roi_align_calls(model, batch, draw):
        R = rois.shape[0]
        k1_args = (feats, bidx, rois, (14, 14), 1 / 16, 0, True)
        # a positive gradient, as in check_k3: no cancellation in dF's sums
        g = torch.rand((R, 14, 14, feats.shape[-1]), generator=gen, device=dev).bfloat16()
        k3_args = (g, bidx, rois, tuple(feats.shape), (14, 14), 1 / 16, 0, True)
        bound, by = roi_bounds_ms(feats, R)
        for name, kernel, plain, args, fp32_args in (
            ("roi_align_fwd", roi_ops.roi_align_forward, roi_ops.roi_align_batched_plain, k1_args,
             (feats.float(), *k1_args[1:])),
            ("roi_align_bwd", roi_ops.roi_align_backward, roi_ops.roi_align_backward_plain, k3_args,
             (g.float(), *k3_args[1:])),
        ):
            err = bf16_max_abs_err(f"{name} {label} {call}", kernel(*args), plain(*fp32_args))
            ms = cuda_ms(lambda: kernel(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 3, warmup=1)
            add_to_row(rows[name], err, ms, plain_ms, bound, by)
            print(f"{name} {label} {call} {R}x14x14x{feats.shape[-1]} over {tuple(feats.shape)} {feats.dtype}: "
                  f"max abs err {err:.4g} (rtol 2e-2), {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
                  f"bound {bound:.5f} ms ({by})")
    for set_name, eval_batch in (eval_batches or {}).items():
        (feats, bidx, rois), calls = eval_kernel_calls(model, eval_batch)
        R = rois.shape[0]
        args = (feats, bidx, rois, (14, 14), 1 / 16, 0, True)
        err = bf16_max_abs_err(f"roi_align_fwd {label} eval {set_name}", roi_ops.roi_align_forward(*args),
                               roi_ops.roi_align_batched_plain(feats.float(), *args[1:]))
        ms = cuda_ms(lambda: roi_ops.roi_align_forward(*args), 10)
        plain_ms = cuda_ms(lambda: roi_ops.roi_align_batched_plain(*args), 3, warmup=1)
        bound, by = roi_bounds_ms(feats, R)
        add_to_row(rows["roi_align_fwd"], err, ms, plain_ms, bound, by)
        print(f"roi_align_fwd {label} eval {set_name} {R}x14x14x{feats.shape[-1]} over {tuple(feats.shape)} "
              f"{feats.dtype}: max abs err {err:.4g} (rtol 2e-2), {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {bound:.5f} ms ({by})")
        nms_calls += calls
    rows = {name: close_row(row) for name, row in rows.items()}
    rows["nms"] = nms_row(nms_ops, label, launches["nms"], nms_calls)
    return rows


# the caption branch runs at iterations past the burn-up (0-based, as in
# JAX): with 3, steps 5-12 of 12
TRAIN_NET_STEPS, TRAIN_NET_BURNUP, TRAIN_NET_IMAGES = 12, 3, 16


class StepProbe:
    """A trainer hook (it has every method of `engine.hooks.HookBase`): per
    step, CUDA events and host clock around it, and the kernel launches it
    made (host counters, read without a sync)."""

    def __init__(self, roi_ops, nms_ops):
        self.steps = []
        self.read = lambda: read_launches(roi_ops, nms_ops)

    def before_train(self):
        self.t_train = time.perf_counter()

    def before_step(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self._open = (e, time.perf_counter(), self.read())

    def after_step(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.steps.append((*self._open, e, time.perf_counter(), self.read()))

    def after_train(self):
        torch.cuda.synchronize()
        self.loop_s = time.perf_counter() - self.t_train
        self.loop_launches = self.read()


def loop_steps(label, probe, waits, n_steps, burnup):
    """The loop's steps from `probe`: per step CUDA events, host wall, the
    wait on the loader and the K1/K3/K4 launches, which must be 3/3/1 with
    the caption branch and 1/1/1 before it; printed one line each."""
    if len(probe.steps) != n_steps:
        fail(f"the {label} loop ran {len(probe.steps)} steps")
    keys = ("roi_align_fwd", "roi_align_bwd", "nms")
    per_step = []
    for i, (e0, h0, l0, e1, h1, l1) in enumerate(probe.steps):
        counts = tuple(l1[k] - l0[k] for k in keys)
        want = (3, 3, 1) if i > burnup else (1, 1, 1)
        if counts != want:
            fail(f"{label} step {i + 1} launched K1/K3/K4 {counts}, expected {want}")
        per_step.append((e0.elapsed_time(e1), (h1 - h0) * 1e3, waits[i] * 1e3, counts))
    for i, (dev_ms, host_ms, wait_ms, counts) in enumerate(per_step):
        print(f"{label} step {i + 1}: {dev_ms:.3f} ms CUDA events, {host_ms:.3f} ms host wall, "
              f"{wait_ms:.3f} ms waiting on the loader, K1/K3/K4 launches {counts}")
    return per_step


def first_eval_batch(cfg, name, dev):
    """The first batch of the eval loader of `name`, on the card."""
    from cddmsl_torch.data import build_detection_test_loader, to_device

    loader, _ = build_detection_test_loader(cfg, name, pin_memory=dev.type == "cuda")
    with loader:
        batch, _ = next(loader)
    return to_device(batch, dev)


def time_device_batch(label, trainer, batch, reps=5):
    """The loop's step on a batch already on the card (no loader, no
    hooks), after 2 warm-up steps: CUDA events and host wall, printed."""
    for _ in range(2):
        trainer.run_step(batch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        trainer.run_step(batch)
    end.record()
    torch.cuda.synchronize()
    print(f"{label} step on a batch already on the card ({tuple(batch.image.shape)}, caption on): "
          f"{start.elapsed_time(end) / reps:.3f} ms/step CUDA events, "
          f"{(time.perf_counter() - t0) / reps * 1e3:.3f} ms/step host wall")


def train_net_path(dev, smi, roi_ops, nms_ops):
    """The VOC train-and-evaluate loop at full width: `DefaultTrainer` on the
    VOC recipe with the synthetic fixture, `train()` (12 steps of 8 images,
    the caption branch on from step 5, checkpoints at steps 6 and 12, then
    `test()`), timed step by step, then a resume check and the kernels at
    the loop's own shapes. Returns its rows {kernel: row}."""
    import os
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from cddmsl_torch.config import get_cfg
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, to_device
    from cddmsl_torch.data import build_detection_train_loader
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
    from cddmsl_torch.data.datasets.voc import register_pascal_DG, register_pascal_voc
    from cddmsl_torch.engine.defaults import DefaultTrainer, build_evaluator
    from cddmsl_torch.evaluation import inference_on_dataset
    from cddmsl_torch.profile_train import busy_and_span_us, device_kernels

    class ProbedTrainer(DefaultTrainer):
        def build_hooks(self):
            self.probe = StepProbe(roi_ops, nms_ops)
            return [self.probe] + super().build_hooks()

        def test(self, cfg=None):
            t0 = time.perf_counter()
            results = super().test(cfg)
            self.test_s = time.perf_counter() - t0
            return results

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_train_net_")
    names = ("chip_smoke_voc_dg", "chip_smoke_voc_test")
    try:
        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_pascal_DG(names[0], voc, "trainval", 2007, "dt_clipart")
        register_pascal_voc(names[1], voc, "test", 2007)
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(here, "configs", "VOC-Experiments", "faster_rcnn_CLIP_R_50_C4.yaml"))
        cfg.merge_from_list([
            "OUTPUT_DIR", os.path.join(root, "out"), "SEED", "0",
            "MODEL.PRE_TRAINED_RCLIP_PATH", "", "MODEL.VISION_TO_LANG_PATH", "",
            "DATASETS.TRAIN", repr((names[0],)), "DATASETS.TEST", repr((names[1],)),
            "SOLVER.MAX_ITER", str(TRAIN_NET_STEPS), "SOLVER.CAPTION_BURNUP_ITERS", str(TRAIN_NET_BURNUP),
            "SOLVER.CHECKPOINT_PERIOD", "6", "TEST.EVAL_PERIOD", "0",
        ])
        cfg.freeze()
        print(f"train_net: the VOC recipe ({cfg.SOLVER.IMS_PER_BATCH} images a step, {cfg.TPU.COMPUTE_DTYPE}, "
              f"clip by {cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE} {cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}, "
              f"KD {cfg.MODEL.KD_REGULRAZIATION}) on the synthetic VOC fixture ({TRAIN_NET_IMAGES} images, "
              "seed 0); the RegionCLIP and ClipCap weights are not in the repository, so "
              "PRE_TRAINED_RCLIP_PATH and VISION_TO_LANG_PATH are '' and every weight is seeded random")

        trainer = ProbedTrainer(cfg, device="cuda")
        trainer.resume_or_load(resume=False)
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        results = trainer.train()
        torch.cuda.synchronize()
        launches = read_launches(roi_ops, nms_ops)
        print(f"train_net path launches (12 steps and the final test): {launches}")
        if min(launches.values()) < 1:
            fail(f"the train_net path did not go through every kernel: {launches}")

        probe = trainer.probe
        waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
        per_step = loop_steps("train_net", probe, waits, TRAIN_NET_STEPS, TRAIN_NET_BURNUP)
        keys = ("roi_align_fwd", "roi_align_bwd", "nms")
        warm = per_step[TRAIN_NET_BURNUP + 2:]  # caption on, past its first step
        mean = lambda xs: sum(xs) / len(xs)
        print(f"train_net loop, steps {TRAIN_NET_BURNUP + 3}-{TRAIN_NET_STEPS} (caption on): "
              f"{mean([p[0] for p in warm]):.3f} ms/step CUDA events, {mean([p[1] for p in warm]):.3f} ms/step "
              f"host wall, {mean([p[2] for p in warm]):.3f} ms/step waiting on the loader; whole loop "
              f"{probe.loop_s * 1e3 / TRAIN_NET_STEPS:.3f} ms/step host wall with 2 checkpoint saves; "
              f"launches per step K1/K3/K4 3/3/1 with caption, 1/1/1 before; on {smi}")

        n_test_batches = -(-TRAIN_NET_IMAGES // cfg.MODEL.CLIP.IMS_PER_BATCH_TEST)
        eval_launches = {k: launches[k] - probe.loop_launches[k] for k in keys}
        per_batch = tuple(eval_launches[k] / n_test_batches for k in keys)
        if per_batch != (1, 0, 2):
            fail(f"the final test launched K1/K3/K4 {per_batch} per batch, expected (1, 0, 2)")
        evaluator = build_evaluator(cfg, names[1])
        loader, n = build_detection_test_loader(cfg, names[1], pin_memory=True)
        t0 = time.perf_counter()
        with loader:
            again = inference_on_dataset(trainer.model, loader, n, evaluator)
        warm_eval_s = time.perf_counter() - t0
        if again != results[names[1]]:
            fail("a second evaluation of the trained weights gave other results")
        ap = {k: round(v, 4) for k, v in results[names[1]]["bbox"].items() if k in ("AP", "AP50", "AP75", "AP50-dog",
                                                                                      "AP50-cat")}
        print(f"train_net eval through inference_on_dataset, {n} images in batches of "
              f"{cfg.MODEL.CLIP.IMS_PER_BATCH_TEST}: {trainer.test_s * 1e3 / n:.3f} ms/image in train()'s final "
              f"test (first call), {warm_eval_s * 1e3 / n:.3f} ms/image warm (host wall, data included); "
              f"launches per batch K1/K3/K4 {per_batch}; AP (random weights, not judged) {json.dumps(ap)}")

        resumed = DefaultTrainer(cfg, device="cuda")
        resumed.resume_or_load(resume=True)
        saved, got = trainer.state.state_dict(), resumed.state.state_dict()
        if resumed.start_iter != TRAIN_NET_STEPS or got["optimizer"]["count"] != TRAIN_NET_STEPS:
            fail(f"resume restored iteration {resumed.start_iter}, count {got['optimizer']['count']}")
        bad = [k for k, v in saved["model"].items() if not torch.equal(got["model"][k], v)]
        momentum = saved["optimizer"]["sgd"]["state"]
        bad += [f"momentum {i}" for i, s in momentum.items()
                if not torch.equal(got["optimizer"]["sgd"]["state"][i]["momentum_buffer"], s["momentum_buffer"])]
        if bad or not momentum:
            fail(f"the resumed state differs from the saved one: {bad[:5]}")
        print(f"train_net resume: a new trainer with resume=True restored iteration {resumed.start_iter}; "
              f"{len(saved['model'])} parameters and buffers and {len(momentum)} momentum buffers bit-equal "
              f"to model_final")
        del resumed

        # the same step on a batch already on the card (no loader, no hooks),
        # beside the loop's; then the kernels at the loop's shapes
        with build_detection_train_loader(cfg, seed=0, pin_memory=True) as train_loader:
            batch = to_device(next(train_loader), dev)
        time_device_batch("train_net", trainer, batch)
        # how busy the device is in that step: the union of its kernels'
        # intervals in a torch.profiler trace
        traced = 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced):
                trainer.run_step(batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) / traced * 1e3
        kernels = device_kernels(prof)
        if not kernels:
            fail("the trace of the train_net step holds no device kernel")
        busy_us, span_us = busy_and_span_us(kernels)
        print(f"train_net step traced ({traced} steps on the batch on the card, torch.profiler on): "
              f"{len(kernels) / traced:.0f} kernels/step, device busy {busy_us / 1e3 / traced:.3f} ms/step of "
              f"{traced_ms:.3f} ms/step host wall; of the kernels' span, busy share {busy_us / span_us:.4f}, "
              f"idle share {1 - busy_us / span_us:.4f}")
        return step_kernel_rows(dev, trainer.model, batch, trainer.state.draw, launches, roi_ops, nms_ops,
                                "train_net", {names[1]: first_eval_batch(cfg, names[1], dev)})
    finally:
        for name in names:
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


# phase 8: the caption branch at 0-based iterations past 3, steps 5-8 of 8
ADVERSE_STEPS, ADVERSE_BURNUP = 8, 3
ADVERSE_TRAIN, ADVERSE_VAL, ADVERSE_BDD = 16, 8, 8
BDD_CLASSES = ("person", "rider", "car", "bus", "truck", "bike", "motor", "traffic light", "traffic sign", "train")
BOX_PREDICTOR = "roi_heads.box_predictor."
D2_RCNN_TOWERS = ("backbone.", "proposal_generator.rpn_head.", BOX_PREDICTOR)  # what the file holds


def write_d2_rcnn_file(model, path, seed):
    """The model's backbone, RPN head and box predictor under the reference's
    names in a detectron2-style model_final.pth (model, optimizer,
    scheduler, iteration), a random background row put in front of
    cls_score and 4 random outputs in front of bbox_pred. Returns what the
    model must hold after loading it: the backbone's tensors also in the
    offline backbone, the box predictor without the background."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
          if k.startswith(D2_RCNN_TOWERS)}
    want = dict(sd)
    want.update({"offline_" + k: v for k, v in sd.items() if k.startswith("backbone.")})
    for name, n in (("cls_score.weight", 1), ("bbox_pred.weight", 4), ("bbox_pred.bias", 4)):
        v = sd[BOX_PREDICTOR + name]
        sd[BOX_PREDICTOR + name] = torch.cat([torch.randn((n, *v.shape[1:]), generator=g), v])
    torch.save({"model": sd, "optimizer": {"state": {}, "param_groups": []}, "scheduler": {"last_epoch": 60000},
                "iteration": 60000}, path)
    return want, {k: tuple(sd[BOX_PREDICTOR + k].shape) for k in ("cls_score.weight", "bbox_pred.weight")}


def adverse_weather_path(dev, smi, roi_ops, nms_ops):
    """The adverse-weather recipe at full width from a reference checkpoint:
    the fixture, the weights through MODEL.WEIGHTS, `test()`, `train()` (8
    steps of 8 images, caption from step 5, KD on, then `test()` set by
    set), `train_net.main --eval-only`, and the kernels at the loop's own
    shapes. Returns its rows {kernel: row}."""
    import os
    import shutil
    import tempfile

    from cddmsl_torch import train_net
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import CfgNode, get_cfg, model_config_from_cfg
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader, to_device
    from cddmsl_torch.data.datasets.cityscapes import register_cityscapes, register_cityscapes_DG
    from cddmsl_torch.data.datasets.coco import register_coco_instances
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_bdd, make_synthetic_cityscapes
    from cddmsl_torch.engine.defaults import DefaultTrainer, default_argument_parser
    from cddmsl_torch.models.build import build_model
    from cddmsl_torch.solver.build import split_parameters

    keys = ("roi_align_fwd", "roi_align_bwd", "nms")

    class ProbedTrainer(DefaultTrainer):
        """Keeps each step's metrics and evaluates set by set, with the
        launches and host wall of each set's evaluation."""

        def build_hooks(self):
            self.probe = StepProbe(roi_ops, nms_ops)
            self.step_metrics = []
            return [self.probe] + super().build_hooks()

        def run_step(self, batch):
            metrics = super().run_step(batch)
            self.step_metrics.append(metrics)
            return metrics

        def test(self, cfg=None):
            cfg = cfg or self.cfg
            results, self.eval_log = {}, {}
            for name in cfg.DATASETS.TEST:
                one = CfgNode(cfg)
                one.DATASETS.TEST = (name,)
                torch.cuda.synchronize()
                l0, t0 = read_launches(roi_ops, nms_ops), time.perf_counter()
                results.update(super().test(one))
                torch.cuda.synchronize()
                l1 = read_launches(roi_ops, nms_ops)
                self.eval_log[name] = (time.perf_counter() - t0, tuple(l1[k] - l0[k] for k in keys))
            return results

    def eval_lines(label, trainer, results):
        for name, (secs, counts) in trainer.eval_log.items():
            n = len(DatasetCatalog.get(name))
            per_batch = tuple(c / -(-n // cfg.MODEL.CLIP.IMS_PER_BATCH_TEST) for c in counts)
            if per_batch != (1, 0, 2):
                fail(f"adverse_weather {label} on {name} launched K1/K3/K4 {per_batch} per batch, expected (1, 0, 2)")
            ap = {k: round(v, 4) for k, v in results[name]["bbox"].items()}
            print(f"adverse_weather {label} on {name}: {n} images, {secs * 1e3 / n:.3f} ms/image (host wall, data "
                  f"and evaluator included), launches per batch K1/K3/K4 {per_batch}; AP (not judged) "
                  f"{json.dumps(ap)}")

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_adverse_weather_")
    data = os.path.join(root, "datasets")
    # the recipe's train set and its three test sets, in its order, under
    # the fixture's own names
    train_name = "chip_smoke_cityscapes_DG_train"
    test_names = ("chip_smoke_cityscapes_foggy_val", "chip_smoke_bdd_100k_val", "chip_smoke_cityscapes_val")
    try:
        t0 = time.perf_counter()
        city = make_synthetic_cityscapes(data, n=ADVERSE_TRAIN, seed=0, split="train")
        make_synthetic_cityscapes(data, n=ADVERSE_VAL, seed=1, split="val", foggy=False)
        bdd_json, bdd_images = make_synthetic_bdd(data, n=ADVERSE_BDD, seed=2, hw=(720, 1280), classes=BDD_CLASSES)
        images, gt = os.path.join(city, "leftImg8bit"), os.path.join(city, "gtFine")
        register_cityscapes_DG(train_name, os.path.join(images, "train"), os.path.join(gt, "train"),
                               os.path.join(city, "leftImg8bit_foggy", "train"))
        # the val split has no fog twins: the foggy set reads the clear
        # images, as register_all registers it where leftImg8bit_foggy/val
        # is missing
        for name in (test_names[0], test_names[2]):
            register_cityscapes(name, os.path.join(images, "val"), os.path.join(gt, "val"))
        register_coco_instances(test_names[1], bdd_json, bdd_images)
        print(f"adverse_weather fixture: {ADVERSE_TRAIN} Cityscapes train PNGs of 2048x1024 with fog twins (one "
              f"missing), {ADVERSE_VAL} val PNGs without (the foggy test set reads them), {ADVERSE_BDD} "
              f"BDD-style 1280x720 JPEGs, written in {time.perf_counter() - t0:.1f} s")

        recipe = os.path.join(here, "configs", "AdverseWeather-Experiments", "faster_rcnn_CLIP_R_50_C4.yaml")
        weights = os.path.join(root, "model_final.pth")
        opts = ["SEED", "0", "MODEL.PRE_TRAINED_RCLIP_PATH", "", "MODEL.VISION_TO_LANG_PATH", "",
                "MODEL.WEIGHTS", weights, "DATASETS.TRAIN", repr((train_name,)), "DATASETS.TEST", repr(test_names)]
        cfg = get_cfg()
        cfg.merge_from_file(recipe)
        cfg.merge_from_list(opts + [
            "OUTPUT_DIR", os.path.join(root, "out"), "SOLVER.MAX_ITER", str(ADVERSE_STEPS),
            "SOLVER.CAPTION_BURNUP_ITERS", str(ADVERSE_BURNUP), "SOLVER.CHECKPOINT_PERIOD", "0",
            "TEST.EVAL_PERIOD", "0",
        ])
        cfg.freeze()
        reference = build_model(model_config_from_cfg(cfg), device="cpu", training=True)
        init_random_(reference, torch.Generator().manual_seed(7))
        want, shapes = write_d2_rcnn_file(reference, weights, seed=8)
        del reference
        print(f"adverse_weather: the recipe ({cfg.SOLVER.IMS_PER_BATCH} images a step, {cfg.TPU.COMPUTE_DTYPE}, KD "
              f"{cfg.MODEL.KD_REGULRAZIATION}, clip by {cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE} "
              f"{cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}, {cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, test sets "
              f"{list(cfg.DATASETS.TEST)}); MODEL.WEIGHTS a detectron2-style d2_rcnn model_final.pth of a seeded "
              f"full-width model (cls_score {shapes['cls_score.weight']}, bbox_pred {shapes['bbox_pred.weight']})")

        trainer = ProbedTrainer(cfg, device="cuda")
        trainer.resume_or_load(resume=False)
        state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
        bad = [k for k, v in want.items() if not torch.equal(state[k], v)]
        if bad or trainer.start_iter != 0:
            fail(f"the d2_rcnn weights did not load bit for bit: {bad[:5]}, start_iter {trainer.start_iter}")
        towers = collections.Counter(next(t for t in ("offline_backbone.", *D2_RCNN_TOWERS) if k.startswith(t))
                                     for k in want)
        print(f"adverse_weather weights: {dict(towers)} tensors bit-equal to the file after the background-row "
              f"surgery; iteration {trainer.start_iter}")
        params = dict(trainer.model.named_parameters())
        _, frozen = split_parameters(trainer.model)
        frozen_before = {n: params[n].detach().clone() for n in frozen}

        loaded = trainer.test()
        eval_lines("test() of the loaded weights", trainer, loaded)

        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        results = trainer.train()
        torch.cuda.synchronize()
        launches = read_launches(roi_ops, nms_ops)
        print(f"adverse_weather path launches ({ADVERSE_STEPS} steps and the final test): {launches}")
        probe = trainer.probe
        waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
        per_step = loop_steps("adverse_weather", probe, waits, ADVERSE_STEPS, ADVERSE_BURNUP)
        for i, metrics in enumerate(trainer.step_metrics):
            losses = {k: v.item() for k, v in metrics.items() if "loss" in k}
            if "kd_loss" not in losses or not all(map(math.isfinite, losses.values())):
                fail(f"adverse_weather step {i + 1}: losses {losses}")
        print(f"adverse_weather losses finite in all {ADVERSE_STEPS} steps; the last: "
              f"{json.dumps({k: round(v.item(), 6) for k, v in trainer.step_metrics[-1].items() if 'loss' in k})}")
        changed = [n for n, v in frozen_before.items() if not torch.equal(params[n], v)]
        if changed:
            fail(f"adverse_weather: frozen parameters changed: {changed[:5]}")
        print(f"adverse_weather: all {len(frozen)} frozen parameters bit-for-bit unchanged")
        warm = per_step[ADVERSE_BURNUP + 2:]  # caption on, past its first step
        mean = lambda xs: sum(xs) / len(xs)
        print(f"adverse_weather loop, steps {ADVERSE_BURNUP + 3}-{ADVERSE_STEPS} (caption and KD on): "
              f"{mean([p[0] for p in warm]):.3f} ms/step CUDA events, {mean([p[1] for p in warm]):.3f} ms/step "
              f"host wall, {mean([p[2] for p in warm]):.3f} ms/step waiting on the loader; steps 2-{ADVERSE_BURNUP + 1}"
              f" (before the caption branch): {mean([p[2] for p in per_step[1:ADVERSE_BURNUP + 1]]):.3f} ms/step "
              f"waiting on the loader; whole loop {probe.loop_s * 1e3 / ADVERSE_STEPS:.3f} ms/step host wall; on {smi}")
        eval_lines("final test", trainer, results)

        t0 = time.perf_counter()
        args = default_argument_parser().parse_args(
            ["--eval-only", "--config-file", recipe, *opts, "OUTPUT_DIR", os.path.join(root, "eval")])
        again = train_net.main(args)
        if json.dumps(again, sort_keys=True) != json.dumps(loaded, sort_keys=True):
            fail(f"train_net --eval-only from {weights} gave other AP dicts than test() of the loaded weights")
        print(f"adverse_weather eval-only (train_net.main --eval-only, MODEL.WEIGHTS the d2_rcnn file): the AP "
              f"dicts of the 3 test sets equal those of test() of the loaded weights; {time.perf_counter() - t0:.1f} s")

        with build_detection_train_loader(cfg, seed=0, pin_memory=True) as train_loader:
            batch = to_device(next(train_loader), dev)
        time_device_batch("adverse_weather", trainer, batch)
        # K1 and K4 also at the eval batches' shapes: a Cityscapes batch
        # (the two Cityscapes sets read the same images here) and a BDD one
        eval_batches = {name: first_eval_batch(cfg, name, dev) for name in test_names[1:]}
        rows = step_kernel_rows(dev, trainer.model, batch, trainer.state.draw, launches, roi_ops, nms_ops,
                                "adverse_weather", eval_batches)
        print(f"adverse_weather phase: {time.perf_counter() - t_phase:.1f} s wall")
        return rows
    finally:
        for name in (train_name, *test_names):
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cddmsl_torch.ops import _build
    from cddmsl_torch.ops import nms as nms_ops
    from cddmsl_torch.ops import roi_align as roi_ops

    t_start = time.perf_counter()
    torch.set_grad_enabled(False)  # the training phases enable it where they need it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)

    secs = _build.build(roi_ops.KERNEL, nms_ops.KERNEL)
    print(f"built K1 and K3 (roi_align.cu) and K4 (nms.cu) in {secs:.1f} s")
    for k in (roi_ops.KERNEL, nms_ops.KERNEL):
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.source.name}: {line.strip()}")

    check_k1(roi_ops, dev)
    check_k3(roi_ops, dev)
    k4_cases = check_k4(nms_ops, dev)
    check_tiny_against_cpu(dev)
    check_tiny_train_against_cpu(dev)

    paths = {"inference": inference_path(dev, smi, roi_ops, nms_ops, k4_cases)}
    torch.cuda.empty_cache()
    paths["training"] = training_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["train_net"] = train_net_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["adverse_weather"] = adverse_weather_path(dev, smi, roi_ops, nms_ops)

    meta = {
        "roi_align_fwd": ("cddmsl_torch/csrc/roi_align.cu", "cddmsl_tpu/ops/pallas/roi_align_pallas.py:94"),
        "roi_align_bwd": ("cddmsl_torch/csrc/roi_align.cu", "cddmsl_tpu/ops/pallas/roi_align_pallas.py:302"),
        "nms": ("cddmsl_torch/csrc/nms.cu", "cddmsl_tpu/ops/nms.py:125"),
    }
    kernels = []
    for path, rows in paths.items():
        for name, row in rows.items():
            source, replaces = meta[name]
            kernels.append({"name": f"{name}/{path}", "route": "cuda", "source": source, "replaces": replaces,
                            **row, "library_ms": None})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall after the card was found")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
