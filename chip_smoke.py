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
     call, then timed with CUDA events: ms per image, each stage, K1 and K4
     beside their plain versions and bounds;
  6. the training path: `train_entry()`'s full-width flagship (bf16 compute,
     fp32 parameters) takes one CDDMSL step past burn-up on two 800x1344
     images, with the launch counts read around that step; all 7 losses
     finite, frozen parameters bit-for-bit unchanged; then 2 warm-up and 5
     timed steps (ms/step, images/s), after which every trainable parameter
     has moved, and K1, K3 and K4 timed at the step's own shapes beside
     their plain versions and bounds: K1 and K3 at each of the step's three
     RoIAlign calls (`training_roi_align_calls`: the supervised pool and the
     region pool on the source and on the translated map), one line each.
The line before the last is the kernels' JSON, one row per kernel and path
(`roi_align_fwd/inference`, ..., `nms/training`): the launches of that
path's run, and the kernel's times and bounds at that path's shapes (for a
kernel launched more than once on a path, the sum over those launches).
The last line is {"ok": true, "device": {...}}. Without a CUDA device it
exits 1 and prints no result.
"""

import json
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
    return max(fp32_err, err2)


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
    errs, abs_errs = {}, []
    for aligned in (True, False):
        g = torch.randn((R, 14, 14, C), generator=gen, device=dev)
        got = roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, aligned)
        if not torch.equal(got, roi_ops.roi_align_backward(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, aligned)):
            fail(f"K3 fp32 (aligned={aligned}) differs between two calls on the same inputs")
        want = roi_ops.roi_align_backward_plain(g, bidx, boxes, shape, (14, 14), 1 / 16, 0, aligned)
        abs_errs.append((got - want).abs().max().item())
        errs[f"fp32_aligned={aligned}"] = abs_errs[-1] / want.abs().max().item()
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
    abs_errs.append((grads[0] - grads[1]).abs().max().item())
    autograd_err = abs_errs[-1] / grads[1].abs().max().item()
    if not autograd_err <= 1e-4 or not grads[0].is_contiguous():
        fail(f"autograd through roi_align_batched disagrees with the plain autograd: {autograd_err}")
    print(f"K3 check: fp32 max abs err / max |dF| {errs} (tol 1e-4), bf16 max rel err {rel.max().item():.3g} "
          f"(rtol 2e-2), autograd {autograd_err:.3g} (tol 1e-4), fp32 and bf16 bit-identical on a second call")
    return max(abs_errs)


def nms_equal(nms_ops, boxes, scores, valid, thr, max_out):
    """K4 on (B, N, 4) boxes against `nms_plain` image by image; returns the
    kernel's (idx, valid) or None where they differ."""
    got = nms_ops.nms(boxes, scores, thr, max_out, valid=valid)
    for i in range(boxes.shape[0]):
        want = nms_ops.nms_plain(boxes[i], scores[i], thr, max_out, valid=valid[i])
        if not (torch.equal(got[0][i], want[0]) and torch.equal(got[1][i], want[1])):
            return None
    return got


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


def nms_row(nms_ops, label, calls):
    """Times K4 over `calls` ((B, N, 4) boxes, scores, valid, threshold,
    max_out): the whole call, and apart from it the score order it starts
    with, each beside its plain version (one image at a time) and its bound,
    with the walk's blocks visited and rows kept per image (read from the
    kernel's output by `walk_extent`); returns the sums
    (ms, plain ms, bound ms, bound_by)."""
    total = [0.0, 0.0, 0.0]
    bys = set()
    for boxes, scores, valid, thr, k in calls:
        b, n = scores.shape
        ms = cuda_ms(lambda: nms_ops.nms(boxes, scores, thr, k, valid=valid), 10)
        order_ms = cuda_ms(lambda: nms_ops._score_order(scores, valid), 10)
        plain = cuda_ms(lambda: [nms_ops.nms_plain(boxes[i], scores[i], thr, k, valid=valid[i]) for i in range(b)],
                        3, warmup=1)
        work = [nms_work(nms_ops, boxes[i], scores[i], valid[i], thr, k) for i in range(b)]
        bound = sum(x[0] for x in work)
        bys.update(x[1] for x in work)
        idx, ok = nms_ops.nms(boxes, scores, thr, k, valid=valid)
        walk = [walk_extent(nms_ops, idx[i], ok[i], scores[i], valid[i], k) for i in range(b)]
        print(f"nms {label} {b}x{n} -> {k} at {thr}: {ms:.4f} ms kernel call ({order_ms:.4f} ms of it the score "
              f"order), {plain:.4f} ms plain, bound {bound:.5f} ms; the kernel's walk visited blocks "
              f"{[x[0] for x in walk]} of {-(-n // 64)}, kept {[x[1] for x in walk]}")
        for i, v in enumerate((ms, plain, bound)):
            total[i] += v
    return (*total, "bytes" if bys == {"bytes"} else "operations")


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
    K1/K4 at its shapes. Returns its rows {kernel: (launches, ms, plain ms,
    bound ms, bound_by)}."""
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
    k1_ms = cuda_ms(lambda: roi_ops.roi_align_forward(*k1_args), 20)
    k1_plain_ms = cuda_ms(lambda: roi_ops.roi_align_batched_plain(*k1_args), 3, warmup=1)
    k1_bound, k1_by = roi_bounds_ms(k1_args[0], R)
    print(f"roi_align_fwd inference {R}x14x14x{features.shape[-1]} {features.dtype}: {k1_ms:.4f} ms kernel, "
          f"{k1_plain_ms:.4f} ms plain, bound {k1_bound:.5f} ms ({k1_by})")
    # the RPN's NMS on this image's own candidates; the detection NMS on
    # random class-shifted boxes at its shape (2048 -> 100 at 0.5)
    rpn = model.proposal_generator
    rpn_nms = (*rpn._nms_inputs(*rpn._head(features), batch.image_sizes, False),
               rpn.nms_thresh, rpn.post_nms_topk[False])
    db, ds, dv, dthr, dk = k4_cases["det_2048_0.5_100"]
    nms_times = nms_row(nms_ops, "inference", [rpn_nms, (db[None], ds[None], dv[None], dthr, dk)])
    return {"roi_align_fwd": (launches["roi_align_fwd"], k1_ms, k1_plain_ms, k1_bound, k1_by),
            "nms": (launches["nms"], *nms_times)}


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

    def call(label, features, boxes):
        b, s = boxes.shape[:2]
        bidx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(s)
        return label, features.contiguous(), bidx, boxes.reshape(b * s, 4).float().contiguous()

    return [call("supervised", f_src, sampled), call("region_src", f_src, region), call("region_trgt", f_trgt, region)]


LOSS_NAMES = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "cont_loss", "kd_loss", "cont_loss_region")


def training_path(dev, smi, roi_ops, nms_ops):
    """The CDDMSL training step at full width: launches, checks, timing and
    K1, K3 and K4 at the step's shapes. Returns its rows {kernel:
    (launches, ms, plain ms, bound ms, bound_by)}."""
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

    # ---- the kernels at the step's own shapes ----
    rpn = model.proposal_generator
    f_src = model.backbone(model._normalize(batch.image))["res4"]
    nms_inputs = rpn._nms_inputs(*rpn._head(f_src), batch.image_sizes, True)
    rows = {"roi_align_fwd": [launches["roi_align_fwd"], 0.0, 0.0, 0.0, set()],
            "roi_align_bwd": [launches["roi_align_bwd"], 0.0, 0.0, 0.0, set()]}
    for label, feats, bidx, rois in training_roi_align_calls(model, batch, trainer.draw):
        R = rois.shape[0]
        k1_args = (feats, bidx, rois, (14, 14), 1 / 16, 0, True)
        g = torch.randn((R, 14, 14, feats.shape[-1]), device=dev).bfloat16()
        k3_args = (g, bidx, rois, tuple(feats.shape), (14, 14), 1 / 16, 0, True)
        bound, by = roi_bounds_ms(feats, R)
        for name, kernel, plain, args in (
            ("roi_align_fwd", roi_ops.roi_align_forward, roi_ops.roi_align_batched_plain, k1_args),
            ("roi_align_bwd", roi_ops.roi_align_backward, roi_ops.roi_align_backward_plain, k3_args),
        ):
            ms = cuda_ms(lambda: kernel(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 3, warmup=1)
            row = rows[name]
            row[1] += ms
            row[2] += plain_ms
            row[3] += bound
            row[4].add(by)
            print(f"{name} training {label} {R}x14x14x{feats.shape[-1]} over {tuple(feats.shape)} {feats.dtype}: "
                  f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound {bound:.5f} ms ({by})")
    rows = {name: (n, ms, plain_ms, bound, "bytes" if bys == {"bytes"} else "operations")
            for name, (n, ms, plain_ms, bound, bys) in rows.items()}
    nms_call = (*nms_inputs, rpn.nms_thresh, rpn.post_nms_topk[True])
    rows["nms"] = (launches["nms"], *nms_row(nms_ops, "training", [nms_call]))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cddmsl_torch.ops import _build
    from cddmsl_torch.ops import nms as nms_ops
    from cddmsl_torch.ops import roi_align as roi_ops

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

    k1_err = check_k1(roi_ops, dev)
    k3_err = check_k3(roi_ops, dev)
    k4_cases = check_k4(nms_ops, dev)
    check_tiny_against_cpu(dev)
    check_tiny_train_against_cpu(dev)

    paths = {"inference": inference_path(dev, smi, roi_ops, nms_ops, k4_cases)}
    torch.cuda.empty_cache()
    paths["training"] = training_path(dev, smi, roi_ops, nms_ops)

    meta = {
        "roi_align_fwd": ("cddmsl_torch/csrc/roi_align.cu", "cddmsl_tpu/ops/pallas/roi_align_pallas.py:94", k1_err),
        "roi_align_bwd": ("cddmsl_torch/csrc/roi_align.cu", "cddmsl_tpu/ops/pallas/roi_align_pallas.py:302", k3_err),
        "nms": ("cddmsl_torch/csrc/nms.cu", "cddmsl_tpu/ops/nms.py:125", 0.0),
    }
    kernels = []
    for path, rows in paths.items():
        for name, (launches, ms, plain_ms, bound, by) in rows.items():
            source, replaces, err = meta[name]
            kernels.append({"name": f"{name}/{path}", "route": "cuda", "source": source, "replaces": replaces,
                            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
