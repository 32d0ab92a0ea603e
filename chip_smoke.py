"""Runs the cddmsl_torch port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. the card: its name, and its name and power limit from nvidia-smi;
  2. builds kernels K1 (RoIAlign forward, csrc/roi_align.cu) and K4 (NMS,
     csrc/nms.cu) with nvcc for sm_90a, in parallel;
  3. holds each kernel against its plain PyTorch version on the card:
     K1 on 1000 ROIs over a 40x50x1024 map, fp32 (TF32 off) to atol 1e-4
     and bf16 (against the plain version in fp32 on the same bf16 inputs)
     to rtol 2e-2; K4 exactly, on 6000 boxes at IoU 0.7 keeping 1000, on
     2048 class-shifted boxes at 0.5 keeping 100, and on a cluster whose
     IoUs sit within a few ulps of the threshold;
  4. the tiny configuration in fp32 on the card against the same model on
     the CPU (plain versions) on two 128x160 images;
  5. the main path: `entry()`'s full-width flagship detector (CLIP-RN50 C4,
     bf16, seeded random weights) on one 640x800 image through
     `model.inference`, with the launch counts of K1 and K4 read around
     that one call;
  6. timing with CUDA events: ms per image, each stage, and each kernel
     beside its plain version and its bound.
The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

import json
import subprocess
import sys
import time

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


def check_k4(nms_ops, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {}
    boxes = random_boxes(gen, 6000, 800.0, 640.0, dev, max_size=300.0)
    scores = torch.rand(6000, generator=gen, device=dev)
    valid = torch.rand(6000, generator=gen, device=dev) > 0.05
    cases["rpn_6000_0.7_1000"] = (boxes, scores, valid, 0.7, 1000)
    det = random_boxes(gen, 2048, 800.0, 640.0, dev, max_size=200.0)
    cls = torch.randint(0, 20, (2048,), generator=gen, device=dev)
    det_scores = torch.rand(2048, generator=gen, device=dev)
    det_valid = det_scores > 0.05
    shift = cls.float() * (torch.where(det_valid[:, None], det, torch.zeros_like(det)).max() + 1.0)
    cases["det_2048_0.5_100"] = (det + shift[:, None], det_scores, det_valid, 0.5, 100)
    cl = near_threshold_cluster(0.7, 300, dev)
    cases["cluster_600_0.7"] = (cl, torch.rand(len(cl), generator=gen, device=dev), None, 0.7, 600)
    for name, (b, s, v, thr, k) in cases.items():
        got = nms_ops.nms(b, s, thr, k, valid=v)
        want = nms_ops.nms_plain(b, s, thr, k, valid=v)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"K4 {name}: kernel and plain version keep different boxes")
        print(f"K4 check {name}: equal ({int(got[1].sum())} kept)")
    # a batch of two images in one launch
    bb = torch.stack([boxes, boxes.flip(0)])
    got = nms_ops.nms(bb, torch.stack([scores, scores.flip(0)]), 0.7, 1000, valid=torch.stack([valid, valid.flip(0)]))
    want = nms_ops.nms_plain(boxes.flip(0), scores.flip(0), 0.7, 1000, valid=valid.flip(0))
    if not (torch.equal(got[0][1], want[0]) and torch.equal(got[1][1], want[1])):
        fail("K4 batched: image 1 differs from its own plain run")
    return cases


def nms_bound_ms(nms_ops, boxes, scores, valid, thr, max_out):
    """Bytes: boxes, scores and valid read once, indices and mask written
    once. Operations: the IoUs the greedy walk needs on this data, each kept
    box against every later box up to the last row examined, ~14 flops each."""
    n = boxes.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=boxes.device) if valid is None else valid
    order = nms_ops._score_order(scores, valid)
    kept = torch.nonzero(nms_ops._greedy_keep(boxes[order], valid[order], thr, max_out)).squeeze(1)[:max_out]
    last = int(kept[-1]) if len(kept) == max_out else n - 1
    pairs = float((last - kept).clamp_min(0).sum())
    bytes_ = n * (16 + 4 + 1) + max_out * (8 + 1)
    return max(bytes_ / H100_BYTES_PER_S, 14 * pairs / H100_FP32_FLOP_PER_S) * 1e3, (
        "bytes" if bytes_ / H100_BYTES_PER_S >= 14 * pairs / H100_FP32_FLOP_PER_S else "operations")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cddmsl_torch.entry import entry
    from cddmsl_torch.models.fast_rcnn import fast_rcnn_inference
    from cddmsl_torch.ops import _build
    from cddmsl_torch.ops import nms as nms_ops
    from cddmsl_torch.ops import roi_align as roi_ops

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)

    secs = _build.build(roi_ops.KERNEL, nms_ops.KERNEL)
    print(f"built K1 and K4 in {secs:.1f} s")
    for k in (roi_ops.KERNEL, nms_ops.KERNEL):
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.source.name}: {line.strip()}")

    k1_err = check_k1(roi_ops, dev)
    k4_cases = check_k4(nms_ops, dev)
    check_tiny_against_cpu(dev)

    # ---- the main path: full-width flagship inference, one image ----
    model, batch = entry("cuda")
    for _ in range(2):  # warm up cuDNN and the allocator
        model.inference(batch)
    torch.cuda.synchronize()
    roi_ops.KERNEL.launches = 0
    nms_ops.KERNEL.launches = 0
    dets = model.inference(batch)
    torch.cuda.synchronize()
    launches = {"roi_align": roi_ops.KERNEL.launches, "nms": nms_ops.KERNEL.launches}
    print(f"main path launches: {launches}")
    if launches["roi_align"] < 1 or launches["nms"] < 2:
        fail(f"the main path did not go through the kernels: {launches}")
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

    # ---- timing ----
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
    with torch.no_grad():
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

    # ---- kernels at the main path's shapes ----
    R = proposals.boxes.shape[1]
    bidx = torch.zeros(R, dtype=torch.int32, device=dev)
    pboxes = proposals.boxes[0].contiguous()
    feats = features.contiguous()
    k1_args = (feats, bidx, pboxes, (14, 14), 1 / 16, 0, True)
    k1_ms = cuda_ms(lambda: roi_ops.roi_align_batched(*k1_args), 20)
    k1_plain_ms = cuda_ms(lambda: roi_ops.roi_align_batched_plain(*k1_args), 3, warmup=1)
    es = feats.element_size()
    k1_bytes = feats.numel() * es + R * (4 + 16) + R * 14 * 14 * feats.shape[-1] * es
    k1_ops = 2 * R * 14 * 14 * feats.shape[-1] * (2 * 2) ** 2  # S x S samples x 4 taps, mul + add
    k1_bound = max(k1_bytes / H100_BYTES_PER_S, k1_ops / H100_FP32_FLOP_PER_S) * 1e3
    k1_by = "bytes" if k1_bytes / H100_BYTES_PER_S >= k1_ops / H100_FP32_FLOP_PER_S else "operations"

    k4_rows = []
    for name, (b, s, v, thr, k) in k4_cases.items():
        if name.startswith("cluster"):
            continue
        ms = cuda_ms(lambda: nms_ops.nms(b, s, thr, k, valid=v), 20)
        plain = cuda_ms(lambda: nms_ops.nms_plain(b, s, thr, k, valid=v), 3, warmup=1)
        bound, by = nms_bound_ms(nms_ops, b, s, v, thr, k)
        k4_rows.append((name, ms, plain, bound, by))
        print(f"K4 {name}: {ms:.4f} ms kernel, {plain:.4f} ms plain, bound {bound:.5f} ms ({by})")
    print(f"K1 roi_align 1000x14x14x1024 bf16: {k1_ms:.4f} ms kernel, {k1_plain_ms:.4f} ms plain, "
          f"bound {k1_bound:.5f} ms ({k1_by})")

    k4_ms = sum(r[1] for r in k4_rows)
    kernels = [
        {"name": "roi_align_fwd", "route": "cuda", "source": "cddmsl_torch/csrc/roi_align.cu",
         "replaces": "cddmsl_tpu/ops/pallas/roi_align_pallas.py:94", "launches": launches["roi_align"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "nms", "route": "cuda", "source": "cddmsl_torch/csrc/nms.cu",
         "replaces": "cddmsl_tpu/ops/nms.py:125", "launches": launches["nms"], "max_abs_err": 0.0,
         "ms": k4_ms, "plain_ms": sum(r[2] for r in k4_rows), "bound_ms": sum(r[3] for r in k4_rows),
         "bound_by": "bytes" if all(r[4] == "bytes" for r in k4_rows) else "operations",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
