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
  9. the consistency path: each MODEL.CONSISTENCY_BRANCH (image,
     image_region, caption_pl_img, caption_pl_region) in turn through
     `DefaultTrainer.train()` on the VOC recipe (batch 8, bf16) with phase
     7's fixture: 5 steps, the caption branch from step 3; the pl branches
     with a full-width GPT-2 caption model in fp32 decoding 20 tokens. Per
     step: the K1/K3/K4 launches of `BRANCH_LAUNCHES`, every loss finite
     under JAX's names, the frozen parameters (the caption model's too)
     unchanged bit for bit. Then the step on a batch on the card, for the
     pl branches the pl step and its greedy decode (ms, tokens/s), for the
     region branches K1, K3 and K4 at the branch's own calls
     (`branch_kernel_calls`), checked and timed as in phase 6; last
     `gen_captions.main` at full width on one fixture image (token ids, ms).
 10. the mean-teacher path: the trainer `train_net.main` runs for
     SEMISUPNET.Trainer "ateacher" (`MeanTeacherTrainer`), on
     `train_net.setup`'s tree of the VOC recipe (bf16, seeded random
     weights) with mt_rcnn_instant_test.yaml's keys (8 labeled and 8
     unlabeled images a step, half of phase 7's 16-image fixture labeled,
     EMA 0.99) for 6 steps with burn-up 2, then the teacher's test.
     BBOX_THRESHOLD is 0.8, or the highest of 0.5 and 0.3 at which the
     teacher keeps some boxes at the first step past burn-up. Per step: the
     K1/K3/K4 launches of `MT_LAUNCHES`, the losses under JAX's names and
     finite, the pseudo-box count, the frozen tensors unchanged, the teacher
     unchanged in burn-up and bit-equal to the student after its last step,
     the discriminator unchanged in burn-up and moved past it; the final
     test of the teacher (launches 1/0/2 per batch); then the step on a
     batch on the card, and K1, K3 and K4 at the step's own calls
     (`mean_teacher_kernel_calls`: the teacher's pool and two NMS on the
     weak unlabeled view, each student pass's pool and RPN NMS), checked
     and timed as in phase 6.
 11. the data-parallel path, through `cddmsl_torch.engine.launch.launch`
     (what `train_net --num-gpus N` runs) on phase 7's fixture and recipe:
     (i) world 1 under NCCL in this process repeats phase 7's 12 steps and
     must leave its parameters and momentum bit for bit (else the tensors
     that differ are printed), its ms/step printed beside phase 7's; (ii)
     world 2 under gloo with both ranks on cuda:0 (4 of the 8 rows each, KD
     on, the caption branch at step 3 of 3, then the eval split over the
     ranks): per rank the launches of each step (1/1/1, then 3/3/1) and of
     the eval (1/0/2 per batch), ms/step, the gradient all-reduce's ms and
     bytes; before burn-up its parameters after step 2 must be as close to
     world 1 with ACCUM_STEPS 2 as two repeats of that run are to each
     other (both printed), and past it the global cont_loss and kd_loss it
     logs at step 3 must be world 1's at the same weights and batch within
     rtol 2e-2, and its model_final one world-1 step (ACCUM_STEPS 1) from
     its save after step 2 within 2e-2 of that step's L2 size, parameters
     and momentum (two repeats, and step 3 again with the planted fault of
     `gather_without_all_reduce`, printed beside, with the projector's
     momentum and what the batch split alone moves the projector's
     gradient, none of these judged); the gathered
     InfoNCE's fp32 gradient at both levels' rows (`infonce_grads`) must
     be one process's within 1e-5, and the planted fault must miss it;
     (iii) world 2 across two cards under NCCL where the machine
     has two (else a line says it was not run). Then K1, K3 and K4 at a
     rank's shapes (rank 0's rows of the first batch and of the first eval
     batch), checked and timed as in phase 7.
 12. the pretraining path: `pretrain_net.main` on
     configs/pretrain/RegionCLIP_RN50.yaml at full width (CLIP-RN50 student
     and frozen teacher, 4764 concepts, the 12-layer text tower, batch 96,
     bf16, seeded random weights) over a seeded corpus of 192 JPEG-caption
     pairs, cut to 6 steps: per step K1/K3/K4 launches (2/1/0, or the run
     fails), CUDA events, the host's inline loader time; the losses finite;
     the teacher, text tower and concept pool (and the stem and layer1)
     bit-equal, every trainable parameter moved; `pretrain_final` reloaded
     bit-equal; the step on a batch already on the card (ms/step,
     images/s); then K1 at both pools and K3 at the student's, at the
     step's shapes, checked and timed as in phase 6;
 13. the language tools: `extract_concept_features` on VOC's 20 classes x
     80 templates with a seeded full-width text tower saved under
     `lang_encoder.`, in bf16 (the default) and fp32, held against the CPU
     in fp32 on the first 2 classes (fp32 to 1e-4, bf16 to 5e-3), its
     encode timed; the written file loaded as MODEL.CLIP.TEXT_EMB_PATH into
     the flagship for one inference; `extract_region_features` on phase
     7's fixture test set in batches of 8 (K1/K3/K4 1/0/1 a batch, one
     .npz of (k, 1024) features an image, ms/image); K1 and K4 at the
     first batch's shapes, checked and timed as in phase 6.
 14. the plain R50-C4 baseline: `DefaultTrainer` on
     configs/VOC-Experiments/faster_rcnn_R_50_C4.yaml (the detectron2
     ResNet-50 tower, the linear classifier, batch 8 at the 800x1344 pad,
     bf16, seeded random weights) over phase 7's fixture: 12 steps (K1/K3/K4
     1/1/1 a step or the run fails, CUDA events, host wall, loader wait),
     every loss finite, the FrozenBN statistics bit-equal, the final test
     (1/0/2 a batch); the step on a batch on the card; one eval batch with
     class-specific boxes and NMS (1/0/2) and one with CLS_AGNOSTIC_BBOX_REG
     and soft-NMS (1/0/1); the soft-NMS on the card against the same call on
     the CPU (the kept boxes exactly, the scores to 1e-6) and its time; K1
     and K3 at the step's pool, K4 at its RPN NMS and K1 and K4 at the eval
     batch, checked and timed as in phase 7. Then
     configs/quick_schedules/rcnn_training_acc_test.yaml (the linear head
     on the tiny CLIP tower, fp32, TF32 off) through `train_net.main`, its
     AP50 printed beside the golden, not judged.
 15. RegionCLIP's open-vocabulary detector (`ovd_path`), bf16, batch 8 at
     the 800x1344 pad, seeded random weights: (a) the LVIS zero-shot recipe
     (CLIP_fast_rcnn_R_50_C4_zsinf.yaml: 1203 classes, NO_BOX_DELTA, the
     offline RPN's NMS at 0.9) through `build_clip_fast_rcnn`, its offline
     ResNet-50 and RPN head from a seeded detectron2 file (BB_RPN_WEIGHTS,
     `load_bb_rpn_weights`, every tensor bit-equal to the file) and its
     1203x1024 text rows from a seeded file, over 8 LVIS-format images at
     $DETECTRON2_DATASETS (lvis_v1_val) through the test loader,
     `inference_on_dataset` and `LVISEvaluator`: K1/K3/K4 1/0/2 a batch,
     ms/image, detections an image, the offline modules and text rows
     bit-equal after; (b) the COCO OVD recipe's `supervised_losses` (48
     classes, focal 0.5, background 0.2) forward and backward on a device
     batch, 5 steps timed after 3: finite losses, 1/1/1 a step, no gradient
     on the offline modules, every trainable parameter with one; (c) the VOC
     recipe's open-set head (class-agnostic boxes, MULTIPLY_RPN_SCORE, 1203
     open-set classes) through `train_net.main --eval-only` on lvis_v1_val,
     1/0/2 a batch. Then K1 and K3 at (b)'s pool, K1 at (a)'s, and K4 at
     (b)'s offline RPN and (a)'s offline RPN and detection NMS (on
     `seeded_candidates` where the batch leaves it none), as in phase 7.
 16. detectron2's FPN box detectors (`fpn_path`), bf16, seeded random
     weights: (a) `DefaultTrainer` on
     configs/COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml (R-50, FPN 256, 80
     classes, batch 8 at the 800x1344 pad) over a synthetic COCO fixture of
     the 80 COCO names (16 480x640 JPEGs): 12 steps, K1/K3/K4 4/4/1 a step
     (the pooler launches K1, and K3 in the backward, once per FPN level;
     the RPN one K4 over every level's candidates) or the run fails, every
     loss finite, the FrozenBN statistics bit-equal, the final test through
     `COCOEvaluator` (4/0/2 a batch), an eval batch's ms/image and the step
     on a batch already on the card; (b) one eval batch through
     `model.inference` of faster_rcnn_R_50_DC5_1x (1/0/2),
     faster_rcnn_X_101_32x8d_FPN_3x (4/0/2) and rpn_R_50_FPN_1x (0/0/1);
     (c) K1 and K3 at each level of the step's pool (each launch handed
     every ROI, the other levels' rows NaN), K4 at its RPN NMS, K1 at each
     level and K4 at both NMS of the eval batch (the detection NMS on
     `seeded_candidates`), as in phase 7.
The line before the last is the kernels' JSON, one row per kernel and path
(`roi_align_fwd/inference`, ..., `nms/language_tools`, `.../plain_r50`,
`.../ovd`, `.../fpn`). `launches` counts
that path's whole run (for train_net, 12 steps and the final test; for
adverse_weather, 8 steps and the final test; for consistency, the four
branches' 5 steps; for mean_teacher, 6 steps, the threshold's choice and
the teacher's test; for ddp, both ranks of world 2 under gloo; for
pretrain, 6 steps; for language_tools, the region features' batches; for
plain_r50, 12 steps and the final test; for ovd, (a)'s and (c)'s eval
batches and (b)'s 9 steps; for fpn, (a)'s 12 steps and final test);
`max_abs_err`, `ms`, `plain_ms` and `bound_ms` cover the `launches_timed`
launches checked and timed at the path's shapes (one inference; one
training step; for train_net and adverse_weather also K1 and K4 of one
eval batch per test set checked, 1 and 2 launches each; for consistency
the two region branches' calls: K1 4, K3 3, K4 2; for mean_teacher one
step's: K1 3, K3 2, K4 4; for ddp one rank's step and eval batch: K1 4,
K3 3, K4 3; for pretrain one step's: K1 2, K3 1; for language_tools the
first region-feature batch: K1 1, K4 1; for plain_r50 one step and one
eval batch: K1 2, K3 1, K4 3; for ovd one step and one eval batch: K1 2,
K3 1, K4 3; for fpn one step and one eval batch: K1 8, K3 4, K4 3): the
largest error and the sums of the times and bounds.
The last line is {"ok": true, "device": {...}}. Without a CUDA device it
exits 1 and prints no result.
"""

import collections
import contextlib
import copy
import io
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


def roi_bounds_ms(feats, R, map_pixels, pooled=14, active=None):
    """(bound ms, bound_by) of K1 or K3 over `map_pixels` pixels of the map
    `feats` and R pooled x pooled ROIs, `active` of them (all by default)
    finite: an FPN level's launch is handed every ROI with the other levels'
    rows NaN, which pool zeros. Both kernels do the same work. Bytes: each
    input read once, each output written once, in the map's dtype: for K1
    the map pixels it reads (`read_map_pixels`), the boxes and indices, and
    the pooled values (every row's); for K3 the gradient g, the boxes and
    indices, and dF, written whole (all the map's pixels). Operations:
    (2S)^2 = 16 multiply-adds, 32 flops, per pooled value of an active ROI
    at the path's S = 2."""
    es = feats.element_size()
    values = R * pooled * pooled * feats.shape[-1]
    bytes_ = values * es + R * (4 + 16) + map_pixels * feats.shape[-1] * es
    ops = 32 * (R if active is None else active) * pooled * pooled * feats.shape[-1]
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, ops / H100_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def read_map_pixels(feats, bidx, rois, pooled=14, scale=1 / 16):
    """How many pixels of the map (B, H, W, C) K1 must read for these ROIs
    (pooled x pooled bins, S = 2, `scale`, aligned): those that some ROI's
    bilinear samples weigh by more than 0, counted once per image. The
    padding of a bucket, the map outside every ROI and NaN ROIs are never
    read. A ROI's samples form a grid, so it reads the rows its y samples
    weigh times the columns its x samples weigh."""
    from cddmsl_torch.ops.roi_align import _interp_matrix, _roi_frame

    B, H, W, _ = feats.shape
    covered = torch.zeros(B, H * W, device=feats.device)
    for lo in range(0, rois.shape[0], 1024):
        x1, y1, w, h = _roi_frame(rois[lo:lo + 1024], scale, True)
        rows = _interp_matrix(y1, h, pooled, 2, H).gt(0).any(1)
        cols = _interp_matrix(x1, w, pooled, 2, W).gt(0).any(1)
        covered.index_add_(0, bidx[lo:lo + 1024].long(), (rows[:, :, None] & cols[:, None, :]).flatten(1).float())
    return int(covered.gt(0).sum())


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
    k1_bound, k1_by = roi_bounds_ms(k1_args[0], R, read_map_pixels(*k1_args[:3]))
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


def seeded_candidates(det_scores, valid, seed):
    """Detection candidates' scores replaced by seeded uniforms in
    [0.05, 1), every candidate valid: a few steps from random weights leave
    every class but the background below the test threshold, which would
    hand the detection stage an empty problem."""
    gen = torch.Generator(device=det_scores.device).manual_seed(seed)
    return 0.05 + 0.95 * torch.rand(det_scores.shape, generator=gen, device=det_scores.device), torch.ones_like(valid)


@torch.no_grad()
def eval_kernel_calls(model, batch, candidates_seed=None):
    """The kernel calls of `model.inference` on one eval batch, rebuilt on
    the model's device: K1's (features, batch_idx, boxes), the RoI heads'
    pool over the batch's proposals, and K4's (boxes, scores, valid,
    threshold, max_out) of the RPN NMS and of the detection NMS (its
    candidates shifted apart by class, as `batched_nms` shifts them), in
    the order inference makes them. A CLIPFastRCNN's RPN is the offline
    one, on the offline tower's res4. With `candidates_seed`, the detection
    NMS gets `seeded_candidates`."""
    from cddmsl_torch.models.fast_rcnn import detection_candidates
    from cddmsl_torch.ops.nms import class_shifted

    rh, backbone = model.roi_heads, model.backbone
    if hasattr(model, "offline_proposal_generator"):  # CLIPFastRCNN
        rpn, box_pool = model.offline_proposal_generator, backbone.attnpool_forward
        x = model._norm(batch.image, model.offline_pixel_mean, model.offline_pixel_std, model.offline_input_bgr)
        head = rpn._head(model.offline_backbone(x)["res4"])
        features = model._features(batch)
    else:
        rpn, box_pool = model.proposal_generator, model._box_pool
        features = backbone(model._normalize(batch.image))["res4"]
        head = rpn._head(features)
    rpn_call = (*rpn._nms_inputs(*head, batch.image_sizes, False), rpn.nms_thresh, rpn.post_nms_topk[False])
    proposals = rpn._predict_proposals(*head, batch.image_sizes, False)
    b, s = proposals.boxes.shape[:2]
    scores, deltas = rh.box_predictor(rh._region_embed(features, proposals.boxes, backbone.res5_forward, box_pool))
    boxes, det_scores, classes, valid = detection_candidates(
        scores.reshape(b, s, -1), deltas.reshape(b, s, -1), proposals.boxes, proposals.valid, batch.image_sizes,
        rh.box2box, rh.num_classes, rh.score_thresh_test, no_box_delta=rh.no_box_delta, rpn_scores=proposals.scores,
        multiply_rpn_score=rh.multiply_rpn_score)
    if candidates_seed is not None:
        det_scores, valid = seeded_candidates(det_scores, valid, candidates_seed)
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
    # the image projector is trained by the "image" branches alone; here no
    # loss reaches it and its decay (lr * 1e-4 of it, at the warmup's LR)
    # is below float32's resolution
    reached = [n for n in trainable if not n.startswith("image_projector.")]
    still = [n for n in reached if torch.equal(params[n], before[n])]
    if changed or still:
        fail(f"after {reps + 3} steps: frozen changed {changed[:5]}, trainable unmoved {still[:5]}")
    print(f"after {reps + 3} steps: all {len(reached)} trainable parameters a loss reaches moved (of "
          f"{len(trainable)}), all {len(frozen)} frozen parameters unchanged")

    return step_kernel_rows(dev, model, batch, trainer.draw, launches, roi_ops, nms_ops, "training")


def add_roi_rows(rows, dev, roi_ops, label, calls, k3_calls):
    """K1 at each of `calls` [(call, features, batch_idx, boxes) or (call,
    features, batch_idx, boxes, pooled, scale); 14 and 1/16 by default] and
    K3 at the calls named in `k3_calls`, each held against its plain version
    on the same inputs in bf16 (rtol 2e-2, the same zeros; K3 on a positive
    gradient, as in check_k3: no cancellation in dF's sums), then timed
    beside the plain version and its bound, into `rows`. NaN boxes (an FPN
    level's share of the other levels' rows) pool zeros in both."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for call, feats, bidx, rois, *geometry in calls:
        pooled, scale = geometry or (14, 1 / 16)
        R = rois.shape[0]
        active = int(torch.isfinite(rois).all(1).sum())
        k1_args = (feats, bidx, rois, (pooled, pooled), scale, 0, True)
        g = torch.rand((R, pooled, pooled, feats.shape[-1]), generator=gen, device=dev).bfloat16()
        k3_args = (g, bidx, rois, tuple(feats.shape), (pooled, pooled), scale, 0, True)
        for name, kernel, plain, args, fp32_args, map_pixels in (
            ("roi_align_fwd", roi_ops.roi_align_forward, roi_ops.roi_align_batched_plain, k1_args,
             (feats.float(), *k1_args[1:]), read_map_pixels(feats, bidx, rois, pooled, scale)),
            ("roi_align_bwd", roi_ops.roi_align_backward, roi_ops.roi_align_backward_plain, k3_args,
             (g.float(), *k3_args[1:]), feats[..., 0].numel()),
        ):
            if name == "roi_align_bwd" and call not in k3_calls:
                continue
            bound, by = roi_bounds_ms(feats, R, map_pixels, pooled, active)
            err = bf16_max_abs_err(f"{name} {label} {call}", kernel(*args), plain(*fp32_args))
            ms = cuda_ms(lambda: kernel(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 3, warmup=1)
            add_to_row(rows[name], err, ms, plain_ms, bound, by)
            share = f", {active} of them finite" if active != R else ""
            print(f"{name} {label} {call} {R}x{pooled}x{pooled}x{feats.shape[-1]}{share} over {tuple(feats.shape)} "
                  f"{feats.dtype}: max abs err {err:.4g} (rtol 2e-2), {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
                  f"bound {bound:.5f} ms ({by}; {map_pixels} of {feats[..., 0].numel()} map pixels in its bytes)")


def step_kernel_rows(dev, model, batch, draw, launches, roi_ops, nms_ops, label, eval_batches=None,
                     roi_calls=None, candidates_seed=None):
    """K1, K3 and K4 at one training step's own shapes: K1 and K3 at each of
    its RoIAlign calls (`roi_calls`, by default the CDDMSL step's three of
    `training_roi_align_calls`), K4 at its RPN NMS; then, for each of
    `eval_batches` ({name: batch on the card}), K1 and K4 at that eval
    batch's shapes (`eval_kernel_calls`: the RoI heads' pool, the RPN NMS
    and the detection NMS, on `seeded_candidates` with `candidates_seed`).
    Each is held against its plain version on the same inputs (K1 and K3
    in bf16 to rtol 2e-2 with the same zeros, K4 exactly), then timed
    beside the plain version and its bound. Returns the path's rows, with
    its `launches`; the times, bounds and errors are summed or maxed over
    the launches checked (`launches_timed`)."""
    rpn = model.proposal_generator
    f_src = model.backbone(model._normalize(batch.image))["res4"]
    nms_inputs = rpn._nms_inputs(*rpn._head(f_src), batch.image_sizes, True)
    rows = {name: new_row(launches[name]) for name in ("roi_align_fwd", "roi_align_bwd")}
    nms_calls = [(*nms_inputs, rpn.nms_thresh, rpn.post_nms_topk[True])]
    calls = (roi_calls or training_roi_align_calls)(model, batch, draw)
    add_roi_rows(rows, dev, roi_ops, label, calls, [call for call, *_ in calls])
    for set_name, eval_batch in (eval_batches or {}).items():
        (feats, bidx, rois), calls = eval_kernel_calls(model, eval_batch, candidates_seed)
        R = rois.shape[0]
        args = (feats, bidx, rois, (14, 14), 1 / 16, 0, True)
        err = bf16_max_abs_err(f"roi_align_fwd {label} eval {set_name}", roi_ops.roi_align_forward(*args),
                               roi_ops.roi_align_batched_plain(feats.float(), *args[1:]))
        ms = cuda_ms(lambda: roi_ops.roi_align_forward(*args), 10)
        plain_ms = cuda_ms(lambda: roi_ops.roi_align_batched_plain(*args), 3, warmup=1)
        bound, by = roi_bounds_ms(feats, R, read_map_pixels(feats, bidx, rois))
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
# phase 7's state after its 12 steps (parameters, momentum) and its steps'
# times, which phase 11 holds its world-1 run to
TRAIN_NET_RUN = {}


def host_state(state):
    """A training state's parameters, buffers and momentum, on the host."""
    sd = state.state_dict()
    return {"model": {k: v.detach().cpu().clone() for k, v in sd["model"].items()},
            "momentum": {i: s["momentum_buffer"].detach().cpu().clone()
                         for i, s in sd["optimizer"]["sgd"]["state"].items()}}


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


def loop_steps(label, probe, waits, n_steps, burnup, want_launches=((1, 1, 1), (3, 3, 1))):
    """The loop's steps from `probe`: per step CUDA events, host wall, the
    wait on the loader and the K1/K3/K4 launches, which must be
    `want_launches` (before the caption branch, with it: by default 1/1/1
    and 3/3/1); printed one line each."""
    if len(probe.steps) != n_steps:
        fail(f"the {label} loop ran {len(probe.steps)} steps")
    keys = ("roi_align_fwd", "roi_align_bwd", "nms")
    per_step = []
    for i, (e0, h0, l0, e1, h1, l1) in enumerate(probe.steps):
        counts = tuple(l1[k] - l0[k] for k in keys)
        want = want_launches[i > burnup]
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


def time_device_batch(label, trainer, batch, reps=5, what="caption on"):
    """The loop's step on a batch already on the card (no loader, no
    hooks), after 2 warm-up steps: CUDA events and host wall, printed."""
    shape = tuple(batch.image.shape) if hasattr(batch, "image") else [tuple(b.image.shape) for p in batch for b in p]
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
    print(f"{label} step on a batch already on the card ({shape}, {what}): "
          f"{start.elapsed_time(end) / reps:.3f} ms/step CUDA events, "
          f"{(time.perf_counter() - t0) / reps * 1e3:.3f} ms/step host wall ({reps} steps)")


VOC_NAMES = ("chip_smoke_voc_dg", "chip_smoke_voc_test")


def register_voc_fixture(voc, names=VOC_NAMES):
    """The synthetic VOC fixture at `voc` as (the training pairs, the test set)."""
    from cddmsl_torch.data.datasets.voc import register_pascal_DG, register_pascal_voc

    register_pascal_DG(names[0], voc, "trainval", 2007, "dt_clipart")
    register_pascal_voc(names[1], voc, "test", 2007)


def voc_recipe_cfg(out_dir, names=VOC_NAMES, *opts):
    """Phase 7's tree: the VOC recipe (bf16, seeded random weights) on the
    fixture registered as `names`, 12 steps, the caption branch from step 5,
    checkpoints at 6 and 12; `opts` override it."""
    import os

    from cddmsl_torch.config import get_cfg

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(here, "configs", "VOC-Experiments", "faster_rcnn_CLIP_R_50_C4.yaml"))
    cfg.merge_from_list([
        "OUTPUT_DIR", out_dir, "SEED", "0",
        "MODEL.PRE_TRAINED_RCLIP_PATH", "", "MODEL.VISION_TO_LANG_PATH", "",
        "DATASETS.TRAIN", repr((names[0],)), "DATASETS.TEST", repr((names[1],)),
        "SOLVER.MAX_ITER", str(TRAIN_NET_STEPS), "SOLVER.CAPTION_BURNUP_ITERS", str(TRAIN_NET_BURNUP),
        "SOLVER.CHECKPOINT_PERIOD", "6", "TEST.EVAL_PERIOD", "0", *opts,
    ])
    cfg.freeze()
    return cfg


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

    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, to_device
    from cddmsl_torch.data import build_detection_train_loader
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
    from cddmsl_torch.engine.defaults import DefaultTrainer, build_evaluator
    from cddmsl_torch.evaluation import inference_on_dataset
    from cddmsl_torch.profile_train import busy_and_span_us, device_kernels

    class ProbedTrainer(DefaultTrainer):
        def build_hooks(self):
            self.probe = StepProbe(roi_ops, nms_ops)
            return [self.probe] + super().build_hooks()

        def test(self, cfg=None, model=None):
            t0 = time.perf_counter()
            results = super().test(cfg, model)
            self.test_s = time.perf_counter() - t0
            return results

    root = tempfile.mkdtemp(prefix="cddmsl_train_net_")
    names = VOC_NAMES
    try:
        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_voc_fixture(voc, names)
        cfg = voc_recipe_cfg(os.path.join(root, "out"), names)
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
        TRAIN_NET_RUN["state"] = host_state(trainer.state)  # phase 11 repeats these steps under a process group
        print(f"train_net path launches (12 steps and the final test): {launches}")
        if min(launches.values()) < 1:
            fail(f"the train_net path did not go through every kernel: {launches}")

        probe = trainer.probe
        waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
        per_step = loop_steps("train_net", probe, waits, TRAIN_NET_STEPS, TRAIN_NET_BURNUP)
        TRAIN_NET_RUN["per_step"] = per_step
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


# phase 9: each MODEL.CONSISTENCY_BRANCH for 5 steps, the caption branch at
# 0-based iterations past 1 (steps 3-5)
CONSISTENCY_STEPS, CONSISTENCY_BURNUP = 5, 1
# the VOC recipe's losses (KD off) and each branch's own, under JAX's names
MAIN_LOSSES = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "cont_loss", "cont_loss_region")
BRANCH_LOSS = {"image": "image_cont_loss", "image_region": "image_region_cont_loss",
               "caption_pl_img": "token-pl_loss", "caption_pl_region": "token-pl-region_loss"}
# K1/K3/K4 launches per step, before the caption branch and with it: the main
# step's 1/1/1 or 3/3/1, and the branch's own. A region branch recomputes
# both views' res4 and the training proposals (one NMS) and pools its boxes
# from both maps (two K1); its gradient reaches both pools in image_region
# (two K3) and only the target's in caption_pl_region (one K3).
BRANCH_LAUNCHES = {"image": ((1, 1, 1), (3, 3, 1)), "image_region": ((3, 3, 2), (5, 5, 2)),
                   "caption_pl_img": ((1, 1, 1), (3, 3, 1)), "caption_pl_region": ((3, 2, 2), (5, 4, 2))}


@torch.no_grad()
def branch_kernel_calls(model, batch, draw, site):
    """The kernel calls of a region branch (draw site "image_region" or
    "caption_pl_region"), rebuilt outside autograd on the model's device:
    K4's RPN NMS on the source map (boxes, scores, valid, threshold,
    max_out), then K1's pools [(label, features, batch_idx, boxes)] of the
    same random proposals on the source and on the translated map."""
    rpn = model.proposal_generator
    f_src = model.backbone(model._normalize(batch.image))["res4"]
    f_trgt = model.backbone(model._normalize(batch.image_trgt))["res4"]
    nms_call = (*rpn._nms_inputs(*rpn._head(f_src), batch.image_sizes, True), rpn.nms_thresh, rpn.post_nms_topk[True])
    boxes = model._branch_region_boxes(f_src, batch, draw, site)
    return nms_call, [("region_src", *pool_args(f_src, boxes)), ("region_trgt", *pool_args(f_trgt, boxes))]


def consistency_path(dev, smi, roi_ops, nms_ops):
    """MODEL.CONSISTENCY_BRANCH at full width: for each branch in turn,
    `DefaultTrainer` on the VOC recipe (batch 8, bf16) with phase 7's
    fixture, `train()` for 5 steps (the caption branch from step 3), per
    step the launches, the losses under JAX's names and the frozen
    parameters (the caption model's too); then the step on a batch on the
    card, for the pl branches the pl step and its decode, and for the
    region branches their kernel calls checked and timed. Last,
    `gen_captions` at full width on one fixture image. Returns its rows."""
    import os
    import shutil
    import tempfile

    from cddmsl_torch import gen_captions
    from cddmsl_torch.config import get_cfg
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader, to_device
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
    from cddmsl_torch.data.datasets.voc import register_pascal_DG
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from cddmsl_torch.engine.hooks import HookBase
    from cddmsl_torch.models.caption import generate

    class FrozenCheck(HookBase):
        """A trainer hook after the probe: the frozen tensors against their
        values before train(), one sync per step, outside the step's events."""

        def __init__(self, frozen):
            self.frozen = frozen
            self.changed = []

        def after_step(self):
            diff = torch.stack([(p != v).any() for p, v in self.frozen.values()])
            if diff.any():
                self.changed.append([n for n, d in zip(self.frozen, diff.tolist()) if d])

    class ProbedTrainer(DefaultTrainer):
        def build_hooks(self):
            self.probe = StepProbe(roi_ops, nms_ops)
            self.step_metrics = []
            frozen = {f"model.{n}": p for n, p in self.model.named_parameters() if not p.requires_grad}
            if self.caption_model is not None:
                frozen.update({f"caption_model.{n}": p for n, p in self.caption_model.named_parameters()})
            self.frozen_check = FrozenCheck({n: (p, p.detach().clone()) for n, p in frozen.items()})
            return [self.probe] + super().build_hooks() + [self.frozen_check]

        def run_step(self, batch):
            metrics = super().run_step(batch)
            self.step_metrics.append(metrics)
            return metrics

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_consistency_")
    name = "chip_smoke_consistency_dg"
    keys = ("roi_align_fwd", "roi_align_bwd", "nms")
    totals = dict.fromkeys(keys, 0)
    rows = {k: new_row(0) for k in keys[:2]}
    nms_calls = []
    try:
        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_pascal_DG(name, voc, "trainval", 2007, "dt_clipart")
        for branch in BRANCH_LOSS:
            cfg = get_cfg()
            cfg.merge_from_file(os.path.join(here, "configs", "VOC-Experiments", "faster_rcnn_CLIP_R_50_C4.yaml"))
            cfg.merge_from_list([
                "OUTPUT_DIR", os.path.join(root, branch), "SEED", "0",
                "MODEL.PRE_TRAINED_RCLIP_PATH", "", "MODEL.VISION_TO_LANG_PATH", "",
                "MODEL.CONSISTENCY_BRANCH", branch, "DATASETS.TRAIN", repr((name,)), "DATASETS.TEST", "()",
                "SOLVER.MAX_ITER", str(CONSISTENCY_STEPS), "SOLVER.CAPTION_BURNUP_ITERS", str(CONSISTENCY_BURNUP),
                "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
            ])
            cfg.freeze()
            trainer = ProbedTrainer(cfg, device="cuda")
            trainer.resume_or_load(resume=False)
            cap = trainer.caption_model
            if branch.startswith("caption_pl"):
                g = cap.gpt_config
                print(f"consistency {branch}: caption model GPT-2 {g.vocab_size}/{g.n_positions}/{g.n_embd}/"
                      f"{g.n_layer}/{g.n_head} (vocab/positions/embd/layers/heads), a mapper of "
                      f"{len(cap.clip_project.transformer.layers)} layers, {cap.prefix_length} prefix tokens, "
                      f"{next(cap.parameters()).dtype}, decode {cfg.MODEL.CAPTION_PL_MAX_LEN} tokens, "
                      f"seeded random weights")
            torch.cuda.synchronize()
            reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
            trainer.train()
            torch.cuda.synchronize()
            launches = read_launches(roi_ops, nms_ops)
            for k in keys:
                totals[k] += launches[k]
            waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
            per_step = loop_steps(f"consistency {branch}", trainer.probe, waits, CONSISTENCY_STEPS,
                                  CONSISTENCY_BURNUP, BRANCH_LAUNCHES[branch])
            want_names = set(MAIN_LOSSES) | {BRANCH_LOSS[branch]}
            for i, metrics in enumerate(trainer.step_metrics):
                losses = {k: v.item() for k, v in metrics.items() if "loss" in k and k != "total_loss"}
                if set(losses) != want_names or not all(map(math.isfinite, losses.values())):
                    fail(f"consistency {branch} step {i + 1}: losses {losses}, expected the names {sorted(want_names)}")
            if trainer.frozen_check.changed:
                fail(f"consistency {branch}: frozen parameters changed: {trainer.frozen_check.changed[0][:5]}")
            warm = per_step[CONSISTENCY_BURNUP + 2:]  # caption on, past its first step
            mean = lambda xs: sum(xs) / len(xs)
            last = {k: round(v.item(), 6) for k, v in trainer.step_metrics[-1].items() if "loss" in k}
            whose = " (the caption model's included)" if cap is not None else ""
            print(f"consistency {branch}: launches {launches} in {CONSISTENCY_STEPS} steps; losses finite under "
                  f"JAX's names in every step, the last {json.dumps(last)}; {len(trainer.frozen_check.frozen)} "
                  f"frozen tensors{whose} bit-equal after every step; steps "
                  f"{CONSISTENCY_BURNUP + 3}-{CONSISTENCY_STEPS}: {mean([p[0] for p in warm]):.3f} ms/iteration "
                  f"CUDA events, {mean([p[1] for p in warm]):.3f} ms/iteration host wall; on {smi}")

            with build_detection_train_loader(cfg, seed=0, pin_memory=True) as train_loader:
                batch = to_device(next(train_loader), dev)
            time_device_batch(f"consistency {branch}", trainer, batch, reps=3)
            model, draw = trainer.model, trainer.state.draw
            if cap is not None:
                pl_ms = cuda_ms(lambda: trainer.caption_pl_step(batch, draw), 3, warmup=1)
                with torch.no_grad():
                    p_src = (model.caption_pl_prefixes(batch)[0] if branch == "caption_pl_img"
                             else model.caption_pl_region_prefixes(batch, draw)[0])
                n_len = cfg.MODEL.CAPTION_PL_MAX_LEN
                gen_ms = cuda_ms(lambda: generate(cap, p_src, max_len=n_len), 3, warmup=1)
                t0 = time.perf_counter()
                _, live = generate(cap, p_src, max_len=n_len)
                torch.cuda.synchronize()
                gen_host = (time.perf_counter() - t0) * 1e3
                print(f"consistency {branch} pl step on the batch on the card: {pl_ms:.3f} ms CUDA events; "
                      f"its greedy decode of {p_src.shape[0]} prefixes x {n_len} tokens: {gen_ms:.3f} ms CUDA "
                      f"events ({gen_host:.3f} ms host wall, once), {p_src.shape[0] * n_len / gen_ms * 1e3:.1f} "
                      f"tokens/s, {int(live.sum())} live tokens")
            if branch.endswith("_region"):
                nms_call, calls = branch_kernel_calls(model, batch, site_draw(dev), branch)
                k3 = ["region_src", "region_trgt"] if branch == "image_region" else ["region_trgt"]
                add_roi_rows(rows, dev, roi_ops, f"consistency {branch}", calls, k3)
                nms_calls.append(nms_call)
            del trainer, model, cap, batch
            torch.cuda.empty_cache()
        print(f"consistency path launches (the four branches' {CONSISTENCY_STEPS} steps each): {totals}")
        if min(totals.values()) < 1:
            fail(f"the consistency path did not go through every kernel: {totals}")

        jpegs = os.path.join(voc, "JPEGImages")
        image = os.path.join(jpegs, sorted(os.listdir(jpegs))[0])
        t0 = time.perf_counter()
        ids = gen_captions.main(["--image", image, "--max-len", "67"])
        torch.cuda.synchronize()
        if not ids or not all(0 <= i < 50257 for i in ids):
            fail(f"gen_captions gave {ids}")
        print(f"gen_captions (python -m cddmsl_torch.gen_captions --image {os.path.basename(image)} --max-len 67, "
              f"full width, seeded random weights): {len(ids)} token ids, {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"host wall with the models' set-up")
        for k in keys[:2]:
            rows[k]["launches"] = totals[k]
        out = {k: close_row(row) for k, row in rows.items()}
        out["nms"] = nms_row(nms_ops, "consistency", totals["nms"], nms_calls)
        print(f"consistency phase: {time.perf_counter() - t_phase:.1f} s wall")
        return out
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


# phase 10: the mean-teacher trainer for 6 steps, burn-up 2 (steps 4-6 past it)
MT_STEPS, MT_BURNUP = 6, 2
# the JAX step's loss names (cddmsl_tpu/engine/mean_teacher.py)
MT_LOSSES = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_cls_pseudo", "loss_rpn_cls_pseudo",
             "loss_D")
# K1/K3/K4 launches per step, in burn-up and past it: the supervised pass's
# pool, its backward and the RPN NMS; past burn-up also the teacher's pool
# and its two NMS (the RPN's and the detections'), and the pseudo-labeled
# pass's pool, backward and RPN NMS
MT_LAUNCHES = ((1, 1, 1), (3, 2, 4))


@torch.no_grad()
def mean_teacher_kernel_calls(trainer, batch, draws):
    """The kernel calls of one mean-teacher step past burn-up, rebuilt
    outside autograd on the card, in the step's order: the teacher's eval
    calls on the weak unlabeled view (`eval_kernel_calls`: its pool and its
    two NMS), then per student pass (the strong labeled view, the strong
    unlabeled view with the teacher's pseudo-labels) its RPN NMS and its
    pool of the sampled ROIs. Returns ([(label, features, batch_idx,
    boxes)], [K4 calls])."""
    (label_s, _), (unlabel_s, unlabel_w) = batch
    model, rpn, rh = trainer.model, trainer.model.proposal_generator, trainer.model.roi_heads
    teacher_pool, nms_calls = eval_kernel_calls(trainer.teacher, unlabel_w)
    pools = [("teacher", *teacher_pool)]
    boxes, classes, valid = trainer._pseudo_label(trainer.teacher, unlabel_w)
    pseudo = unlabel_s._replace(gt_boxes=boxes, gt_classes=classes, gt_valid=valid)
    for name, b, draw in (("supervised", label_s, draws[0]), ("pseudo", pseudo, draws[1])):
        f = model.extract_res4(b.image)
        head = rpn._head(f)
        nms_calls.append((*rpn._nms_inputs(*head, b.image_sizes, True), rpn.nms_thresh, rpn.post_nms_topk[True]))
        proposals = rpn._predict_proposals(*head, b.image_sizes, True)
        sampled = rh.label_and_sample_proposals(proposals, b.gt_boxes, b.gt_classes, b.gt_valid, draw)[0]
        pools.append((name, *pool_args(f, sampled)))
    return pools, nms_calls


def mean_teacher_path(dev, smi, roi_ops, nms_ops):
    """SEMISUPNET.Trainer "ateacher" at full width: the trainer
    `train_net.main` runs for it, on `train_net.setup`'s tree of the VOC
    recipe with mt_rcnn_instant_test.yaml's keys (8 labeled and 8
    unlabeled images a step, half of phase 7's fixture labeled, EMA 0.99)
    for 6 steps with burn-up 2, then the teacher's test. Per step the
    launches, JAX's loss names, the frozen tensors, the teacher (unchanged
    in burn-up, the student at its end) and the discriminator (moved past
    it); then the step on a batch on the card and K1/K3/K4 at the step's
    own calls. Returns its rows {kernel: row}."""
    import argparse
    import os
    import shutil
    import tempfile

    from cddmsl_torch import train_net
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
    from cddmsl_torch.data.datasets.voc import register_pascal_voc
    from cddmsl_torch.engine import mean_teacher
    from cddmsl_torch.engine.hooks import HookBase

    class Threshold(HookBase):
        """Before the probe: at the first step past burn-up, BBOX_THRESHOLD
        0.8, or the highest of 0.5 and 0.3 at which the teacher keeps some
        boxes of the last step's weak unlabeled view (on the card, outside
        the step's events and launch counts)."""

        def before_step(self):
            t = self.trainer
            if t.state.iteration != MT_BURNUP + 1:
                return
            label = mean_teacher.MeanTeacherTrainer._pseudo_label  # not the probe's counting one
            for thr in (0.8, 0.5, 0.3):
                t.bbox_threshold = thr
                t.thresholds.append((thr, int(label(t, t.teacher, t.last_weak)[2].sum())))
                if t.thresholds[-1][1]:
                    break

    class MTCheck(HookBase):
        """After the probe: per step the frozen tensors, the teacher against
        its start and against the student, the discriminator against its
        start, one sync outside the step's events."""

        def before_train(self):
            t = self.trainer
            self.frozen = {n: (p, p.detach().clone()) for n, p in t.model.named_parameters() if not p.requires_grad}
            self.teacher0 = {k: v.clone() for k, v in t.teacher.state_dict().items()}
            self.dis0 = {k: v.clone() for k, v in t.discriminator.state_dict().items()}
            self.flags = []

        def after_step(self):
            t = self.trainer
            teacher, student, dis = t.teacher.state_dict(), t.model.state_dict(), t.discriminator.state_dict()
            same = lambda a, b: torch.stack([(a[k] == b[k]).all() for k in a]).all()  # noqa: E731
            flags = torch.stack([torch.stack([(p == v).all() for p, v in self.frozen.values()]).all(),
                                 same(teacher, self.teacher0), same(teacher, student), same(dis, self.dis0)])
            self.flags.append(dict(zip(("frozen", "teacher_unchanged", "teacher_is_student", "dis_unchanged"),
                                       flags.tolist())))

    class ProbedTrainer(mean_teacher.MeanTeacherTrainer):
        def __init__(self, cfg, device="cuda"):
            super().__init__(cfg, device)
            self.step_metrics, self.pseudo_counts, self.thresholds = [], [], []

        def build_hooks(self):
            self.probe, self.check = StepProbe(roi_ops, nms_ops), MTCheck()
            return [Threshold(), self.probe] + super().build_hooks() + [self.check]

        def _pseudo_label(self, teacher, weak_batch):
            out = super()._pseudo_label(teacher, weak_batch)
            self.pseudo_counts.append(out[2].sum())
            return out

        def run_step(self, batch):
            metrics = super().run_step(batch)
            self.step_metrics.append(metrics)
            self.last_weak = batch[1][1]
            return metrics

        def test(self, cfg=None, model=None):
            t0 = time.perf_counter()
            results = super().test(cfg, model)
            self.test_s = time.perf_counter() - t0
            self.tested = "teacher" if model is self.teacher else "student"
            return results

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_mean_teacher_")
    names = ("chip_smoke_mt_trainval", "chip_smoke_mt_test")
    keys = ("roi_align_fwd", "roi_align_bwd", "nms")
    try:
        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_pascal_voc(names[0], voc, "trainval", 2007)
        register_pascal_voc(names[1], voc, "test", 2007)
        args = argparse.Namespace(
            config_file=os.path.join(here, "configs", "VOC-Experiments", "faster_rcnn_CLIP_R_50_C4.yaml"),
            resume=False, eval_only=False, device="cuda", opts=[
                "OUTPUT_DIR", os.path.join(root, "out"), "SEED", "0",
                "MODEL.PRE_TRAINED_RCLIP_PATH", "", "MODEL.VISION_TO_LANG_PATH", "",
                "SEMISUPNET.Trainer", "ateacher", "SEMISUPNET.BURN_UP_STEP", str(MT_BURNUP),
                "SEMISUPNET.EMA_KEEP_RATE", "0.99", "SEMISUPNET.BBOX_THRESHOLD", "0.8",
                "SEMISUPNET.UNSUP_LOSS_WEIGHT", "0.5", "DATASETS.CROSS_DATASET", "False",
                "DATASETS.TRAIN", repr((names[0],)), "DATASETS.TEST", repr((names[1],)),
                "DATALOADER.SUP_PERCENT", "50.0", "SOLVER.IMG_PER_BATCH_LABEL", "8",
                "SOLVER.IMG_PER_BATCH_UNLABEL", "8", "SOLVER.MAX_ITER", str(MT_STEPS),
                "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
            ])
        cfg = train_net.setup(args)  # the tree with the mean-teacher block, as train_net.main builds it
        trainer = ProbedTrainer(cfg, device="cuda")  # what train_net.main runs for SEMISUPNET.Trainer ateacher
        trainer.resume_or_load(resume=False)
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        results = trainer.train()
        torch.cuda.synchronize()
        launches = read_launches(roi_ops, nms_ops)
        print(f"mean_teacher: train_net's mean-teacher trainer on the VOC recipe with SEMISUPNET.Trainer ateacher "
              f"({cfg.SOLVER.IMG_PER_BATCH_LABEL} labeled + {cfg.SOLVER.IMG_PER_BATCH_UNLABEL} unlabeled images a "
              f"step, {cfg.TPU.COMPUTE_DTYPE}, burn-up {MT_BURNUP}, EMA {cfg.SEMISUPNET.EMA_KEEP_RATE}, "
              f"SUP_PERCENT {cfg.DATALOADER.SUP_PERCENT} of the {TRAIN_NET_IMAGES}-image fixture, seeded random "
              f"weights); path launches ({MT_STEPS} steps and the teacher's test): {launches}")
        if min(launches.values()) < 1:
            fail(f"the mean_teacher path did not go through every kernel: {launches}")
        print(f"mean_teacher BBOX_THRESHOLD {trainer.bbox_threshold} (boxes kept by the teacher at the first step "
              f"past burn-up at each threshold tried: {trainer.thresholds})")
        waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
        per_step = loop_steps("mean_teacher", trainer.probe, waits, MT_STEPS, MT_BURNUP, MT_LAUNCHES)
        counts = [int(c) for c in trainer.pseudo_counts]
        for i, (metrics, flags) in enumerate(zip(trainer.step_metrics, trainer.check.flags)):
            losses = {k: v.item() for k, v in metrics.items() if k != "total_loss"}
            past = i > MT_BURNUP
            want = {"frozen": True, "teacher_unchanged": i < MT_BURNUP, "teacher_is_student": i == MT_BURNUP or None,
                    "dis_unchanged": not past}
            bad = {k: v for k, v in flags.items() if want[k] is not None and v != want[k]}
            if set(losses) != set(MT_LOSSES) or not all(map(math.isfinite, losses.values())) or bad:
                fail(f"mean_teacher step {i + 1}: losses {losses}, checks {flags} (wrong: {bad})")
            if past != (losses["loss_D"] > 0):
                fail(f"mean_teacher step {i + 1}: loss_D {losses['loss_D']}")
            print(f"mean_teacher step {i + 1}: losses {json.dumps({k: round(v, 6) for k, v in losses.items()})}, "
                  f"pseudo-boxes {counts[i - MT_BURNUP - 1] if past else 'none (burn-up)'}; {flags}")
        if len(counts) != MT_STEPS - MT_BURNUP - 1 or not any(counts):
            fail(f"mean_teacher pseudo-box counts {counts}")
        warm = per_step[MT_BURNUP + 2:]  # past burn-up, after its first step
        mean = lambda xs: sum(xs) / len(xs)
        print(f"mean_teacher loop, steps {MT_BURNUP + 3}-{MT_STEPS} (past burn-up): "
              f"{mean([p[0] for p in warm]):.3f} ms/iteration CUDA events, {mean([p[1] for p in warm]):.3f} "
              f"ms/iteration host wall, {mean([p[2] for p in warm]):.3f} ms/iteration waiting on the loader; "
              f"whole loop {trainer.probe.loop_s * 1e3 / MT_STEPS:.3f} ms/iteration host wall; on {smi}")

        n_test = -(-TRAIN_NET_IMAGES // cfg.MODEL.CLIP.IMS_PER_BATCH_TEST)
        per_batch = tuple((launches[k] - trainer.probe.loop_launches[k]) / n_test for k in keys)
        if trainer.tested != "teacher" or per_batch != (1, 0, 2):
            fail(f"the final test evaluated the {trainer.tested}, launching K1/K3/K4 {per_batch} per batch")
        ap = {k: round(v, 4) for k, v in results[names[1]]["bbox"].items() if k in ("AP", "AP50", "AP75")}
        print(f"mean_teacher teacher test: {trainer.test_s * 1e3 / TRAIN_NET_IMAGES:.3f} ms/image, launches per "
              f"batch K1/K3/K4 {per_batch}; AP (random weights, not judged) {json.dumps(ap)}")

        with trainer.build_train_loader() as loader:
            batch = trainer.batch_to_device(next(loader))
        time_device_batch("mean_teacher", trainer, batch, what="past burn-up, EMA every step")
        # where the step's time goes: the teacher's pseudo-labels on 8 weak
        # images and the EMA over the teacher's state; the rest is the two
        # student passes with their backward, the discriminator and the
        # two optimizer steps
        teacher_ms = cuda_ms(lambda: trainer._pseudo_label(trainer.teacher, batch[1][1]), 5)
        ema_ms = cuda_ms(lambda: trainer._update_teacher(MT_BURNUP + 1), 5)
        n_teacher = sum(v.numel() for v in trainer.teacher.state_dict().values())
        print(f"mean_teacher step parts (CUDA events): the teacher's pseudo-labels {teacher_ms:.3f} ms, the EMA over "
              f"{n_teacher} teacher values {ema_ms:.3f} ms; on {smi}")
        pools, nms_calls = mean_teacher_kernel_calls(trainer, batch, (site_draw(dev), site_draw(dev)))
        rows = {k: new_row(launches[k]) for k in keys[:2]}
        add_roi_rows(rows, dev, roi_ops, "mean_teacher", pools, ["supervised", "pseudo"])
        out = {k: close_row(row) for k, row in rows.items()}
        out["nms"] = nms_row(nms_ops, "mean_teacher", launches["nms"], nms_calls)
        print(f"mean_teacher phase: {time.perf_counter() - t_phase:.1f} s wall")
        return out
    finally:
        for name in names:
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


# phase 11: the VOC loop data-parallel. World 2 takes 3 steps, the caption
# branch (KD on) at the third; its save after step 2 is the pre-burn-up state
DDP_STEPS, DDP_BURNUP, DDP_WORLD = 3, 1, 2
# world 2's step past burn-up against world 1's from the same state: the
# past-burn-up tolerance of the losses, on the step's L2 size; the gathered
# InfoNCE's gradient in fp32 against one process's
DDP_STEP_RTOL, INFONCE_RTOL = 2e-2, 1e-5
DDP_OPTS = ("SOLVER.MAX_ITER", str(DDP_STEPS), "SOLVER.CAPTION_BURNUP_ITERS", str(DDP_BURNUP),
            "SOLVER.CHECKPOINT_PERIOD", "2", "MODEL.KD_REGULRAZIATION", "True")


def probed_trainer(cfg, roi_ops, nms_ops):
    """A `DefaultTrainer` on the card with a `StepProbe` (`.probe`) first
    among its hooks."""
    from cddmsl_torch.engine.defaults import DefaultTrainer

    trainer = DefaultTrainer(cfg, device="cuda")
    trainer.probe = StepProbe(roi_ops, nms_ops)
    build_hooks = trainer.build_hooks
    trainer.build_hooks = lambda: [trainer.probe] + build_hooks()
    return trainer


def ddp_rank_run(voc, out_dir, result_dir):
    """One rank of a world-2 run of the VOC loop (`launch` runs it in each
    process): 3 steps of its 4 rows of 8, the eval split over the ranks.
    Writes its step times and launches, the eval results and the gradient
    all-reduce's time and bytes to result_dir/rank<r>.json. Then rank 0
    writes to result_dir/checks.pth: `infonce_grads` with the gather as it
    is and with the planted fault (`gather_without_all_reduce`), and the
    state of step 3 taken again from the save after step 2 with the
    planted fault."""
    import os

    from cddmsl_torch.data import build_detection_train_loader
    from cddmsl_torch.ops import _build
    from cddmsl_torch.ops import nms as nms_ops
    from cddmsl_torch.ops import roi_align as roi_ops
    from cddmsl_torch.parallel import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(roi_ops.KERNEL, nms_ops.KERNEL)
    register_voc_fixture(voc)
    cfg = voc_recipe_cfg(out_dir, VOC_NAMES, *DDP_OPTS)
    trainer = probed_trainer(cfg, roi_ops, nms_ops)
    trainer.resume_or_load(resume=False)
    torch.cuda.synchronize()
    comm.synchronize()
    reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
    results = trainer.train()
    torch.cuda.synchronize()
    launches = read_launches(roi_ops, nms_ops)
    rank = comm.get_rank()
    waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
    lines = io.StringIO()  # printed by the parent, one rank after the other
    with contextlib.redirect_stdout(lines):
        per_step = loop_steps(f"ddp rank {rank}", trainer.probe, waits, DDP_STEPS, DDP_BURNUP)
    grads = [p.grad for p in trainer.optimizer.params]
    n_bytes = sum(g.numel() * g.element_size() for g in grads)
    comm.all_reduce_mean_(grads)  # warm
    torch.cuda.synchronize()
    comm.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        comm.all_reduce_mean_(grads)
    torch.cuda.synchronize()
    with open(os.path.join(result_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"device": str(torch.cuda.current_device()), "world": comm.get_world_size(),
                   "per_step": per_step, "lines": lines.getvalue(), "launches": launches, "loop_launches": trainer.probe.loop_launches,
                   "results": results, "allreduce_ms": (time.perf_counter() - t0) / 3 * 1e3,
                   "allreduce_bytes": n_bytes, "trainable": sum(g.numel() for g in grads)}, f)

    checks = {"infonce": infonce_grads(trainer.model.projector)}
    with gather_without_all_reduce():
        checks["infonce_fault"] = infonce_grads(trainer.model.projector)
    with build_detection_train_loader(cfg, seed=0, pin_memory=True) as loader:
        batch = trainer.batch_to_device([next(loader) for _ in range(DDP_STEPS)][-1])
    trainer.checkpointer.load(os.path.join(out_dir, "model_0000001.pth"), trainer.state)
    with gather_without_all_reduce():
        trainer.run_step(batch)
    checks["fault"] = host_state(trainer.state)
    if rank == 0:
        torch.save(checks, os.path.join(result_dir, "checks.pth"))
    comm.synchronize()


def ddp_world1_run(voc, out_dir, roi_ops, nms_ops):
    """Phase 7's 12 steps again, in this process, under a process group of
    one (NCCL) through `launch`: -> (per-step rows, host state)."""
    cfg = voc_recipe_cfg(out_dir, VOC_NAMES, "DATASETS.TEST", "()")
    trainer = probed_trainer(cfg, roi_ops, nms_ops)
    trainer.resume_or_load(resume=False)
    torch.cuda.synchronize()
    trainer.train()
    torch.cuda.synchronize()
    waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
    return loop_steps("ddp world 1", trainer.probe, waits, TRAIN_NET_STEPS, TRAIN_NET_BURNUP), host_state(trainer.state)


@contextlib.contextmanager
def gather_without_all_reduce():
    """The planted fault: the gathered rows' backward without its
    all-reduce, so that each rank's rows get only its own copy of the
    loss's gradient (1 / world of it after the gradient mean)."""
    from cddmsl_torch.parallel import comm

    backward = comm._AllGatherWithGrad.backward
    comm._AllGatherWithGrad.backward = staticmethod(lambda ctx, g: g[ctx.rows[0] : ctx.rows[1]])
    try:
        yield
    finally:
        comm._AllGatherWithGrad.backward = backward


# the caption InfoNCE's rows in a global batch of 8: the image level, the
# region level (16 boxes an image)
INFONCE_ROWS = (8, 128)


def infonce_grads(projector):
    """The caption InfoNCE's gradient in fp32 (TF32 off) at both levels'
    rows of a global batch of 8, through an fp32 copy of `projector`: every
    rank draws the same seeded features of all rows, projects its
    `local_rows` and gathers; the gradient is averaged over the ranks as
    `Optimizer.step` averages it. -> {"projector": the weights, "grads":
    {name: gradient}}; one process without a group projects every row."""
    from cddmsl_torch.models.rcnn import infonce_bidirectional
    from cddmsl_torch.parallel import comm

    proj = copy.deepcopy(projector).float()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.enable_grad():
        for n in INFONCE_ROWS:
            a, b = torch.randn((2, n, proj.fc1.in_features), generator=gen, device="cuda")
            lo, hi = comm.local_rows(n)
            infonce_bidirectional(proj(a[lo:hi]), proj(b[lo:hi])).backward()
    comm.all_reduce_mean_([p.grad for p in proj.parameters()])
    return {"projector": {k: v.cpu() for k, v in proj.state_dict().items()},
            "grads": {k: p.grad.cpu() for k, p in proj.named_parameters()}}


def caption_projector_grad(model, batch, parts):
    """The projector's gradient of the image-level caption InfoNCE on
    `batch` on one process, the student's features computed over `parts`
    equal row blocks, a call each (as `parts` ranks compute theirs)."""
    from cddmsl_torch.models.rcnn import infonce_bidirectional

    with torch.enable_grad():
        a, b = (model.projector(torch.cat([model._student_v2l(x) for x in model._v2l_preprocess(images).chunk(parts)]))
                for images in (batch.image_trgt, batch.image))
        grads = torch.autograd.grad(infonce_bidirectional(a, b), list(model.projector.parameters()))
    return dict(zip([n for n, _ in model.projector.named_parameters()], grads))


def rel_l2(got, want):
    """|got - want| / |want| in L2 over the tensors of two dicts."""
    num = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    return math.sqrt(num / sum(float(w.double().square().sum()) for w in want.values()))


def saved_state(path):
    """A save's parameters, buffers and momentum, as `host_state` gives them."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return {"model": saved["model"],
            "momentum": {i: s["momentum_buffer"] for i, s in saved["optimizer"]["sgd"]["state"].items()}}


def step_errors(got, want, start, names, momentum):
    """How far the step from `start` to `got` is from the step to `want`, as
    |got - want| / |want - start| in L2 over the trainable parameters, the
    same over the momentum buffers (the step's part of a buffer, want -
    momentum * start, as the denominator), and that over the projector's
    buffers, whose gradient is the caption InfoNCE's alone."""
    def rel(triples):
        return math.sqrt(sum(float((g.double() - w.double()).square().sum()) for g, w, _ in triples)
                         / sum(float((w.double() - s.double()).square().sum()) for _, w, s in triples))

    mom = [(got["momentum"][i], want["momentum"][i], momentum * start["momentum"][i].double())
           for i in range(len(names))]
    return {"parameters": rel([(got["model"][n], want["model"][n], start["model"][n]) for n in names]),
            "momentum": rel(mom),
            "projector": rel([m for n, m in zip(names, mom) if n.startswith("projector.")])}


def state_diffs(got, want):
    """[(name, max |got - want|)] of the tensors that differ."""
    out = [(k, float((got["model"][k].double() - v.double()).abs().max())) for k, v in want["model"].items()
           if not torch.equal(got["model"][k], v)]
    return out + [(f"momentum {i}", float((got["momentum"][i] - v).abs().max())) for i, v in want["momentum"].items()
                  if not torch.equal(got["momentum"][i], v)]


def ddp_path(dev, smi, roi_ops, nms_ops):
    """The VOC loop data-parallel through `launch` (`python -m
    cddmsl_torch.train_net --num-gpus N`): (i) world 1 under NCCL repeats
    phase 7's 12 steps, bit for bit; (ii) world 2 on the one card under
    gloo (both ranks on cuda:0, 4 rows of 8 each) takes 3 steps and
    evaluates split over the ranks: before burn-up its parameters are held
    to world 1 with ACCUM_STEPS 2 within the gap two repeats of that run
    show, past it its global cont_loss and kd_loss to world 1's at the same
    weights and batch (rtol 2e-2) and its last step to world 1's from the
    same save (`step_errors`), and the gathered InfoNCE's gradient to one
    process's (`infonce_grads`), which the planted fault must miss; (iii)
    world 2 on two cards under NCCL where there are two. Then K1, K3 and K4
    at a rank's shapes. Returns the rows {kernel: row}; `launches` is world
    2's, both ranks."""
    import glob
    import os
    import shutil
    import tempfile

    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader
    from cddmsl_torch.data import build_detection_train_loader, to_device
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
    from cddmsl_torch.engine.defaults import DefaultTrainer, _iteration_seed
    from cddmsl_torch.engine.launch import launch
    from cddmsl_torch.models.sampling import generator_draw
    from cddmsl_torch.parallel import comm
    from cddmsl_torch.solver.build import split_parameters

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cddmsl_ddp_")
    try:
        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_voc_fixture(voc)

        # (i) world 1 under NCCL, in this process
        per_step, state = launch(ddp_world1_run, 1, dist_url=f"tcp://127.0.0.1:{free_port()}", device="cuda",
                                 args=(voc, os.path.join(root, "w1"), roi_ops, nms_ops))
        if comm.get_world_size() != 1 or torch.distributed.is_initialized():
            fail("launch left the process group of world 1 open")
        diffs = state_diffs(state, TRAIN_NET_RUN["state"])
        if diffs:
            fail(f"world 1 under NCCL differs from phase 7's run in {len(diffs)} tensors, the first "
                 f"{diffs[:8]}")
        warm = lambda rows: sum(p[0] for p in rows[TRAIN_NET_BURNUP + 2:]) / len(rows[TRAIN_NET_BURNUP + 2:])
        print(f"ddp world 1 (NCCL, launch in this process): {TRAIN_NET_STEPS} steps, parameters and momentum "
              f"bit-equal to phase 7's run ({len(state['model'])} tensors, {len(state['momentum'])} momentum "
              f"buffers); steps {TRAIN_NET_BURNUP + 3}-{TRAIN_NET_STEPS}: {warm(per_step):.3f} ms/step CUDA events "
              f"with the process group, {warm(TRAIN_NET_RUN['per_step']):.3f} without (phase 7); on {smi}")

        # (ii) world 2 on one card under gloo; (iii) on two cards under NCCL
        runs = [("gloo, both ranks on cuda:0", "gloo", "w2")]
        if torch.cuda.device_count() >= 2:
            runs.append(("NCCL, cuda:0 and cuda:1", "nccl", "w2nccl"))
        else:
            print(f"ddp world 2 under NCCL across two cards: not run, this machine has "
                  f"{torch.cuda.device_count()} card (NCCL needs a card per rank)")
        torch.cuda.empty_cache()
        ranks = {}
        for label, backend, sub in runs:
            out, res = os.path.join(root, sub), os.path.join(root, sub + "_ranks")
            os.makedirs(res)
            t0 = time.perf_counter()
            launch(ddp_rank_run, DDP_WORLD, dist_url=f"tcp://127.0.0.1:{free_port()}", device="cuda",
                   backend=backend, args=(voc, out, res))
            wall = time.perf_counter() - t0
            ranks[sub] = [json.load(open(p)) for p in sorted(glob.glob(os.path.join(res, "rank*.json")))]
            rs = ranks[sub]
            if len(rs) != DDP_WORLD or any(r["world"] != DDP_WORLD for r in rs):
                fail(f"world 2 ({label}) wrote {len(rs)} rank results")
            if rs[0]["results"] != rs[1]["results"]:
                fail(f"the ranks of world 2 ({label}) returned different eval results")
            for r, x in enumerate(rs):
                steps = x["per_step"]
                print(x["lines"], end="")
                print(f"ddp world 2 ({label}) rank {r} on cuda:{x['device']}: {DDP_STEPS} steps of 4 rows, CUDA "
                      f"events {steps[0][0]:.3f} ms the first step, {steps[1][0]:.3f} ms the second (before "
                      f"burn-up), {steps[2][0]:.3f} ms the third (caption and KD on); two processes share the card: "
                      f"not a speedup; gradient all-reduce {x['allreduce_ms']:.3f} ms for {x['allreduce_bytes']} "
                      f"bytes ({x['trainable']} trainable values x 4); launches {x['launches']}")
            print(f"ddp world 2 ({label}): {wall:.1f} s wall for the launch (process start, build, 3 steps, the "
                  f"eval of {TRAIN_NET_IMAGES} images split over the ranks); eval results (random weights, not "
                  f"judged) AP50 {rs[0]['results'][VOC_NAMES[1]]['bbox']['AP50']:.4f}")
        launches = {k: sum(r["launches"][k] for r in ranks["w2"]) for k in ("roi_align_fwd", "roi_align_bwd", "nms")}
        if min(launches.values()) < 1:
            fail(f"world 2 did not go through every kernel: {launches}")
        eval_launches = [{k: r["launches"][k] - r["loop_launches"][k] for k in launches} for r in ranks["w2"]]
        if any(tuple(e.values()) != (2, 0, 4) for e in eval_launches):
            fail(f"world 2's eval launched K1/K3/K4 {eval_launches} per rank, expected 1/0/2 per batch of 2")

        # (ii) before burn-up: world 1 with ACCUM_STEPS 2, twice, against world 2's save after step 2
        cfg = voc_recipe_cfg(os.path.join(root, "w1a"), VOC_NAMES, *DDP_OPTS, "SOLVER.ACCUM_STEPS", "2",
                             "DATASETS.TEST", "()")
        trainer = DefaultTrainer(cfg, device="cuda")
        trainer.resume_or_load(resume=False)
        start = copy.deepcopy(trainer.state.state_dict())
        with build_detection_train_loader(cfg, seed=0, pin_memory=True) as loader:
            batches = [to_device(next(loader), dev) for _ in range(DDP_STEPS)]
        repeats = []
        for _ in range(2):
            trainer.state.load_state_dict(start)
            for b in batches[:DDP_BURNUP + 1]:
                trainer.run_step(b)
            repeats.append({k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()})
        saved = torch.load(os.path.join(root, "w2", "model_0000001.pth"), map_location="cpu", weights_only=True)
        gap = max(float((repeats[0][k].double() - repeats[1][k].double()).abs().max()) for k in repeats[0])
        got = max(float((saved["model"][k].double() - repeats[0][k].double()).abs().max()) for k in repeats[0])
        print(f"ddp world 2 before burn-up (2 steps) against world 1 with ACCUM_STEPS 2: max |parameter "
              f"difference| {got:.6g}; two repeats of that world-1 run differ by {gap:.6g}")
        if got > gap:
            fail(f"world 2 before burn-up is {got:.6g} from world 1 with ACCUM_STEPS 2, beyond its repeat gap {gap:.6g}")

        # (ii) past burn-up: world 2's step 3 against world 1 at the same weights and batch
        save_2 = os.path.join(root, "w2", "model_0000001.pth")
        trainer.checkpointer.load(save_2, trainer.state)
        trainer.generator.manual_seed(_iteration_seed(trainer._draw_seed, DDP_BURNUP + 1))
        losses = trainer.model.cddmsl_losses(batches[DDP_BURNUP + 1], generator_draw(trainer.generator), True, True,
                                             True)
        logged = json.loads(open(os.path.join(root, "w2", "metrics.json")).read().splitlines()[-1])
        for k in ("cont_loss", "kd_loss"):
            w1, w2 = float(losses[k]), logged[k]
            print(f"ddp step {DDP_STEPS} past burn-up: global {k} {w2:.6f} at world 2, {w1:.6f} at world 1 on the "
                  f"same weights and batch (rel. diff {abs(w2 - w1) / abs(w1):.3g}, rtol 2e-2)")
            if not math.isfinite(w2) or abs(w2 - w1) > 2e-2 * abs(w1):
                fail(f"world 2's global {k} {w2} is not world 1's {w1} within rtol 2e-2")
        # the step itself: world 2's model_final, and the planted fault's, against one world-1 step (ACCUM_STEPS 1:
        # the InfoNCE over all 8 rows) from that save on batch 3, twice
        checks = torch.load(os.path.join(root, "w2_ranks", "checks.pth"), weights_only=True)
        trainer.state.accum_steps = 1
        trainer.checkpointer.load(save_2, trainer.state)
        split = rel_l2(*(caption_projector_grad(trainer.model, batches[DDP_BURNUP + 1], n) for n in (DDP_WORLD, 1)))
        repeats = []
        for _ in range(2):
            trainer.checkpointer.load(save_2, trainer.state)
            trainer.run_step(batches[DDP_BURNUP + 1])
            repeats.append(host_state(trainer.state))
        names = split_parameters(trainer.model)[0]
        errs = {k: step_errors(v, repeats[0], saved_state(save_2), names, trainer.cfg.SOLVER.MOMENTUM) for k, v in (
            ("a repeat", repeats[1]), ("world 2", saved_state(os.path.join(root, "w2", "model_final.pth"))),
            ("the planted fault", checks["fault"]))}
        for k, e in errs.items():
            print(f"ddp step {DDP_STEPS} past burn-up, {k} against one world-1 step (ACCUM_STEPS 1) from world 2's save "
                  f"after step {DDP_BURNUP + 1}: |difference| / |world 1's step| (L2) parameters {e['parameters']:.6g}, "
                  f"momentum {e['momentum']:.6g} (tolerance {DDP_STEP_RTOL:g}); the projector's momentum (the caption "
                  f"InfoNCE's gradient alone, not judged) {e['projector']:.6g}")
        print(f"ddp step {DDP_STEPS}: on one process, the image-level caption InfoNCE's projector gradient with the "
              f"student's bf16 features computed 4 rows a call moves by {split:.6g} (L2, relative) from 8 rows a call")
        for k in ("a repeat", "world 2"):
            if max(errs[k]["parameters"], errs[k]["momentum"]) > DDP_STEP_RTOL:
                fail(f"{k}'s step {DDP_STEPS} is not world 1's within {DDP_STEP_RTOL:g}: {errs[k]}")

        # the gathered InfoNCE's gradient on the card in fp32, with the gather as it is and with the planted fault
        projector = copy.deepcopy(trainer.model.projector)
        projector.load_state_dict(checks["infonce"]["projector"])
        want = infonce_grads(projector)["grads"]
        got, fault = (rel_l2(checks[k]["grads"], want) for k in ("infonce", "infonce_fault"))
        print(f"ddp gathered InfoNCE (fp32, {'+'.join(map(str, INFONCE_ROWS))} rows, gloo on cuda:0): the projector's "
              f"gradient averaged over world 2 against one process on all rows, |difference| / |gradient| (L2) "
              f"{got:.6g}; with the planted fault (the gather's backward without its all-reduce) {fault:.6g}; "
              f"tolerance {INFONCE_RTOL:g}")
        if got > INFONCE_RTOL:
            fail(f"world 2's gathered InfoNCE gradient is {got:.6g} from one process's, beyond {INFONCE_RTOL:g}")
        if fault <= INFONCE_RTOL:
            fail(f"the planted fault passes the gathered InfoNCE check ({fault:.6g} <= {INFONCE_RTOL:g})")

        # K1, K3 and K4 at a rank's shapes: rank 0's rows of the first batch and of the first eval batch
        with build_detection_train_loader(cfg, seed=0, pin_memory=True, rank=0, world=DDP_WORLD) as loader:
            rank_batch = to_device(next(loader), dev)
        eval_loader, _ = build_detection_test_loader(cfg, VOC_NAMES[1], 8, pin_memory=True, rank=0, world=DDP_WORLD)
        with eval_loader:
            rank_eval = to_device(next(eval_loader)[0], dev)
        rows = step_kernel_rows(dev, trainer.model, rank_batch, trainer.state.draw, launches, roi_ops, nms_ops,
                                "ddp", {VOC_NAMES[1]: rank_eval})
        print(f"ddp path launches (world 2 under gloo, both ranks: 3 steps and the eval): {launches}")
        print(f"ddp phase: {time.perf_counter() - t_phase:.1f} s wall")
        return rows
    finally:
        for name in VOC_NAMES:
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


# phase 12: RegionCLIP pretraining on the recipe, 6 steps of 96 pairs from a
# corpus of 192; per step the student's and the teacher's pools (K1) and the
# student's backward (K3), no NMS (grid regions)
PRETRAIN_STEPS, PRETRAIN_PAIRS = 6, 192
PRETRAIN_LAUNCHES = (2, 1, 0)


def write_pretrain_corpus(root, n, seed):
    """`n` seeded image-caption pairs as the corpus's two TSV files: smooth
    random 320x240 JPEGs (base64) and captions of a few words, every third
    one a JSON dict of captions. Returns (image TSV, text TSV)."""
    import base64
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    adjectives = ("red", "small", "wooden", "old", "bright", "striped", "wet", "empty")
    nouns = ("dog", "car", "boat", "chair", "bird", "tree", "house", "bicycle", "bus", "sheep")
    places = ("street", "beach", "table", "field", "river", "road", "kitchen")
    img_tsv, txt_tsv = os.path.join(root, "images.tsv"), os.path.join(root, "texts.tsv")
    with open(img_tsv, "w") as fi, open(txt_tsv, "w") as ft:
        for i in range(n):
            small = Image.fromarray((rng.rand(6, 8, 3) * 255).astype(np.uint8))
            buf = io.BytesIO()
            small.resize((320, 240), Image.BILINEAR).save(buf, format="JPEG", quality=90)
            fi.write(f"pair{i}\t{base64.b64encode(buf.getvalue()).decode()}\n")
            caption = (f"a {adjectives[rng.randint(len(adjectives))]} {nouns[rng.randint(len(nouns))]} "
                       f"by the {places[rng.randint(len(places))]}")
            ft.write(f"pair{i}\t{json.dumps({'captions': [caption, 'unused']}) if i % 3 == 0 else caption}\n")
    return img_tsv, txt_tsv


def pretrain_path(dev, smi, roi_ops, nms_ops):
    """Region-language pretraining through `pretrain_net.main` on
    configs/pretrain/RegionCLIP_RN50.yaml at full width (CLIP-RN50 student
    and teacher, 4764 concepts, the 12-layer text tower, batch 96, bf16),
    cut to 6 steps: per step the launches (2/1/0), the host's loader time
    and CUDA events; the losses finite; the teacher, text tower and concept
    pool bit-equal and every trainable parameter moved; the save reloaded
    bit-equal; the step on a batch already on the card; K1 (both pools) and
    K3 at the step's shapes. Returns its rows {kernel: row}."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from cddmsl_torch import pretrain_net
    from cddmsl_torch.checkpoint.checkpointer import DetectionCheckpointer
    from cddmsl_torch.data.clip_datasets import CLIPImgTxtPairTSVDataset
    from cddmsl_torch.data.clip_tokenizer import tokenize
    from cddmsl_torch.engine.pretrain import grid_region_boxes, make_pretrain_step

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_pretrain_")
    build_state, loop = pretrain_net.build_state, pretrain_net.pretrain_loop
    probe = {}

    def probed_build_state(cfg, device):
        state = build_state(cfg, device)
        probe["initial"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        probe["marks"] = [(e, time.perf_counter(), read_launches(roi_ops, nms_ops), 0.0, None)]
        return state

    def on_step(it, metrics, loader_s):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        probe["marks"].append((e, time.perf_counter(), read_launches(roi_ops, nms_ops), loader_s, metrics))

    try:
        img_tsv, txt_tsv = write_pretrain_corpus(root, PRETRAIN_PAIRS, seed=0)
        out = os.path.join(root, "out")
        argv = ["--config-file", os.path.join(here, "configs", "pretrain", "RegionCLIP_RN50.yaml"),
                "--image-tsv", img_tsv, "--text-tsv", txt_tsv, "--device", "cuda",
                "OUTPUT_DIR", out, "SEED", "0", "SOLVER.MAX_ITER", str(PRETRAIN_STEPS)]
        cfg = pretrain_net.setup(pretrain_net.parser().parse_args(argv))
        print(f"pretrain: {os.path.basename(argv[1])} (CLIP-RN50 student and teacher, "
              f"{cfg.MODEL.CLIP.PRETRAIN_NUM_CONCEPTS} concepts, text tower {cfg.MODEL.CLIP.TEXT_LAYERS}x"
              f"{cfg.MODEL.CLIP.TEXT_WIDTH} over {cfg.MODEL.CLIP.TEXT_VOCAB_SIZE} tokens, batch "
              f"{cfg.SOLVER.IMS_PER_BATCH}, {cfg.TPU.COMPUTE_DTYPE}, seeded random weights) on a seeded corpus of "
              f"{PRETRAIN_PAIRS} 320x240 JPEG-caption pairs; cut to {PRETRAIN_STEPS} steps of the recipe's 600000")
        pretrain_net.build_state, pretrain_net.pretrain_loop = probed_build_state, (
            lambda *a, **k: loop(*a, on_step=on_step, **k))
        try:
            t0 = time.perf_counter()
            state, final = pretrain_net.main(argv)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
        finally:
            pretrain_net.build_state, pretrain_net.pretrain_loop = build_state, loop
        launches = read_launches(roi_ops, nms_ops)
        print(f"pretrain path launches ({PRETRAIN_STEPS} steps): {launches}")

        marks = probe["marks"]
        if len(marks) != PRETRAIN_STEPS + 1:
            fail(f"pretraining ran {len(marks) - 1} steps, expected {PRETRAIN_STEPS}")
        keys = ("roi_align_fwd", "roi_align_bwd", "nms")
        losses = []
        for i in range(1, len(marks)):
            (e0, h0, l0, _, _), (e1, h1, l1, loader_s, metrics) = marks[i - 1], marks[i]
            counts = tuple(l1[k] - l0[k] for k in keys)
            if counts != PRETRAIN_LAUNCHES:
                fail(f"pretrain step {i} launched K1/K3/K4 {counts}, expected {PRETRAIN_LAUNCHES}")
            step_losses = {k: v.item() for k, v in metrics.items()}
            losses.append(step_losses)
            print(f"pretrain step {i}: {e0.elapsed_time(e1):.3f} ms CUDA events, {(h1 - h0) * 1e3:.3f} ms host wall, "
                  f"{loader_s * 1e3:.3f} ms in the loader (decode, resize, normalise, tokenize, copy), "
                  f"K1/K3/K4 launches {counts}, losses {json.dumps(step_losses)}")
        if not all(np.isfinite(v) for step in losses for v in step.values()):
            fail(f"non-finite pretraining losses: {losses}")
        warm = marks[2:]
        mean_ms = sum(marks[i - 1][0].elapsed_time(marks[i][0]) for i in range(2, len(marks))) / len(warm)
        mean_loader = sum(m[3] for m in warm) / len(warm) * 1e3
        print(f"pretrain loop, steps 2-{PRETRAIN_STEPS}: {mean_ms:.3f} ms/step CUDA events, "
              f"{cfg.SOLVER.IMS_PER_BATCH / mean_ms * 1e3:.3f} images/s, {mean_loader:.3f} ms/step in the inline "
              f"loader; main() {main_s:.1f} s wall (build, {PRETRAIN_STEPS} steps, save); on {smi}")

        model = state.model
        initial = probe["initial"]
        params = dict(model.named_parameters())
        trainable = [n for n, p in params.items() if p.requires_grad]
        frozen = [n for n, p in params.items() if not p.requires_grad]
        towers = [n for n in frozen if n.startswith(("teacher_backbone.", "lang_encoder.")) or n == "concept_emb"]
        changed = [n for n in frozen if not torch.equal(params[n], initial[n])]
        unmoved = [n for n in trainable if torch.equal(params[n], initial[n])]
        if changed or unmoved or len(towers) < len(frozen) // 2:
            fail(f"after {PRETRAIN_STEPS} steps: frozen changed {changed[:5]}, trainable unmoved {unmoved[:5]}")
        print(f"after {PRETRAIN_STEPS} steps: all {len(trainable)} trainable parameters moved; all {len(frozen)} "
              f"frozen ones bit-equal ({len(towers)} of them the teacher, the text tower and the concept pool, "
              f"the rest the student's stem and layer1)")

        fresh = pretrain_net.build_state(cfg, dev)
        path = os.path.join(out, "pretrain_final.pth")
        DetectionCheckpointer(out).load(path, fresh)
        saved, got = state.state_dict(), fresh.state_dict()
        bad = [k for k, v in saved["model"].items() if not torch.equal(got["model"][k], v)]
        momentum = saved["optimizer"]["sgd"]["state"]
        bad += [f"momentum {i}" for i, m in momentum.items()
                if not torch.equal(got["optimizer"]["sgd"]["state"][i]["momentum_buffer"], m["momentum_buffer"])]
        if bad or not momentum or got["iteration"] != PRETRAIN_STEPS or got["optimizer"]["count"] != PRETRAIN_STEPS:
            fail(f"pretrain_final reloads differently: {bad[:5]}, iteration {got['iteration']}")
        print(f"pretrain save: pretrain_final.pth ({os.path.getsize(path) / 2**20:.1f} MiB) reloads bit-equal: "
              f"{len(saved['model'])} tensors, {len(momentum)} momentum buffers, iteration {got['iteration']}")
        del fresh, saved, got

        ds = CLIPImgTxtPairTSVDataset([img_tsv], [txt_tsv])
        images_u8, captions = next(ds.batches(cfg.SOLVER.IMS_PER_BATCH, image_size=224, seed=1))
        mean = np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32)
        std = np.asarray(cfg.MODEL.PIXEL_STD, np.float32)
        images = torch.from_numpy((images_u8.astype(np.float32) / 255.0 - mean) / std).to(dev)
        tokens = torch.from_numpy(tokenize(captions, context_length=model.text_context_length)).to(dev)
        grid = torch.from_numpy(grid_region_boxes(224, 3)).to(dev)
        boxes = grid.expand(images.shape[0], -1, -1)
        step = make_pretrain_step(state)
        for _ in range(2):
            step(images, boxes, tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = 3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            step(images, boxes, tokens)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        print(f"pretrain step on a batch already on the card ({tuple(images.shape)}, {grid.shape[0]} regions an "
              f"image): {ms:.3f} ms/step CUDA events, {(time.perf_counter() - t0) / reps * 1e3:.3f} ms/step host "
              f"wall, {images.shape[0] / ms * 1e3:.3f} images/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {smi}")

        with torch.no_grad():
            f_student = model.backbone(images.to(model.dtype))["res4"]
            f_teacher = model.teacher_backbone(images.to(model.dtype))["res4"]
        rows = {name: new_row(launches[name]) for name in ("roi_align_fwd", "roi_align_bwd")}
        add_roi_rows(rows, dev, roi_ops, "pretrain", [("student", *pool_args(f_student, boxes)),
                                                       ("teacher", *pool_args(f_teacher, boxes))], ["student"])
        print(f"pretrain phase: {time.perf_counter() - t_phase:.1f} s wall")
        return {name: close_row(row) for name, row in rows.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 13: the language tools. The card's concept embeddings are held
# against the CPU's fp32 on the first CONCEPT_CPU_CLASSES classes: float32
# (TF32 off) to 1e-4, bfloat16 (the tool's default) to 5e-3, on unit rows
# of 1024 (bf16 against fp32 on the CPU gave ~6e-4)
CONCEPT_CPU_CLASSES = 2
CONCEPT_FP32_TOL, CONCEPT_BF16_TOL = 1e-4, 5e-3
REGION_LAUNCHES = (1, 0, 1)


def language_tools_path(dev, smi, roi_ops, nms_ops):
    """`extract_concept_features` on VOC's 20 classes x 80 templates with a
    seeded full-width text tower written under lang_encoder. (the 'lang'
    keys), on the card in bf16 and fp32 against the CPU in fp32; its file
    loaded as MODEL.CLIP.TEXT_EMB_PATH into the full-width flagship for one
    inference; then `extract_region_features` on phase 7's fixture test
    set in batches of 8 (1/0/1 launches a batch, one .npz of (k, 1024)
    features an image). Returns its rows {kernel: row}: K1 and K4 at the
    first batch's shapes."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from cddmsl_torch import extract_concept_features as ecf
    from cddmsl_torch import extract_region_features as erf
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.checkpoint.convert_torch import load_text_emb_classifier
    from cddmsl_torch.config import get_cfg
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
    from cddmsl_torch.data.clip_tokenizer import pre_tokenize
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
    from cddmsl_torch.data.datasets.voc import CLASS_NAMES
    from cddmsl_torch.entry import entry
    from cddmsl_torch.models.backbone.text_encoder import CLIPTextEncoder

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_lang_")
    names = VOC_NAMES
    registered = False
    try:
        tower = CLIPTextEncoder(1024, 77, 49408, 512, 8, 12)
        init_random_(tower, torch.Generator().manual_seed(21))
        weights = os.path.join(root, "regionclip_lang.pth")
        torch.save({"model": {"lang_encoder." + k: v for k, v in tower.state_dict().items()}}, weights)
        fp32_yaml = os.path.join(root, "fp32.yaml")
        with open(fp32_yaml, "w") as f:
            f.write('TPU:\n  COMPUTE_DTYPE: "float32"\n')
        emb_path = os.path.join(root, "voc_20_cls_emb.pth")
        t0 = time.perf_counter()
        emb = ecf.main(["--weights", weights, "--out", emb_path])
        tool_s = time.perf_counter() - t0
        emb32 = ecf.main(["--config-file", fp32_yaml, "--weights", weights, "--out", os.path.join(root, "fp32.pth")])
        if emb.shape != (20, 1024) or not np.isfinite(emb).all():
            fail(f"concept embeddings of shape {emb.shape}, finite {np.isfinite(emb).all()}")

        cfg32 = get_cfg()
        cfg32.merge_from_file(fp32_yaml)
        tokens = pre_tokenize(CLASS_NAMES)
        cpu = ecf.build_encoder(cfg32, weights, torch.device("cpu"))
        t0 = time.perf_counter()
        want = ecf.encode_classes(cpu, tokens[:CONCEPT_CPU_CLASSES], torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        err32 = float(np.abs(emb32[:CONCEPT_CPU_CLASSES] - want).max())
        err16 = float(np.abs(emb[:CONCEPT_CPU_CLASSES] - want).max())
        if err32 > CONCEPT_FP32_TOL or err16 > CONCEPT_BF16_TOL:
            fail(f"concept embeddings on the card differ from the CPU's fp32: fp32 {err32}, bf16 {err16}")
        timed = {}
        for label, cfg_t in (("bfloat16", get_cfg()), ("float32", cfg32)):
            enc = ecf.build_encoder(cfg_t, weights, dev)
            ecf.encode_classes(enc, tokens, dev)
            t0 = time.perf_counter()
            for _ in range(3):
                ecf.encode_classes(enc, tokens, dev)
            timed[label] = (time.perf_counter() - t0) / 3 * 1e3
            del enc
        print(f"extract_concept_features: VOC's 20 classes x 80 templates through the 12-layer text tower of a "
              f"seeded lang_encoder. file: main() {tool_s:.2f} s wall (load, encode, save); encode "
              f"{timed['bfloat16']:.3f} ms for the 20 classes in bf16, {timed['float32']:.3f} ms in fp32 (host "
              f"wall, one copy back per class); against the CPU's fp32 on {CONCEPT_CPU_CLASSES} classes "
              f"({cpu_s:.1f} s there): fp32 max abs err {err32:.3g} (tol {CONCEPT_FP32_TOL}), bf16 {err16:.3g} "
              f"(tol {CONCEPT_BF16_TOL}); on {smi}")

        model, batch = entry("cuda")
        load_text_emb_classifier(model, emb_path)
        if not np.array_equal(model.roi_heads.box_predictor.cls_score.weight.detach().cpu().numpy(), emb):
            fail("MODEL.CLIP.TEXT_EMB_PATH did not load the written embeddings")
        dets = model.inference(batch)
        torch.cuda.synchronize()
        if not (torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()):
            fail("non-finite detections with the written text embeddings")
        print(f"the written file as MODEL.CLIP.TEXT_EMB_PATH: the flagship's 20 classifier rows bit-equal to it, "
              f"one inference on {tuple(batch.image.shape)}: {int(dets.valid.sum())} valid detections, finite")
        del model, batch, dets

        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_voc_fixture(voc, names)
        registered = True
        calls = []
        region_features = erf.region_features

        def probed(model, batch):
            l0, t0 = read_launches(roi_ops, nms_ops), time.perf_counter()
            result = region_features(model, batch)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0, l0, read_launches(roi_ops, nms_ops),
                          (model, batch) if not calls else None))
            return result

        feats_dir = os.path.join(root, "region_feats")
        argv = ["--config-file", os.path.join(here, "configs", "VOC-Experiments", "faster_rcnn_CLIP_R_50_C4.yaml"),
                "--dataset", names[1], "--out", feats_dir, "OUTPUT_DIR", os.path.join(root, "out"), "SEED", "0",
                "MODEL.PRE_TRAINED_RCLIP_PATH", "", "MODEL.VISION_TO_LANG_PATH", "",
                "MODEL.CLIP.TEXT_EMB_PATH", emb_path]
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        erf.region_features = probed
        try:
            t0 = time.perf_counter()
            seen = erf.main(argv)
            main_s = time.perf_counter() - t0
        finally:
            erf.region_features = region_features
        launches = read_launches(roi_ops, nms_ops)
        keys = ("roi_align_fwd", "roi_align_bwd", "nms")
        for i, (_, l0, l1, _) in enumerate(calls):
            counts = tuple(l1[k] - l0[k] for k in keys)
            if counts != REGION_LAUNCHES:
                fail(f"region-feature batch {i + 1} launched K1/K3/K4 {counts}, expected {REGION_LAUNCHES}")
        files = sorted(os.listdir(feats_dir))
        n_images = len(DatasetCatalog.get(names[1]))
        if not calls or seen != n_images or len(files) != n_images:
            fail(f"region features: {seen} images written, {len(files)} files, {n_images} in the set")
        ks = []
        for name in files:
            saved = np.load(os.path.join(feats_dir, name))
            k = saved["boxes"].shape[0]
            if (k < 1 or saved["boxes"].shape != (k, 4) or saved["features"].shape != (k, 1024)
                    or not np.isfinite(saved["features"]).all()):
                fail(f"{name}: boxes {saved['boxes'].shape}, features {saved['features'].shape}")
            ks.append(k)
        batch_s = sum(c[0] for c in calls)
        batch_size = calls[0][3][1].image.shape[0]
        print(f"extract_region_features on the fixture's test set ({n_images} images, {len(calls)} batches of "
              f"{batch_size}, "
              f"bf16): launches {launches}, K1/K3/K4 {REGION_LAUNCHES} per batch; one .npz per image, (k, 1024) "
              f"features for k in {min(ks)}-{max(ks)}; {batch_s * 1e3 / n_images:.3f} ms/image in the batches "
              f"(host wall, synchronised), main() {main_s:.1f} s wall (build, load, loader, save); on {smi}")

        model, batch = calls[0][3]
        rpn = model.proposal_generator
        with torch.no_grad():
            features = model.backbone(model._normalize(batch.image))["res4"]
            head = rpn._head(features)
            rpn_call = (*rpn._nms_inputs(*head, batch.image_sizes, False), rpn.nms_thresh, rpn.post_nms_topk[False])
            proposals = rpn._predict_proposals(*head, batch.image_sizes, False)
        rows = {"roi_align_fwd": new_row(launches["roi_align_fwd"])}
        add_roi_rows(rows, dev, roi_ops, "region_features", [("rpn_proposals", *pool_args(features, proposals.boxes))],
                     [])
        rows = {"roi_align_fwd": close_row(rows["roi_align_fwd"]),
                "nms": nms_row(nms_ops, "region_features", launches["nms"], [rpn_call])}
        print(f"language_tools phase: {time.perf_counter() - t_phase:.1f} s wall")
        return rows
    finally:
        if registered:
            for name in names:
                DatasetCatalog.remove(name)
                MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


# phase 14: the plain R50-C4 baseline, 12 steps of 8 images
PLAIN_STEPS = 12
PLAIN_NAMES = ("chip_smoke_plain_train", "chip_smoke_plain_test")
GOLDEN = "rcnn_training_acc_test.yaml"
# the seed of the detection candidates' scores that phase 14's soft-NMS
# check and its detection K4 row share (`seeded_candidates`)
PLAIN_CANDIDATES_SEED = 14


def supervised_roi_align_calls(model, batch, draw):
    """The one RoIAlign call of a supervised step (the plain tower's step),
    rebuilt outside autograd: the pool of the B x batch_size_per_image
    sampled ROIs on the res4 map."""
    rpn, rh = model.proposal_generator, model.roi_heads
    features = model.extract_res4(batch.image)
    proposals = rpn._predict_proposals(*rpn._head(features), batch.image_sizes, True)
    sampled = rh.label_and_sample_proposals(proposals, batch.gt_boxes, batch.gt_classes, batch.gt_valid, draw)[0]
    return [("supervised", *pool_args(features, sampled))]


def soft_nms_bound_ms(b, n, max_out):
    """(bound ms, bound_by) of the class-aware soft-NMS of b images of n
    candidates keeping max_out. Bytes: the boxes (16), scores (4), classes
    (4) and validity (1) read once, the kept indices (8), scores (4) and
    validity (1) written once. Operations: per image, each of the max_out
    rounds takes one row of the (n, n) IoU block: the argmax over the n
    scores (1 flop a candidate), the chosen box's IoU with each (14) and
    its decay (4: square, scale, exp, multiply)."""
    bytes_ = b * n * (16 + 4 + 4 + 1) + b * max_out * (8 + 4 + 1)
    ops = b * max_out * n * (1 + 14 + 4)
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, ops / H100_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


@torch.no_grad()
def soft_nms_on_card_and_cpu(model, batch, label, smi):
    """The class-aware soft-NMS of `model` (SOFT_NMS_ENABLED) on the
    candidates of one eval batch (their boxes and classes, with
    `seeded_candidates` at PLAIN_CANDIDATES_SEED, as phase 14's detection
    K4 row has them), on the card against the same call on the CPU: the
    kept indices and validity exactly, the decayed scores to 1e-6; its time
    on the card beside the CPU's. Plain PyTorch, not a kernel."""
    from cddmsl_torch.models.fast_rcnn import detection_candidates
    from cddmsl_torch.ops.soft_nms import batched_soft_nms

    rh = model.roi_heads
    features, proposals = model.proposals(batch)
    b, s = proposals.boxes.shape[:2]
    scores, deltas = rh.box_predictor(rh._region_embed(features, proposals.boxes, model.backbone.res5_forward,
                                                       model._box_pool))
    boxes, det_scores, classes, valid = detection_candidates(
        scores.reshape(b, s, -1), deltas.reshape(b, s, -1), proposals.boxes, proposals.valid, batch.image_sizes,
        rh.box2box, rh.num_classes, rh.score_thresh_test)
    det_scores, valid = seeded_candidates(det_scores, valid, PLAIN_CANDIDATES_SEED)
    method, sigma, prune = rh.soft_nms

    def call(b, s, c, v):
        return batched_soft_nms(b, s, c, method, sigma, rh.nms_thresh_test, prune, rh.detections_per_image, v)

    got = call(boxes, det_scores, classes, valid)
    cpu_args = [t.cpu() for t in (boxes, det_scores, classes, valid)]
    t0 = time.perf_counter()
    want = call(*cpu_args)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])):
        fail(f"soft-NMS {label}: the card keeps other boxes than the CPU")
    err = float((got[1].cpu() - want[1]).abs().max())
    if err > 1e-6:
        fail(f"soft-NMS {label}: decayed scores {err} from the CPU's (tol 1e-6)")
    ms = cuda_ms(lambda: call(boxes, det_scores, classes, valid), 5)
    bound, by = soft_nms_bound_ms(b, boxes.shape[1], rh.detections_per_image)
    print(f"soft-NMS {label} ({method}, sigma {sigma}, linear threshold {rh.nms_thresh_test}, prune {prune}) on "
          f"{b}x{boxes.shape[1]} candidates -> {rh.detections_per_image}: kept {got[2].sum(1).tolist()}, equal to "
          f"the CPU's (scores max abs err {err:.3g}, tol 1e-6); {ms:.4f} ms on the card (plain PyTorch, "
          f"{rh.detections_per_image} selection rounds), bound {bound:.5f} ms ({by}), {cpu_ms:.4f} ms on the host "
          f"CPU; on {smi}")


def plain_r50_path(dev, smi, roi_ops, nms_ops):
    """Phase 14: the plain R50-C4 baseline (VOC-Experiments/
    faster_rcnn_R_50_C4.yaml: the detectron2 ResNet-50 C4 with the linear
    classifier, batch 8 at the recipe's 800x1344 pad, bf16, seeded random
    weights: the ImageNet R-50 is not in the repository) through
    `DefaultTrainer.train()` on phase 7's fixture: 12 steps, K1/K3/K4 1/1/1
    a step, every loss finite, the FrozenBN statistics unchanged bit for
    bit; the final test (1/0/2 a batch); the step on a batch on the card;
    one eval batch with the class-specific boxes (1/0/2) and one with
    CLS_AGNOSTIC_BBOX_REG and soft-NMS (1/0/1) and the soft-NMS on the card
    against the CPU; K1, K3 and K4 at the path's shapes. Then
    rcnn_training_acc_test.yaml (the linear head on the tiny CLIP tower,
    fp32, TF32 off) through `train_net.main` on the card, its AP50 printed
    beside the golden and not judged (the port's own init and draws).
    Returns the path's rows {kernel: row}."""
    import os
    import shutil
    import tempfile

    from cddmsl_torch import train_net
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import get_cfg, model_config_from_cfg
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader, to_device
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc, register_synthetic_quick
    from cddmsl_torch.data.datasets.voc import register_pascal_voc
    from cddmsl_torch.engine.defaults import DefaultTrainer, default_argument_parser
    from cddmsl_torch.models.build import build_model

    class ProbedTrainer(DefaultTrainer):
        def build_hooks(self):
            self.probe = StepProbe(roi_ops, nms_ops)
            return [self.probe] + super().build_hooks()

        def run_step(self, batch):
            metrics = super().run_step(batch)
            self.step_losses.append({k: v.detach() for k, v in metrics.items() if k.startswith("loss")})
            return metrics

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_plain_")
    names = PLAIN_NAMES
    quick = ("synthetic_voc_trainval", "synthetic_voc_trainval_plain", "synthetic_voc_test")
    try:
        voc = make_synthetic_voc(os.path.join(root, "datasets"), n=TRAIN_NET_IMAGES, seed=0)
        register_pascal_voc(names[0], voc, "trainval", 2007)
        register_pascal_voc(names[1], voc, "test", 2007)
        def plain_cfg(*opts):
            cfg = get_cfg()
            cfg.merge_from_file(os.path.join(here, "configs", "VOC-Experiments", "faster_rcnn_R_50_C4.yaml"))
            cfg.merge_from_list(["OUTPUT_DIR", os.path.join(root, "out"), "SEED", "0", "DATASETS.TRAIN",
                                 repr((names[0],)), "DATASETS.TEST", repr((names[1],)), "SOLVER.MAX_ITER",
                                 str(PLAIN_STEPS), "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", *opts])
            cfg.freeze()
            return cfg

        cfg = plain_cfg()
        config = model_config_from_cfg(cfg)
        print(f"plain_r50: {os.path.join('configs', 'VOC-Experiments', 'faster_rcnn_R_50_C4.yaml')} "
              f"({config.backbone_type} depth {config.backbone_depth}, linear classifier, {cfg.SOLVER.IMS_PER_BATCH} "
              f"images a step padded to {tuple(cfg.TPU.PAD_SIZE_TRAIN)}, {cfg.TPU.COMPUTE_DTYPE}, FREEZE_AT "
              f"{cfg.MODEL.BACKBONE.FREEZE_AT}) on the synthetic VOC fixture ({TRAIN_NET_IMAGES} images); the "
              "ImageNet R-50 is not in the repository, so every weight is seeded random")

        trainer = ProbedTrainer(cfg, device="cuda")
        trainer.step_losses = []
        trainer.resume_or_load(resume=False)
        model = trainer.model
        buffers = {n: (b, b.clone()) for n, b in model.named_buffers()}
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        results = trainer.train()
        torch.cuda.synchronize()
        launches = read_launches(roi_ops, nms_ops)
        print(f"plain_r50 path launches ({PLAIN_STEPS} steps and the final test): {launches}")
        if min(launches.values()) < 1:
            fail(f"the plain_r50 path did not go through every kernel: {launches}")
        probe = trainer.probe
        waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
        per_step = loop_steps("plain_r50", probe, waits, PLAIN_STEPS, PLAIN_STEPS, ((1, 1, 1), (1, 1, 1)))
        losses = [{k: v.item() for k, v in step.items()} for step in trainer.step_losses]
        if len(losses) != PLAIN_STEPS or not all(math.isfinite(v) for step in losses for v in step.values()):
            fail(f"plain_r50: non-finite losses {losses}")
        for i in (0, PLAIN_STEPS - 1):
            print(f"plain_r50 step {i + 1} losses: {json.dumps({k: round(v, 6) for k, v in losses[i].items()})}")
        changed = [n for n, (b, b0) in buffers.items() if not torch.equal(b, b0)]
        if changed:
            fail(f"plain_r50: FrozenBN statistics changed: {changed[:5]}")
        print(f"plain_r50: all {len(buffers)} FrozenBN statistics bit-equal after {PLAIN_STEPS} steps; "
              f"{len(frozen)} frozen parameters (FREEZE_AT {cfg.MODEL.BACKBONE.FREEZE_AT} names the CLIP tower's "
              f"stages, as in JAX), {sum(p.requires_grad for p in model.parameters())} trainable, the linear "
              f"cls_score among them")
        warm = per_step[2:]
        mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
        print(f"plain_r50 loop, steps 3-{PLAIN_STEPS}: {mean([p[0] for p in warm]):.3f} ms/step CUDA events, "
              f"{mean([p[1] for p in warm]):.3f} ms/step host wall, {mean([p[2] for p in warm]):.3f} ms/step waiting "
              f"on the loader; whole loop {probe.loop_s * 1e3 / PLAIN_STEPS:.3f} ms/step host wall; on {smi}")
        keys = ("roi_align_fwd", "roi_align_bwd", "nms")
        n_test_batches = -(-TRAIN_NET_IMAGES // cfg.MODEL.CLIP.IMS_PER_BATCH_TEST)
        per_batch = tuple((launches[k] - probe.loop_launches[k]) / n_test_batches for k in keys)
        if per_batch != (1, 0, 2):
            fail(f"the plain_r50 final test launched K1/K3/K4 {per_batch} per batch, expected (1, 0, 2)")
        ap = {k: round(v, 4) for k, v in results[names[1]]["bbox"].items() if k in ("AP", "AP50", "AP75")}
        print(f"plain_r50 final test: launches per batch K1/K3/K4 {per_batch}; AP (random weights, not judged) "
              f"{json.dumps(ap)}")

        with build_detection_train_loader(cfg, seed=0, pin_memory=True) as train_loader:
            batch = to_device(next(train_loader), dev)
        time_device_batch("plain_r50", trainer, batch, what="supervised")

        eval_batch = first_eval_batch(cfg, names[1], dev)
        soft_cfg = plain_cfg("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", "True",
                             "MODEL.ROI_HEADS.SOFT_NMS_ENABLED", "True")
        soft = init_random_(build_model(model_config_from_cfg(soft_cfg), device="cpu"),
                            torch.Generator().manual_seed(1))
        trained, own = model.state_dict(), soft.state_dict()
        # the trained weights; bbox_pred, 4 wide now, stays seeded random
        soft.load_state_dict({k: trained[k] if trained[k].shape == v.shape else v for k, v in own.items()})
        soft = soft.to(dev).eval()
        for label, m, want in (("class-specific boxes, NMS", model, (1, 0, 2)),
                               ("class-agnostic boxes, soft-NMS", soft, (1, 0, 1))):
            torch.cuda.synchronize()
            reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
            det = m.inference(eval_batch)
            torch.cuda.synchronize()
            got = tuple(read_launches(roi_ops, nms_ops)[k] for k in keys)
            if got != want or not bool(torch.isfinite(det.scores).all()):
                fail(f"plain_r50 eval batch ({label}): launches {got}, expected {want}")
            ms = cuda_ms(lambda: m.inference(eval_batch), 3, warmup=1)
            print(f"plain_r50 eval batch {tuple(eval_batch.image.shape)} ({label}): K1/K3/K4 {got}, "
                  f"{ms / eval_batch.image.shape[0]:.3f} ms/image, {det.valid.sum(1).tolist()} detections an image")
        soft_nms_on_card_and_cpu(soft, eval_batch, "plain_r50 eval", smi)
        rows = step_kernel_rows(dev, model, batch, trainer.state.draw, launches, roi_ops, nms_ops, "plain_r50",
                                {names[1]: eval_batch}, roi_calls=supervised_roi_align_calls,
                                candidates_seed=PLAIN_CANDIDATES_SEED)
        del trainer, model, soft

        # the linear CLIP head's golden schedule, at its tiny width on the card
        register_synthetic_quick(os.path.join(root, "quick"))
        args = default_argument_parser().parse_args([
            "--config-file", os.path.join(here, "configs", "quick_schedules", GOLDEN),
            "OUTPUT_DIR", os.path.join(root, "golden"), "TEST.EXPECTED_RESULTS", "[]"])
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        t0 = time.perf_counter()
        with torch.enable_grad():
            golden = train_net.main(args)["synthetic_voc_test"]["bbox"]
        torch.cuda.synchronize()
        print(f"plain_r50: {GOLDEN} (linear head, tiny CLIP tower, fp32, TF32 off) through train_net on the card: "
              f"AP50 {golden['AP50']:.4f} beside the golden 7.211 +/- 0.1 (not judged: the port's own init and "
              f"draws; the CPU tests hold the golden from JAX's), AP {golden['AP']:.4f}, "
              f"{time.perf_counter() - t0:.1f} s, launches {read_launches(roi_ops, nms_ops)}")
        print(f"plain_r50 phase: {time.perf_counter() - t_phase:.1f} s wall")
        return rows
    finally:
        for name in names + quick:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
                MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


# phase 15: RegionCLIP's open-vocabulary detector. (a) zero-shot inference
# of the LVIS recipe over 8 LVIS-format images, (b) the OVD recipe's loss on
# a device batch, 5 steps timed after 3, (c) the open-set head of the VOC
# recipe through `train_net --eval-only` on the same images
OVD_IMAGES, OVD_HW = 8, (600, 1000)
OVD_STEPS, OVD_WARMUP = 5, 3
LVIS_CLASSES = 1203
# the seed of the detection candidates' scores where the eval batch leaves
# the detection NMS none (`seeded_candidates`)
OVD_CANDIDATES_SEED = 15
OVD_CONFIGS = ("LVISv1-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_zsinf.yaml",
               "COCO-InstanceSegmentation/CLIP_fast_rcnn_R_50_C4_ovd.yaml")


def write_lvis_fixture(root, n, seed):
    """An LVIS v1 val set at `root` as $DETECTRON2_DATASETS lays it out:
    lvis/lvis_v1_val.json (1203 categories with image counts over the rare,
    common and frequent buckets; per image a few boxes, negative and
    not-exhaustive ids; images named by coco_url) and n seeded JPEGs of
    OVD_HW under coco/val2017. Returns the json's path."""
    import os

    import numpy as np
    from PIL import Image

    r = np.random.RandomState(seed)
    h, w = OVD_HW
    os.makedirs(os.path.join(root, "coco", "val2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "lvis"), exist_ok=True)
    cats = [{"id": c + 1, "name": f"lvis_class_{c}", "image_count": int(r.choice([5, 50, 500]))}
            for c in range(LVIS_CLASSES)]
    images, annos = [], []
    for i in range(n):
        image_id = 1 + i
        name = f"{image_id:012d}.jpg"
        Image.fromarray((r.rand(h, w, 3) * 255).astype(np.uint8)).save(os.path.join(root, "coco", "val2017", name))
        pos = [int(c) for c in r.choice(LVIS_CLASSES, 3, replace=False) + 1]
        images.append({"id": image_id, "height": h, "width": w, "coco_url": f"http://images.cocodataset.org/val2017/{name}",
                       "neg_category_ids": [int(c) for c in r.choice(LVIS_CLASSES, 5) + 1],
                       "not_exhaustive_category_ids": pos[:1]})
        for k in range(int(r.randint(2, 6))):
            bw, bh = 40 + r.rand() * 400, 40 + r.rand() * 300
            x, y = r.rand() * (w - bw), r.rand() * (h - bh)
            annos.append({"id": len(annos) + 1, "image_id": image_id, "category_id": pos[k % 3], "area": bw * bh,
                          "bbox": [x, y, bw, bh]})
    path = os.path.join(root, "lvis", "lvis_v1_val.json")
    with open(path, "w") as f:
        json.dump({"categories": cats, "images": images, "annotations": annos}, f)
    return path


def write_bb_rpn_file(path, seed):
    """MODEL.CLIP.BB_RPN_WEIGHTS: a seeded plain ResNet-50 tower and RPN head
    (`init_random_`) under detectron2's names (backbone.stem.*,
    backbone.res{s}.*, proposal_generator.rpn_head.*) in a detectron2-style
    file. The stem's kernel is divided by 58, the pixels' standard
    deviation in 0..255 units: the offline tower takes BGR minus the means
    unscaled (PIXEL_STD 1, as detectron2's R-50 does), and a He-normal stem
    on those inputs sends every proposal off the image. Returns its
    tensors."""
    from torch import nn

    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.models.backbone.resnet import D2ResNet
    from cddmsl_torch.models.rpn import StandardRPNHead

    holder = nn.Module()
    holder.backbone = D2ResNet(50)
    holder.proposal_generator = nn.Module()
    holder.proposal_generator.rpn_head = StandardRPNHead(1024, 15)
    sd = init_random_(holder, torch.Generator().manual_seed(seed)).state_dict()
    sd["backbone.stem.conv1.weight"] /= 58.0
    torch.save({"model": sd, "iteration": 0}, path)
    return sd


def ovd_model(cfg_file, dev, bb_path, emb_path, seed, *opts):
    """`build_clip_fast_rcnn` of a CLIP_fast_rcnn config on the card: seeded
    random weights, then the offline tower and RPN from `bb_path` and, with
    `emb_path`, the classifier rows. Returns (cfg, model)."""
    import os

    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.checkpoint.convert_torch import load_bb_rpn_weights, load_text_emb_classifier
    from cddmsl_torch.config import get_cfg
    from cddmsl_torch.models.build import build_clip_fast_rcnn

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", cfg_file))
    cfg.merge_from_list(["MODEL.CLIP.BB_RPN_WEIGHTS", bb_path, *opts])
    cfg.freeze()
    model = init_random_(build_clip_fast_rcnn(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    n = load_bb_rpn_weights(model, cfg.MODEL.CLIP.BB_RPN_WEIGHTS)
    if emb_path:
        load_text_emb_classifier(model, emb_path)
    return cfg, model.to(dev).eval(), n


def offline_state(model):
    """The offline tower, the offline RPN and the classifier rows, cloned."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith(("offline_", "roi_heads.box_predictor.cls_score."))}


@torch.no_grad()
def ovd_training_calls(model, batch, draw):
    """The kernel calls of one CLIPFastRCNN `supervised_losses` step,
    rebuilt outside autograd on the model's device: K1's and K3's
    ("train_pool", features, batch_idx, boxes), the B x 512 sampled ROIs on
    the CLIP tower's res4 map, and K4's (boxes, scores, valid, threshold,
    max_out), the offline RPN's NMS at the training top-k."""
    rpn = model.offline_proposal_generator
    x = model._norm(batch.image, model.offline_pixel_mean, model.offline_pixel_std, model.offline_input_bgr)
    head = rpn._head(model.offline_backbone(x)["res4"])
    rpn_call = (*rpn._nms_inputs(*head, batch.image_sizes, True), rpn.nms_thresh, rpn.post_nms_topk[True])
    proposals = rpn._predict_proposals(*head, batch.image_sizes, True)
    sampled = model.roi_heads.label_and_sample_proposals(proposals, batch.gt_boxes, batch.gt_classes,
                                                         batch.gt_valid, draw)[0]
    return ("train_pool", *pool_args(model._features(batch), sampled)), rpn_call


def ovd_path(dev, smi, roi_ops, nms_ops):
    """Phase 15: RegionCLIP's open-vocabulary detector at full width (bf16,
    batch 8 at the 800x1344 pad, seeded random weights: RegionCLIP's
    checkpoint, rpn_lvis_866.pth and the concept embeddings are not in the
    repository). (a) LVIS zero-shot inference (CLIP_fast_rcnn_R_50_C4_zsinf:
    1203 classes, NO_BOX_DELTA, the offline RPN's NMS at 0.9) with
    BB_RPN_WEIGHTS a seeded detectron2 file through `load_bb_rpn_weights`
    and seeded text rows, over 8 LVIS-format images through the test loader,
    `model.inference` and `LVISEvaluator` (K1/K3/K4 1/0/2 a batch), the
    offline modules and the text rows bit-equal after; (b) the OVD recipe's
    `supervised_losses` (48 classes, focal 0.5, background 0.2) forward and
    backward on a device batch, 5 steps timed after 3: finite losses,
    1/1/1 a step, no gradient on the offline modules; (c) the VOC recipe's
    open-set head (class-agnostic boxes, MULTIPLY_RPN_SCORE, 1203 open-set
    classes from a seeded file) through `train_net.main --eval-only` on
    lvis_v1_val over the same images ($DETECTRON2_DATASETS), 1/0/2 a batch.
    Then K1, K3 and K4 at the path's shapes. Returns its rows."""
    import os
    import shutil
    import tempfile

    from cddmsl_torch import train_net
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, to_device
    from cddmsl_torch.data.datasets import builtin
    from cddmsl_torch.engine.defaults import build_evaluator, default_argument_parser
    from cddmsl_torch.entry import synthetic_batch
    from cddmsl_torch.evaluation import inference_on_dataset
    from cddmsl_torch.models.sampling import generator_draw

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cddmsl_ovd_")
    env = os.environ.get("DETECTRON2_DATASETS")
    keys = ("roi_align_fwd", "roi_align_bwd", "nms")
    try:
        write_lvis_fixture(root, OVD_IMAGES, seed=15)
        # the builtin names again, at the fixture's root
        for name in DatasetCatalog.list():
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
        builtin._REGISTERED = False
        os.environ["DETECTRON2_DATASETS"] = root
        builtin.register_all()
        bb_path, emb_path = os.path.join(root, "bb_rpn.pth"), os.path.join(root, "lvis_emb.pth")
        bb_sd = write_bb_rpn_file(bb_path, seed=151)
        torch.save(torch.randn((LVIS_CLASSES, 1024), generator=torch.Generator().manual_seed(152)), emb_path)

        # (a) zero-shot inference
        cfg, model, n_loaded = ovd_model(OVD_CONFIGS[0], dev, bb_path, emb_path, 150, "OUTPUT_DIR",
                                         os.path.join(root, "zsinf"))
        state = model.state_dict()
        res5 = [k for k in bb_sd if k.startswith("backbone.res5.")]
        for k, v in bb_sd.items():  # backbone.* -> offline_backbone.*, proposal_generator.* -> offline_...
            if k not in res5 and not torch.equal(state["offline_" + k].cpu(), v):
                fail(f"ovd: offline_{k} is not the BB_RPN_WEIGHTS file's {k}")
        if n_loaded != len(bb_sd) - len(res5):
            fail(f"ovd: load_bb_rpn_weights loaded {n_loaded} tensors, expected {len(bb_sd) - len(res5)}")
        print(f"ovd (a): {OVD_CONFIGS[0]} through build_clip_fast_rcnn ({model.num_classes} classes, NO_BOX_DELTA "
              f"{model.roi_heads.no_box_delta}, offline RPN NMS {model.offline_rpn_nms_thresh}, {model.dtype}); "
              f"BB_RPN_WEIGHTS: {n_loaded} tensors bit-equal to the file (its {len(res5)} res5 tensors have no home: "
              "the offline tower ends at res4), the 1203x1024 text rows from a seeded file")
        frozen = offline_state(model)
        name = "lvis_v1_val"
        evaluator_type = MetadataCatalog.get(name).evaluator_type
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        t0 = time.perf_counter()
        loader, n = build_detection_test_loader(cfg, name, pin_memory=True)
        with loader:
            evaluator = build_evaluator(cfg, name)
            results = inference_on_dataset(model, loader, n, evaluator, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_a = read_launches(roi_ops, nms_ops)
        n_batches = -(-n // cfg.MODEL.CLIP.IMS_PER_BATCH_TEST)
        per_batch = tuple(launches_a[k] / n_batches for k in keys)
        if per_batch != (1, 0, 2) or type(evaluator).__name__ != "LVISEvaluator" or evaluator_type != "lvis":
            fail(f"ovd (a): launches per batch {per_batch} (expected (1, 0, 2)), evaluator {type(evaluator).__name__}")
        eval_batch = first_eval_batch(cfg, name, dev)
        det = model.inference(eval_batch)
        if not bool(torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()) or det.boxes.shape != (
                OVD_IMAGES, cfg.TEST.DETECTIONS_PER_IMAGE, 4):
            fail(f"ovd (a): detections of shape {tuple(det.boxes.shape)} or not finite")
        ms = cuda_ms(lambda: model.inference(eval_batch), 3, warmup=1)
        after = offline_state(model)
        changed = [k for k in frozen if not torch.equal(frozen[k], after[k])]
        if changed:
            fail(f"ovd (a): the offline modules or the text rows changed: {changed[:5]}")
        ap = {k: round(v, 4) for k, v in results["bbox"].items()}
        print(f"ovd (a) zero-shot inference on {name} ({n} images of {OVD_HW}, batch {tuple(eval_batch.image.shape)}): "
              f"{ms / OVD_IMAGES:.3f} ms/image CUDA events ({wall * 1e3 / n:.3f} ms/image host wall through the "
              f"loader, inference_on_dataset and LVISEvaluator), {det.valid.sum(1).tolist()} detections an image; "
              f"K1/K3/K4 {per_batch} a batch; the {len(frozen)} offline and text tensors bit-equal after; LVIS AP "
              f"(random weights, not judged) {json.dumps(ap)}; on {smi}")
        zs_pool, zs_calls = eval_kernel_calls(model, eval_batch)
        seeded = not bool(zs_calls[1][2].any())
        if seeded:
            zs_pool, zs_calls = eval_kernel_calls(model, eval_batch, OVD_CANDIDATES_SEED)
        print(f"ovd (a): the detection NMS of the eval batch has {int(zs_calls[1][2].sum())} candidates"
              + (f" (seeded: the model's own were none; seed {OVD_CANDIDATES_SEED})" if seeded else ""))
        del model

        # (b) the OVD training loss on a device batch
        cfg_b, model, _ = ovd_model(OVD_CONFIGS[1], dev, bb_path, "", 160)
        batch = synthetic_batch(8, 800, 1344, g=8, seed=16, with_trgt=False, device=dev)
        gen = torch.Generator(device=dev)
        frozen = offline_state(model)
        trainable = [p for p in model.parameters() if p.requires_grad]
        offline = [(n_, p) for n_, p in model.named_parameters() if n_.startswith("offline_")]

        def step():
            for p in trainable:
                p.grad = None
            with torch.enable_grad():
                losses = model.supervised_losses(batch, generator_draw(gen))
                sum(losses.values()).backward()
            return losses

        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        gen.manual_seed(0)
        losses = {k: v.item() for k, v in step().items()}
        torch.cuda.synchronize()
        launches_b = read_launches(roi_ops, nms_ops)
        if tuple(launches_b[k] for k in keys) != (1, 1, 1):
            fail(f"ovd (b): a step launched K1/K3/K4 {launches_b}, expected 1/1/1")
        if set(losses) != {"loss_cls", "loss_box_reg"} or not all(math.isfinite(v) for v in losses.values()):
            fail(f"ovd (b): losses {losses}")
        if any(p.requires_grad or p.grad is not None for _, p in offline) or not all(
                p.grad is not None for p in trainable):
            fail("ovd (b): a gradient reached an offline module, or a trainable parameter got none")
        for _ in range(OVD_WARMUP):
            step()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(OVD_STEPS):
            step()
        end.record()
        torch.cuda.synchronize()
        launches_b = read_launches(roi_ops, nms_ops)
        steps = 1 + OVD_WARMUP + OVD_STEPS
        if tuple(launches_b[k] for k in keys) != (steps, steps, steps):
            fail(f"ovd (b): {steps} steps launched K1/K3/K4 {launches_b}")
        after = offline_state(model)
        if any(not torch.equal(frozen[k], after[k]) for k in frozen):
            fail("ovd (b): an offline tensor changed")
        print(f"ovd (b) {OVD_CONFIGS[1]} ({model.num_classes} classes, focal {model.roi_heads.focal_gamma}, "
              f"background weight {model.roi_heads.bg_loss_weight}): supervised_losses forward and backward on a "
              f"device batch {tuple(batch.image.shape)}: {start.elapsed_time(end) / OVD_STEPS:.3f} ms/step CUDA "
              f"events, {(time.perf_counter() - t0) / OVD_STEPS * 1e3:.3f} ms/step host wall ({OVD_STEPS} steps "
              f"after {OVD_WARMUP}); first losses {json.dumps({k: round(v, 6) for k, v in losses.items()})}; "
              f"K1/K3/K4 1/1/1 a step; {len(offline)} offline parameters frozen, no gradient, bit-equal after; "
              f"{len(trainable)} trainable parameters all with a gradient; no optimizer step (JAX has no trainer "
              "for this arch)")
        train_pool, train_rpn_call = ovd_training_calls(model, batch, generator_draw(gen))
        del model

        # (c) the open-set head through train_net --eval-only
        here = os.path.dirname(os.path.abspath(__file__))
        args = default_argument_parser().parse_args([
            "--eval-only", "--config-file", os.path.join(here, "configs", "VOC-Experiments",
                                                         "faster_rcnn_CLIP_R_50_C4.yaml"),
            "OUTPUT_DIR", os.path.join(root, "openset"), "SEED", "0", "MODEL.PRE_TRAINED_RCLIP_PATH", "",
            "MODEL.VISION_TO_LANG_PATH", "", "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", "True",
            "MODEL.CLIP.MULTIPLY_RPN_SCORE", "True", "MODEL.CLIP.OPENSET_TEST_NUM_CLASSES", str(LVIS_CLASSES),
            "MODEL.CLIP.OPENSET_TEST_TEXT_EMB_PATH", emb_path, "DATASETS.TEST", "('lvis_v1_val',)"])
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        t0 = time.perf_counter()
        open_results = train_net.main(args)["lvis_v1_val"]["bbox"]
        torch.cuda.synchronize()
        launches_c = read_launches(roi_ops, nms_ops)
        per_batch = tuple(launches_c[k] / n_batches for k in keys)
        if per_batch != (1, 0, 2):
            fail(f"ovd (c): the open-set eval launched K1/K3/K4 {per_batch} a batch, expected (1, 0, 2)")
        print(f"ovd (c) the VOC recipe's open-set head (CLS_AGNOSTIC_BBOX_REG, MULTIPLY_RPN_SCORE, "
              f"OPENSET_TEST_NUM_CLASSES {LVIS_CLASSES}) through train_net --eval-only on lvis_v1_val: "
              f"{time.perf_counter() - t0:.1f} s with the build, K1/K3/K4 {per_batch} a batch; LVIS AP (random "
              f"weights, not judged) {json.dumps({k: round(v, 4) for k, v in open_results.items()})}")
        launches = {k: launches_a[k] + launches_b[k] + launches_c[k] for k in keys}
        print(f"ovd path launches ((a) {n_batches} eval batches, (b) {steps} steps, (c) {n_batches} eval batches): "
              f"{launches}")

        rows = {name_: new_row(launches[name_]) for name_ in ("roi_align_fwd", "roi_align_bwd")}
        add_roi_rows(rows, dev, roi_ops, "ovd", [train_pool, ("zero_shot_pool", *zs_pool)], ["train_pool"])
        rows = {name_: close_row(row) for name_, row in rows.items()}
        rows["nms"] = nms_row(nms_ops, "ovd", launches["nms"], [train_rpn_call, *zs_calls])
        print(f"ovd phase: {time.perf_counter() - t_phase:.1f} s wall")
        return rows
    finally:
        if env is None:
            os.environ.pop("DETECTRON2_DATASETS", None)
        else:
            os.environ["DETECTRON2_DATASETS"] = env
        shutil.rmtree(root, ignore_errors=True)


# phase 16: detectron2's FPN box detectors. (a) DefaultTrainer on the R-50
# FPN recipe over a synthetic COCO fixture with the 80 COCO names, 12 steps
# and the final test, (b) one eval batch through the DC5, X-101 FPN and RPN
# detectors, (c) K1, K3 and K4 at the path's shapes
FPN_STEPS, FPN_IMAGES, FPN_HW = 12, 16, (480, 640)
FPN_NAMES = ("chip_smoke_coco_train", "chip_smoke_coco_val")
FPN_CANDIDATES_SEED = 16
FPN_CONFIG = "COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml"
# (config, K1/K3/K4 launches of one eval batch's inference)
FPN_EVAL_CONFIGS = (("COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml", (1, 0, 2)),
                    ("COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x.yaml", (4, 0, 2)),
                    ("COCO-Detection/rpn_R_50_FPN_1x.yaml", (0, 0, 1)))
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat", "traffic light",
    "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow", "elephant",
    "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant", "bed", "dining table", "toilet",
    "tv", "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush",
)


@torch.no_grad()
def unit_scale_stem(model):
    """Seeded random weights for a recipe whose PIXEL_STD is 1 (the caffe2
    ResNets' inputs: 0..255 less the means): the stem kernel divided by 58,
    about the pixels' standard deviation, so that the He-normal towers see
    unit-scale inputs. Without it the FPN maps reach ~4e3 and the recipe's
    SGD, unclipped, diverges within 12 steps (NaN at step 11 on the card)."""
    tower = getattr(model.backbone, "bottom_up", model.backbone)
    if max(model.pixel_std) == 1.0:
        tower.stem.conv1.weight.div_(58.0)
    return model


def level_pool_calls(roi_heads, levels, boxes, label):
    """The K1 launches of the multi-level pooler on boxes (B, S, 4): per FPN
    level (call, features, batch_idx, boxes with the other levels' rows NaN,
    pooled size, scale), as `ROIPooler` hands them to `roi_align_batched`."""
    pooler = roi_heads.pooler
    bidx, per_level = pooler.level_boxes(boxes)
    return [(f"{label} p{i + 2}" if len(levels) > 1 else label, feat.contiguous(), bidx, level_boxes,
             pooler.output_size, scale)
            for i, (feat, scale, level_boxes) in enumerate(zip(levels, pooler.scales, per_level))]


def fpn_rpn_nms_call(model, batch, training):
    """K4's call of the FPN RPN: every level's pre-NMS top-k moved apart by
    level, their logits and which may be kept, the threshold and the
    post-NMS top-k."""
    rpn = model.proposal_generator
    shifted, scores, ok, _ = rpn.nms_inputs(rpn._levels(model.features(batch.image)[1]), batch.image_sizes, training)
    return shifted, scores, ok, rpn.nms_thresh, rpn.post_nms_topk[training]


def fpn_step_roi_align_calls(model, batch, draw):
    """The RoIAlign calls of one FPNRCNN training step, rebuilt outside
    autograd: the pool of the B x batch_size_per_image sampled ROIs, one
    call per level."""
    rpn, rh = model.proposal_generator, model.roi_heads
    head, rpn_levels = model.features(batch.image)
    proposals = rpn._predict_levels(rpn._levels(rpn_levels), batch.image_sizes, True)
    sampled = rh.label_and_sample_proposals(proposals, batch.gt_boxes, batch.gt_classes, batch.gt_valid, draw)[0]
    return level_pool_calls(rh, head, sampled, "supervised")


@torch.no_grad()
def fpn_eval_kernel_calls(model, batch, candidates_seed=None):
    """The kernel calls of FPNRCNN.inference on one eval batch: K1's per
    level over the proposals, K4's at the RPN NMS and at the detection NMS
    (on `seeded_candidates` with `candidates_seed`)."""
    from cddmsl_torch.models.fast_rcnn import detection_candidates
    from cddmsl_torch.ops.nms import class_shifted

    rh = model.roi_heads
    head, proposals = model.proposals(batch)
    b, s = proposals.boxes.shape[:2]
    scores, deltas = rh.box_predictor(rh.box_features(head, proposals.boxes))
    boxes, det_scores, classes, valid = detection_candidates(
        scores.reshape(b, s, -1), deltas.reshape(b, s, -1), proposals.boxes, proposals.valid, batch.image_sizes,
        rh.box2box, rh.num_classes, rh.score_thresh_test)
    if candidates_seed is not None:
        det_scores, valid = seeded_candidates(det_scores, valid, candidates_seed)
    det_call = (class_shifted(boxes, classes, valid), det_scores, valid, rh.nms_thresh_test, rh.detections_per_image)
    return level_pool_calls(rh, head, proposals.boxes, "eval"), [fpn_rpn_nms_call(model, batch, False), det_call]


def fpn_path(dev, smi, roi_ops, nms_ops):
    """Phase 16: the FPN family at full width (bf16, seeded random weights,
    the stem scaled to the pixels by `unit_scale_stem`: the ImageNet and
    model-zoo weights are not in the repository). (a)
    `DefaultTrainer.train()` on configs/COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml
    (R-50, FPN 256, 80 classes, batch 8 at the 800x1344 pad) over a
    synthetic COCO fixture of the 80 COCO names: 12 steps (K1/K3/K4 4/4/1 a
    step, one K1 and one K3 per FPN level, or the run fails), every loss
    finite, the FrozenBN statistics bit-equal, the final test through
    `COCOEvaluator` (4/0/2 a batch); an eval batch's ms/image and the step
    on a batch already on the card. (b) One eval batch through
    `model.inference` of the DC5 (1/0/2), X-101 32x8d FPN (4/0/2) and RPN
    (0/0/1) detectors. (c) K1 and K3 at each level of the step's pool, K4
    at its RPN NMS, K1 at each level and K4 at both NMS of the eval batch,
    checked and timed as in phase 7. Returns the path's rows."""
    import os
    import shutil
    import tempfile

    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import get_cfg
    from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader, to_device
    from cddmsl_torch.data.datasets.coco import register_coco_instances
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_coco
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from cddmsl_torch.models.build import build_detector

    class ProbedTrainer(DefaultTrainer):
        def build_hooks(self):
            self.probe = StepProbe(roi_ops, nms_ops)
            return [self.probe] + super().build_hooks()

        def run_step(self, batch):
            metrics = super().run_step(batch)
            self.step_losses.append({k: v.detach() for k, v in metrics.items() if k.startswith("loss")})
            return metrics

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cddmsl_fpn_")
    keys = ("roi_align_fwd", "roi_align_bwd", "nms")
    try:
        json_path, img_root = make_synthetic_coco(os.path.join(root, "coco"), n=FPN_IMAGES, seed=16,
                                                  classes=COCO_CLASSES, hw=FPN_HW)
        for name in FPN_NAMES:
            register_coco_instances(name, json_path, img_root)

        def fpn_cfg(config, *opts):
            cfg = get_cfg()
            cfg.merge_from_file(os.path.join(here, "configs", config))
            cfg.merge_from_list(["OUTPUT_DIR", os.path.join(root, "out"), "SEED", "0", "DATASETS.TRAIN",
                                 repr((FPN_NAMES[0],)), "DATASETS.TEST", repr((FPN_NAMES[1],)),
                                 "SOLVER.IMS_PER_BATCH", "8", "SOLVER.MAX_ITER", str(FPN_STEPS),
                                 "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", *opts])
            cfg.freeze()
            return cfg

        cfg = fpn_cfg(FPN_CONFIG)
        print(f"fpn: configs/{FPN_CONFIG} (R-{cfg.MODEL.RESNETS.DEPTH} FPN {cfg.MODEL.FPN.OUT_CHANNELS}, "
              f"{cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, {cfg.SOLVER.IMS_PER_BATCH} images a step padded to "
              f"{tuple(cfg.TPU.PAD_SIZE_TRAIN)}, {cfg.TPU.COMPUTE_DTYPE}) on a synthetic COCO fixture of "
              f"{FPN_IMAGES} {FPN_HW[0]}x{FPN_HW[1]} images named with the 80 COCO classes; every weight seeded random")
        trainer = ProbedTrainer(cfg, device="cuda")
        trainer.step_losses = []
        trainer.resume_or_load(resume=False)
        model = unit_scale_stem(trainer.model)
        if type(model).__name__ != "FPNRCNN":
            fail(f"fpn: the trainer built {type(model).__name__}, not FPNRCNN")
        buffers = {n: (b, b.clone()) for n, b in model.named_buffers()}
        torch.cuda.synchronize()
        reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
        results = trainer.train()
        torch.cuda.synchronize()
        launches = read_launches(roi_ops, nms_ops)
        print(f"fpn path launches ({FPN_STEPS} steps and the final test): {launches}")
        if min(launches.values()) < 1:
            fail(f"the fpn path did not go through every kernel: {launches}")
        probe = trainer.probe
        waits = [v for _, v in trainer.storage.histories()["data_time"]._values]
        per_step = loop_steps("fpn", probe, waits, FPN_STEPS, FPN_STEPS, ((4, 4, 1), (4, 4, 1)))
        losses = [{k: v.item() for k, v in step.items()} for step in trainer.step_losses]
        names = {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
        if len(losses) != FPN_STEPS or any(set(step) != names for step in losses) or not all(
                math.isfinite(v) for step in losses for v in step.values()):
            fail(f"fpn: the losses are not the four finite ones: {losses}")
        for i in (0, FPN_STEPS - 1):
            print(f"fpn step {i + 1} losses: {json.dumps({k: round(v, 6) for k, v in losses[i].items()})}")
        changed = [n for n, (b, b0) in buffers.items() if not torch.equal(b, b0)]
        if changed:
            fail(f"fpn: FrozenBN statistics changed: {changed[:5]}")
        print(f"fpn: all {len(buffers)} FrozenBN statistics bit-equal after {FPN_STEPS} steps; "
              f"{sum(p.requires_grad for p in model.parameters())} trainable parameters")
        warm = per_step[2:]
        mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
        print(f"fpn loop, steps 3-{FPN_STEPS}: {mean([p[0] for p in warm]):.3f} ms/step CUDA events, "
              f"{mean([p[1] for p in warm]):.3f} ms/step host wall, {mean([p[2] for p in warm]):.3f} ms/step waiting "
              f"on the loader; whole loop {probe.loop_s * 1e3 / FPN_STEPS:.3f} ms/step host wall; on {smi}")
        n_test_batches = -(-FPN_IMAGES // cfg.MODEL.CLIP.IMS_PER_BATCH_TEST)
        per_batch = tuple((launches[k] - probe.loop_launches[k]) / n_test_batches for k in keys)
        if per_batch != (4, 0, 2):
            fail(f"the fpn final test launched K1/K3/K4 {per_batch} per batch, expected (4, 0, 2)")
        ap = {k: round(v, 4) for k, v in results[FPN_NAMES[1]]["bbox"].items() if k in ("AP", "AP50", "AP75")}
        print(f"fpn final test (COCOEvaluator): launches per batch K1/K3/K4 {per_batch}; AP (random weights, not "
              f"judged) {json.dumps(ap)}")

        eval_batch = first_eval_batch(cfg, FPN_NAMES[1], dev)
        n_img = eval_batch.image.shape[0]
        ms = cuda_ms(lambda: model.inference(eval_batch), 3, warmup=1)
        det = model.inference(eval_batch)
        print(f"fpn eval batch {tuple(eval_batch.image.shape)}: {ms / n_img:.3f} ms/image CUDA events, "
              f"{det.valid.sum(1).tolist()} detections an image")
        with build_detection_train_loader(cfg, seed=0, pin_memory=True) as train_loader:
            batch = to_device(next(train_loader), dev)
        time_device_batch("fpn", trainer, batch, what="supervised")

        for config, want in FPN_EVAL_CONFIGS:
            other = init_random_(build_detector(fpn_cfg(config), device="cpu"), torch.Generator().manual_seed(16))
            other = unit_scale_stem(other)
            other = other.to(dev).eval()
            torch.cuda.synchronize()
            reset_launches(roi_ops.KERNEL, nms_ops.KERNEL)
            det = other.inference(eval_batch)
            torch.cuda.synchronize()
            got = tuple(read_launches(roi_ops, nms_ops)[k] for k in keys)
            if got != want or not bool(torch.isfinite(det.scores).all()) or not bool(torch.isfinite(det.boxes).all()):
                fail(f"fpn: configs/{config} on an eval batch launched K1/K3/K4 {got} (expected {want}) or gave "
                     "non-finite detections")
            ms = cuda_ms(lambda: other.inference(eval_batch), 3, warmup=1)
            print(f"fpn: configs/{config} ({type(other).__name__}) on the eval batch: K1/K3/K4 {got}, "
                  f"{ms / n_img:.3f} ms/image, {det.valid.sum(1).tolist()} detections an image")
            del other

        rows = {name: new_row(launches[name]) for name in ("roi_align_fwd", "roi_align_bwd")}
        calls = fpn_step_roi_align_calls(model, batch, trainer.state.draw)
        add_roi_rows(rows, dev, roi_ops, "fpn", calls, [call for call, *_ in calls])
        eval_calls, eval_nms = fpn_eval_kernel_calls(model, eval_batch, FPN_CANDIDATES_SEED)
        add_roi_rows(rows, dev, roi_ops, "fpn", eval_calls, [])
        rows = {name: close_row(row) for name, row in rows.items()}
        rows["nms"] = nms_row(nms_ops, "fpn", launches["nms"], [fpn_rpn_nms_call(model, batch, True)] + eval_nms)
        del trainer, model
        print(f"fpn phase: {time.perf_counter() - t_phase:.1f} s wall")
        return rows
    finally:
        for name in FPN_NAMES:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
                MetadataCatalog.remove(name)
        shutil.rmtree(root, ignore_errors=True)


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


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
    torch.cuda.empty_cache()
    paths["consistency"] = consistency_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["mean_teacher"] = mean_teacher_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["ddp"] = ddp_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["pretrain"] = pretrain_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["language_tools"] = language_tools_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["plain_r50"] = plain_r50_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["ovd"] = ovd_path(dev, smi, roi_ops, nms_ops)
    torch.cuda.empty_cache()
    paths["fpn"] = fpn_path(dev, smi, roi_ops, nms_ops)

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
