"""Greedy NMS with a fixed-size output: the plain PyTorch versions and the
wrapper of kernel K4.

Counterpart of cddmsl_tpu/ops/nms.py (`nms_mask`, `nms`, `batched_nms`).
Boxes are visited in descending score order, ties going to the lower index
(a stable sort); a box is suppressed when its IoU with a kept box is above
the threshold; rows marked invalid are never kept and suppress nothing. The
result is the first `max_out` kept indices in score order, padded with
index 0, plus a validity mask.

`nms` is what the model calls. For CUDA tensors it launches the
hand-written kernel (csrc/nms.cu); for CPU tensors it runs `nms_plain`.
"""

import ctypes
from typing import Optional, Tuple

import torch

from ..structures.boxes import pairwise_iou
from ._build import CudaKernel

KERNEL = CudaKernel(
    "nms.cu",
    {
        "cddmsl_nms": (
            ctypes.c_void_p,  # boxes (B, N, 4) float32
            ctypes.c_void_p,  # valid (B, N) bool
            ctypes.c_void_p,  # order (B, N) int64, score order
            ctypes.c_void_p,  # masked scores (B, N) float32 in score order, or None
            ctypes.c_void_p,  # scratch, cddmsl_nms_scratch_words(B, N) int64 words
            ctypes.c_void_p,  # out_idx (B, max_out) int64
            ctypes.c_void_p,  # out_valid (B, max_out) bool
            ctypes.c_int, ctypes.c_int,  # B N
            ctypes.c_float,  # iou threshold
            ctypes.c_int,  # max_out
            ctypes.c_void_p,  # stream
        )
    },
    extra_flags=("-fmad=false",),
    queries={"cddmsl_nms_scratch_words": ((ctypes.c_int, ctypes.c_int), ctypes.c_longlong)},
)

_TILE = 256


def _score_order(scores: torch.Tensor, valid: torch.Tensor):
    """Descending score order along the last dim, invalid rows last, ties to
    the lower index: torch.sort's (values, indices) of the scores with the
    invalid rows' set to -inf."""
    return torch.sort(torch.where(valid, scores, float("-inf")), dim=-1, descending=True, stable=True)


def _greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float, max_keep: int) -> torch.Tensor:
    """Greedy keep mask over boxes already in score order. Tiles of rows are
    decided in order: each is first suppressed by the rows kept before it,
    then resolved by iterating `kept <- active & ~suppressed_by(kept)` to its
    fixpoint, which is the greedy answer because the suppression mask is
    strictly upper-triangular. Stops once `max_keep` rows are kept."""
    n = boxes.shape[0]
    sup = torch.triu(pairwise_iou(boxes, boxes) > iou_threshold, diagonal=1)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    n_kept = 0
    for start in range(0, n, _TILE):
        end = min(start + _TILE, n)
        earlier = torch.any(sup[:start, start:end] & keep[:start, None], dim=0)
        active = valid[start:end] & ~earlier
        block = sup[start:end, start:end]
        cur = active
        while True:
            nxt = active & ~torch.any(block & cur[:, None], dim=0)
            if torch.equal(nxt, cur):
                break
            cur = nxt
        keep[start:end] = cur
        n_kept += int(cur.sum())
        if n_kept >= max_keep:
            break
    return keep


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain greedy NMS keep mask (N,) bool, in the original order."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    order = _score_order(scores, valid).indices
    kept_sorted = _greedy_keep(boxes[order], valid[order], iou_threshold, n)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = kept_sorted
    return keep


def nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 for one image: boxes (N, 4), scores (N,) ->
    idx (max_out,) int64 in score order, padded with 0, and valid (max_out,).
    With max_out >= N, a kept row whose score is not above -inf is given
    index 0 and marked invalid, as JAX's `nms` does in that case."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    idx = torch.zeros(max_out, dtype=torch.int64, device=dev)
    out_valid = torch.zeros(max_out, dtype=torch.bool, device=dev)
    if n == 0:
        return idx, out_valid
    order = _score_order(scores, valid).indices
    kept_sorted = _greedy_keep(boxes[order], valid[order], iou_threshold, max_out)
    pos = torch.nonzero(kept_sorted).squeeze(1)[:max_out]
    k = pos.numel()
    idx[:k] = order[pos]
    out_valid[:k] = True
    if max_out >= n:
        out_valid[:k] = scores[idx[:k]] > float("-inf")
        idx[:k] = torch.where(out_valid[:k], idx[:k], 0)
    return idx, out_valid


def _nms_cuda(boxes, scores, valid, iou_threshold, max_out):
    B, N = scores.shape
    dev = boxes.device
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms: boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"nms: valid must be bool, got {valid.dtype}")
    if scores.device != dev or valid.device != dev:
        raise ValueError("nms: all inputs must be on the same device")
    out_idx = torch.empty((B, max_out), dtype=torch.int64, device=dev)
    out_valid = torch.empty((B, max_out), dtype=torch.bool, device=dev)
    if N == 0 or max_out == 0:
        return out_idx.zero_(), out_valid.zero_()
    values, order = _score_order(scores, valid)
    # with max_out >= N the kernel drops kept rows whose score is -inf (JAX's rule)
    values = values.float() if max_out >= N else None
    boxes, valid = boxes.contiguous(), valid.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads each box as one float4
        boxes = boxes.clone()
    with torch.cuda.device(dev):
        words = KERNEL.query("cddmsl_nms_scratch_words", B, N)
        scratch = torch.empty(words, dtype=torch.int64, device=dev)
        KERNEL.launch(
            "cddmsl_nms",
            boxes.data_ptr(), valid.data_ptr(), order.data_ptr(), None if values is None else values.data_ptr(),
            scratch.data_ptr(), out_idx.data_ptr(), out_valid.data_ptr(), B, N, float(iou_threshold), max_out,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return out_idx, out_valid


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one image, boxes (N, 4), or of a batch, boxes
    (B, N, 4), with scores and valid shaped like boxes[..., 0].

    Returns idx (..., max_out) int64 indices into N, score-descending, padded
    with 0, and out_valid (..., max_out) bool. CUDA tensors go to kernel K4,
    CPU tensors to `nms_plain`.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if boxes.shape[-1] != 4 or boxes.shape[:2] != scores.shape or valid.shape != scores.shape:
        raise ValueError(f"nms: shapes {tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(valid.shape)}")
    if boxes.device.type == "cpu":
        pairs = [nms_plain(boxes[b], scores[b], iou_threshold, max_out, valid[b]) for b in range(boxes.shape[0])]
        idx = torch.stack([p[0] for p in pairs])
        out_valid = torch.stack([p[1] for p in pairs])
    elif boxes.device.type == "cuda":
        idx, out_valid = _nms_cuda(boxes, scores, valid, iou_threshold, max_out)
    else:
        raise ValueError(f"nms: unsupported device {boxes.device}")
    if single:
        return idx[0], out_valid[0]
    return idx, out_valid


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by the coordinate shift: boxes of different `idxs`
    move apart by idx * (max_coord + 1) so they never overlap, then one
    `nms` runs. Shapes as in `nms`; max_coord is taken per image over the
    valid boxes."""
    kept = boxes if valid is None else torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = torch.amax(kept, dim=(-2, -1), keepdim=True)  # (..., 1, 1)
    offsets = idxs.to(boxes.dtype) * (max_coord[..., 0] + 1.0)
    return nms(boxes + offsets[..., None], scores, iou_threshold, max_out, valid=valid)
