"""Soft-NMS with a fixed-size output, in plain PyTorch (counterpart of
cddmsl_tpu/ops/soft_nms.py `soft_nms` and `batched_soft_nms`, which are XLA
there, not Pallas).

Each of `max_out` selections takes the highest remaining score (ties to the
lower index), records it, and decays the scores of every box by its IoU with
the one taken: by exp(-iou^2 / sigma) ("gaussian"), by 1 - iou above
`linear_threshold` ("linear"), or to 0 above it ("hard"); the box taken
drops to 0. A selection whose best score is not above `prune_threshold`
ends the search: it and every later slot are invalid (index 0, score 0).
The images of a batch run side by side, on whatever device the tensors are
on, without a host sync; on the card that is `max_out` short rounds of
elementwise launches over the (B, N, N) IoUs.
"""

from typing import Optional, Tuple

import torch

from ..structures.boxes import pairwise_iou

METHODS = ("gaussian", "linear", "hard")


def soft_nms(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    method: str = "gaussian",
    gaussian_sigma: float = 0.5,
    linear_threshold: float = 0.3,
    prune_threshold: float = 0.001,
    max_out: int = 100,
    valid: Optional[torch.Tensor] = None,  # (B, N) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (indices (B, max_out) int64, decayed scores (B, max_out) float32,
    valid (B, max_out) bool)."""
    if method not in METHODS:
        raise ValueError(f"soft-NMS method {method!r}: one of {METHODS}")
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    b, n = scores.shape
    iou = pairwise_iou(boxes, boxes)  # (B, N, N)
    remaining = torch.where(valid, scores.float(), torch.zeros((), device=scores.device))
    out_idx = torch.zeros((b, max_out), dtype=torch.int64, device=scores.device)
    out_scores = torch.full((b, max_out), float("-inf"), device=scores.device)
    rows = torch.arange(b, device=scores.device)
    # a tensor divisor: CUDA would multiply by the rounded reciprocal of a
    # Python scalar, and round otherwise than the CPU does
    sigma = torch.full((), gaussian_sigma, device=scores.device)
    for i in range(max_out):
        j = torch.argmax(remaining, dim=1)  # the first of equal maxima
        sj = remaining[rows, j]
        picked = sj > prune_threshold
        out_idx[:, i] = torch.where(picked, j, torch.zeros_like(j))
        out_scores[:, i] = torch.where(picked, sj, torch.full_like(sj, float("-inf")))
        ious = iou[rows, j]  # (B, N)
        if method == "gaussian":
            decay = torch.exp(-(ious * ious) / sigma)
        elif method == "linear":
            decay = torch.where(ious > linear_threshold, 1.0 - ious, torch.ones_like(ious))
        else:
            decay = torch.where(ious > linear_threshold, torch.zeros_like(ious), torch.ones_like(ious))
        remaining = remaining * decay
        remaining[rows, j] = 0.0
        remaining = torch.where(picked[:, None], remaining, torch.zeros_like(remaining))
    out_valid = out_scores > float("-inf")
    return out_idx, torch.where(out_valid, out_scores, torch.zeros_like(out_scores)), out_valid


def batched_soft_nms(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    idxs: torch.Tensor,  # (B, N) class of each box
    method: str = "gaussian",
    gaussian_sigma: float = 0.5,
    linear_threshold: float = 0.3,
    prune_threshold: float = 0.001,
    max_out: int = 100,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-aware `soft_nms`: each image's boxes shifted by class * (its
    largest valid coordinate + 1), so boxes of two classes never overlap."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    max_coord = torch.where(valid[..., None], boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = max_coord.reshape(boxes.shape[0], -1).max(dim=1).values
    offsets = idxs.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    return soft_nms(boxes + offsets[..., None], scores, method, gaussian_sigma, linear_threshold, prune_threshold,
                    max_out, valid)
