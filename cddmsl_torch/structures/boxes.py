"""Box math over (..., 4) XYXY tensors (counterpart of
cddmsl_tpu/structures/boxes.py). Padded boxes are all-zero rows."""

from typing import Tuple

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) XYXY -> (...)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w * h


def clip(boxes: torch.Tensor, image_size: Tuple) -> torch.Tensor:
    """Clip boxes to [0, W] x [0, H]. image_size is (H, W): Python numbers, or
    tensors that broadcast against boxes[..., 0]."""
    h, w = image_size[0], image_size[1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def _clamp(v, hi):
        hi = torch.as_tensor(hi, dtype=boxes.dtype, device=boxes.device)
        return torch.minimum(torch.maximum(v, zero), hi)

    return torch.stack(
        [
            _clamp(boxes[..., 0], w),
            _clamp(boxes[..., 1], h),
            _clamp(boxes[..., 2], w),
            _clamp(boxes[..., 3], h),
        ],
        dim=-1,
    )


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """(..., 4) -> (...) bool: width and height both > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N,4),(M,4) -> (N,M) intersection areas."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N,4),(M,4) -> (N,M) IoU; pairs with a zero union give 0. The order of
    operations (inter, then a1 + a2 - inter, then inter / union) is the one
    the NMS kernel repeats, so both take the same threshold decisions."""
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[:, None]
    a2 = area(boxes2)[None, :]
    union = a1 + a2 - inter
    ok = union > 0
    return torch.where(ok, inter / torch.where(ok, union, torch.ones_like(union)), torch.zeros_like(union))
