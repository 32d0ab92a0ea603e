"""Multi-level RoI pooling (counterpart of cddmsl_tpu/models/poolers.py
`assign_boxes_to_levels` and `ROIPooler`).

Each box is assigned the FPN level floor(4 + log2(sqrt(area) / 224)),
clamped to the pooler's levels, in float32 as JAX computes it. JAX pools
every box at every level and selects by level; here each level gets one
launch of kernel K1 over the whole box list, the rows assigned to other
levels set to NaN: K1 pools zeros for a non-finite box and K3's footprint
test skips it, so the sum of the levels' outputs is JAX's selection and each
level's gradient comes only from its own rows. No host sync decides which
rows go where.
"""

from typing import Sequence

import torch

from ..ops.roi_align import roi_align_batched
from ..structures import boxes as box_ops


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int, canonical_size: int = 224,
                           canonical_level: int = 4) -> torch.Tensor:
    """(..., 4) -> (...,) int32 levels in [min_level, max_level]. log2 is
    log(x) / log(2), and every divisor a tensor, as jnp.log2 and XLA divide."""
    area = torch.clamp(box_ops.area(boxes.float()), min=1e-6)
    s = torch.sqrt(area)
    ratio = s / torch.full_like(s, float(canonical_size)) + 1e-8
    log2 = torch.log(ratio) / torch.log(torch.full_like(ratio, 2.0))
    lvl = torch.floor(canonical_level + log2)
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


class ROIPooler:
    """`output_size` x `output_size` aligned RoIAlign of each image's boxes
    from the level each box is assigned to; `scales` are the levels' (finest
    first, level `min_level` first). One level pools every box."""

    def __init__(self, output_size: int, scales: Sequence[float], sampling_ratio: int = 0, min_level: int = 2,
                 canonical_size: int = 224):
        self.output_size = output_size
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.min_level = min_level
        self.max_level = min_level + len(scales) - 1
        self.canonical_size = canonical_size

    def level_boxes(self, boxes: torch.Tensor):
        """(B, S, 4) -> (batch_idx (B*S,) int32, [(R, 4) float32 per level]):
        the boxes each level's K1 launch gets, NaN where another level owns
        the row."""
        b, s = boxes.shape[:2]
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(s)
        flat = boxes.reshape(b * s, 4).float().contiguous()
        if len(self.scales) == 1:
            return batch_idx, [flat]
        levels = assign_boxes_to_levels(flat, self.min_level, self.max_level, self.canonical_size)
        nan = torch.full_like(flat, float("nan"))
        return batch_idx, [torch.where((levels == self.min_level + i)[:, None], flat, nan).contiguous()
                           for i in range(len(self.scales))]

    def __call__(self, features: Sequence[torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """features: per level (B, H_l, W_l, C); boxes (B, S, 4) ->
        (B*S, P, P, C), image-major."""
        batch_idx, per_level = self.level_boxes(boxes)
        out = None
        size = (self.output_size, self.output_size)
        for feat, scale, level_boxes in zip(features, self.scales, per_level):
            pooled = roi_align_batched(feat.contiguous(), batch_idx, level_boxes, size, scale, self.sampling_ratio,
                                       True)
            out = pooled if out is None else out + pooled
        return out
