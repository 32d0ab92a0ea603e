"""Anchor grid generation (counterpart of cddmsl_tpu/ops/anchors.py): the
outer product of sizes x aspect ratios, tiled over the feature grid."""

from typing import Sequence

import numpy as np
import torch


def generate_cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """(len(sizes)*len(aspect_ratios), 4) XYXY anchors centered at (0, 0)."""
    anchors = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def anchor_grid(
    grid_height: int,
    grid_width: int,
    stride: int,
    cell_anchors: np.ndarray,
    offset: float = 0.0,
    device=None,
) -> torch.Tensor:
    """(grid_h * grid_w * A, 4) fp32 anchors, row-major with the per-cell
    anchors fastest."""
    shift_x = (np.arange(grid_width) + offset) * stride
    shift_y = (np.arange(grid_height) + offset) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)  # (HW, 4)
    all_anchors = shifts[:, None, :] + cell_anchors[None, :, :]  # (HW, A, 4)
    return torch.as_tensor(all_anchors.reshape(-1, 4).astype(np.float32), device=device)
