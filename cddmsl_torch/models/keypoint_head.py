"""Keypoint R-CNN's head, its targets, loss and decode (counterpart of
cddmsl_tpu/models/keypoint_head.py `KRCNNConvDeconvUpsampleHead`,
`keypoint_rcnn_loss`, `KeypointROIHeads.keypoints_to_heatmap_targets`,
`_refine_matrix` and `decode_keypoint_heatmaps`). Plain PyTorch: none of it
is a kernel.

The head (detectron2's names: conv_fcn{i}, score_lowres) reads the pooled
regions (N, P, P, C) NHWC: a 3x3 ReLU conv for each of CONV_DIMS, the 4x4
stride-2 `score_lowres` deconv to K channels (flax's "SAME" transposed
convolution, whose taps are applied unflipped: a ConvTranspose2d of
padding 1 with the kernel flipped on both spatial axes, which
checkpoint/convert_jax.py does), and a 2x bilinear upsample in float32 ->
(N, 4P, 4P, K) logits. jax.image.resize renormalises the edge weights where
F.interpolate (align_corners False) clamps the sample: both give the edge
pixel itself.

Targets: each keypoint's bin floor((x - x1) * S / w) in the box's S x S
heatmap, clipped to [0, S - 1], box sides floored at 1e-4; a keypoint is
visible where its flag is > 0 and it lies inside the box, tested on the
coordinates (a keypoint on the far edge stays visible, in the last bin).
The loss is the cross-entropy over the flat heatmap of each visible
keypoint, divided by the visible count (over the global batch under a
process group), or by a fixed normaliser.

The decode is JAX's static refinement, not detectron2's per-box bicubic
upsample: the coarse argmax of each heatmap (the first maximum), then the
Keys (a = -0.75) bicubic surface of the 8 x 8 taps around it (edge taps
clamped) on a 24 x 24 lattice of offsets in (-1.5, 1.5) bins, argmaxed
again; x = x1 + (s + 0.5) * w / S. The score is the softmax over the
heatmap at the coarse argmax.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm


class KRCNNConvDeconvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17, conv_dims: Sequence[int] = (512,) * 8):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.num_conv = len(conv_dims)
        c = in_channels
        for i, dim in enumerate(conv_dims):
            setattr(self, f"conv_fcn{i + 1}", nn.Conv2d(c, dim, 3, padding=1))
            c = dim
        self.score_lowres = nn.ConvTranspose2d(c, num_keypoints, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, P, P, C) pooled regions -> (N, 4P, 4P, K) float32 logits,
        computed in the input's dtype up to the upsample."""
        x = x.permute(0, 3, 1, 2)
        dt = x.dtype
        for i in range(self.num_conv):
            conv = getattr(self, f"conv_fcn{i + 1}")
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1))
        deconv = self.score_lowres
        x = F.conv_transpose2d(x, deconv.weight.to(dt), deconv.bias.to(dt), stride=2, padding=1)
        x = F.interpolate(x.float(), scale_factor=2, mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)


@torch.no_grad()
def keypoints_to_heatmap_targets(keypoints: torch.Tensor, boxes: torch.Tensor,
                                 heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K, 3) keypoints (x, y, flag) in image coordinates, (N, 4) boxes ->
    (N, K) flat heatmap index and (N, K) visibility."""
    x1, y1, x2, y2 = (boxes[:, i:i + 1].float() for i in range(4))
    w = torch.clamp(x2 - x1, min=1e-4)
    h = torch.clamp(y2 - y1, min=1e-4)
    sx = torch.full_like(w, float(heatmap_size)) / w
    sy = torch.full_like(h, float(heatmap_size)) / h
    kx_, ky_ = keypoints[..., 0].float(), keypoints[..., 1].float()
    kx = torch.clamp(torch.floor((kx_ - x1) * sx), 0, heatmap_size - 1).long()
    ky = torch.clamp(torch.floor((ky_ - y1) * sy), 0, heatmap_size - 1).long()
    inside = (kx_ >= x1) & (kx_ <= x2) & (ky_ >= y1) & (ky_ <= y2)
    return ky * heatmap_size + kx, (keypoints[..., 2] > 0) & inside


def keypoint_rcnn_loss(heatmaps: torch.Tensor, positions: torch.Tensor, visible: torch.Tensor,
                       normalizer: Optional[float] = None) -> torch.Tensor:
    """Cross-entropy over each (N, S, S, K) heatmap's S*S positions at the
    target `positions` (N, K) of the `visible` (N, K) keypoints, summed and
    divided by the visible count or by `normalizer` (each at least 1; both
    over the global batch under a process group)."""
    n, s, _, k = heatmaps.shape
    lp = F.log_softmax(heatmaps.reshape(n, s * s, k), dim=1)
    tgt = torch.clamp(positions.long(), 0, s * s - 1)
    nll = -torch.gather(lp, 1, tgt[:, None, :])[:, 0, :]
    m = visible.float()
    count = m.sum() if normalizer is None else torch.tensor(float(normalizer), device=m.device)
    return (nll * m).sum() / comm.global_normalizer(count)


def refine_matrix(grid: int, span: float = 1.5) -> Tuple[np.ndarray, np.ndarray, int]:
    """(grid, 2r + 2) matrix A of the 1-D Keys (a = -0.75) interpolant at
    `grid` offsets in (-span, span) bins around the argmax bin, the offsets,
    and r = ceil(span) + 1 taps of left padding: interp(argmax + off[g]) =
    sum_t A[g, t] * heat[argmax - r + t]."""

    def cubic(d, a=-0.75):
        d = np.abs(d)
        return np.where(d <= 1.0, ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0,
                        ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a)

    offs = (np.arange(grid) + 0.5) / grid * (2 * span) - span
    r = int(np.ceil(span)) + 1
    a_mat = np.zeros((grid, 2 * r + 2), np.float64)
    for g, off in enumerate(offs):
        base = int(np.floor(off))
        frac = off - base
        for tap in range(-1, 3):
            a_mat[g, base + tap + r] += cubic(frac - tap)
    return a_mat.astype(np.float32), offs.astype(np.float32), r


@torch.no_grad()
def decode_keypoint_heatmaps(heat: torch.Tensor, boxes: torch.Tensor, refine_grid: int = 24) -> torch.Tensor:
    """(B*D, S, S, K) logits and their (B, D, 4) boxes -> (B, D, K, 3)
    (x, y, score) in the boxes' frame."""
    b, d = boxes.shape[:2]
    n, size, _, k = heat.shape
    heat = heat.float()
    flat = heat.reshape(n, size * size, k)
    idx = torch.argmax(flat, dim=1)  # (N, K), the first maximum
    score = torch.gather(torch.softmax(flat, dim=1), 1, idx[:, None, :])[:, 0, :]
    ky, kx = idx // size, idx % size
    a_np, offs_np, r = refine_matrix(refine_grid)
    a_mat = torch.from_numpy(a_np).to(heat.device)
    offs = torch.from_numpy(offs_np).to(heat.device)
    taps = torch.arange(a_mat.shape[1], device=heat.device) - r
    ry = torch.clamp(ky[..., None] + taps, 0, size - 1)  # (N, K, T)
    rx = torch.clamp(kx[..., None] + taps, 0, size - 1)
    t = taps.numel()
    hkc = heat.permute(0, 3, 1, 2).reshape(n, k, size * size)
    patch = torch.gather(hkc, 2, (ry[..., :, None] * size + rx[..., None, :]).reshape(n, k, t * t))
    vals = torch.matmul(torch.matmul(a_mat, patch.reshape(n, k, t, t)), a_mat.T)  # (N, K, G, G)
    g = torch.argmax(vals.reshape(n, k, -1), dim=-1)
    sy = ky.float() + offs[g // refine_grid]
    sx = kx.float() + offs[g % refine_grid]
    bx = boxes.reshape(n, 4).float()
    x1, y1 = bx[:, 0:1], bx[:, 1:2]
    w = torch.clamp(bx[:, 2:3] - x1, min=1e-4)
    h = torch.clamp(bx[:, 3:4] - y1, min=1e-4)
    px = x1 + (sx + 0.5) * w / torch.full_like(w, float(size))
    py = y1 + (sy + 0.5) * h / torch.full_like(h, float(size))
    return torch.stack([px, py, score], dim=-1).reshape(b, d, k, 3)


def keypoint_branch_losses(head: KRCNNConvDeconvUpsampleHead, regions: torch.Tensor,
                           gt_keypoints: Optional[torch.Tensor], boxes: torch.Tensor, classes: torch.Tensor,
                           valid: torch.Tensor, matched_idx: torch.Tensor, num_classes: int,
                           loss_weight: float = 1.0, loss_normalizer: float = -1.0) -> torch.Tensor:
    """`loss_keypoint` of the leading rows of each image: regions (B*F, P,
    P, C) pooled for boxes (B, F, 4) with their sampled classes, validity
    and matched instances (B, F); gt_keypoints (B, G, K, 3). A
    `loss_normalizer` > 0 divides by B x it (JAX's images x NUM_KEYPOINTS x
    BATCH_SIZE_PER_IMAGE x POSITIVE_FRACTION), else by the visible count."""
    if gt_keypoints is None:
        raise ValueError("KEYPOINT_ON training needs DetBatch.gt_keypoints")
    b, f = boxes.shape[:2]
    k = gt_keypoints.shape[2]
    kp = torch.gather(gt_keypoints, 1, matched_idx.long()[..., None, None].expand(-1, -1, k, 3))  # (B, F, K, 3)
    heat = head(regions)
    pos, vis = keypoints_to_heatmap_targets(kp.reshape(b * f, k, 3), boxes.reshape(b * f, 4), heat.shape[1])
    fg = (valid & (classes >= 0) & (classes < num_classes)).reshape(b * f)
    norm = None if loss_normalizer <= 0 else b * loss_normalizer
    return loss_weight * keypoint_rcnn_loss(heat, pos, vis & fg[:, None], norm)
