"""Mask R-CNN's mask head, its loss, targets and inference (counterpart of
cddmsl_tpu/models/mask_head.py `MaskRCNNConvUpsampleHead`,
`mask_rcnn_loss`, `mask_rcnn_inference`, `crop_mask_targets` and
`paste_masks_in_image`). Plain PyTorch: none of it is a kernel.

The head (detectron2's names: mask_fcn{i}, deconv, predictor) reads the
pooled regions (N, P, P, C) NHWC: NUM_CONV 3x3 ReLU convs (0 on C4, where it
reads res5's 7x7 crops; 4 on the FPN; each followed by ROI_MASK_HEAD.NORM, GN
or SyncBN, where set), a 2x2 stride-2 ReLU deconv, and a 1x1
predictor of K channels, or 1 with CLS_AGNOSTIC_MASK -> (N, 2P, 2P, K)
logits in float32. It computes in its input's dtype.

The targets come from the batch's ground-truth canvas at
TPU.MASK_CANVAS_STRIDE (data/build.py `rasterize_polygons`): each sampled
box's matched instance is cropped by an aligned bilinear RoIAlign of M x M
bins with 2 x 2 samples each, sample coordinates clipped to the canvas, then
binarised at >= 0.5 (detectron2's `BitMasks.crop_and_resize`). Only the
samples' taps are gathered, never a canvas per box.

The loss is the BCE of each foreground row's ground-truth class channel,
averaged over its pixels and then over the foreground rows (over the global
batch's under a process group).

`paste_masks_in_image` is the paste into the image (detectron2's
`_do_paste_mask`): inverse bilinear sampling of each M x M mask with
unclamped sample coordinates, taps outside the mask weighing zero, then
>= threshold. The evaluator pastes on the host (evaluation/masks.py); this
is the same function on tensors.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm
from .backbone.resnet import NormConv2d


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_conv: int = 0, conv_dim: int = 256,
                 cls_agnostic: bool = False, conv_norm: str = ""):
        """`conv_norm` (ROI_MASK_HEAD.NORM: "", GN or SyncBN) follows each
        mask_fcn, which then has no bias."""
        super().__init__()
        self.num_conv = num_conv
        self.conv_norm = conv_norm
        c = in_channels
        for i in range(num_conv):
            setattr(self, f"mask_fcn{i + 1}", NormConv2d(c, conv_dim, 3, padding=1, norm=conv_norm))
            c = conv_dim
        self.deconv = nn.ConvTranspose2d(c, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, 1 if cls_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, P, P, C) pooled regions -> (N, 2P, 2P, K or 1) float32 logits."""
        x = x.permute(0, 3, 1, 2)
        dt = x.dtype
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(F.conv_transpose2d(x, self.deconv.weight.to(dt), self.deconv.bias.to(dt), stride=2))
        x = F.conv2d(x, self.predictor.weight.to(dt), self.predictor.bias.to(dt))
        return x.permute(0, 2, 3, 1).float()


def _class_channel(mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """(N, M, M, K) x (N,) -> (N, M, M): each row's class channel (the one
    channel of a class-agnostic head), classes clamped to [0, K-1]."""
    cls = torch.clamp(classes.long(), 0, mask_logits.shape[-1] - 1)
    m = mask_logits.shape[1]
    return torch.gather(mask_logits, 3, cls[:, None, None, None].expand(-1, m, m, 1))[..., 0]


def mask_rcnn_loss(mask_logits: torch.Tensor, targets: torch.Tensor, classes: torch.Tensor,
                   fg: torch.Tensor) -> torch.Tensor:
    """Per-class BCE: logits (N, M, M, K), {0, 1} targets (N, M, M), classes
    (N,) and foreground rows (N,) -> the mean over the foreground rows of
    each row's mean over its pixels (0 without foreground)."""
    logit = _class_channel(mask_logits, classes)
    bce = torch.clamp(logit, min=0) - logit * targets.float() + torch.log1p(torch.exp(-torch.abs(logit)))
    w = fg.float()
    return (bce.mean(dim=(1, 2)) * w).sum() / comm.global_normalizer(w.sum())


def mask_rcnn_inference(mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """The predicted class's channel through the sigmoid: (N, M, M, K), (N,) -> (N, M, M)."""
    return torch.sigmoid(_class_channel(mask_logits, classes))


def _aligned_samples(lo: torch.Tensor, size: torch.Tensor, n: int, limit: int):
    """The aligned RoIAlign sample coordinates lo + (i + 0.5) * size / n - 0.5,
    i < n, clipped to [0, limit - 1]: (..., n) floor index, next index and
    the fraction past the floor."""
    i = torch.arange(n, dtype=lo.dtype, device=lo.device) + 0.5
    t = i * size[..., None]
    s = lo[..., None] + t / torch.full_like(t, float(n)) - 0.5
    s = torch.clamp(s, 0.0, limit - 1.0)
    i0 = torch.floor(s)
    return i0.long(), torch.clamp(i0.long() + 1, max=limit - 1), s - i0


@torch.no_grad()
def crop_mask_targets(canvas: torch.Tensor, gt_idx: torch.Tensor, boxes: torch.Tensor, out_size: int,
                      stride: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """The mask targets: canvas (B, G, Hm, Wm) {0, 1} at `stride`, each
    sampled row's matched instance gt_idx (B, S) and box (B, S, 4) in image
    coordinates -> (B, S, out_size, out_size) {0, 1} float32."""
    b, g, hm, wm = canvas.shape
    s = gt_idx.shape[1]
    sr = max(sampling_ratio, 1)
    n = out_size * sr
    bx = boxes.float() / torch.full_like(boxes.float(), float(stride))
    x1, y1, x2, y2 = bx.unbind(-1)
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    y0, y1i, ly = _aligned_samples(y1, bh, n, hm)  # (B, S, n)
    x0, x1i, lx = _aligned_samples(x1, bw, n, wm)
    base = (torch.arange(b, device=canvas.device)[:, None] * g + gt_idx.long()) * (hm * wm)  # (B, S)
    flat = canvas.reshape(-1)

    def tap(rows, cols):
        idx = base[..., None, None] + rows[..., :, None] * wm + cols[..., None, :]
        return flat[idx]  # (B, S, n, n)

    ly, lx = ly[..., :, None], lx[..., None, :]
    v = (tap(y0, x0) * (1 - ly) * (1 - lx) + tap(y0, x1i) * (1 - ly) * lx
         + tap(y1i, x0) * ly * (1 - lx) + tap(y1i, x1i) * ly * lx)
    v = v.reshape(b, s, out_size, sr, out_size, sr).mean(dim=(3, 5))
    return (v >= 0.5).float()


def _paste_taps(s: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    i0 = torch.floor(s)
    f = s - i0
    i0 = i0.long()
    w0 = (1 - f) * ((i0 >= 0) & (i0 <= m - 1))
    w1 = f * ((i0 + 1 >= 0) & (i0 + 1 <= m - 1))
    return torch.clamp(i0, 0, m - 1), w0, torch.clamp(i0 + 1, 0, m - 1), w1


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor, image_hw: Tuple[int, int],
                         threshold: float = 0.5) -> torch.Tensor:
    """(N, M, M) probabilities in each box's frame, (N, 4) boxes -> (N, H, W)
    bool masks in the image."""
    h_img, w_img = int(image_hw[0]), int(image_hw[1])
    n, m = masks.shape[:2]
    out = torch.zeros((n, h_img, w_img), dtype=torch.bool, device=masks.device)
    ys = torch.arange(h_img, dtype=torch.float32, device=masks.device) + 0.5
    xs = torch.arange(w_img, dtype=torch.float32, device=masks.device) + 0.5
    for i in range(n):
        x1, y1, x2, y2 = boxes[i].float()
        w = torch.clamp(x2 - x1, min=1e-3)
        h = torch.clamp(y2 - y1, min=1e-3)
        r0, wy0, r1, wy1 = _paste_taps((ys - y1) / h * m - 0.5, m)
        c0, wx0, c1, wx1 = _paste_taps((xs - x1) / w * m - 0.5, m)
        mk = masks[i].float()
        v = (mk[r0][:, c0] * wy0[:, None] * wx0[None, :] + mk[r0][:, c1] * wy0[:, None] * wx1[None, :]
             + mk[r1][:, c0] * wy1[:, None] * wx0[None, :] + mk[r1][:, c1] * wy1[:, None] * wx1[None, :])
        out[i] = v >= threshold
    return out


def foreground_rows(batch_size_per_image: int, positive_fraction: float) -> int:
    """The sampler's quota of foreground rows an image:
    int(batch_size_per_image * positive_fraction) positives, packed first.
    The mask branch trains on that many leading rows of each image, or on
    more where keys tied at the quota's threshold kept more positives
    (roi_heads `_mask_losses`), so it sees every foreground row (detectron2
    runs it on the foreground alone; JAX runs it on every row and masks the
    loss: the loss and its gradients are the same)."""
    return min(batch_size_per_image, int(batch_size_per_image * positive_fraction))


def mask_branch_losses(head: MaskRCNNConvUpsampleHead, regions: torch.Tensor, canvas: Optional[torch.Tensor],
                       boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor, matched_idx: torch.Tensor,
                       num_classes: int, canvas_stride: float) -> torch.Tensor:
    """`loss_mask` of the leading rows of each image: regions (B*F, P, P, C)
    pooled for boxes (B, F, 4) with their sampled classes, validity and
    matched instances (B, F)."""
    if canvas is None:
        raise ValueError("MASK_ON training needs DetBatch.gt_masks (TPU.MASK_CANVAS_STRIDE canvases)")
    logits = head(regions)
    targets = crop_mask_targets(canvas, matched_idx, boxes, logits.shape[1], stride=canvas_stride)
    n = classes.numel()
    flat_classes = classes.reshape(n)
    fg = valid.reshape(n) & (flat_classes >= 0) & (flat_classes < num_classes)
    return mask_rcnn_loss(logits, targets.reshape(n, *targets.shape[2:]), flat_classes, fg)
