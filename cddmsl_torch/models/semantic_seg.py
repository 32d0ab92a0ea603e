"""The semantic branch and the semantic segmentor (counterparts of
cddmsl_tpu/models/extra_meta_archs.py `SemSegFPNHead` and
`SemanticSegmentor`).

`SemSegFPNHead` runs, on each FPN level, a 3x3 conv of 128 channels (with
`norm` "GN" a bias-free conv and `GroupNorm32` of
models/backbone/batch_norm.py), ReLU, and per 2x step down
to the common stride 4 a bilinear resize as `jax.image.resize` computes it,
followed by another conv block except after the last step; the levels are
summed and a 1x1 predictor gives the class logits, cast to float32.
Submodule names are those of JAX's tree: `head_{i}_conv{u}`,
`head_{i}_gn{u}` and `predictor`, `i` the level's place in the head's
features.

`SemanticSegmentor` is the FPN tower (detectron2's ResNet of
RESNETS.DEPTH, FrozenBN, no p6 needed) with the head on IN_FEATURES, the
logits resized bilinearly to the padded image, and the per-pixel cross
entropy over the pixels whose label is not `ignore_value`, divided by their
count (the global count under a process group). It samples nothing: the
trainer's draw is not read. `inference` gives the argmax class map of the
padded image, (B, H, W) int64.

Layout: NHWC at the public methods (the FPN's), NCHW in the head.
"""

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear_nchw
from ..parallel import comm
from .backbone.batch_norm import GroupNorm32
from .backbone.resnet import FPN, D2ResNet, _conv
from .rcnn import DetBatch, normalize
from .sampling import Draw

LEVEL_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
# what JAX's head computes with: the FPN's 256 channels in, 128 in its
# convs, the levels upsampled to stride 4
IN_CHANNELS, CONV_DIM, COMMON_STRIDE = 256, 128, 4


class SemSegFPNHead(nn.Module):
    def __init__(self, num_classes: int, strides: Sequence[int] = (4, 8, 16, 32), norm: str = ""):
        """`strides` are the head's levels' (IN_FEATURES'); `norm` "" (convs
        with a bias) or "GN"."""
        super().__init__()
        if norm not in ("", "GN"):
            raise ValueError(f"SemSegFPNHead norm {norm!r}: '' or 'GN'")
        self.norm = norm
        self.ups = []
        for i, stride in enumerate(strides):
            n_up = (stride // COMMON_STRIDE).bit_length() - 1  # log2
            self.ups.append(n_up)
            for u in range(max(n_up, 1)):
                cin = IN_CHANNELS if u == 0 else CONV_DIM
                self.add_module(f"head_{i}_conv{u}", nn.Conv2d(cin, CONV_DIM, 3, padding=1, bias=norm == ""))
                if norm == "GN":
                    self.add_module(f"head_{i}_gn{u}", GroupNorm32(CONV_DIM))
        self.predictor = nn.Conv2d(CONV_DIM, num_classes, 1)

    def _block(self, x: torch.Tensor, i: int, u: int) -> torch.Tensor:
        x = _conv(getattr(self, f"head_{i}_conv{u}"), x)
        if self.norm == "GN":
            x = getattr(self, f"head_{i}_gn{u}")(x)
        return F.relu(x)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per level (B, H_l, W_l, C) NHWC -> float32 logits (B, K, H/4, W/4)."""
        out = None
        for i, (f, n_up) in enumerate(zip(features, self.ups)):
            x = self._block(f.permute(0, 3, 1, 2), i, 0)
            for u in range(n_up):
                x = resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))
                if u < n_up - 1:
                    x = self._block(x, i, u + 1)
            out = x if out is None else out + x
        return _conv(self.predictor, out).float()


def sem_seg_loss(logits: torch.Tensor, target: torch.Tensor, ignore_value: int = 255) -> torch.Tensor:
    """logits (B, K, H, W) float32, target (B, H, W) int -> the mean over the
    pixels not labelled `ignore_value` of -log_softmax at the label (the
    global count of them under a process group, at least 1)."""
    valid = target != ignore_value
    gt = torch.where(valid, target, torch.zeros_like(target)).long()
    nll = -torch.gather(torch.log_softmax(logits, dim=1), 1, gt[:, None])[:, 0]
    return torch.sum(nll * valid) / comm.global_normalizer(valid.sum().float())


class SemanticSegmentor(nn.Module):
    use_text_emb = False  # no classifier rows for the optimizer to freeze

    def __init__(self, num_classes: int = 54, depth: int = 50, ignore_value: int = 255,
                 in_features: Sequence[str] = ("p2", "p3", "p4", "p5"), head_norm: str = "",
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675), pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ignore_value = ignore_value
        self.in_features = tuple(in_features)
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.backbone = FPN(D2ResNet(depth))
        self.sem_seg_head = SemSegFPNHead(num_classes, tuple(LEVEL_STRIDES[f] for f in self.in_features), head_norm)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """Raw images (B, H, W, 3) -> float32 logits (B, K, H, W) of the
        padded image."""
        feats = self.backbone(normalize(images, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False))
        return resize_bilinear_nchw(self.sem_seg_head([feats[f] for f in self.in_features]), images.shape[1:3])

    def losses(self, batch: DetBatch) -> Dict[str, torch.Tensor]:
        if batch.sem_seg is None:
            raise ValueError("SemanticSegmentor training needs DetBatch.sem_seg: register a sem-seg dataset (the "
                             "loader then maps it with SemSegDatasetMapper)")
        return {"loss_sem_seg": sem_seg_loss(self.logits(batch.image), batch.sem_seg.to(batch.image.device),
                                             self.ignore_value)}

    def cddmsl_losses(self, batch: DetBatch, draw: Draw = None, caption_on: bool = False,
                      kd_regularization: bool = True, enable_caption: bool = True) -> Dict[str, torch.Tensor]:
        """The trainer's loss set: {"loss_sem_seg"}; the draw and the
        caption gates are not read, as in JAX."""
        return self.losses(batch)

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> torch.Tensor:
        """The argmax class map of the padded images (B, H, W); the
        evaluator crops and resizes it (`do_postprocess` changes nothing)."""
        return torch.argmax(self.logits(batch.image), dim=1)
