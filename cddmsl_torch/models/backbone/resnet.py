"""The plain detectron2 ResNet of the R50-C4 baselines (counterpart of
cddmsl_tpu/models/backbone/resnet.py `D2ResNet` and `D2Bottleneck`, as JAX's
GeneralizedRCNN builds them: stride in the 1x1, one group of width 64,
FrozenBN, no deformable stage).

Layout and dtypes as in clip_resnet.py: NHWC at the public methods, NCHW in
`torch.channels_last` inside, float32 parameters cast to the activations'
dtype. Submodule names follow detectron2's checkpoint keys (stem.conv1,
stem.conv1.norm, res2.0.conv1, res2.0.shortcut.norm, ...), so a reference
`.pth` loads by a prefix swap.
"""

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...config import D2_RESNET_SPECS
from .clip_resnet import Conv2d, FrozenBatchNorm2d, _nchw, _nhwc


class ConvNorm(Conv2d):
    """A bias-free conv followed by its FrozenBN (detectron2's Conv2d with
    `norm`)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.norm = FrozenBatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class D2Bottleneck(nn.Module):
    """1x1 (carrying the stride) -> 3x3 -> 1x1, each with FrozenBN, and a
    projection shortcut where the stride or the width changes."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvNorm(cin, bottleneck, 1, stride=stride)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, padding=1)
        self.conv3 = ConvNorm(bottleneck, cout, 1)
        self.shortcut = ConvNorm(cin, cout, 1, stride=stride) if stride > 1 or cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class Stem(nn.Module):
    """7x7/2 conv, FrozenBN, ReLU, 3x3/2 max-pool over a pad of 1 (the pad
    never wins the max: JAX pads with -inf)."""

    def __init__(self, cout: int = 64):
        super().__init__()
        self.conv1 = ConvNorm(3, cout, 7, stride=2, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


class D2ResNet(nn.Module):
    """The stem and res2..res5 of MODEL.RESNETS.DEPTH. `forward` stops after
    res4 unless the call asks for res5; the C4 head runs res5 on the
    pooled crops (`res5_forward`). Without `res5` the tower ends at res4,
    as CLIPFastRCNN's offline tower does (JAX's tree holds no res5 there)."""

    def __init__(self, depth: int = 50, res5: bool = True):
        super().__init__()
        self.stem = Stem(64)
        cin, bottleneck, cout = 64, 64, 256
        for i, n in enumerate(D2_RESNET_SPECS[depth][:4 if res5 else 3]):
            stride = 1 if i == 0 else 2
            blocks = [D2Bottleneck(cin, bottleneck, cout, stride)]
            blocks += [D2Bottleneck(cout, bottleneck, cout) for _ in range(1, n)]
            self.add_module(f"res{i + 2}", nn.Sequential(*blocks))
            cin, bottleneck, cout = cout, bottleneck * 2, cout * 2

    def forward(self, x: torch.Tensor, out_features: Sequence[str] = ("res4",)) -> Dict[str, torch.Tensor]:
        """x: (N, H, W, 3) in the compute dtype -> the maps `out_features`
        names of {"res4": (N, H/16, W/16, 1024), "res5": (N, H/32, W/32, 2048)},
        NHWC."""
        x = self.res4(self.res3(self.res2(self.stem(_nchw(x)))))
        out = {"res4": _nhwc(x)} if "res4" in out_features else {}
        if "res5" in out_features:
            out["res5"] = _nhwc(self.res5(x))
        return out

    def res5_forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, P, P, 1024) pooled crops -> (N, P/2, P/2, 2048), NHWC."""
        return _nhwc(self.res5(_nchw(x)))
