"""The plain detectron2 ResNet and its FPN (counterparts of
cddmsl_tpu/models/backbone/resnet.py `D2ResNet`, `D2Bottleneck` and `FPN`,
as JAX's GeneralizedRCNN and FPNRCNN build them: FrozenBN, no deformable
stage).

`D2ResNet` takes RESNETS.NUM_GROUPS x WIDTH_PER_GROUP bottleneck channels
(ResNeXt: a grouped 3x3), the stride in the 1x1 or in the 3x3
(STRIDE_IN_1X1), and RES5_DILATION: at 2 res5 keeps stride 16 and dilates
its 3x3s (the DC5 family). `FPN` puts detectron2's lateral and output convs
on res2..res5 and adds p6, a stride-2 subsample of p5.

Layout and dtypes as in clip_resnet.py: NHWC at the public methods, NCHW in
`torch.channels_last` inside, float32 parameters cast to the activations'
dtype. Submodule names follow detectron2's checkpoint keys (stem.conv1,
stem.conv1.norm, res2.0.conv1, res2.0.shortcut.norm, ...; under the FPN
bottom_up.*, fpn_lateral2, fpn_output2, ...), so a reference `.pth` loads by
a prefix swap.
"""

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import D2_RESNET_SPECS
from .clip_resnet import FrozenBatchNorm2d, _nchw, _nhwc


class ConvNorm(nn.Conv2d):
    """A bias-free conv followed by its FrozenBN (detectron2's Conv2d with
    `norm`); its float32 weight is cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation, groups=groups,
                         bias=False)
        self.norm = FrozenBatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding, self.dilation, self.groups)
        return self.norm(y)


class D2Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped, dilated) -> 1x1, each with FrozenBN, the stride
    in the first 1x1 or in the 3x3, and a projection shortcut where the
    stride or the width changes."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int = 1, stride_in_1x1: bool = True,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(cin, bottleneck, 1, stride=s1)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, stride=s3, padding=dilation, dilation=dilation, groups=groups)
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
    as CLIPFastRCNN's offline tower does (JAX's tree holds no res5 there).
    `num_groups` x `width_per_group` is res2's bottleneck width (doubling
    each stage), `res2_out_channels` its output width; with
    `res5_dilation` 2 res5 keeps res4's stride."""

    def __init__(self, depth: int = 50, res5: bool = True, num_groups: int = 1, width_per_group: int = 64,
                 stride_in_1x1: bool = True, res5_dilation: int = 1, res2_out_channels: int = 256):
        super().__init__()
        self.stem = Stem(64)
        cin, bottleneck, cout = 64, num_groups * width_per_group, res2_out_channels
        self.out_channels = {}
        for i, n in enumerate(D2_RESNET_SPECS[depth][:4 if res5 else 3]):
            name = f"res{i + 2}"
            dilation = res5_dilation if name == "res5" else 1
            stride = 1 if i == 0 or dilation > 1 else 2
            kw = dict(stride_in_1x1=stride_in_1x1, dilation=dilation, groups=num_groups)
            blocks = [D2Bottleneck(cin, bottleneck, cout, stride, **kw)]
            blocks += [D2Bottleneck(cout, bottleneck, cout, **kw) for _ in range(1, n)]
            self.add_module(name, nn.Sequential(*blocks))
            self.out_channels[name] = cout
            cin, bottleneck, cout = cout, bottleneck * 2, cout * 2

    def forward(self, x: torch.Tensor, out_features: Sequence[str] = ("res4",)) -> Dict[str, torch.Tensor]:
        """x: (N, H, W, 3) in the compute dtype -> the maps `out_features`
        names of res2 (stride 4) .. res5 (stride 32, 16 when dilated), NHWC."""
        x = self.stem(_nchw(x))
        out = {}
        last = "res5" if "res5" in out_features else "res4"
        for name in ("res2", "res3", "res4", "res5"):
            x = getattr(self, name)(x)
            if name in out_features:
                out[name] = _nhwc(x)
            if name == last:
                return out
        return out

    def res5_forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, P, P, 1024) pooled crops -> (N, P/2, P/2, 2048), NHWC."""
        return _nhwc(self.res5(_nchw(x)))


def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), layer.stride, layer.padding)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """jax.image.resize's "nearest" source rows for m -> n:
    floor((i + 0.5) * m / n) in float32, rounded as numpy rounds each
    operation (torch's "nearest-exact" computes the same formula from a
    rounded scale m / n; "nearest" is floor(i * m / n))."""
    i = np.arange(n, dtype=np.float32)
    src = np.floor((i + np.float32(0.5)) * np.float32(m) / np.float32(n)).astype(np.int64)
    return torch.from_numpy(src).to(device)


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W) as jax.image.resize(..., "nearest")
    resizes a map, along each axis whose size changes."""
    h, w = x.shape[2:]
    if h != hw[0]:
        x = x.index_select(2, _nearest_index(h, hw[0], x.device))
    if w != hw[1]:
        x = x.index_select(3, _nearest_index(w, hw[1], x.device))
    return x


class FPN(nn.Module):
    """detectron2's FPN over a `D2ResNet` (`bottom_up`): a 1x1 lateral conv
    on each of res2..res5, the top-down sum with the coarser level resized
    by nearest neighbour to the lateral's size (not a fixed x2: at a pad
    that is a multiple of 16 and not of 32 p5 is not half of p4), a 3x3
    output conv per level, and p6 = p5[::2, ::2] (a 1x1 max-pool of stride
    2)."""

    def __init__(self, bottom_up: D2ResNet, out_channels: int = 256):
        super().__init__()
        self.bottom_up = bottom_up
        self.out_channels = out_channels
        for level in range(2, 6):
            cin = bottom_up.out_channels[f"res{level}"]
            self.add_module(f"fpn_lateral{level}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_output{level}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (N, H, W, 3) -> {"p2": (N, H/4, W/4, C), ..., "p6"}, NHWC."""
        feats = self.bottom_up(x, ("res2", "res3", "res4", "res5"))
        laterals = [_conv(getattr(self, f"fpn_lateral{level}"), _nchw(feats[f"res{level}"])) for level in range(2, 6)]
        results = [laterals[-1]]
        for lat in laterals[-2::-1]:
            results.insert(0, lat + resize_nearest(results[0], lat.shape[2:]))
        out = {f"p{level}": _nhwc(_conv(getattr(self, f"fpn_output{level}"), r))
               for level, r in zip(range(2, 6), results)}
        out["p6"] = out["p5"][:, ::2, ::2]
        return out
