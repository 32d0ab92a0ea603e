"""The plain detectron2 ResNet and its FPN (counterparts of
cddmsl_tpu/models/backbone/resnet.py `D2ResNet`, `D2Bottleneck` and `FPN`,
as JAX's GeneralizedRCNN, FPNRCNN, PanopticFPN and RetinaNet build them).

`D2ResNet` takes RESNETS.NUM_GROUPS x WIDTH_PER_GROUP bottleneck channels
(ResNeXt: a grouped 3x3), the stride in the 1x1 or in the 3x3
(STRIDE_IN_1X1), and RES5_DILATION: at 2 res5 keeps stride 16 and dilates
its 3x3s (the DC5 family), and RESNETS.NORM (`norm`): FrozenBN, or the
trainable GN and SyncBN of models/backbone/batch_norm.py (JAX's
`_make_norm`), and RESNETS.DEFORM_ON_PER_STAGE / DEFORM_MODULATED
(`deform_on_per_stage`, `deform_modulated`): every 3x3 of a stage so
marked is deformable (ops/deform_conv.py), v1, or v2 with a mask. `FPN`
puts detectron2's lateral and output convs on res2..res5
(res3..res5 for RetinaNet), with FPN.NORM after each (the convs then have no
bias), and adds p6, a stride-2 subsample of p5, or RetinaNet's learned
p6/p7 (detectron2's LastLevelP6P7).

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

from ...config import BASIC_BLOCK_DEPTHS, D2_RESNET_SPECS
from ...ops.deform_conv import deform_conv2d
from .batch_norm import head_norm, make_norm
from .clip_resnet import _nchw, _nhwc


class ConvNorm(nn.Conv2d):
    """A bias-free conv followed by its norm (detectron2's Conv2d with
    `norm`: FrozenBN by default); its float32 weight is cast to the input's
    dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, norm: str = "FrozenBN"):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation, groups=groups,
                         bias=False)
        self.norm = make_norm(norm, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding, self.dilation, self.groups)
        return self.norm(y)


class D2Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped, dilated) -> 1x1, each with its norm, the stride
    in the first 1x1 or in the 3x3, and a projection shortcut where the
    stride or the width changes. With `deform` the 3x3 is deformable
    (detectron2's DeformBottleneckBlock, JAX's `deform` branch):
    `conv2_offset`, a 3x3 conv with a bias at conv2's stride and dilation,
    zero at init, predicts 18 offset channels ((dy, dx) per tap), and under
    `deform_modulated` 9 more whose sigmoid is the mask (DCN v2); conv2's
    kernel then samples there (`deform_conv2d`, in float32 inside a
    bfloat16 tower, as JAX casts). A deformable 3x3 is not grouped."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int = 1, stride_in_1x1: bool = True,
                 dilation: int = 1, groups: int = 1, norm: str = "FrozenBN", deform: bool = False,
                 deform_modulated: bool = False):
        super().__init__()
        if deform and groups != 1:
            raise ValueError("a deformable 3x3 with groups > 1 is not built (JAX asserts NUM_GROUPS == 1 there)")
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(cin, bottleneck, 1, stride=s1, norm=norm)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, stride=s3, padding=dilation, dilation=dilation, groups=groups,
                              norm=norm)
        self.deform_modulated = deform_modulated
        self.conv2_offset = nn.Conv2d(bottleneck, (3 if deform_modulated else 2) * 9, 3, stride=s3,
                                      padding=dilation, dilation=dilation) if deform else None
        if deform:
            nn.init.zeros_(self.conv2_offset.weight)
            nn.init.zeros_(self.conv2_offset.bias)
        self.conv3 = ConvNorm(bottleneck, cout, 1, norm=norm)
        self.shortcut = ConvNorm(cin, cout, 1, stride=stride, norm=norm) if stride > 1 or cin != cout else None

    def _deform_conv2(self, x: torch.Tensor) -> torch.Tensor:
        c2, dt = self.conv2, torch.promote_types(x.dtype, torch.float32)
        off = _conv(self.conv2_offset, x).to(dt)
        mask = torch.sigmoid(off[:, 18:]) if self.deform_modulated else None
        y = deform_conv2d(x.to(dt), off[:, :18], c2.weight, mask, stride=c2.stride[0], padding=c2.padding[0],
                          dilation=c2.dilation[0], layout="NCHW")
        return c2.norm(y.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out) if self.conv2_offset is None else self._deform_conv2(out))
        out = self.conv3(out)
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class D2BasicBlock(nn.Module):
    """Two 3x3 convs, each with FrozenBN, and a projection shortcut where
    the stride or the width changes (detectron2's BasicBlock of ResNet-18
    and -34, JAX's `D2BasicBlock`: FrozenBN whatever RESNETS.NORM says,
    never dilated, grouped or deformable)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvNorm(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = ConvNorm(cout, cout, 3, padding=1)
        self.shortcut = ConvNorm(cin, cout, 1, stride=stride) if stride > 1 or cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x)))
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class Stem(nn.Module):
    """7x7/2 conv, its norm, ReLU, 3x3/2 max-pool over a pad of 1 (the pad
    never wins the max: JAX pads with -inf)."""

    def __init__(self, cout: int = 64, norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = ConvNorm(3, cout, 7, stride=2, padding=3, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


class D2ResNet(nn.Module):
    """The stem and res2..res5 of MODEL.RESNETS.DEPTH. `forward` stops after
    res4 unless the call asks for res5; the C4 head runs res5 on the
    pooled crops (`res5_forward`). Without `res5` the tower ends at res4,
    as CLIPFastRCNN's offline tower does (JAX's tree holds no res5 there).
    `num_groups` x `width_per_group` is res2's bottleneck width (doubling
    each stage), `res2_out_channels` its output width; with
    `res5_dilation` 2 res5 keeps res4's stride. `norm` is every conv's
    (RESNETS.NORM); `deform_on_per_stage` (res2..res5) makes every block
    of a stage deformable, v2 under `deform_modulated`. Depths 18 and 34
    stack `D2BasicBlock`s from a res2 of 64 channels, as JAX's tower does
    whatever RES2_OUT_CHANNELS, NORM, NUM_GROUPS and the deformable stages
    say (its stem takes `norm`)."""

    def __init__(self, depth: int = 50, res5: bool = True, num_groups: int = 1, width_per_group: int = 64,
                 stride_in_1x1: bool = True, res5_dilation: int = 1, res2_out_channels: int = 256,
                 norm: str = "FrozenBN", deform_on_per_stage: Sequence[bool] = (False,) * 4,
                 deform_modulated: bool = False):
        super().__init__()
        self.stem = Stem(64, norm)
        basic = depth in BASIC_BLOCK_DEPTHS
        cin, bottleneck, cout = 64, num_groups * width_per_group, 64 if basic else res2_out_channels
        self.out_channels = {}
        for i, n in enumerate(D2_RESNET_SPECS[depth][:4 if res5 else 3]):
            name = f"res{i + 2}"
            dilation = res5_dilation if name == "res5" else 1
            stride = 1 if i == 0 or dilation > 1 else 2
            kw = dict(stride_in_1x1=stride_in_1x1, dilation=dilation, groups=num_groups, norm=norm,
                      deform=bool(deform_on_per_stage[i]), deform_modulated=deform_modulated)
            if basic:
                blocks = [D2BasicBlock(cin if j == 0 else cout, cout, stride if j == 0 else 1) for j in range(n)]
            else:
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
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride, layer.padding, layer.dilation)


class NormConv2d(nn.Conv2d):
    """detectron2's Conv2d with an optional `norm` after it (a head's
    FPN.NORM or ROI_*_HEAD.NORM): with a norm the conv has no bias. Its
    float32 weight is cast to the input's dtype; NCHW in and out."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, norm: str = ""):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=norm == "")
        self.norm = head_norm(norm, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(self, x)
        return y if self.norm is None else self.norm(y)


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
    """detectron2's FPN over a bottom-up tower (`bottom_up`: a `D2ResNet`,
    or CLIP's ModifiedResNet under MODEL.BACKBONE.NAME
    build_clip_resnet_fpn_backbone): a 1x1 lateral conv on each of the
    tower's `in_levels` (res2..res5, or res3..res5), the top-down sum with
    the coarser level resized by nearest neighbour to the lateral's size
    (not a fixed x2: at a pad that is a multiple of 16 and not of 32 p5 is
    not half of p4), a 3x3 output conv per level, each conv followed by
    `norm` (FPN.NORM: "", GN or SyncBN; without a bias under a norm), and
    the top block: `top_block` "p6", p6 = p5[::2, ::2] (a 1x1 max-pool of
    stride 2), or "p6p7", RetinaNet's two learned stride-2 3x3 convs fed
    from the last bottom-up map (res5, not p5), p7 reading relu(p6).
    Outputs are named by stride (p{level}); JAX names them by position
    (p2.. over in_levels), which only its converters see."""

    def __init__(self, bottom_up: nn.Module, out_channels: int = 256, in_levels=(2, 3, 4, 5), norm: str = "",
                 top_block: str = "p6"):
        super().__init__()
        if top_block not in ("p6", "p6p7"):
            raise ValueError(f"FPN top block {top_block!r}: p6 or p6p7")
        self.bottom_up = bottom_up
        self.out_channels = out_channels
        self.in_levels = tuple(in_levels)
        self.top_block_kind = top_block
        in_channels = bottom_up.out_channels
        for level in self.in_levels:
            cin = in_channels[f"res{level}"]
            self.add_module(f"fpn_lateral{level}", NormConv2d(cin, out_channels, 1, norm=norm))
            self.add_module(f"fpn_output{level}", NormConv2d(out_channels, out_channels, 3, padding=1, norm=norm))
        if top_block == "p6p7":
            last = in_channels[f"res{self.in_levels[-1]}"]
            self.top_block = nn.Module()
            self.top_block.p6 = nn.Conv2d(last, out_channels, 3, stride=2, padding=1)
            self.top_block.p7 = nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (N, H, W, 3) -> {"p2": (N, H/4, W/4, C), ..., "p6"} (or p3..p7
        with the p6p7 top block), NHWC."""
        feats = self.bottom_up(x, tuple(f"res{level}" for level in self.in_levels))
        laterals = [getattr(self, f"fpn_lateral{level}")(_nchw(feats[f"res{level}"])) for level in self.in_levels]
        results = [laterals[-1]]
        for lat in laterals[-2::-1]:
            results.insert(0, lat + resize_nearest(results[0], lat.shape[2:]))
        out = {f"p{level}": _nhwc(getattr(self, f"fpn_output{level}")(r)) for level, r in zip(self.in_levels, results)}
        last = self.in_levels[-1]
        if self.top_block_kind == "p6p7":
            p6 = _conv(self.top_block.p6, _nchw(feats[f"res{last}"]))
            out[f"p{last + 1}"] = _nhwc(p6)
            out[f"p{last + 2}"] = _nhwc(_conv(self.top_block.p7, F.relu(p6)))
        else:
            out[f"p{last + 1}"] = out[f"p{last}"][:, ::2, ::2]
        return out
