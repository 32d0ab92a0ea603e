"""CLIP "ModifiedResNet" backbone (counterpart of
cddmsl_tpu/models/backbone/clip_resnet.py).

The convolutions run NCHW in `torch.channels_last`, so an NHWC tensor and its
NCHW view share one memory layout: the public methods take and return NHWC
as the JAX package does, and the permutes at their edges copy nothing.
Parameters stay float32; each forward casts them to the activations' dtype,
as flax does with `dtype=` and `param_dtype=float32`. Submodule names follow
the OpenAI-CLIP checkpoint keys (conv1, bn1, layer1.0.downsample.0, ...).
"""

from collections import OrderedDict
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear_grid


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    return x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x_nchw: torch.Tensor) -> torch.Tensor:
    return x_nchw.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """Bias-free conv whose float32 weight is cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics: scale and shift are folded in float32
    (eps 1e-5), then cast to the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


class Bottleneck(nn.Module):
    """CLIP bottleneck: all convs stride 1, AvgPool(stride) after conv2, and
    a residual downsample of AvgPool -> 1x1 conv -> BN."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = Conv2d(planes, out_ch, 1)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(
                OrderedDict(
                    [
                        ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                        ("0", Conv2d(inplanes, out_ch, 1)),
                        ("1", FrozenBatchNorm2d(out_ch)),
                    ]
                )
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling with a learned positional embedding. Only the
    CLS query (mean token + position 0) is computed: it is the one output the
    full self-attention keeps. Scores are taken in float32, divided by
    sqrt(head_dim) after the dot, and soft-maxed in float32."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    @staticmethod
    def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) -> (N, output_dim). On a grid other than
        spacial_dim^2 the grid part of the positional embedding is resized
        bilinearly (antialiased when it shrinks), as the JAX module does."""
        n, h, w, c = x.shape
        pos = self.positional_embedding
        if h * w != self.spacial_dim ** 2:
            s = self.spacial_dim
            grid = resize_bilinear_grid(pos[1:].reshape(s, s, -1), (h, w))
            pos = torch.cat([pos[:1], grid.reshape(h * w, -1)], dim=0)
        seq = x.reshape(n, h * w, c)
        cls = seq.mean(dim=1, keepdim=True)
        tokens = torch.cat([cls, seq], dim=1) + pos.to(x.dtype)[None]

        heads = self.num_heads
        hd = c // heads
        q = self._linear(self.q_proj, tokens[:, :1]).reshape(n, heads, hd)
        k = self._linear(self.k_proj, tokens).reshape(n, -1, heads, hd)
        v = self._linear(self.v_proj, tokens).reshape(n, -1, heads, hd)
        attn = torch.einsum("nhd,nkhd->nhk", q.float(), k.float())
        attn = torch.softmax(attn / (hd ** 0.5), dim=-1)
        out = torch.einsum("nhk,nkhd->nhd", attn.to(x.dtype), v).reshape(n, c)
        return self._linear(self.c_proj, out)


class ModifiedResNet(nn.Module):
    """The CLIP ResNet as a C4 detection backbone: `forward` runs the stem
    and res2..res4 and returns the NHWC res4 map, and layer4's full-image
    res5 only when the call asks for it; the RoI head runs layer4
    (`res5_forward`) and the attention pool on pooled crops."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int, width: int = 64, input_resolution: int = 224,
                 attnpool: bool = True):
        """Without `attnpool` the tower has no attention pool: the FPN's
        bottom-up (JAX's tree holds none there, as nothing calls it)."""
        super().__init__()
        w = width
        self.conv1 = Conv2d(3, w // 2, 3, stride=2, padding=1)
        self.bn1 = FrozenBatchNorm2d(w // 2)
        self.conv2 = Conv2d(w // 2, w // 2, 3, padding=1)
        self.bn2 = FrozenBatchNorm2d(w // 2)
        self.conv3 = Conv2d(w // 2, w, 3, padding=1)
        self.bn3 = FrozenBatchNorm2d(w)
        self.avgpool = nn.AvgPool2d(2)

        self._inplanes = w
        self.layer1 = self._make_layer(w, layers[0])
        self.layer2 = self._make_layer(w * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(w * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(w * 8, layers[3], stride=2)
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads, output_dim) if attnpool else None
        self.out_channels = {f"res{i + 2}": w * 4 * 2 ** i for i in range(4)}

    def _make_layer(self, planes: int, blocks: int, stride: int = 1) -> nn.Sequential:
        mods = [Bottleneck(self._inplanes, planes, stride)]
        self._inplanes = planes * Bottleneck.expansion
        mods += [Bottleneck(self._inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        return self.avgpool(x)

    def forward(self, x: torch.Tensor, out_features: Sequence[str] = ("res4",)) -> Dict[str, torch.Tensor]:
        """x: (N, H, W, 3) in the compute dtype -> the maps `out_features`
        names of {"res2": (N, H/4, W/4, C2), ..., "res4": (N, H/16, W/16, C4),
        "res5": (N, H/32, W/32, C5)}; layer4 runs only for res5."""
        x = self._stem(_nchw(x))
        out = {}
        for name, stage in (("res2", self.layer1), ("res3", self.layer2), ("res4", self.layer3)):
            x = stage(x)
            if name in out_features:
                out[name] = _nhwc(x)
        if "res5" in out_features:
            out["res5"] = _nhwc(self.layer4(x))
        return out

    def res5_forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, P, P, C4) pooled crops -> (N, P/2, P/2, C5), NHWC."""
        return _nhwc(self.layer4(_nchw(x)))

    def attnpool_forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C5) -> (N, output_dim) attention-pooled embedding."""
        return self.attnpool(x)

    def global_embed(self, x: torch.Tensor) -> torch.Tensor:
        """Full CLIP visual forward: (N, H, W, 3) -> (N, output_dim)."""
        feats = self._stem(_nchw(x))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            feats = stage(feats)
        return self.attnpool(_nhwc(feats))
