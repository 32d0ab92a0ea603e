"""Weights carried across from the JAX package, and a seeded random init.

`convert_jax_params` turns the JAX package's GeneralizedRCNN parameter tree,
given as nested dicts of numpy arrays, into this port's state dict. The torch
names are the OpenAI-CLIP / detectron2 checkpoint keys (`backbone.layer1.0.
downsample.0.weight`, `proposal_generator.rpn_head.conv.weight`,
`roi_heads.box_predictor.cls_score.weight`, ...). Layouts: conv kernels HWIO
-> OIHW, Dense kernels (in, out) -> Linear weights (out, in); FrozenBN
buffers, the positional embedding and the (K, D) class embeddings copy as
they are.
"""

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.backbone.clip_resnet import FrozenBatchNorm2d

# subtrees of the JAX model that inference never reads
SKIPPED_SUBTREES = ("offline_backbone", "v2l_mapper", "projector", "image_projector")

_BN = r"(weight|bias|running_mean|running_var)"
# (JAX path regex, torch key template, layout)
_RULES: Tuple[Tuple[str, str, str], ...] = (
    (r"backbone/(conv[123])/kernel", r"backbone.\1.weight", "conv"),
    (rf"backbone/(bn[123])/{_BN}", r"backbone.\1.\2", "copy"),
    (r"backbone/layer(\d)_(\d+)/(conv[123])/kernel", r"backbone.layer\1.\2.\3.weight", "conv"),
    (rf"backbone/layer(\d)_(\d+)/(bn[123])/{_BN}", r"backbone.layer\1.\2.\3.\4", "copy"),
    (r"backbone/layer(\d)_(\d+)/downsample_conv/kernel", r"backbone.layer\1.\2.downsample.0.weight", "conv"),
    (rf"backbone/layer(\d)_(\d+)/downsample_bn/{_BN}", r"backbone.layer\1.\2.downsample.1.\3", "copy"),
    (r"backbone/attnpool/positional_embedding", r"backbone.attnpool.positional_embedding", "copy"),
    (r"backbone/attnpool/([qkvc]_proj)/kernel", r"backbone.attnpool.\1.weight", "dense"),
    (r"backbone/attnpool/([qkvc]_proj)/bias", r"backbone.attnpool.\1.bias", "copy"),
    (
        r"proposal_generator/head/(conv|objectness_logits|anchor_deltas)/kernel",
        r"proposal_generator.rpn_head.\1.weight",
        "conv",
    ),
    (
        r"proposal_generator/head/(conv|objectness_logits|anchor_deltas)/bias",
        r"proposal_generator.rpn_head.\1.bias",
        "copy",
    ),
    (r"roi_heads/box_predictor/cls_score_weight", r"roi_heads.box_predictor.cls_score.weight", "copy"),
    (r"roi_heads/box_predictor/bbox_pred/kernel", r"roi_heads.box_predictor.bbox_pred.weight", "dense"),
    (r"roi_heads/box_predictor/bbox_pred/bias", r"roi_heads.box_predictor.bbox_pred.bias", "copy"),
)
_LAYOUT = {
    "conv": lambda a: np.transpose(a, (3, 2, 0, 1)),  # HWIO -> OIHW
    "dense": np.transpose,  # (in, out) -> (out, in)
    "copy": lambda a: a,
}


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + "/")
        else:
            yield path, val


def convert_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GeneralizedRCNN params (with or without the top-level 'params'
    key) -> state dict. Skips `SKIPPED_SUBTREES`; raises on any other key it
    does not map."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(params):
        if path.split("/", 1)[0] in SKIPPED_SUBTREES:
            continue
        for pattern, template, layout in _RULES:
            m = re.fullmatch(pattern, path)
            if m:
                arr = _LAYOUT[layout](np.asarray(val, dtype=np.float32))
                state[m.expand(template)] = torch.from_numpy(np.ascontiguousarray(arr))
                break
        else:
            raise KeyError(f"convert_jax_params: no mapping for JAX parameter {path!r}")
    return state


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fills every parameter and FrozenBN buffer from `generator` (a CPU
    generator): He-normal convs, 1/sqrt(fan_in) linears, FrozenBN with
    running_var in [0.5, 1.5], small RPN/box-regression heads. For runs that
    have no JAX checkpoint at hand; the model may live on any device."""

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform(t: torch.Tensor, lo: float, hi: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            uniform(mod.weight, 0.5, 1.0)
            uniform(mod.bias, -0.1, 0.1)
            uniform(mod.running_mean, -0.1, 0.1)
            uniform(mod.running_var, 0.5, 1.5)
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            head = name.startswith("proposal_generator")
            normal(mod.weight, 0.01 if head else (2.0 / fan_in) ** 0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            regressor = name.endswith("bbox_pred")
            normal(mod.weight, 0.001 if regressor else mod.in_features ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("positional_embedding"):
            normal(p, p.shape[1] ** -0.5)
    return model
