"""Weights carried across from the JAX package, and a seeded random init.

`convert_jax_params` turns the JAX package's GeneralizedRCNN parameter tree,
given as nested dicts of numpy arrays, into this port's state dict. The torch
names are the OpenAI-CLIP / detectron2 / ClipCap checkpoint keys
(`backbone.layer1.0.downsample.0.weight`,
`proposal_generator.rpn_head.conv.weight`,
`roi_heads.box_predictor.cls_score.weight`,
`v2l_mapper.transformer.layers.0.attn.to_queries.weight`, ...). Layouts:
conv kernels HWIO -> OIHW, Dense kernels (in, out) -> Linear weights
(out, in), LayerNorm scale -> weight; FrozenBN buffers, the positional
embedding, the mapper's prefix and the (K, D) class embeddings copy as they
are. The offline backbone maps as the backbone does.

`convert_jax_mt_state` carries the mean-teacher trainer's `MTState` across:
the student and the teacher through `convert_jax_params`, the
discriminator's convs HWIO -> OIHW.

`convert_jax_caption_params` does the same for the JAX package's
`ClipCaptionModel` tree (its `clip_project` mapper and its GPT-2) into
`models.caption.ClipCaptionModel`'s names (`clip_project.*`,
`gpt.transformer.*`); GPT-2's Dense kernels are HF Conv1D weights as they
are, (in, out).
"""

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.backbone.clip_resnet import FrozenBatchNorm2d
from ..models.gpt2 import Conv1D

_BN = r"(weight|bias|running_mean|running_var)"


def _mapper_rules(name: str):
    """A ClipCap TransformerMapper under `name`, in both trees."""
    layer = rf"{name}/layers_(\d+)"
    return (
        (rf"{name}/linear/kernel", rf"{name}.linear.weight", "dense"),
        (rf"{name}/linear/bias", rf"{name}.linear.bias", "copy"),
        (rf"{name}/prefix_const", rf"{name}.prefix_const", "copy"),
        (rf"{layer}/(norm[12])/scale", rf"{name}.transformer.layers.\1.\2.weight", "copy"),
        (rf"{layer}/(norm[12])/bias", rf"{name}.transformer.layers.\1.\2.bias", "copy"),
        (rf"{layer}/attn/(to_queries|to_keys_values|project)/kernel", rf"{name}.transformer.layers.\1.attn.\2.weight",
         "dense"),
        (rf"{layer}/attn/project/bias", rf"{name}.transformer.layers.\1.attn.project.bias", "copy"),
        (rf"{layer}/mlp_(fc[12])/kernel", rf"{name}.transformer.layers.\1.mlp.\2.weight", "dense"),
        (rf"{layer}/mlp_(fc[12])/bias", rf"{name}.transformer.layers.\1.mlp.\2.bias", "copy"),
    )


def _projector_rules(name: str):
    return (
        (rf"{name}/(fc[12])/kernel", rf"{name}.\1.weight", "dense"),
        (rf"{name}/(fc[12])/bias", rf"{name}.\1.bias", "copy"),
    )


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
    *_mapper_rules("v2l_mapper"),
    *_projector_rules("projector"),
    *_projector_rules("image_projector"),
)
_CAPTION_RULES: Tuple[Tuple[str, str, str], ...] = (
    *_mapper_rules("clip_project"),
    (r"gpt/(wte|wpe)", r"gpt.transformer.\1.weight", "copy"),
    (r"gpt/ln_f/scale", r"gpt.transformer.ln_f.weight", "copy"),
    (r"gpt/ln_f/bias", r"gpt.transformer.ln_f.bias", "copy"),
    (r"gpt/h_(\d+)/(ln_[12])/scale", r"gpt.transformer.h.\1.\2.weight", "copy"),
    (r"gpt/h_(\d+)/(ln_[12])/bias", r"gpt.transformer.h.\1.\2.bias", "copy"),
    (r"gpt/h_(\d+)/(c_attn|c_proj)/kernel", r"gpt.transformer.h.\1.attn.\2.weight", "copy"),
    (r"gpt/h_(\d+)/(c_attn|c_proj)/bias", r"gpt.transformer.h.\1.attn.\2.bias", "copy"),
    (r"gpt/h_(\d+)/mlp_(c_fc|c_proj)/kernel", r"gpt.transformer.h.\1.mlp.\2.weight", "copy"),
    (r"gpt/h_(\d+)/mlp_(c_fc|c_proj)/bias", r"gpt.transformer.h.\1.mlp.\2.bias", "copy"),
)
_DISCRIMINATOR_RULES: Tuple[Tuple[str, str, str], ...] = (
    (r"(conv1|conv2|classifier)/kernel", r"\1.weight", "conv"),
    (r"(conv1|conv2|classifier)/bias", r"\1.bias", "copy"),
)
_OFFLINE = "offline_backbone"
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


def _convert(params: Mapping[str, Any], rules, what: str) -> Dict[str, torch.Tensor]:
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(params):
        tower, _, rest = path.partition("/")
        offline = tower == _OFFLINE  # the backbone's rules, under another name
        for pattern, template, layout in rules:
            m = re.fullmatch(pattern, "backbone/" + rest if offline else path)
            if m:
                arr = _LAYOUT[layout](np.asarray(val, dtype=np.float32))
                key = m.expand(template)
                state[_OFFLINE + key[len("backbone"):] if offline else key] = torch.tensor(np.ascontiguousarray(arr))
                break
        else:
            raise KeyError(f"{what}: no mapping for JAX parameter {path!r}")
    return state


def convert_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GeneralizedRCNN params (with or without the top-level 'params'
    key) -> state dict; raises on a key it does not map."""
    return _convert(params, _RULES, "convert_jax_params")


def convert_jax_mt_state(mt_state) -> Dict[str, Any]:
    """JAX's MTState (numpy or JAX leaves) -> the weights and iteration of
    a mean-teacher save: {"model", "teacher", "discriminator", "iteration"}.
    The optimizer states are not carried across."""
    return {
        "model": convert_jax_params(mt_state.params),
        "teacher": convert_jax_params(mt_state.teacher_params),
        "discriminator": _convert(mt_state.dis_params, _DISCRIMINATOR_RULES, "convert_jax_mt_state"),
        "iteration": int(mt_state.step),
    }


def convert_jax_caption_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ClipCaptionModel params (with or without 'params') -> the state
    dict of `models.caption.ClipCaptionModel`; raises on a key it does not
    map."""
    return _convert(params, _CAPTION_RULES, "convert_jax_caption_params")


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fills every parameter and FrozenBN buffer from `generator` (a CPU
    generator): He-normal convs, 1/sqrt(fan_in) linears, FrozenBN with
    running_var in [0.5, 1.5], LayerNorm scales in [0.5, 1.5], small
    RPN/box-regression heads, a unit-normal mapper prefix; for GPT-2,
    1/sqrt(fan_in) Conv1D weights and normal token (0.02) and position
    (0.01) embeddings, as the JAX package initialises them. For runs that
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
        elif isinstance(mod, nn.LayerNorm):
            uniform(mod.weight, 0.5, 1.5)
            uniform(mod.bias, -0.1, 0.1)
        elif isinstance(mod, Conv1D):
            normal(mod.weight, mod.weight.shape[0] ** -0.5)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 0.02 if name.endswith("wte") else 0.01)
        elif isinstance(mod, nn.Linear):
            regressor = name.endswith("bbox_pred")
            normal(mod.weight, 0.001 if regressor else mod.in_features ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("positional_embedding"):
            normal(p, p.shape[1] ** -0.5)
        elif name.endswith("prefix_const"):
            normal(p, 1.0)
    return model
