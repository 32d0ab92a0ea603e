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
are. The offline backbone maps as the backbone does. The plain tower
(`D2ResNet`: stem_conv1, stem_bn1, res{s}_{i}/conv{1,2,3}, bn{1,2,3},
shortcut, shortcut_bn) maps to detectron2's names (backbone.stem.conv1,
its .norm, backbone.res{s}.{i}.conv{1,2,3}, .shortcut and their .norm);
the linear classifier's cls_score Dense to `cls_score.weight` and `.bias`.

A JAX `FPNRCNN` or `FPNProposalNetwork` tree (it has `fpn`, or for DC5 a
`roi_heads` with `box_head_fc1`) converts by the FPN family's rules: the
tower under `backbone.bottom_up.` (`backbone.` under DC5),
fpn/lateral_res{l} and output_res{l} to `backbone.fpn_lateral{l}` and
`backbone.fpn_output{l}`, `box_head_fc{i}` to `roi_heads.box_head.fc{i}`
(fc1's rows in JAX's HWC order of the pooled map, as the port's head reads
it). A JAX `ProposalNetwork` tree is the plain tower and an RPN head, which
the default rules map.

A JAX `CLIPFastRCNN` tree (it has `offline_proposal_generator`) converts
by its own rules, chosen by the module and not by a tower's name: its
`offline_backbone` is the plain `D2ResNet` (detectron2's names under
`offline_backbone.`), not the CLIP copy `GeneralizedRCNN` keeps there, and
its offline RPN head goes to `offline_proposal_generator.rpn_head.`.

`convert_jax_text_params` and `convert_jax_pretrain_params` do the same
for a JAX `CLIPTextEncoder` tree and a `PretrainFastRCNN` tree (the
student and teacher backbones, the text tower `lang_encoder`, the concept
pool and the logit scale): the text tower's Dense kernels (out_proj, the
MLP) are transposed, `resblocks_{i}` becomes `transformer.resblocks.{i}`,
`mlp_c_fc` becomes `mlp.c_fc`; `in_proj_weight` is (3C, C) in both.

`convert_jax_mt_state` carries the mean-teacher trainer's `MTState` across:
the student and the teacher through `convert_jax_params`, the
discriminator's convs HWIO -> OIHW.

`convert_jax_caption_params` does the same for the JAX package's
`ClipCaptionModel` tree (its `clip_project` mapper and its GPT-2) into
`models.caption.ClipCaptionModel`'s names (`clip_project.*`,
`gpt.transformer.*`); GPT-2's Dense kernels are HF Conv1D weights as they
are, (in, out).
"""

import math
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


def _text_rules(name: str):
    """A CLIPTextEncoder under `name` ("" for the bare tower), in both trees."""
    j, t = (f"{name}/", f"{name}.") if name else ("", "")
    block = rf"{j}resblocks_(\d+)"
    return (
        (rf"{j}token_embedding", rf"{t}token_embedding.weight", "copy"),
        (rf"{j}(positional_embedding|text_projection)", rf"{t}\1", "copy"),
        (rf"{j}ln_final/scale", rf"{t}ln_final.weight", "copy"),
        (rf"{j}ln_final/bias", rf"{t}ln_final.bias", "copy"),
        (rf"{block}/attn/in_proj_(weight|bias)", rf"{t}transformer.resblocks.\1.attn.in_proj_\2", "copy"),
        (rf"{block}/attn/out_proj/kernel", rf"{t}transformer.resblocks.\1.attn.out_proj.weight", "dense"),
        (rf"{block}/attn/out_proj/bias", rf"{t}transformer.resblocks.\1.attn.out_proj.bias", "copy"),
        (rf"{block}/(ln_[12])/scale", rf"{t}transformer.resblocks.\1.\2.weight", "copy"),
        (rf"{block}/(ln_[12])/bias", rf"{t}transformer.resblocks.\1.\2.bias", "copy"),
        (rf"{block}/mlp_(c_fc|c_proj)/kernel", rf"{t}transformer.resblocks.\1.mlp.\2.weight", "dense"),
        (rf"{block}/mlp_(c_fc|c_proj)/bias", rf"{t}transformer.resblocks.\1.mlp.\2.bias", "copy"),
    )


# (JAX path regex, torch key template, layout)
_BACKBONE_RULES: Tuple[Tuple[str, str, str], ...] = (
    (r"backbone/(conv[123])/kernel", r"backbone.\1.weight", "conv"),
    (rf"backbone/(bn[123])/{_BN}", r"backbone.\1.\2", "copy"),
    (r"backbone/layer(\d)_(\d+)/(conv[123])/kernel", r"backbone.layer\1.\2.\3.weight", "conv"),
    (rf"backbone/layer(\d)_(\d+)/(bn[123])/{_BN}", r"backbone.layer\1.\2.\3.\4", "copy"),
    (r"backbone/layer(\d)_(\d+)/downsample_conv/kernel", r"backbone.layer\1.\2.downsample.0.weight", "conv"),
    (rf"backbone/layer(\d)_(\d+)/downsample_bn/{_BN}", r"backbone.layer\1.\2.downsample.1.\3", "copy"),
    (r"backbone/attnpool/positional_embedding", r"backbone.attnpool.positional_embedding", "copy"),
    (r"backbone/attnpool/([qkvc]_proj)/kernel", r"backbone.attnpool.\1.weight", "dense"),
    (r"backbone/attnpool/([qkvc]_proj)/bias", r"backbone.attnpool.\1.bias", "copy"),
)
def _d2_tower_rules(name: str):
    """The plain tower, D2ResNet, under `name`: detectron2's names, each norm
    under its conv."""
    return (
        (rf"{name}/stem_conv1/kernel", rf"{name}.stem.conv1.weight", "conv"),
        (rf"{name}/stem_bn1/{_BN}", rf"{name}.stem.conv1.norm.\1", "copy"),
        (rf"{name}/res(\d)_(\d+)/(conv[123]|shortcut)/kernel", rf"{name}.res\1.\2.\3.weight", "conv"),
        (rf"{name}/res(\d)_(\d+)/bn([123])/{_BN}", rf"{name}.res\1.\2.conv\3.norm.\4", "copy"),
        (rf"{name}/res(\d)_(\d+)/shortcut_bn/{_BN}", rf"{name}.res\1.\2.shortcut.norm.\3", "copy"),
    )


def _rpn_rules(name: str):
    """A StandardRPNHead under `name`/head -> `name`.rpn_head."""
    return (
        (rf"{name}/head/(conv|objectness_logits|anchor_deltas)/kernel", rf"{name}.rpn_head.\1.weight", "conv"),
        (rf"{name}/head/(conv|objectness_logits|anchor_deltas)/bias", rf"{name}.rpn_head.\1.bias", "copy"),
    )


_D2_BACKBONE_RULES = _d2_tower_rules("backbone")
_BOX_PREDICTOR_RULES: Tuple[Tuple[str, str, str], ...] = (
    (r"roi_heads/box_predictor/cls_score_weight", r"roi_heads.box_predictor.cls_score.weight", "copy"),
    (r"roi_heads/box_predictor/cls_score/kernel", r"roi_heads.box_predictor.cls_score.weight", "dense"),
    (r"roi_heads/box_predictor/cls_score/bias", r"roi_heads.box_predictor.cls_score.bias", "copy"),
    (r"roi_heads/box_predictor/bbox_pred/kernel", r"roi_heads.box_predictor.bbox_pred.weight", "dense"),
    (r"roi_heads/box_predictor/bbox_pred/bias", r"roi_heads.box_predictor.bbox_pred.bias", "copy"),
)
_RULES: Tuple[Tuple[str, str, str], ...] = (
    *_BACKBONE_RULES,
    *_D2_BACKBONE_RULES,
    *_rpn_rules("proposal_generator"),
    *_BOX_PREDICTOR_RULES,
    *_mapper_rules("v2l_mapper"),
    *_projector_rules("projector"),
    *_projector_rules("image_projector"),
)
# CLIPFastRCNN: the CLIP tower, the offline plain tower and its RPN, the box
# predictor; no tower takes another's rules
_CLIP_FAST_RCNN_RULES: Tuple[Tuple[str, str, str], ...] = (
    *_BACKBONE_RULES,
    *_d2_tower_rules("offline_backbone"),
    *_rpn_rules("offline_proposal_generator"),
    *_BOX_PREDICTOR_RULES,
)



def _fpn_family_rules(tower: str):
    """FPNRCNN and FPNProposalNetwork with the tower under `tower`."""
    return (
        *((pattern, template.replace("backbone", tower, 1), layout)
          for pattern, template, layout in _d2_tower_rules("backbone")),
        (r"fpn/(lateral|output)_res(\d)/kernel", r"backbone.fpn_\1\2.weight", "conv"),
        (r"fpn/(lateral|output)_res(\d)/bias", r"backbone.fpn_\1\2.bias", "copy"),
        *_rpn_rules("proposal_generator"),
        (r"roi_heads/box_head_fc([12])/kernel", r"roi_heads.box_head.fc\1.weight", "dense"),
        (r"roi_heads/box_head_fc([12])/bias", r"roi_heads.box_head.fc\1.bias", "copy"),
        *_BOX_PREDICTOR_RULES,
    )


_FPN_RULES = _fpn_family_rules("backbone.bottom_up")
_DC5_RULES = _fpn_family_rules("backbone")
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
_PRETRAIN_RULES: Tuple[Tuple[str, str, str], ...] = (
    *_BACKBONE_RULES,
    *_text_rules("lang_encoder"),
    (r"(concept_emb|logit_scale)", r"\1", "copy"),
)
_DISCRIMINATOR_RULES: Tuple[Tuple[str, str, str], ...] = (
    (r"(conv1|conv2|classifier)/kernel", r"\1.weight", "conv"),
    (r"(conv1|conv2|classifier)/bias", r"\1.bias", "copy"),
)
_OFFLINE = "offline_backbone"
# towers that take the backbone's rules under their own name
_BACKBONE_TWINS = (_OFFLINE, "teacher_backbone")
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


def _convert(params: Mapping[str, Any], rules, what: str, twins=_BACKBONE_TWINS) -> Dict[str, torch.Tensor]:
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(params):
        tower, _, rest = path.partition("/")
        twin = tower in twins  # the backbone's rules, under another name
        for pattern, template, layout in rules:
            m = re.fullmatch(pattern, "backbone/" + rest if twin else path)
            if m:
                arr = _LAYOUT[layout](np.asarray(val, dtype=np.float32))
                key = m.expand(template)
                state[tower + key[len("backbone"):] if twin else key] = torch.tensor(np.ascontiguousarray(arr))
                break
        else:
            raise KeyError(f"{what}: no mapping for JAX parameter {path!r}")
    return state


def convert_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GeneralizedRCNN, FPNRCNN, ProposalNetwork, FPNProposalNetwork or
    CLIPFastRCNN params (with or without the
    top-level 'params' key) -> state dict; raises on a key it does not
    map."""
    tree = params["params"] if set(params) == {"params"} else params
    if "offline_proposal_generator" in tree:
        return _convert(tree, _CLIP_FAST_RCNN_RULES, "convert_jax_params (CLIPFastRCNN)", twins=())
    if "fpn" in tree:
        return _convert(tree, _FPN_RULES, "convert_jax_params (FPN)", twins=())
    if "box_head_fc1" in tree.get("roi_heads", {}):
        return _convert(tree, _DC5_RULES, "convert_jax_params (DC5)", twins=())
    return _convert(tree, _RULES, "convert_jax_params")


def convert_jax_text_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX CLIPTextEncoder params (with or without 'params') -> the state
    dict of `models.backbone.text_encoder.CLIPTextEncoder`."""
    return _convert(params, _text_rules(""), "convert_jax_text_params")


def convert_jax_pretrain_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX PretrainFastRCNN params (with or without 'params') -> the state
    dict of `models.clip_rcnn.PretrainFastRCNN`: both backbones, the text
    tower under `lang_encoder.`, `concept_emb` and `logit_scale`."""
    return _convert(params, _PRETRAIN_RULES, "convert_jax_pretrain_params")


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
    (0.01) embeddings, as the JAX package initialises them; for the text
    tower 1/sqrt(fan_in) attention and projection weights and normal (0.02)
    token embeddings; a normal (0.01) concept pool and a logit scale of
    log(1 / 0.07). For runs that
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
            head = name.startswith(("proposal_generator", "offline_proposal_generator"))
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
            normal(mod.weight, 0.02 if name.endswith(("wte", "token_embedding")) else 0.01)
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
        elif name.endswith(("in_proj_weight", "text_projection")):
            normal(p, p.shape[1 if name.endswith("in_proj_weight") else 0] ** -0.5)
        elif name == "concept_emb":
            normal(p, 0.01)
        elif name == "logit_scale":
            p.fill_(math.log(1 / 0.07))
    return model
