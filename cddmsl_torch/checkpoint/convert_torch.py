"""The reference's `.pth` files (counterpart of `load_rcnn_weights`,
`detect_dialect`, `load_offline_backbone`, `load_clipcap_mapper` and
`load_text_emb_classifier` in cddmsl_tpu/checkpoint/convert_torch.py, and of
`convert_hf_gpt2` in cddmsl_tpu/models/gpt2.py).

The port's modules carry the reference checkpoint keys, so each load is a
prefix swap into the model's own state: the RegionCLIP visual tower
("backbone.*", else "visual.*") into the frozen offline backbone, the ClipCap
mapper ("clip_project.*") into `v2l_mapper`, and the text-embedding tensor
into the classifier rows. A detector checkpoint (MODEL.WEIGHTS) loads by its
dialect: "d2_rcnn" (backbone into both backbones, RPN head, box predictor
without its background row), "oai_clip" (the visual tower into both
backbones) or "clipcap" (the mapper). Only the keys the JAX converters take
are read: the rest of the file, and every tensor of the model it names no
key for, is left as it is. A key whose shape differs raises, where the JAX
package skips it with a warning.

An HF GPT-2 state dict (`transformer.*` keys, or the same without the
prefix) goes into `models.gpt2.GPT2LMHead` through `convert_hf_gpt2`, which
keeps the keys the JAX converter takes (the embeddings, the blocks' norms and
projections, the final norm) and leaves out HF's attention-mask buffers and
the tied `lm_head.weight`.
"""

import logging
import re
from typing import Dict

import torch
from torch import nn

logger = logging.getLogger(__name__)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """torch.load -> {name: tensor}, floats as float32; unwraps detectron2's
    {"model": ...} and {"state_dict": ...}."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
            obj = obj[wrapper]
    return {k: v.float() if v.is_floating_point() else v for k, v in obj.items() if isinstance(v, torch.Tensor)}


# the keys each JAX converter takes, after its prefix: `convert_clip_visual`,
# `convert_clipcap_mapper`, `convert_rpn_head` and `convert_box_predictor`
_BN = r"bn[123]\.(weight|bias|running_mean|running_var)"
_VISUAL = re.compile(
    rf"(conv[123]\.weight|{_BN}|layer\d\.\d+\.(conv[123]\.weight|{_BN}|downsample\.0\.weight|"
    r"downsample\.1\.(weight|bias|running_mean|running_var))|attnpool\.positional_embedding|"
    r"attnpool\.[qkvc]_proj\.(weight|bias))"
)
_MAPPER = re.compile(
    r"(linear\.(weight|bias)|prefix_const|transformer\.layers\.\d+\.(norm[12]\.(weight|bias)|"
    r"attn\.(to_queries|to_keys_values|project)\.weight|attn\.project\.bias|mlp\.fc[12]\.(weight|bias)))"
)
_GPT2 = re.compile(
    r"(wte|wpe)\.weight|ln_f\.(weight|bias)|h\.\d+\.(ln_[12]\.(weight|bias)|attn\.c_(attn|proj)\.(weight|bias)|"
    r"mlp\.c_(fc|proj)\.(weight|bias))"
)
_RPN_HEAD = re.compile(r"(conv|objectness_logits|anchor_deltas)\.(weight|bias)")
_BOX_PREDICTOR = re.compile(r"cls_score\.weight|bbox_pred\.(weight|bias)")


@torch.no_grad()
def _load_prefixed(module: nn.Module, sd: Dict[str, torch.Tensor], prefix: str, what: str,
                   taken: re.Pattern) -> int:
    own = module.state_dict()
    n = 0
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if name not in own or not taken.fullmatch(name):
            continue
        if tuple(own[name].shape) != tuple(val.shape):
            raise ValueError(f"{what}: {key} has shape {tuple(val.shape)}, the model's {name} {tuple(own[name].shape)}")
        own[name].copy_(val)
        n += 1
    logger.info("%s: loaded %d of %d tensors", what, n, len(own))
    return n


def detect_dialect(sd: Dict[str, torch.Tensor]) -> str:
    """The checkpoint's dialect, by its keys, in the JAX package's order."""
    keys = sd.keys()
    for dialect, prefixes in (
        ("clipcap", ("clip_project.",)), ("oai_clip", ("visual.",)), ("d2_retinanet", ("head.cls_subnet.",)),
        ("d2_fpn", ("backbone.bottom_up.", "backbone.fpn_lateral")), ("d2_rcnn", ("backbone.",)),
        ("lang", ("lang_encoder.",)),
    ):
        if any(k.startswith(prefixes) for k in keys):
            return dialect
    return "unknown"


def _drop_background(sd: Dict[str, torch.Tensor], prefix: str, num_classes: int) -> Dict[str, torch.Tensor]:
    """The reference's background-row surgery: a cls_score of K+1 rows loses
    row 0 (the background; this model's is an implicit zero embedding), a
    bbox_pred of (K+1)*4 outputs loses its first 4."""
    out = dict(sd)
    for name, rows, cut in (("cls_score.weight", num_classes + 1, 1), ("bbox_pred.weight", (num_classes + 1) * 4, 4),
                            ("bbox_pred.bias", (num_classes + 1) * 4, 4)):
        val = sd.get(prefix + name)
        if val is not None and val.shape[0] == rows:
            logger.info("background-row surgery: %s %s -> dropping the first %d", name, tuple(val.shape), cut)
            out[prefix + name] = val[cut:]
    return out


def load_rcnn_weights(model: nn.Module, path: str) -> str:
    """A reference detector checkpoint (MODEL.WEIGHTS ending in .pth, .pt or
    .pkl) into `model`, by its dialect; returns the dialect. The offline
    backbone and the mapper are loaded when the model has them (the
    training build)."""
    sd = load_torch_state_dict(path)
    dialect = detect_dialect(sd)
    backbones = [model.backbone] + ([model.offline_backbone] if hasattr(model, "offline_backbone") else [])
    if dialect in ("oai_clip", "d2_rcnn"):
        prefix = "visual." if dialect == "oai_clip" else "backbone."
        for tower in backbones:
            _load_prefixed(tower, sd, prefix, f"{path}: {dialect} visual tower", _VISUAL)
        if dialect == "d2_rcnn":
            _load_prefixed(model.proposal_generator.rpn_head, sd, "proposal_generator.rpn_head.",
                           f"{path}: RPN head", _RPN_HEAD)
            box = "roi_heads.box_predictor."
            num_classes = model.roi_heads.box_predictor.cls_score.weight.shape[0]
            _load_prefixed(model.roi_heads.box_predictor, _drop_background(sd, box, num_classes), box,
                           f"{path}: box predictor", _BOX_PREDICTOR)
    elif dialect == "clipcap":
        _load_prefixed(model.v2l_mapper, sd, "clip_project.", f"{path}: ClipCap mapper", _MAPPER)
    elif dialect in ("d2_fpn", "d2_retinanet", "lang"):
        raise NotImplementedError(f"{path}: loading a {dialect!r} checkpoint is not ported")
    else:
        raise ValueError(f"Cannot detect checkpoint dialect of {path}")
    return dialect


def load_visual_tower(tower: nn.Module, sd: Dict[str, torch.Tensor], prefix: str, what: str) -> int:
    """The CLIP visual tensors of `sd` under `prefix` into a ModifiedResNet."""
    return _load_prefixed(tower, sd, prefix, what, _VISUAL)


def load_offline_backbone(model: nn.Module, path: str) -> None:
    """MODEL.PRE_TRAINED_RCLIP_PATH -> the frozen offline backbone."""
    sd = load_torch_state_dict(path)
    prefix = "backbone." if any(k.startswith("backbone.") for k in sd) else "visual."
    _load_prefixed(model.offline_backbone, sd, prefix, "offline backbone", _VISUAL)


def load_clipcap_mapper(model: nn.Module, path: str) -> None:
    """MODEL.VISION_TO_LANG_PATH -> the frozen ClipCap mapper (only
    `clip_project` is kept)."""
    load_mapper_state(model.v2l_mapper, load_torch_state_dict(path), "ClipCap mapper")


def load_mapper_state(mapper: nn.Module, sd: Dict[str, torch.Tensor], what: str) -> int:
    """The "clip_project.*" tensors of a ClipCap state dict into a
    TransformerMapper (the caption model's `clip_project`)."""
    return _load_prefixed(mapper, sd, "clip_project.", what, _MAPPER)


def convert_hf_gpt2(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF GPT2LMHeadModel (or GPT2Model) state dict -> the state dict of
    `models.gpt2.GPT2LMHead`: Conv1D weights stay (in, out)."""
    out = {}
    for key, val in sd.items():
        k = key[len("transformer."):] if key.startswith("transformer.") else key
        if _GPT2.fullmatch(k):
            out["transformer." + k] = val
    return out


@torch.no_grad()
def load_gpt2(gpt: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """An HF GPT-2 state dict into `gpt` (a GPT2LMHead): every tensor of
    the model must be in it, at its shape."""
    gpt.load_state_dict(convert_hf_gpt2(sd), strict=True)


@torch.no_grad()
def load_text_emb_classifier(model: nn.Module, path: str) -> None:
    """MODEL.CLIP.TEXT_EMB_PATH, a (K, D) tensor -> the frozen classifier
    rows."""
    w = torch.load(path, map_location="cpu", weights_only=False)
    w = torch.as_tensor(w).float()
    cur = model.roi_heads.box_predictor.cls_score.weight
    if tuple(w.shape) != tuple(cur.shape):
        raise ValueError(f"text embeddings {tuple(w.shape)} != classifier {tuple(cur.shape)}")
    cur.copy_(w)
