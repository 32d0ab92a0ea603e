"""The reference's `.pth` files (counterpart of `load_rcnn_weights`,
`detect_dialect`, `load_offline_backbone`, `load_clipcap_mapper`,
`load_bb_rpn_weights` and `load_text_emb_classifier` in
cddmsl_tpu/checkpoint/convert_torch.py, of
`convert_clip_text` there (`load_text_tower`), and of `convert_hf_gpt2` in
cddmsl_tpu/models/gpt2.py).

The port's modules carry the reference checkpoint keys, so each load is a
prefix swap into the model's own state: the RegionCLIP visual tower
("backbone.*", else "visual.*") into the frozen offline backbone, the ClipCap
mapper ("clip_project.*") into `v2l_mapper`, and the text-embedding tensor
into the classifier rows. A detector checkpoint (MODEL.WEIGHTS) loads by its
dialect: "d2_rcnn" (backbone into both backbones, or detectron2's ResNet
keys into the plain tower, RPN head, box predictor: the text classifier
without its background row, the linear one as it is), "d2_fpn" (an FPN
detector's: `load_d2_fpn`), "oai_clip" (the visual tower into both
backbones), "clipcap" (the mapper) or "lang" (the CLIP text tower,
"lang_encoder.*", into a model that has one: the pretraining model); a
model with a text tower also takes an oai_clip file's "transformer.*" text
tensors and a d2_rcnn file's "lang_encoder.*" ones. The text tower's keys
are OpenAI-CLIP's, so `load_text_tower` strips a prefix ("" or
"lang_encoder.") and copies. Into `CLIPFastRCNN` an oai_clip file loads
the CLIP tower and leaves the offline detectron2 tower as it was (JAX
merges the CLIP names into that tower, where nothing reads them); a
d2_rcnn file raises, as JAX's loader does (KeyError there): the arch has no
trainable RPN. Its offline tower and RPN head come from
MODEL.CLIP.BB_RPN_WEIGHTS (`load_bb_rpn_weights`): detectron2's
"backbone.*" ResNet keys and "proposal_generator.rpn_head.*".
Only the keys the JAX converters take
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

from ..models.backbone.resnet import FPN, D2ResNet

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
_TEXT = re.compile(
    r"token_embedding\.weight|positional_embedding|text_projection|ln_final\.(weight|bias)|"
    r"transformer\.resblocks\.\d+\.(attn\.in_proj_(weight|bias)|attn\.out_proj\.(weight|bias)|ln_[12]\.(weight|bias)|"
    r"mlp\.c_(fc|proj)\.(weight|bias))"
)
_RPN_HEAD = re.compile(r"(conv|objectness_logits|anchor_deltas)\.(weight|bias)")
_BOX_PREDICTOR = re.compile(r"cls_score\.weight|bbox_pred\.(weight|bias)")
_LINEAR_BOX_PREDICTOR = re.compile(r"cls_score\.(weight|bias)|bbox_pred\.(weight|bias)")
# `convert_d2_resnet`'s keys without the deformable ones
_D2_RESNET = re.compile(
    r"(stem\.conv1|res\d\.\d+\.(conv[123]|shortcut))\.(weight|norm\.(weight|bias|running_mean|running_var))"
)
# `convert_d2_fpn_rcnn`'s FPN convs and fc box head (no GN variants: FPN.NORM
# and ROI_BOX_HEAD.NORM are refused)
_FPN_CONVS = re.compile(r"fpn_(lateral|output)\d\.(weight|bias)")
_BOX_HEAD = re.compile(r"fc[12]\.(weight|bias)")


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
    training build). A plain tower takes detectron2's ResNet keys under
    "backbone." (stem.conv1, res{s}.{i}.conv{1,2,3} and shortcut, each with
    its norm), and a linear classifier the file's cls_score weight and bias
    as they are (K + 1 rows, background last, as detectron2 writes them)."""
    sd = load_torch_state_dict(path)
    dialect = detect_dialect(sd)
    # CLIPFastRCNN's offline tower is a plain ResNet that only BB_RPN_WEIGHTS fills
    clip_fast = hasattr(model, "offline_proposal_generator")
    if clip_fast and dialect == "d2_rcnn":
        raise ValueError(f"{path}: a d2_rcnn detector file does not load into CLIPFastRCNN: its "
                         "proposal_generator.* has no trainable RPN to go to (the offline RPN comes from "
                         "MODEL.CLIP.BB_RPN_WEIGHTS); JAX's load_rcnn_weights raises KeyError on it")
    has_offline = hasattr(model, "offline_backbone") and not clip_fast
    backbones = [model.backbone] + ([model.offline_backbone] if has_offline else [])
    text = getattr(model, "lang_encoder", None)
    plain = isinstance(model.backbone, D2ResNet)
    if dialect in ("oai_clip", "d2_rcnn"):
        prefix = "visual." if dialect == "oai_clip" else "backbone."
        for tower in backbones:
            if plain:
                _load_prefixed(tower, sd, prefix, f"{path}: {dialect} plain ResNet", _D2_RESNET)
            else:
                _load_prefixed(tower, sd, prefix, f"{path}: {dialect} visual tower", _VISUAL)
        text_prefix, marker = ("", "transformer.") if dialect == "oai_clip" else ("lang_encoder.", "lang_encoder.")
        if text is not None and any(k.startswith(marker) for k in sd):
            load_text_tower(text, sd, text_prefix, f"{path}: text tower")
        if dialect == "d2_rcnn":
            _load_prefixed(model.proposal_generator.rpn_head, sd, "proposal_generator.rpn_head.",
                           f"{path}: RPN head", _RPN_HEAD)
            box, head = "roi_heads.box_predictor.", model.roi_heads.box_predictor
            if head.use_text_emb:
                _load_prefixed(head, _drop_background(sd, box, head.num_classes), box, f"{path}: box predictor",
                               _BOX_PREDICTOR)
            else:  # the linear classifier has the file's K + 1 rows
                _load_prefixed(head, sd, box, f"{path}: box predictor", _LINEAR_BOX_PREDICTOR)
    elif dialect == "clipcap":
        _load_prefixed(model.v2l_mapper, sd, "clip_project.", f"{path}: ClipCap mapper", _MAPPER)
    elif dialect == "lang":
        if text is None:
            raise NotImplementedError(f"{path}: a 'lang' checkpoint holds a text tower, which this model does not "
                                      "have (JAX's loader refuses it too)")
        load_text_tower(text, sd, "lang_encoder.", f"{path}: text tower")
    elif dialect == "d2_fpn":
        load_d2_fpn(model, sd, path)
    elif dialect == "d2_retinanet":
        raise NotImplementedError(f"{path}: loading a {dialect!r} checkpoint is not ported")
    else:
        raise ValueError(f"Cannot detect checkpoint dialect of {path}")
    return dialect


def fc1_from_chw(weight: torch.Tensor, channels: int, resolution: int) -> torch.Tensor:
    """detectron2's box_head.fc1 weight (out, C*P*P), which reads the pooled
    map flattened CHW, -> the port's (out, P*P*C), which reads it HWC."""
    out = weight.shape[0]
    return weight.reshape(out, channels, resolution, resolution).permute(0, 2, 3, 1).reshape(out, -1).contiguous()


def load_d2_fpn(model: nn.Module, sd: Dict[str, torch.Tensor], path: str) -> int:
    """A detectron2 FPN-family file (JAX's `convert_d2_fpn_rcnn`) into an FPN
    detector or FPN ProposalNetwork: "backbone.bottom_up.*" (detectron2's
    ResNet names) into the tower, backbone.fpn_lateral{l} / fpn_output{l},
    the RPN head, roi_heads.box_head.fc1 (permuted from CHW to HWC where it
    reads the pooled map) and fc2, and the linear box predictor as it is
    (background last). Returns how many tensors were loaded."""
    if not isinstance(getattr(model, "backbone", None), FPN):
        raise NotImplementedError(f"{path}: loading a 'd2_fpn' checkpoint into a model without an FPN is not "
                                  "ported (it loads into MODEL.BACKBONE.NAME build_resnet_fpn_backbone)")
    n = _load_prefixed(model.backbone.bottom_up, sd, "backbone.bottom_up.", f"{path}: FPN bottom-up", _D2_RESNET)
    n += _load_prefixed(model.backbone, sd, "backbone.", f"{path}: FPN convs", _FPN_CONVS)
    if hasattr(model, "proposal_generator"):
        n += _load_prefixed(model.proposal_generator.rpn_head, sd, "proposal_generator.rpn_head.",
                            f"{path}: RPN head", _RPN_HEAD)
    if hasattr(model, "roi_heads"):
        rh, fc1 = model.roi_heads, "roi_heads.box_head.fc1.weight"
        c, r = model.backbone.out_channels, rh.pooler_resolution
        if fc1 in sd and sd[fc1].shape[1] == c * r * r:
            sd = {**sd, fc1: fc1_from_chw(sd[fc1], c, r)}
        n += _load_prefixed(rh.box_head, sd, "roi_heads.box_head.", f"{path}: box head", _BOX_HEAD)
        n += _load_prefixed(rh.box_predictor, sd, "roi_heads.box_predictor.", f"{path}: box predictor",
                            _LINEAR_BOX_PREDICTOR)
    return n


def load_bb_rpn_weights(model: nn.Module, path: str) -> int:
    """MODEL.CLIP.BB_RPN_WEIGHTS, a detectron2 R-CNN file, into
    CLIPFastRCNN's frozen offline RPN: "backbone.*" (detectron2's ResNet
    names) into `offline_backbone`, "proposal_generator.rpn_head.*" into
    `offline_proposal_generator.rpn_head`. Returns how many tensors were
    loaded. A model without the offline detectron2 tower raises, as JAX's
    loader asserts."""
    if not hasattr(model, "offline_proposal_generator") or not isinstance(model.offline_backbone, D2ResNet):
        raise ValueError(f"{path}: BB_RPN_WEIGHTS needs CLIPFastRCNN's offline detectron2 tower and RPN")
    sd = load_torch_state_dict(path)
    n = _load_prefixed(model.offline_backbone, sd, "backbone.", f"{path}: offline ResNet", _D2_RESNET)
    return n + _load_prefixed(model.offline_proposal_generator.rpn_head, sd, "proposal_generator.rpn_head.",
                              f"{path}: offline RPN head", _RPN_HEAD)


def load_visual_tower(tower: nn.Module, sd: Dict[str, torch.Tensor], prefix: str, what: str) -> int:
    """The CLIP visual tensors of `sd` under `prefix` into a ModifiedResNet."""
    return _load_prefixed(tower, sd, prefix, what, _VISUAL)


def load_text_tower(tower: nn.Module, sd: Dict[str, torch.Tensor], prefix: str, what: str) -> int:
    """The CLIP text tensors of `sd` under `prefix` into a CLIPTextEncoder;
    returns how many were loaded."""
    return _load_prefixed(tower, sd, prefix, what, _TEXT)


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
