"""The recipe's side-loads from the reference's `.pth` files (counterpart of
`load_offline_backbone`, `load_clipcap_mapper` and
`load_text_emb_classifier` in cddmsl_tpu/checkpoint/convert_torch.py).

The port's modules carry the reference checkpoint keys, so each load is a
prefix swap into the model's own state: the RegionCLIP visual tower
("backbone.*", else "visual.*") into the frozen offline backbone, the ClipCap
mapper ("clip_project.*") into `v2l_mapper`, and the text-embedding tensor
into the classifier rows. Keys outside the target's state are left out, as
the JAX converters leave them out; a key whose shape differs raises.
"""

import logging
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


@torch.no_grad()
def _load_prefixed(module: nn.Module, sd: Dict[str, torch.Tensor], prefix: str, what: str) -> int:
    own = module.state_dict()
    n = 0
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if name not in own:
            continue
        if tuple(own[name].shape) != tuple(val.shape):
            raise ValueError(f"{what}: {key} has shape {tuple(val.shape)}, the model's {name} {tuple(own[name].shape)}")
        own[name].copy_(val)
        n += 1
    logger.info("%s: loaded %d of %d tensors", what, n, len(own))
    return n


def load_offline_backbone(model: nn.Module, path: str) -> None:
    """MODEL.PRE_TRAINED_RCLIP_PATH -> the frozen offline backbone."""
    sd = load_torch_state_dict(path)
    prefix = "backbone." if any(k.startswith("backbone.") for k in sd) else "visual."
    _load_prefixed(model.offline_backbone, sd, prefix, "offline backbone")


def load_clipcap_mapper(model: nn.Module, path: str) -> None:
    """MODEL.VISION_TO_LANG_PATH -> the frozen ClipCap mapper (only
    `clip_project` is kept)."""
    _load_prefixed(model.v2l_mapper, load_torch_state_dict(path), "clip_project.", "ClipCap mapper")


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
