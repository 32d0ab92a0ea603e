"""Captions an image through the ClipCap stack (counterpart of
tools/gen_captions.py):

    python -m cddmsl_torch.gen_captions --image img.jpg [--rclip-weights regionclip.pth] \
        [--clipcap-weights clipcap.pt [--gpt2-weights gpt2_state_dict.pt]] [--top-p 0.8] [--max-len 67] \
        [--device cpu]

The image is resized to 224x224 (bicubic) and CLIP-normalized; the CLIP RN50
visual tower's global embedding is the prefix of the caption model (a ClipCap
mapper of 40 tokens, then GPT-2), which decodes greedily, or with top-p
sampling, up to the stop token. A module whose file is not given keeps
seeded random weights; GPT-2's weights come from --gpt2-weights or else from
the ClipCap file's "gpt.*" tensors, and only with --clipcap-weights, as in
the JAX tool (alone, --gpt2-weights is ignored with a warning). The GPT-2
vocabulary is not in the repository, so the token ids are printed. It runs
on the card unless --device cpu is given.
"""

import argparse
import logging
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from .checkpoint.convert_jax import init_random_
from .checkpoint.convert_torch import load_gpt2, load_mapper_state, load_torch_state_dict, load_visual_tower
from .config import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, EMBED_DIMS, RESNET_SPECS
from .device import resolve_device
from .models.backbone.clip_resnet import ModifiedResNet
from .models.caption import ClipCaptionModel, generate

logger = logging.getLogger(__name__)


def load_image(path: str) -> torch.Tensor:
    """-> (1, 224, 224, 3) float32: PIL bicubic resize, /255, CLIP normalization."""
    img = Image.open(path).convert("RGB").resize((224, 224), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - np.array(CLIP_PIXEL_MEAN, np.float32)) / np.array(CLIP_PIXEL_STD, np.float32)
    return torch.from_numpy(x[None])


def build(args, device: torch.device):
    """(visual tower, caption model) with seeded random weights, then the files given."""
    layers, width = RESNET_SPECS[50]
    backbone = ModifiedResNet(layers, EMBED_DIMS[50], width * 32 // 64, width)
    init_random_(backbone, torch.Generator().manual_seed(0))
    if args.rclip_weights:
        sd = load_torch_state_dict(args.rclip_weights)
        prefix = "visual." if any(k.startswith("visual.") for k in sd) else "backbone."
        load_visual_tower(backbone, sd, prefix, f"{args.rclip_weights}: visual tower")
    model = ClipCaptionModel()
    init_random_(model, torch.Generator().manual_seed(1))
    if args.gpt2_weights and not args.clipcap_weights:
        logger.warning("--gpt2-weights is read only with --clipcap-weights, as in tools/gen_captions.py: ignored")
    if args.clipcap_weights:
        sd = load_torch_state_dict(args.clipcap_weights)
        load_mapper_state(model.clip_project, sd, f"{args.clipcap_weights}: ClipCap mapper")
        if args.gpt2_weights or any(k.startswith("gpt.") for k in sd):
            gsd = (load_torch_state_dict(args.gpt2_weights) if args.gpt2_weights
                   else {k[len("gpt."):]: v for k, v in sd.items() if k.startswith("gpt.")})
            load_gpt2(model.gpt, gsd)
    return backbone.to(device).eval(), model.to(device).eval()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ClipCap caption token ids of an image")
    ap.add_argument("--image", required=True)
    ap.add_argument("--rclip-weights", default="")
    ap.add_argument("--clipcap-weights", default="")
    ap.add_argument("--gpt2-weights", default="")
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--max-len", type=int, default=67)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> List[int]:
    """Prints and returns the caption's token ids (up to the stop token)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    backbone, model = build(args, device)
    prefix = backbone.global_embed(load_image(args.image).to(device))
    generator = torch.Generator(device=device).manual_seed(2)
    tokens, live = generate(model, prefix, args.max_len, args.top_p, generator)
    ids = tokens[0][live[0]].tolist()
    print("token ids (GPT-2 tokenizer unavailable offline):", ids)
    return ids


if __name__ == "__main__":
    main()
