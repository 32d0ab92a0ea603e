"""Class names -> a text-embedding classifier (counterpart of
tools/extract_concept_features.py):

    python -m cddmsl_torch.extract_concept_features --config-file cfg.yaml \\
        --weights regionclip.pth --out voc_20_cls_emb.pth [--classes aeroplane bicycle ...] [--device cpu]

Each class name goes into CLIP's 80 prompt templates (`pre_tokenize`); the
text tower of `build_clip_text_encoder` (width and heads from
MODEL.RESNETS.DEPTH, depth, context and vocabulary from MODEL.TEXT_ENCODER,
TPU.COMPUTE_DTYPE) encodes each prompt at its EOT token; the embeddings are
L2-normalised, averaged over the templates and normalised again, in numpy
float32, and saved as a (num_classes, D) float32 array: `.npy` by numpy, any
other name by `torch.save`, which is what MODEL.CLIP.TEXT_EMB_PATH reads.
The names are --classes, else the classes of the registered --dataset, else
VOC's 20. The tower's weights are the text tensors of --weights (OpenAI-CLIP
keys, bare or under "lang_encoder."); a file without them raises, where the
JAX tool keeps its random weights. Without --weights the tower keeps seeded
random weights. The flags are the JAX tool's: KEY VALUE overrides are not
taken. It runs on the card unless --device cpu is given.
"""

import argparse
from typing import List, Optional

import numpy as np
import torch

from .checkpoint.convert_jax import init_random_
from .checkpoint.convert_torch import load_text_tower, load_torch_state_dict
from .config import get_cfg
from .data.clip_tokenizer import pre_tokenize
from .device import resolve_device
from .models.backbone.text_encoder import build_clip_text_encoder


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CLIP text embeddings of class names")
    ap.add_argument("--config-file", default="")
    ap.add_argument("--weights", default="", help="a torch checkpoint with the CLIP text tower")
    ap.add_argument("--out", required=True)
    ap.add_argument("--classes", nargs="*", default=None)
    ap.add_argument("--dataset", default="", help="take the class names from this registered dataset")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def class_names(args) -> List[str]:
    if args.classes:
        return list(args.classes)
    if args.dataset:
        from .data import MetadataCatalog, register_all

        register_all()
        return list(MetadataCatalog.get(args.dataset).thing_classes)
    from .data.datasets.voc import CLASS_NAMES

    return list(CLASS_NAMES)


def build_encoder(cfg, weights: str, device: torch.device):
    """The text tower with seeded random weights, then the text tensors of
    `weights` where given; raises ValueError when that file has none."""
    encoder = build_clip_text_encoder(cfg)
    init_random_(encoder, torch.Generator().manual_seed(0))
    if weights:
        sd = load_torch_state_dict(weights)
        prefix = "lang_encoder." if any(k.startswith("lang_encoder.") for k in sd) else ""
        if load_text_tower(encoder, sd, prefix, f"{weights}: text tower") == 0:
            raise ValueError(f"--weights {weights} holds no CLIP text-tower tensor (token_embedding.weight, "
                             f"transformer.resblocks.*, ...{' under lang_encoder.' if prefix else ''})")
    return encoder.to(device).eval()


@torch.no_grad()
def encode_classes(encoder, tokens: np.ndarray, device: torch.device) -> np.ndarray:
    """(C, T, L) prompt tokens -> (C, D) float32: per class the unit
    embeddings of its T prompts, averaged and normalised."""
    embs = []
    for c in range(tokens.shape[0]):
        e = encoder(torch.from_numpy(tokens[c]).to(device)).float().cpu().numpy()  # (T, D)
        e = e / np.linalg.norm(e, axis=1, keepdims=True)
        m = e.mean(axis=0)
        embs.append(m / np.linalg.norm(m))
    return np.stack(embs).astype(np.float32)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    args = parser().parse_args(argv)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    names = class_names(args)
    device = resolve_device(args.device)
    encoder = build_encoder(cfg, args.weights, device)
    out = encode_classes(encoder, pre_tokenize(names), device)
    if args.out.endswith(".npy"):
        np.save(args.out, out)
    else:
        torch.save(torch.from_numpy(out), args.out)
    print(f"saved {out.shape} text embeddings for {len(names)} classes -> {args.out}")
    return out


if __name__ == "__main__":
    main()
