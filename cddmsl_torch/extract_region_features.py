"""Per-image region features (counterpart of tools/extract_region_features.py):

    python -m cddmsl_torch.extract_region_features --config-file cfg.yaml --dataset voc_2007_test \\
        --out feats/ [--max-images 100] [--device cpu] [KEY VALUE ...]

`DefaultTrainer` builds the detector (seeded random weights, then
MODEL.WEIGHTS and the side-loads); each test batch of the registered
--dataset goes through the backbone to res4, the RPN's proposals (kernel
K4's NMS on the card) and the RoI head's region embedding: RoIAlign (K1),
res5 and the attention pool. Each image's valid proposals and their
embeddings are saved as `<image_id>.npz` ("boxes" (k, 4), "features"
(k, D), float32: the JAX tool keeps bf16 features in bf16). It stops after
the batch that reaches --max-images. It runs on the card unless --device
cpu is given.
"""

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .config import add_ateacher_config, get_cfg
from .data import build_detection_test_loader, register_all, to_device
from .engine.defaults import DefaultTrainer
from .models.rcnn import DetBatch, GeneralizedRCNN


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="RPN region features of a dataset's images")
    ap.add_argument("--config-file", default="")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return ap


@torch.no_grad()
def region_features(model: GeneralizedRCNN, batch: DetBatch):
    """-> proposals (B, K, 4), their validity (B, K) and embeddings (B, K, D)."""
    feats = model.backbone(model._normalize(batch.image))["res4"]
    proposals, _ = model.proposal_generator(feats, batch.image_sizes, training=False)
    emb = model.roi_heads._region_embed(feats, proposals.boxes, model.backbone.res5_forward,
                                        model.backbone.attnpool_forward)
    b, k = proposals.boxes.shape[:2]
    return proposals.boxes, proposals.valid, emb.reshape(b, k, -1)


def main(argv: Optional[List[str]] = None) -> int:
    """Writes the files; returns how many images it wrote."""
    args = parser().parse_args(argv)
    cfg = get_cfg()
    add_ateacher_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    register_all()
    trainer = DefaultTrainer(cfg, device=args.device)
    trainer.resume_or_load(resume=False)
    os.makedirs(args.out, exist_ok=True)
    loader, _ = build_detection_test_loader(cfg, args.dataset, pin_memory=trainer.device.type == "cuda")
    seen = 0
    with loader:
        for batch, metas in loader:
            boxes, valid, emb = (t.cpu() for t in region_features(trainer.model, to_device(batch, trainer.device)))
            for i, meta in enumerate(metas):
                np.savez(os.path.join(args.out, f"{meta['image_id']}.npz"),
                         boxes=boxes[i][valid[i]].numpy(), features=emb[i][valid[i]].float().numpy())
                seen += 1
            if args.max_images and seen >= args.max_images:
                break
    print(f"wrote region features for {seen} images -> {args.out}")
    return seen


if __name__ == "__main__":
    main()
