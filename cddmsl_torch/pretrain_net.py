"""Region-language pretraining CLI over the image-text TSV corpus
(counterpart of tools/pretrain_net.py):

    python -m cddmsl_torch.pretrain_net --config-file configs/pretrain/RegionCLIP_RN50.yaml \\
        --image-tsv data/imgs.tsv --text-tsv data/texts.tsv
    python -m cddmsl_torch.pretrain_net --config-file cddmsl_torch/configs/pretrain_tiny.yaml \\
        --image-tsv imgs.tsv --text-tsv texts.tsv --device cpu OUTPUT_DIR output/pretrain_tiny

--image-tsv and --text-tsv take one or more shards each, so KEY VALUE
overrides come after another option (here --device), as in the JAX tool.

It builds `PretrainFastRCNN` with seeded random weights (SEED, at least 0),
streams SOLVER.IMS_PER_BATCH pairs a step at 224x224 (the order seeded by
SEED), tokenizes the captions with CLIP's BPE, runs SOLVER.MAX_ITER steps of
`pretrain_loop` and saves `pretrain_final.pth` in OUTPUT_DIR through
`DetectionCheckpointer`. MODEL.WEIGHTS, MODEL.CLIP.CONCEPT_POOL_EMB and
TPU.PIPELINE_AXIS raise (config `check_pretrain_supported`): the JAX tool
reads neither of the first two. It runs on the card unless `--device cpu`
is given, and raises when there is no card.
"""

import argparse
import logging
from typing import List, Optional, Tuple

import torch

from .checkpoint.checkpointer import DetectionCheckpointer
from .checkpoint.convert_jax import init_random_
from .config import get_cfg, solver_config_from_cfg
from .data.clip_datasets import CLIPImgTxtPairTSVDataset
from .data.clip_tokenizer import SimpleTokenizer, tokenize
from .device import resolve_device
from .engine.pretrain import PretrainState, pretrain_loop
from .models.build import build_pretrain_fast_rcnn
from .solver.build import build_optimizer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="RegionCLIP region-language pretraining")
    ap.add_argument("--config-file", default="")
    ap.add_argument("--image-tsv", nargs="+", required=True)
    ap.add_argument("--text-tsv", nargs="+", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE overrides")
    return ap


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def build_state(cfg, device) -> PretrainState:
    """The model with seeded random weights on `device`, its optimizer (the
    teacher, the text tower, the concept pool, the stem and FREEZE_AT's
    stages frozen) and iteration 0."""
    model = build_pretrain_fast_rcnn(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(max(cfg.SEED, 0)))
    model = model.to(device)
    return PretrainState(model, build_optimizer(model, solver_config_from_cfg(cfg)))


def main(argv: Optional[List[str]] = None) -> Tuple[PretrainState, dict]:
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")
    cfg = setup(args)
    device = resolve_device(args.device)
    state = build_state(cfg, device)
    ds = CLIPImgTxtPairTSVDataset(args.image_tsv, args.text_tsv)
    print(f"pretraining corpus: {len(ds)} image-text pairs")
    batches = ds.batches(cfg.SOLVER.IMS_PER_BATCH, image_size=224, seed=max(cfg.SEED, 0))
    tokenizer = SimpleTokenizer()
    context = state.model.text_context_length
    metrics = pretrain_loop(
        state, batches, lambda captions: tokenize(captions, tokenizer, context_length=context),
        max_iter=cfg.SOLVER.MAX_ITER, pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD),
    )
    print("final:", metrics)
    if cfg.OUTPUT_DIR:
        DetectionCheckpointer(cfg.OUTPUT_DIR).save("pretrain_final", state)
    return state, metrics


if __name__ == "__main__":
    main()
