"""Training and evaluation CLI (counterpart of tools/train_net.py):

    python -m cddmsl_torch.train_net --config-file configs/VOC-Experiments/faster_rcnn_CLIP_R_50_C4.yaml
    python -m cddmsl_torch.train_net --eval-only --config-file ... MODEL.WEIGHTS output/model_final.pth
    python -m cddmsl_torch.train_net --resume --config-file ...
    python -m cddmsl_torch.train_net --device cpu --config-file cddmsl_torch/configs/voc_tiny.yaml

KEY VALUE pairs after the options override the config. It runs on the CUDA
card unless `--device cpu` is given, and raises when there is no card. The
datasets are read from $DETECTRON2_DATASETS (default ./datasets).
"""

import sys

from .config import get_cfg
from .engine.defaults import DefaultTrainer, default_argument_parser, default_setup
from .evaluation import verify_results


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def main(args):
    cfg = setup(args)
    trainer = DefaultTrainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test()
        if len(results) == 1 and not verify_results(cfg, next(iter(results.values()))):
            sys.exit(1)
        return results
    return trainer.train()


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
