"""Training and evaluation CLI (counterpart of tools/train_net.py):

    python -m cddmsl_torch.train_net --config-file configs/VOC-Experiments/faster_rcnn_CLIP_R_50_C4.yaml
    python -m cddmsl_torch.train_net --eval-only --config-file ... MODEL.WEIGHTS output/model_final.pth
    python -m cddmsl_torch.train_net --resume --config-file ...
    python -m cddmsl_torch.train_net --device cpu --config-file cddmsl_torch/configs/voc_tiny.yaml
    python -m cddmsl_torch.train_net --device cpu --config-file cddmsl_torch/configs/mt_tiny.yaml
    python -m cddmsl_torch.train_net --num-gpus 8 --config-file ...
    python -m cddmsl_torch.train_net --device cpu --num-gpus 2 --config-file cddmsl_torch/configs/voc_tiny.yaml

KEY VALUE pairs after the options override the config. It runs on the CUDA
card unless `--device cpu` is given, and raises when there is no card. The
datasets are read from $DETECTRON2_DATASETS (default ./datasets).

`--num-gpus N` runs N processes data-parallel on this machine, one per
card (NCCL), or with `--device cpu` N CPU processes (gloo); with
`--num-machines M --machine-rank i --dist-url tcp://host:port` on each of
M machines, a world of N * M. The world trains the global batch
SOLVER.IMS_PER_BATCH as one process would (engine/launch.py,
parallel/comm.py).

The tree holds the mean-teacher block (`add_ateacher_config`); with
SEMISUPNET.Trainer "ateacher" training runs `MeanTeacherTrainer`, and
`--eval-only` evaluates through `DefaultTrainer`, as the JAX tool does (a
mean-teacher save does not restore there: it raises).
"""

import sys

from .config import add_ateacher_config, get_cfg
from .engine.defaults import DefaultTrainer, default_argument_parser, default_setup
from .engine.launch import launch
from .evaluation import verify_results


def setup(args):
    cfg = get_cfg()
    add_ateacher_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def main(args):
    cfg = setup(args)
    if cfg.SEMISUPNET.Trainer == "ateacher" and not args.eval_only:
        from .engine.mean_teacher import MeanTeacherTrainer

        trainer = MeanTeacherTrainer(cfg, device=args.device)
    else:
        trainer = DefaultTrainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test()
        if len(results) == 1 and not verify_results(cfg, next(iter(results.values()))):
            sys.exit(1)
        return results
    return trainer.train()


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, num_machines=args.num_machines, machine_rank=args.machine_rank,
           dist_url=args.dist_url, device=args.device, args=(args,))
