"""The world-2 half of tests/test_torch_port_ddp.py, in one session of two
CPU ranks under gloo:

    python tests/torch_ddp_session.py OUT_DIR VOC_ROOT

(VOC_ROOT holds the synthetic VOC fixture, `make_synthetic_voc`.)

It goes through `cddmsl_torch.engine.launch.launch` (what `python -m
cddmsl_torch.train_net --num-gpus 2` runs), so torch is imported and the
ranks joined once for every case. Each rank, with convolutions off oneDNN
(`torch.backends.mkldnn`, as the test's one process runs them: oneDNN
rounds an image's convolution by the batch it is in, and the classifier's
temperature of 0.01 lifts that to ~1e-5 in the momentum):

1. `train_net.main` on voc_tiny.yaml for each of `TRAIN_CASES`, recording
   the files each rank opens for writing under OUTPUT_DIR, then the
   detections the trained model gives through the sharded
   `inference_on_dataset`;
2. `normalizer_case` and `infonce_case`, which the test also runs on one
   process;
3. `train_net.main` on mt_tiny.yaml with `MT_OPTS`, then `val_losses` of
   its save.

Rank 0 saves what the ranks return to OUT_DIR/session.pt.
"""

import builtins
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
VOC_TINY = REPO / "cddmsl_torch" / "configs" / "voc_tiny.yaml"
MT_TINY = REPO / "cddmsl_torch" / "configs" / "mt_tiny.yaml"
WORLD = 2
# voc_tiny.yaml's 4 steps with the caption branch from step 2 and KD on, then
# the same with the image_region branch
TRAIN_CASES = {
    "caption_kd": ("SOLVER.CAPTION_BURNUP_ITERS", "0", "MODEL.KD_REGULRAZIATION", "True"),
    "image_region": ("SOLVER.CAPTION_BURNUP_ITERS", "0", "MODEL.KD_REGULRAZIATION", "True",
                     "MODEL.CONSISTENCY_BRANCH", "image_region"),
}
# one burn-up step, then two semi-supervised ones
MT_OPTS = ("SOLVER.MAX_ITER", "3", "SEMISUPNET.BURN_UP_STEP", "0", "SEED", "0")


def register_fixture(root) -> None:
    """The synthetic VOC fixture under `root` as "ddp_voc_trainval" (paired
    with its dt_clipart twins), "ddp_voc_trainval_plain" and
    "ddp_voc_test"."""
    from cddmsl_torch.data import DatasetCatalog
    from cddmsl_torch.data.datasets.voc import register_pascal_DG, register_pascal_voc

    voc = os.path.join(str(root), "VOC2007")
    for name, register in (
        ("ddp_voc_trainval", lambda n: register_pascal_DG(n, voc, "trainval", 2007, "dt_clipart")),
        ("ddp_voc_trainval_plain", lambda n: register_pascal_voc(n, voc, "trainval", 2007)),
        ("ddp_voc_test", lambda n: register_pascal_voc(n, voc, "test", 2007)),
    ):
        if name not in DatasetCatalog:
            register(name)


def train_net_argv(config, out_dir, *opts):
    """`train_net`'s arguments for `config` on the registered fixture."""
    train = "ddp_voc_trainval_plain" if config == MT_TINY else "ddp_voc_trainval"
    return ["--device", "cpu", "--config-file", str(config), "OUTPUT_DIR", str(out_dir), "SEED", "0",
            "DATASETS.TRAIN", f"('{train}',)", "DATASETS.TEST", "('ddp_voc_test',)", *opts]


class Recorder:
    """An evaluator that keeps the detections it is fed, in order."""

    def reset(self):
        self.seen = []

    def process(self, image_id, boxes, scores, classes):
        self.seen.append((image_id, boxes, scores, classes))

    def process_gt(self, *args):
        pass

    def evaluate(self):
        return {"detections": self.seen}


def detections(argv):
    """The detections of the save in OUTPUT_DIR on the first test set,
    through `inference_on_dataset` in `DefaultTrainer.test`'s batches."""
    from cddmsl_torch import train_net
    from cddmsl_torch.data import build_detection_test_loader
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from cddmsl_torch.evaluation import inference_on_dataset
    from cddmsl_torch.parallel import comm

    cfg = train_net.setup(train_net.default_argument_parser().parse_args(argv))
    trainer = DefaultTrainer(cfg, device="cpu")
    trainer.resume_or_load(resume=True)
    world = comm.get_world_size()
    loader, n = build_detection_test_loader(cfg, cfg.DATASETS.TEST[0], -(-cfg.MODEL.CLIP.IMS_PER_BATCH_TEST // world)
                                            * world)
    with loader:
        return inference_on_dataset(trainer.model, loader, n, Recorder())["detections"]


def val_losses(argv):
    """`MeanTeacherTrainer.compute_val_loss` of the save in OUTPUT_DIR on the
    two-crop loader's first weak labeled batch (this rank's rows of it)."""
    from cddmsl_torch import train_net
    from cddmsl_torch.engine.mean_teacher import MeanTeacherTrainer

    cfg = train_net.setup(train_net.default_argument_parser().parse_args(argv))
    trainer = MeanTeacherTrainer(cfg, device="cpu")
    trainer.resume_or_load(resume=True)
    with trainer.build_train_loader() as loader:
        (_, label_weak), _ = next(loader)
    return trainer.compute_val_loss(label_weak)


def _tiny_model():
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import get_cfg, model_config_from_cfg
    from cddmsl_torch.models.build import build_model

    cfg = get_cfg()
    cfg.merge_from_file(str(VOC_TINY))
    config = model_config_from_cfg(cfg)
    model = build_model(config, device="cpu")
    return init_random_(model, torch.Generator().manual_seed(3)), config.backbone_width * 16


def _rows(n):
    from cddmsl_torch.parallel import comm

    lo, hi = comm.local_rows(n)
    return slice(lo, hi)


def normalizer_case():
    """The RoI heads' training losses on 4 images whose first two (rank 0's
    at world 2) hold 5 valid proposals each, so their sampler takes 5 + 2
    ground-truth rows where its quota is 32, and whose last two hold 64:
    -> ({parameter: gradient averaged over the ranks}, this rank's sampled
    row count)."""
    from cddmsl_torch.models.rpn import Proposals
    from cddmsl_torch.models.sampling import generator_draw, rank_draw
    from cddmsl_torch.parallel import comm

    model, channels = _tiny_model()
    r = np.random.RandomState(0)
    b, p, g, (h, w) = 4, 64, 2, (96, 160)
    feats = r.randn(b, h // 16, w // 16, channels).astype(np.float32)
    xy = r.uniform(0, 100, (b, p, 2))
    boxes = np.concatenate([xy, xy + r.uniform(8, 50, (b, p, 2))], -1).clip(0, [w, h, w, h]).astype(np.float32)
    valid = np.ones((b, p), bool)
    valid[:2, 5:] = False
    gt = np.concatenate([boxes[:, :g, :2] + 1, boxes[:, :g, 2:] - 1], -1)
    rows = _rows(b)
    t = lambda x: torch.tensor(x[rows])
    proposals = Proposals(t(boxes), torch.zeros(rows.stop - rows.start, p), t(valid))
    gt_kw = dict(gt_boxes=t(gt), gt_classes=t(r.randint(0, 20, (b, g)).astype(np.int32)), gt_valid=t(np.ones((b, g), bool)))
    draw = lambda: rank_draw(generator_draw(torch.Generator().manual_seed(7)), rows.stop - rows.start)
    sampled = int(model.roi_heads.label_and_sample_proposals(proposals, draw=draw(), **gt_kw)[3].sum())
    with torch.enable_grad():
        losses = model.roi_heads(t(feats), proposals, torch.tensor([[h, w]] * (rows.stop - rows.start)),
                                 model.backbone.res5_forward, model.backbone.attnpool_forward, training=True,
                                 draw=draw(), **gt_kw)
        torch.stack(list(losses.values())).sum().backward()
    named = [(k, v) for k, v in model.named_parameters() if v.grad is not None]
    comm.all_reduce_mean_([v.grad for _, v in named])
    return {k: v.grad.clone() for k, v in named}, sampled


class _OwnSliceGather(torch.autograd.Function):
    """The reference's GatherLayer: every rank's rows forward; backward, a
    rank keeps its own rows of its own gradient."""

    @staticmethod
    def forward(ctx, x):
        out = [torch.zeros_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(out, x.contiguous())
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // dist.get_world_size()
        return g[dist.get_rank() * n : (dist.get_rank() + 1) * n]


def infonce_case():
    """InfoNCE of two projected views of 8 rows (4 per rank at world 2):
    -> {"loss", "W": the projection's gradient averaged over the ranks,
    "a", "b": each view's gradient on this rank's rows as the average over
    the ranks applies it (its own over the world), and "a_ref": the same
    under the reference's GatherLayer}."""
    from cddmsl_torch.models.rcnn import infonce_bidirectional
    from cddmsl_torch.parallel import comm

    world = comm.get_world_size()
    r = np.random.RandomState(1)
    a, b, w = (torch.tensor(r.randn(*s), dtype=torch.float32) for s in ((8, 16), (8, 16), (16, 12)))
    rows = _rows(8)
    out = {}
    for key, gather in (("", comm.all_gather_with_grad), ("_ref", _OwnSliceGather.apply if world > 1 else None)):
        xa, xb, xw = (x.clone().requires_grad_(True) for x in (a[rows], b[rows], w))
        saved = comm.all_gather_with_grad
        comm.all_gather_with_grad = gather or saved
        try:
            with torch.enable_grad():
                loss = infonce_bidirectional(xa @ xw, xb @ xw)
                loss.backward()
        finally:
            comm.all_gather_with_grad = saved
        comm.all_reduce_mean_([xw.grad])
        out.update({f"loss{key}": loss.detach(), f"W{key}": xw.grad, f"a{key}": xa.grad / world,
                    f"b{key}": xb.grad / world})
    return out


def _spy_writes(root):
    """Records the paths under `root` that this process opens for writing
    or `torch.save`s to; -> (the list, a function that ends the
    recording)."""
    seen, real_open, real_save = [], builtins.open, torch.save
    root = os.path.realpath(root)

    def note(file):
        if isinstance(file, (str, os.PathLike)):
            path = os.path.realpath(file)
            if path.startswith(root + os.sep):
                seen.append(os.path.relpath(path, root))

    def spy_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            note(file)
        return real_open(file, mode, *args, **kwargs)

    def spy_save(obj, f, *args, **kwargs):
        note(f)
        return real_save(obj, f, *args, **kwargs)

    def stop():
        builtins.open, torch.save = real_open, real_save

    builtins.open, torch.save = spy_open, spy_save
    return seen, stop


def _rank_main(out_dir, voc_root):
    from cddmsl_torch import train_net
    from cddmsl_torch.parallel import comm

    torch.backends.mkldnn.enabled = False
    register_fixture(voc_root)
    parse = train_net.default_argument_parser().parse_args
    result = {}
    for case, opts in TRAIN_CASES.items():
        argv = ["--num-gpus", str(WORLD), *train_net_argv(VOC_TINY, os.path.join(out_dir, case), *opts)]
        writes, stop = _spy_writes(os.path.join(out_dir, case))
        try:
            eval_results = train_net.main(parse(argv))
        finally:
            stop()
        result[case] = {"results": eval_results, "writes": comm.all_gather_objects(sorted(set(writes))),
                        "detections": detections(argv)}
    grads, sampled = normalizer_case()
    result["normalizer"] = {"grads": grads, "sampled": comm.all_gather_objects(sampled)}
    saved = comm.global_normalizer
    comm.global_normalizer = lambda count, min_value=1.0: torch.clamp(count, min=min_value)  # each rank's own count
    try:
        result["normalizer"]["local_grads"] = normalizer_case()[0]
    finally:
        comm.global_normalizer = saved
    result["infonce"] = comm.all_gather_objects(infonce_case())
    argv = ["--num-gpus", str(WORLD), *train_net_argv(MT_TINY, os.path.join(out_dir, "mean_teacher"), *MT_OPTS)]
    result["mean_teacher"] = train_net.main(parse(argv))
    result["mt_val_losses"] = comm.all_gather_objects(val_losses(argv))
    if comm.is_main_process():
        torch.save(result, os.path.join(out_dir, "session.pt"))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    from cddmsl_torch.engine.launch import launch

    # a rendezvous file in OUT_DIR: no port to share with other processes on the machine
    launch(_rank_main, WORLD, dist_url=f"file://{os.path.join(sys.argv[1], 'rendezvous')}", device="cpu",
           args=tuple(sys.argv[1:3]))
