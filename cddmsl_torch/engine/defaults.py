"""Training and evaluation orchestration on one device (counterpart of
cddmsl_tpu/engine/defaults.py: `default_argument_parser`, `default_setup`,
`build_evaluator`, `DefaultPredictor` and `DefaultTrainer`).

`DefaultTrainer` builds the detector of the tree (`models.build.
build_detector`: the CDDMSL C4 model, or the FPN family's FPNRCNN, its DC5
form or a ProposalNetwork, PanopticFPN or the SemanticSegmentor, whose
loss sets ignore the caption switches) with
seeded random weights, its optimizer and the training state, restores or side-loads weights
(`resume_or_load`), runs the loop with its hooks, the NaN guard and the
periodic checkpoints, saves `model_final` and evaluates every
DATASETS.TEST set (`test`), the Watercolor and Comic sets on their 6
classes.

One process drives one device. Under a process group (`launch`,
`--num-gpus` / `--num-machines`) every rank builds the same model and
steps its rows of SOLVER.IMS_PER_BATCH (parallel/comm.py says how the step
stays the global batch's); the losses logged are their means over the
ranks; only rank 0 writes config.yaml, metrics.json and the checkpoints;
evaluation splits each batch, rounded up to a multiple of the ranks, over
them and scores the whole set on rank 0 (JAX's mesh-sharded eval), and
every rank gets the results.

With MODEL.CLIP.OPENSET_TEST_NUM_CLASSES (class-agnostic boxes and the text
classifier only) `test` evaluates the open-set head: a model of that many
classes whose classifier rows are MODEL.CLIP.OPENSET_TEST_TEXT_EMB_PATH's
and whose every other tensor is the evaluated model's.

Each iteration's sampler draws come from a generator seeded by (SEED,
iteration), as the JAX loop folds the iteration into its key, so a resumed
run draws what an uninterrupted one would.

MODEL.CONSISTENCY_BRANCH "image" / "image_region" adds the language-free
branch to the step (weighted by MODEL.CONSISTENCY_LOSS_WEIGHT);
"caption_pl_img" / "caption_pl_region" builds the frozen caption model
(`build_caption_model`) and runs the pseudo-label step after every main
step from iteration 0, its draws seeded by (SEED, iteration, 1) as JAX
folds 1 into the step's key.
"""

import argparse
import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import DetectionCheckpointer
from ..checkpoint.convert_jax import init_random_
from ..checkpoint.convert_torch import (
    load_clipcap_mapper, load_gpt2, load_mapper_state, load_offline_backbone, load_text_emb_classifier,
    load_torch_state_dict,
)
from ..config import CfgNode, check_supported, model_config_from_cfg, solver_config_from_cfg
from ..data import MetadataCatalog, build_detection_test_loader, build_detection_train_loader, register_all, to_device
from ..data.build import _bucket_for, pad_and_collate
from ..data.datasets.voc import ARTISTIC_6_CLASSES
from ..data.transforms import ResizeShortestEdge, apply_augmentations
from ..device import resolve_device
from ..evaluation import (
    COCOEvaluator, LVISEvaluator, PascalVOCDetectionEvaluator, inference_on_dataset, print_csv_format, verify_results,
)
from ..evaluation.cityscapes_eval import CityscapesInstanceEvaluator
from ..evaluation.masks import paste_masks_np
from ..evaluation.panoptic_eval import COCOPanopticEvaluator, inference_on_dataset_panoptic
from ..evaluation.rotated_coco_eval import RotatedCOCOEvaluator
from ..evaluation.sem_seg_eval import SemSegEvaluator, inference_on_dataset_semseg
from ..models.backbone.batch_norm import running_state, update_bn_stats
from ..models.build import build_detector, build_model
from ..models.caption import ClipCaptionModel
from ..models.gpt2 import GPT2Config
from ..models.sampling import generator_draw, rank_draw
from ..parallel import comm
from ..solver.build import build_optimizer
from ..utils.events import CommonMetricPrinter, EventStorage, JSONWriter
from . import hooks as H
from .train_loop import Trainer, make_caption_pl_step

logger = logging.getLogger(__name__)

_SIX_CLASS_SETS = ("Watercolor_test", "Comic_test", "Watercolor_train", "Comic_train")


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="cddmsl_torch training and evaluation")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true", help="restore the newest checkpoint in OUTPUT_DIR")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="processes on this machine, one per GPU (with --device cpu: CPU processes)")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0, help="this machine's index")
    parser.add_argument("--dist-url", default="auto",
                        help="the process group's rendezvous, tcp://host:port ('auto': a free local port)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return parser


def default_setup(cfg: CfgNode, args=None) -> None:
    """Creates OUTPUT_DIR, sets up logging (INFO on rank 0, warnings on the
    others), seeds numpy and torch when SEED >= 0 and, on rank 0, writes the
    merged config to OUTPUT_DIR/config.yaml."""
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    level = logging.INFO if comm.is_main_process() else logging.WARNING
    logging.basicConfig(level=level, format="[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")
    if cfg.SEED >= 0:
        np.random.seed(cfg.SEED)
        torch.manual_seed(cfg.SEED)
    if comm.is_main_process():
        cfg.dump_to_file(os.path.join(cfg.OUTPUT_DIR, "config.yaml"))
    comm.synchronize()


def build_evaluator(cfg: CfgNode, dataset_name: str):
    """The VOC evaluator (Watercolor and Comic scored on the 6 classes they
    annotate), for a "coco" set the COCO evaluator of bbox (and segm with
    MODEL.MASK_ON, keypoints with MODEL.KEYPOINT_ON, its OKS sigmas from
    TEST.KEYPOINT_OKS_SIGMAS where set), which writes its detections to
    OUTPUT_DIR/inference/coco_instances_results_<name>.json, for an
    "lvis" set the LVIS evaluator, for a "sem_seg" set the sem-seg
    evaluator, for a panoptic set ("coco_panoptic_seg",
    "cityscapes_panoptic_seg") the PQ evaluator, for "cityscapes_instance"
    the Cityscapes instance evaluator (segm under MODEL.MASK_ON, else its
    bbox proxy) and for "rotated_coco" the rotated-box COCO evaluator.
    Cityscapes' instance sets are "pascal_voc" sets, as JAX registers them.
    Other evaluator types are not ported."""
    ev_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "pascal_voc")
    if ev_type == "pascal_voc":
        target = ARTISTIC_6_CLASSES if dataset_name in _SIX_CLASS_SETS else None
        return PascalVOCDetectionEvaluator(dataset_name, target_classnames=target)
    if ev_type == "coco":
        out_json = (os.path.join(cfg.OUTPUT_DIR, "inference", f"coco_instances_results_{dataset_name}.json")
                    if cfg.OUTPUT_DIR else None)
        tasks = ("bbox",) + (("segm",) if cfg.MODEL.MASK_ON else ()) + (("keypoints",) if cfg.MODEL.KEYPOINT_ON else ())
        return COCOEvaluator(dataset_name, output_json=out_json, tasks=tasks,
                             kpt_oks_sigmas=list(cfg.TEST.KEYPOINT_OKS_SIGMAS) or None)
    if ev_type == "lvis":
        return LVISEvaluator(dataset_name)
    if ev_type == "sem_seg":
        return SemSegEvaluator(dataset_name)
    if ev_type in ("coco_panoptic_seg", "cityscapes_panoptic_seg"):
        return COCOPanopticEvaluator(dataset_name)
    if ev_type == "cityscapes_instance":
        # mask-level AP with masks, the bbox proxy (with a warning) without
        return CityscapesInstanceEvaluator(dataset_name, tasks=("segm",) if cfg.MODEL.MASK_ON else ("bbox",))
    if ev_type == "rotated_coco":
        return RotatedCOCOEvaluator(dataset_name)
    raise NotImplementedError(f"evaluator type {ev_type!r} of {dataset_name} is not ported")


def _global_means(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's metrics on the host: each loss's mean over the ranks (the
    global batch's), `lr` as it is (the same on every rank)."""
    names = [k for k in metrics if k != "lr"]
    values = torch.stack([metrics[k].detach().float() for k in names])
    comm.all_reduce_mean_([values])
    host = dict(zip(names, values.tolist()))
    if "lr" in metrics:
        host["lr"] = float(metrics["lr"])
    return host


def _iteration_seed(seed: int, iteration: int, *fold: int) -> int:
    return int(np.random.SeedSequence([seed, iteration, *fold]).generate_state(1, np.uint64)[0])


def build_caption_model(cfg: CfgNode, device="cuda") -> ClipCaptionModel:
    """The frozen caption model of the caption_pl branches, in float32:
    GPT-2 of TPU.GPT2_*, a ClipCap mapper of 8 layers whose prefix and clip
    lengths are TPU.V2L_MAPPER_TOKENS, from the detector's CLIP embedding
    width; seeded random weights (SEED + 41), then MODEL.VISION_TO_LANG_PATH
    into `clip_project` and MODEL.CAPTION_GPT2_PATH into `gpt` where set."""
    t = cfg.TPU
    gpt = GPT2Config(vocab_size=t.GPT2_VOCAB, n_positions=t.GPT2_POSITIONS, n_embd=t.GPT2_EMBD,
                     n_layer=t.GPT2_LAYERS, n_head=t.GPT2_HEADS)
    model = ClipCaptionModel(prefix_length=t.V2L_MAPPER_TOKENS, clip_length=t.V2L_MAPPER_TOKENS,
                             dim_clip=model_config_from_cfg(cfg).embed_dim, gpt_config=gpt)
    init_random_(model, torch.Generator().manual_seed(max(cfg.SEED, 0) + 41))
    if cfg.MODEL.VISION_TO_LANG_PATH:
        load_mapper_state(model.clip_project, load_torch_state_dict(cfg.MODEL.VISION_TO_LANG_PATH),
                          "caption model's ClipCap mapper")
    if cfg.MODEL.CAPTION_GPT2_PATH:
        load_gpt2(model.gpt, load_torch_state_dict(cfg.MODEL.CAPTION_GPT2_PATH))
    return model.requires_grad_(False).to(resolve_device(device)).eval()


class DefaultTrainer:
    def __init__(self, cfg: CfgNode, device="cuda"):
        register_all()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        model = build_detector(cfg, device="cpu", training=True)
        init_random_(model, torch.Generator().manual_seed(max(cfg.SEED, 0)))
        self.model = model.to(self.device)
        self.optimizer = build_optimizer(self.model, solver_config_from_cfg(cfg))
        self._draw_seed = max(cfg.SEED, 0) + 12345
        self.generator = torch.Generator(device=self.device)
        branch = cfg.MODEL.CONSISTENCY_BRANCH
        self.state = Trainer(
            self.model, self.optimizer, caption_burnup_iters=cfg.SOLVER.CAPTION_BURNUP_ITERS,
            generator=self.generator, kd_regularization=cfg.MODEL.KD_REGULRAZIATION,
            enable_caption=cfg.TPU.ENABLE_CAPTION_CONSISTENCY, accum_steps=cfg.SOLVER.ACCUM_STEPS,
            consistency_branch=branch if branch in ("image", "image_region") else "",
            consistency_weight=cfg.MODEL.CONSISTENCY_LOSS_WEIGHT,
        )
        self.caption_model = self.caption_pl_step = None
        if branch.startswith("caption_pl"):
            self.caption_model = build_caption_model(cfg, self.device)
            self.caption_pl_step = make_caption_pl_step(
                self.model, self.caption_model, self.optimizer, level=branch[len("caption_pl_"):],
                loss_type=cfg.MODEL.CAPTION_PL_LOSS, max_len=cfg.MODEL.CAPTION_PL_MAX_LEN,
                loss_weight=cfg.MODEL.CONSISTENCY_LOSS_WEIGHT,
            )
        self.checkpointer = DetectionCheckpointer(cfg.OUTPUT_DIR, max_to_keep=cfg.SOLVER.CHECKPOINT_MAX_TO_KEEP)
        self.openset_model = None
        if cfg.MODEL.CLIP.OPENSET_TEST_NUM_CLASSES:
            config = model_config_from_cfg(cfg)
            self.openset_model = build_model(
                dataclasses.replace(config, num_classes=cfg.MODEL.CLIP.OPENSET_TEST_NUM_CLASSES), device=self.device)
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self._hooks = []

    # ---- weight loading ----
    def resume_or_load(self, resume: bool = True) -> None:
        """Restores the newest checkpoint (with `resume`), else
        `load_weights`."""
        if resume and self.checkpointer.has_checkpoint():
            self.checkpointer.load(self.checkpointer.get_checkpoint_file(), self.state)
        else:
            self.load_weights(self.state)
        self.start_iter = self.state.iteration

    def load_weights(self, state) -> None:
        """A fresh start: MODEL.WEIGHTS into `state` where set, then the
        side-loads of the text embeddings, the ClipCap mapper and the
        RegionCLIP offline backbone from the paths set."""
        cfg = self.cfg
        if cfg.MODEL.WEIGHTS:
            self.checkpointer.load_weights(cfg.MODEL.WEIGHTS, state)
        if cfg.MODEL.CLIP.TEXT_EMB_PATH:
            load_text_emb_classifier(self.model, cfg.MODEL.CLIP.TEXT_EMB_PATH)
        if cfg.MODEL.VISION_TO_LANG_PATH:
            load_clipcap_mapper(self.model, cfg.MODEL.VISION_TO_LANG_PATH)
        if cfg.MODEL.PRE_TRAINED_RCLIP_PATH:
            load_offline_backbone(self.model, cfg.MODEL.PRE_TRAINED_RCLIP_PATH)

    # ---- hooks ----
    def build_hooks(self):
        cfg = self.cfg
        writers = []
        if comm.is_main_process():
            writers = [CommonMetricPrinter(self.max_iter), JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]
        ret = [H.IterationTimer()]
        if cfg.SOLVER.CHECKPOINT_PERIOD:
            ret.append(H.PeriodicCheckpointer(self.checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD))
        if cfg.TEST.EVAL_PERIOD:
            ret.append(H.EvalHook(cfg.TEST.EVAL_PERIOD, self._eval_into_storage))
        ret.append(H.PeriodicWriter(writers, period=20))
        return ret

    def register_hooks(self, hooks_list) -> None:
        for h in hooks_list:
            h.trainer = self
        self._hooks = list(hooks_list)

    def _eval_into_storage(self, model: Optional[torch.nn.Module] = None, prefix: str = "") -> None:
        for ds, res in self.test(model=model).items():
            for task, m in res.items():
                for k, v in m.items():
                    if "-" not in k:  # not the per-class AP50-x
                        self.storage.put_scalar(f"{prefix}{ds}/{task}/{k}", v, smoothing_hint=False)

    # ---- training ----
    def run_step(self, batch) -> Dict[str, torch.Tensor]:
        """One training step with this iteration's draws, then with a
        caption_pl branch the pseudo-label step on the same batch."""
        it = self.state.iteration
        self.generator.manual_seed(_iteration_seed(self._draw_seed, it))
        metrics = self.state.train_step(batch)
        if self.caption_pl_step is not None:
            self.generator.manual_seed(_iteration_seed(self._draw_seed, it, 1))
            metrics.update(self.caption_pl_step(batch, self.state.draw))
        return metrics

    def build_train_loader(self):
        return build_detection_train_loader(self.cfg, seed=max(self.cfg.SEED, 0),
                                            pin_memory=self.device.type == "cuda")

    def batch_to_device(self, batch):
        return to_device(batch, self.device)

    def train(self) -> Dict[str, dict]:
        """Iterations start_iter..MAX_ITER-1, then model_final and
        `final_test`. Raises FloatingPointError when the loss is not finite
        at a logging step. The host's wait on the loader is the `data_time`
        scalar."""
        cfg = self.cfg
        loader = self.build_train_loader()
        self.register_hooks(self.build_hooks())
        log_period = 20
        logger.info("Starting training from iteration %d", self.start_iter)
        try:
            with EventStorage(self.start_iter) as storage:
                self.storage = storage
                for h in self._hooks:
                    h.before_train()
                t_step = time.perf_counter()
                for it in range(self.start_iter, self.max_iter):
                    for h in self._hooks:
                        h.before_step()
                    t0 = time.perf_counter()
                    batch = next(loader)
                    storage.put_scalar("data_time", time.perf_counter() - t0)
                    metrics = self.run_step(self.batch_to_device(batch))
                    if (it + 1) % log_period == 0 or it == self.max_iter - 1:
                        host = _global_means(metrics)  # the loop's sync point
                        if not np.isfinite(host["total_loss"]):
                            raise FloatingPointError(f"Loss became infinite or NaN at iteration={it}! metrics={host}")
                        now = time.perf_counter()
                        storage.put_scalar("time", (now - t_step) / log_period, smoothing_hint=False)
                        t_step = now
                        for k, v in host.items():
                            storage.put_scalar(k, v)
                    for h in self._hooks:
                        h.after_step()
                    storage.step()
                for h in self._hooks:
                    h.after_train()
        finally:
            loader.close()
        self.checkpointer.save("model_final", self.state)
        if not cfg.DATASETS.TEST:
            return {}
        return self.final_test()

    # ---- evaluation ----
    def final_test(self) -> Dict[str, dict]:
        """The test after training, checked against TEST.EXPECTED_RESULTS."""
        results = self.test()
        self._verify_final(results)
        return results

    def test(self, cfg: Optional[CfgNode] = None, model: Optional[torch.nn.Module] = None) -> Dict[str, dict]:
        """Every DATASETS.TEST set through `inference_on_dataset` of `model`
        (the trained model by default) in MODEL.CLIP.IMS_PER_BATCH_TEST
        batches, rounded up to a multiple of the ranks: {dataset: {"bbox":
        {...}}}, on every rank. A panoptic set goes through
        `inference_on_dataset_panoptic` with MODEL.PANOPTIC_FPN.COMBINE's
        thresholds ({"panoptic_seg": PQ ...}), a sem-seg set through
        `inference_on_dataset_semseg` ({"sem_seg": mIoU ...}). With
        TEST.PRECISE_BN the model evaluates with re-estimated running
        statistics (`_precise_bn`)."""
        cfg = cfg or self.cfg
        model = self.model if model is None else model
        if self.openset_model is not None:
            model = self._openset(cfg, model)
        with self._precise_bn(cfg, model):
            return self._test(cfg, model)

    @contextlib.contextmanager
    def _precise_bn(self, cfg: CfgNode, model: torch.nn.Module):
        """TEST.PRECISE_BN (JAX's `_maybe_precise_bn`): for the block the
        model's running state is re-estimated as the mean of the statistics
        of NUM_ITER training batches (`update_bn_stats`) from a loader
        seeded max(SEED, 0) + 777, the draws of each forward from max(SEED,
        0) + 778; afterwards the training state goes on from its own EMA.
        Nothing happens without running state (FrozenBN models)."""
        state = running_state(model)
        if not (cfg.TEST.PRECISE_BN.ENABLED and state):
            yield
            return
        seed = max(cfg.SEED, 0)
        loader = build_detection_train_loader(cfg, seed=seed + 777, pin_memory=self.device.type == "cuda")
        generator = torch.Generator(device=self.device)

        def forward(batch):
            generator.manual_seed(seed + 778)
            batch = self.batch_to_device(batch)  # a rank draws its rows of the global draws, as in the step
            model.cddmsl_losses(batch, rank_draw(generator_draw(generator), batch.image.shape[0]), False, True, False)

        n_iter = cfg.TEST.PRECISE_BN.NUM_ITER
        logger.info("PreciseBN: re-estimating the running state over %d batches", n_iter)
        try:
            means = update_bn_stats(model, forward, (next(loader) for _ in range(n_iter)))
        finally:
            loader.close()
        kept = {k: v.clone() for k, v in state.items()}
        with torch.no_grad():
            for k, v in state.items():
                v.copy_(means[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, v in state.items():
                    v.copy_(kept[k])

    def _test(self, cfg: CfgNode, model: torch.nn.Module) -> Dict[str, dict]:
        world = comm.get_world_size()
        batch_size = -(-cfg.MODEL.CLIP.IMS_PER_BATCH_TEST // world) * world
        results = {}
        for name in cfg.DATASETS.TEST:
            # the loader first: a COCO set names its classes in the metadata when it is read
            loader, n = build_detection_test_loader(cfg, name, batch_size, pin_memory=self.device.type == "cuda")
            with loader:
                evaluator = build_evaluator(cfg, name)
                if isinstance(evaluator, COCOPanopticEvaluator):
                    comb = cfg.MODEL.PANOPTIC_FPN.COMBINE
                    results[name] = inference_on_dataset_panoptic(
                        model, loader, evaluator, dict(overlap_threshold=comb.OVERLAP_THRESH,
                                                       stuff_area_limit=comb.STUFF_AREA_LIMIT,
                                                       instances_score_thresh=comb.INSTANCES_CONFIDENCE_THRESH),
                        self.device)
                elif isinstance(evaluator, SemSegEvaluator):
                    results[name] = inference_on_dataset_semseg(model, loader, evaluator, self.device)
                else:
                    results[name] = inference_on_dataset(model, loader, n, evaluator, self.device)
            logger.info("Results on %s:", name)
            print_csv_format(results[name])
        return results

    @torch.no_grad()
    def _openset(self, cfg: CfgNode, model: torch.nn.Module) -> torch.nn.Module:
        """The open-set eval model: `model`'s tensors, and the classifier
        rows of OPENSET_TEST_TEXT_EMB_PATH (one per open-set class)."""
        path = cfg.MODEL.CLIP.OPENSET_TEST_TEXT_EMB_PATH
        if not path:
            raise ValueError("MODEL.CLIP.OPENSET_TEST_NUM_CLASSES needs MODEL.CLIP.OPENSET_TEST_TEXT_EMB_PATH: the "
                             "open-set classifier's rows")
        rows, trained = "roi_heads.box_predictor.cls_score.weight", model.state_dict()
        self.openset_model.load_state_dict({k: trained[k] for k in self.openset_model.state_dict() if k != rows},
                                           strict=False)
        load_text_emb_classifier(self.openset_model, path)
        return self.openset_model

    def _verify_final(self, results) -> None:
        """TEST.EXPECTED_RESULTS, checked on the final results of a single
        test set."""
        if self.cfg.TEST.EXPECTED_RESULTS and len(results) == 1:
            if not verify_results(self.cfg, next(iter(results.values()))):
                raise RuntimeError("Result verification failed!")


class DefaultPredictor:
    """One image in, its detections in original-image coordinates out:
    resized by INPUT.MIN/MAX_SIZE_TEST, padded to the TPU.PAD_SIZE_TEST
    bucket of its orientation, `model.inference`. Without a `model` it
    builds the serving model with seeded random weights, then loads
    MODEL.WEIGHTS (a file `DetectionCheckpointer` wrote or a reference
    checkpoint) and then the text embeddings of MODEL.CLIP.TEXT_EMB_PATH
    over it, in the order of the JAX package's `resume_or_load`. With a
    mask head the output has "masks": (N, H, W) bool, pasted into the
    original image (`paste_masks_np`)."""

    def __init__(self, cfg: CfgNode, model: Optional[torch.nn.Module] = None, device="cuda"):
        self.cfg = cfg
        if model is None:
            check_supported(cfg)
            model = build_detector(cfg, device="cpu")
            init_random_(model, torch.Generator().manual_seed(max(cfg.SEED, 0)))
            model = model.to(resolve_device(device))
            if cfg.MODEL.WEIGHTS:
                DetectionCheckpointer.load_model(cfg.MODEL.WEIGHTS, model)
            if cfg.MODEL.CLIP.TEXT_EMB_PATH:
                load_text_emb_classifier(model, cfg.MODEL.CLIP.TEXT_EMB_PATH)
        self.model = model
        self.device = next(model.parameters()).device

    def __call__(self, original_image: np.ndarray) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        resize = ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
        img, _ = apply_augmentations([resize], original_image, np.random.RandomState(0))
        sample = {"image": img, "orig_hw": np.asarray(original_image.shape[:2], np.int32),
                  "boxes": np.zeros((0, 4), np.float32), "classes": np.zeros((0,), np.int32)}
        batch = pad_and_collate([sample], _bucket_for(sample, tuple(cfg.TPU.PAD_SIZE_TEST)), cfg.TPU.MAX_GT_BOXES,
                                with_trgt=False)
        det = self.model.inference(to_device(batch, self.device))
        keep = det.valid[0].cpu()
        out = {k: getattr(det, k)[0].cpu()[keep].numpy() for k in ("boxes", "scores", "classes")}
        if det.masks is not None:  # the box-frame probabilities pasted into the original image
            out["masks"] = paste_masks_np(det.masks[0].cpu()[keep].numpy(), out["boxes"], original_image.shape[:2])
        return out
