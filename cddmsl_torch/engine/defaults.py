"""Training and evaluation orchestration on one device (counterpart of
cddmsl_tpu/engine/defaults.py: `default_argument_parser`, `default_setup`,
`build_evaluator`, `DefaultPredictor` and `DefaultTrainer`).

`DefaultTrainer` builds the CDDMSL model with seeded random weights, its
optimizer and the training state, restores or side-loads weights
(`resume_or_load`), runs the loop with its hooks, the NaN guard and the
periodic checkpoints, saves `model_final` and evaluates every
DATASETS.TEST set (`test`), the Watercolor and Comic sets on their 6
classes. One process drives one device; there is no mesh.

Each iteration's sampler draws come from a generator seeded by (SEED,
iteration), as the JAX loop folds the iteration into its key, so a resumed
run draws what an uninterrupted one would.
"""

import argparse
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import DetectionCheckpointer
from ..checkpoint.convert_jax import init_random_
from ..checkpoint.convert_torch import load_clipcap_mapper, load_offline_backbone, load_text_emb_classifier
from ..config import CfgNode, check_supported, model_config_from_cfg, solver_config_from_cfg
from ..data import MetadataCatalog, build_detection_test_loader, build_detection_train_loader, register_all, to_device
from ..data.build import _bucket_for, pad_and_collate
from ..data.datasets.voc import ARTISTIC_6_CLASSES
from ..data.transforms import ResizeShortestEdge, apply_augmentations
from ..device import resolve_device
from ..evaluation import (
    COCOEvaluator, PascalVOCDetectionEvaluator, inference_on_dataset, print_csv_format, verify_results,
)
from ..models.build import build_model
from ..solver.build import build_optimizer
from ..utils.events import CommonMetricPrinter, EventStorage, JSONWriter
from . import hooks as H
from .train_loop import Trainer

logger = logging.getLogger(__name__)

_SIX_CLASS_SETS = ("Watercolor_test", "Comic_test", "Watercolor_train", "Comic_train")


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="cddmsl_torch training and evaluation")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true", help="restore the newest checkpoint in OUTPUT_DIR")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return parser


def default_setup(cfg: CfgNode, args=None) -> None:
    """Creates OUTPUT_DIR, sets up logging, seeds numpy and torch when
    SEED >= 0 and writes the merged config to OUTPUT_DIR/config.yaml."""
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")
    if cfg.SEED >= 0:
        np.random.seed(cfg.SEED)
        torch.manual_seed(cfg.SEED)
    cfg.dump_to_file(os.path.join(cfg.OUTPUT_DIR, "config.yaml"))


def build_evaluator(cfg: CfgNode, dataset_name: str):
    """The VOC evaluator (Watercolor and Comic scored on the 6 classes they
    annotate), or for a "coco" set the COCO bbox evaluator, which writes its
    detections to OUTPUT_DIR/inference/coco_instances_results_<name>.json.
    Other evaluator types, and COCO segm and keypoints, are not ported."""
    ev_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "pascal_voc")
    if ev_type == "pascal_voc":
        target = ARTISTIC_6_CLASSES if dataset_name in _SIX_CLASS_SETS else None
        return PascalVOCDetectionEvaluator(dataset_name, target_classnames=target)
    if ev_type == "coco":
        if cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINT_ON:
            raise NotImplementedError(f"COCO segm and keypoint evaluation of {dataset_name} is not ported")
        out_json = (os.path.join(cfg.OUTPUT_DIR, "inference", f"coco_instances_results_{dataset_name}.json")
                    if cfg.OUTPUT_DIR else None)
        return COCOEvaluator(dataset_name, output_json=out_json)
    raise NotImplementedError(f"evaluator type {ev_type!r} of {dataset_name} is not ported")


def _iteration_seed(seed: int, iteration: int) -> int:
    return int(np.random.SeedSequence([seed, iteration]).generate_state(1, np.uint64)[0])


class DefaultTrainer:
    def __init__(self, cfg: CfgNode, device="cuda"):
        register_all()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        model = build_model(model_config_from_cfg(cfg), device="cpu", training=True)
        init_random_(model, torch.Generator().manual_seed(max(cfg.SEED, 0)))
        self.model = model.to(self.device)
        self.optimizer = build_optimizer(self.model, solver_config_from_cfg(cfg))
        self._draw_seed = max(cfg.SEED, 0) + 12345
        self.generator = torch.Generator(device=self.device)
        self.state = Trainer(
            self.model, self.optimizer, caption_burnup_iters=cfg.SOLVER.CAPTION_BURNUP_ITERS,
            generator=self.generator, kd_regularization=cfg.MODEL.KD_REGULRAZIATION,
            enable_caption=cfg.TPU.ENABLE_CAPTION_CONSISTENCY, accum_steps=cfg.SOLVER.ACCUM_STEPS,
        )
        self.checkpointer = DetectionCheckpointer(cfg.OUTPUT_DIR, max_to_keep=cfg.SOLVER.CHECKPOINT_MAX_TO_KEEP)
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self._hooks = []

    # ---- weight loading ----
    def resume_or_load(self, resume: bool = True) -> None:
        """Restores the newest checkpoint (with `resume`) or MODEL.WEIGHTS;
        on a fresh start also side-loads the text embeddings, the ClipCap
        mapper and the RegionCLIP offline backbone from the paths set."""
        cfg = self.cfg
        resumed = resume and self.checkpointer.has_checkpoint()
        self.checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, self.state, resume)
        if not resumed:
            if cfg.MODEL.CLIP.TEXT_EMB_PATH:
                load_text_emb_classifier(self.model, cfg.MODEL.CLIP.TEXT_EMB_PATH)
            if cfg.MODEL.VISION_TO_LANG_PATH:
                load_clipcap_mapper(self.model, cfg.MODEL.VISION_TO_LANG_PATH)
            if cfg.MODEL.PRE_TRAINED_RCLIP_PATH:
                load_offline_backbone(self.model, cfg.MODEL.PRE_TRAINED_RCLIP_PATH)
        self.start_iter = self.state.iteration

    # ---- hooks ----
    def build_hooks(self):
        cfg = self.cfg
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

    def _eval_into_storage(self) -> None:
        for ds, res in self.test().items():
            for task, m in res.items():
                for k, v in m.items():
                    if "-" not in k:  # not the per-class AP50-x
                        self.storage.put_scalar(f"{ds}/{task}/{k}", v, smoothing_hint=False)

    # ---- training ----
    def run_step(self, batch) -> Dict[str, torch.Tensor]:
        """One training step with this iteration's draws."""
        self.generator.manual_seed(_iteration_seed(self._draw_seed, self.state.iteration))
        return self.state.train_step(batch)

    def train(self) -> Dict[str, dict]:
        """Iterations start_iter..MAX_ITER-1, then model_final and `test`.
        Raises FloatingPointError when the loss is not finite at a logging
        step. The host's wait on the loader is the `data_time` scalar."""
        cfg = self.cfg
        loader = build_detection_train_loader(cfg, seed=max(cfg.SEED, 0), pin_memory=self.device.type == "cuda")
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
                    metrics = self.run_step(to_device(batch, self.device))
                    if (it + 1) % log_period == 0 or it == self.max_iter - 1:
                        host = {k: float(v) for k, v in metrics.items()}  # the loop's sync point
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
        results = self.test()
        self._verify_final(results)
        return results

    # ---- evaluation ----
    def test(self, cfg: Optional[CfgNode] = None) -> Dict[str, dict]:
        """Every DATASETS.TEST set through `inference_on_dataset` in
        MODEL.CLIP.IMS_PER_BATCH_TEST batches: {dataset: {"bbox": {...}}}."""
        cfg = cfg or self.cfg
        results = {}
        for name in cfg.DATASETS.TEST:
            # the loader first: a COCO set names its classes in the metadata when it is read
            loader, n = build_detection_test_loader(cfg, name, pin_memory=self.device.type == "cuda")
            with loader:
                evaluator = build_evaluator(cfg, name)
                results[name] = inference_on_dataset(self.model, loader, n, evaluator, self.device)
            logger.info("Results on %s:", name)
            print_csv_format(results[name])
        return results

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
    over it, in the order of the JAX package's `resume_or_load`."""

    def __init__(self, cfg: CfgNode, model: Optional[torch.nn.Module] = None, device="cuda"):
        self.cfg = cfg
        if model is None:
            check_supported(cfg)
            model = build_model(model_config_from_cfg(cfg), device="cpu")
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
        return {k: getattr(det, k)[0].cpu()[keep].numpy() for k in ("boxes", "scores", "classes")}
