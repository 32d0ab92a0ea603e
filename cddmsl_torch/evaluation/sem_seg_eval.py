"""Semantic segmentation evaluation (the port's copy of
cddmsl_tpu/evaluation/sem_seg_eval.py): the confusion matrix over the
labelled pixels, mIoU, fwIoU, mACC, pACC and each class's IoU, and the
dataset loop that feeds it.
"""

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.build import to_device
from ..parallel import comm

logger = logging.getLogger(__name__)


def nearest_resize(m: np.ndarray, hw) -> np.ndarray:
    """(h, w) map -> (H, W), each output pixel the input pixel under its
    center: floor((i + 0.5) h / H), clamped."""
    H, W = int(hw[0]), int(hw[1])
    h, w = m.shape
    if (h, w) == (H, W):
        return m
    yi = np.minimum(((np.arange(H) + 0.5) * h / H).astype(np.int64), h - 1)
    xi = np.minimum(((np.arange(W) + 0.5) * w / W).astype(np.int64), w - 1)
    return m[yi][:, xi]


def feed_rows(data_loader, infer: Callable, feed: Callable, device, what: str) -> None:
    """The loop both segmentation evaluations share: per (DetBatch, metas)
    of the loader, `infer(batch on device)` -> this rank's rows (a list,
    one per row of its DetBatch), then `feed(meta, row)` for each real row
    in the single process's order (under a process group on rank 0, after
    gathering every rank's rows of the batch). Logs the per-image times."""
    world = comm.get_world_size()
    total_compute = total_feed = total_data = 0.0
    seen = 0
    start = t_data = time.perf_counter()
    for batch, metas in data_loader:
        total_data += time.perf_counter() - t_data
        t0 = time.perf_counter()
        rows = infer(to_device(batch, device))
        total_compute += time.perf_counter() - t0
        t1 = time.perf_counter()
        lo = comm.get_rank() * len(rows)
        rows = rows[: max(0, min(len(rows), len(metas) - lo))]
        if world > 1:
            rows = [r for rank_rows in comm.all_gather_objects(rows) for r in rank_rows]
        if world == 1 or comm.is_main_process():
            for meta, row in zip(metas, rows):
                feed(meta, row)
        seen += len(metas)
        total_feed += time.perf_counter() - t1
        t_data = time.perf_counter()
    logger.info("%s inference done on %d images: total %.1fs (%.4fs/img compute, %.4fs/img data, %.4fs/img host)",
                what, seen, time.perf_counter() - start, total_compute / max(seen, 1), total_data / max(seen, 1),
                total_feed / max(seen, 1))


def inference_on_dataset_semseg(model, data_loader, evaluator: "SemSegEvaluator", device=None) -> Dict[str, dict]:
    """`model.inference` (the argmax map of the padded image) over the
    loader; each real image's map cropped to its true size and resized
    NEAREST to its original size, scored against the record's
    `sem_seg_gt` array or its `sem_seg_file_name` PNG (a record with neither
    is skipped). Under a process group rank 0 scores and every rank
    returns the metrics."""
    from PIL import Image

    evaluator.reset()
    device = device if device is not None else next(model.parameters()).device

    def infer(batch):
        pred = model.inference(batch).cpu().numpy()
        sizes, origs = batch.image_sizes.cpu().numpy(), batch.orig_sizes.cpu().numpy()
        return [nearest_resize(p[:h, :w], o) for p, (h, w), o in zip(pred, sizes, origs)]

    def feed(meta, pred):
        if "sem_seg_gt" in meta:
            gt = np.asarray(meta["sem_seg_gt"])
        elif "sem_seg_file_name" in meta:
            gt = np.asarray(Image.open(meta["sem_seg_file_name"]), np.int32)
        else:
            return
        evaluator.process(pred, gt)

    feed_rows(data_loader, infer, feed, device, "Sem-seg")
    if comm.get_world_size() == 1:
        return evaluator.evaluate()
    return comm.broadcast_object(evaluator.evaluate() if comm.is_main_process() else None)


class SemSegEvaluator:
    def __init__(self, dataset_name: str = "", num_classes: int = 0, ignore_label: int = 255,
                 class_names: Optional[Sequence[str]] = None):
        """The classes are the set's `stuff_classes` unless given."""
        if not num_classes and dataset_name:
            from ..data.catalog import MetadataCatalog

            class_names = class_names or MetadataCatalog.get(dataset_name).get("stuff_classes")
            num_classes = len(class_names) if class_names else 0
        if num_classes <= 0:
            raise ValueError("SemSegEvaluator needs num_classes (or a set with stuff_classes)")
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names: List[str] = list(class_names) if class_names else [str(i) for i in range(num_classes)]
        self.reset()

    def reset(self):
        self._conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred, gt: (H, W) int class maps; gt's `ignore_label` pixels are
        left out, predictions clipped to the classes."""
        pred = np.asarray(pred).reshape(-1)
        gt = np.asarray(gt).reshape(-1)
        valid = gt != self.ignore_label
        gt = gt[valid]
        pred = np.clip(pred[valid], 0, self.num_classes - 1)
        idx = gt * self.num_classes + pred
        self._conf += np.bincount(idx, minlength=self.num_classes ** 2).reshape(self.num_classes, self.num_classes)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        conf = self._conf.astype(np.float64)
        tp = np.diag(conf)
        pos_gt = conf.sum(axis=1)
        pos_pred = conf.sum(axis=0)
        union = pos_gt + pos_pred - tp
        iou = np.where(union > 0, tp / np.maximum(union, 1), np.nan)
        acc = np.where(pos_gt > 0, tp / np.maximum(pos_gt, 1), np.nan)
        freq = pos_gt / max(pos_gt.sum(), 1)
        res = {
            "mIoU": 100 * float(np.nanmean(iou)),
            "fwIoU": 100 * float(np.nansum(iou * freq)),
            "mACC": 100 * float(np.nanmean(acc)),
            "pACC": 100 * float(tp.sum() / max(pos_gt.sum(), 1)),
        }
        for i, name in enumerate(self.class_names):
            res[f"IoU-{name}"] = 100 * float(iou[i]) if np.isfinite(iou[i]) else float("nan")
        return {"sem_seg": res}
