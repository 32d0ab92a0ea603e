"""The dataset inference loop with data, compute and evaluation time (the
port's copy of cddmsl_tpu/evaluation/evaluator.py `inference_on_dataset`,
`print_csv_format` and `verify_results`)."""

import logging
import time

import numpy as np

from ..data.build import to_device

logger = logging.getLogger(__name__)


def inference_on_dataset(model, data_loader, num_images: int, evaluator, device=None) -> dict:
    """Runs `model.inference` over the loader's (DetBatch, metas) pairs on
    `device` (the model's own by default), feeds the evaluator each real
    image's detections and ground truth, and returns its metrics. The rows
    past len(metas) repeat the batch's last image and are dropped. Reading
    the detections back to the host is each batch's sync. The ground truth's
    `difficult` flags (0 where a record has none) go in third, as in the JAX
    package, where `COCOEvaluator.process_gt` takes them as `iscrowd`."""
    evaluator.reset()
    device = device if device is not None else next(model.parameters()).device
    total_compute = total_eval = total_data = 0.0
    start = t_data = time.perf_counter()
    seen = 0
    for batch, metas in data_loader:
        total_data += time.perf_counter() - t_data
        t0 = time.perf_counter()
        det = model.inference(to_device(batch, device))
        boxes, scores, classes, valid = (t.cpu().numpy() for t in (det.boxes, det.scores, det.classes, det.valid))
        total_compute += time.perf_counter() - t0

        t1 = time.perf_counter()
        for i, meta in enumerate(metas):
            keep = valid[i]
            evaluator.process(meta["image_id"], boxes[i][keep], scores[i][keep], classes[i][keep])
            if "annotations" in meta:
                annos = meta["annotations"]
                gb = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
                gc = np.array([a["category_id"] for a in annos], np.int32).reshape(-1)
                gd = np.array([a.get("difficult", 0) for a in annos], bool).reshape(-1)
                evaluator.process_gt(meta["image_id"], gb, gc, gd)
        seen += len(metas)
        total_eval += time.perf_counter() - t1
        t_data = time.perf_counter()
    logger.info(
        "Inference done on %d of %d images: total %.1fs (%.4fs/img compute, %.4fs/img data, %.4fs/img eval)",
        seen, num_images, time.perf_counter() - start,
        total_compute / max(seen, 1), total_data / max(seen, 1), total_eval / max(seen, 1),
    )
    return evaluator.evaluate()


def print_csv_format(results: dict) -> str:
    lines = []
    for task, metrics in results.items():
        lines.append(f"[{task}]")
        lines.append(",".join(metrics.keys()))
        lines.append(",".join(f"{v:.4f}" for v in metrics.values()))
    out = "\n".join(lines)
    logger.info("Evaluation results:\n%s", out)
    return out


def verify_results(cfg, results: dict) -> bool:
    """TEST.EXPECTED_RESULTS = [[task, metric, mean, tolerance], ...]."""
    ok = True
    for task, metric, mean, tol in cfg.TEST.EXPECTED_RESULTS:
        actual = results[task][metric]
        if abs(actual - mean) > tol:
            logger.error("%s/%s = %.4f, expected %.4f +/- %.4f", task, metric, actual, mean, tol)
            ok = False
    return ok
