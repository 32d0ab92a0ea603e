"""The region-language pretraining loop (counterpart of
cddmsl_tpu/engine/pretrain.py: `grid_region_boxes`, `make_pretrain_step`
and `pretrain_loop`).

Every image gets the same static grid of regions (the whole image, a 3x3
tiling and nine half-size tiles: 19 boxes at grid 3). A step is
`PretrainFastRCNN.pretrain_losses_with_text`, the sum of its three losses
in order, backward, and the optimizer's step (engine/train_loop.py's SGD
with its frozen parameters left out). The loop reads a batch of uint8
images and captions, normalises the images on the host in numpy float32
((u8 / 255 - mean) / std, as JAX's loop does), tokenizes the captions, and
steps; the loader runs inline, in the step's thread.
"""

import logging
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from ..models.clip_rcnn import PretrainFastRCNN
from ..solver.build import Optimizer
from .train_loop import check_state_keys

logger = logging.getLogger(__name__)


def grid_region_boxes(image_size: int, grid: int = 3, scales: Tuple[float, ...] = (1.0, 0.5)) -> np.ndarray:
    """Static proposals over a square image: the whole image, then at each
    scale `grid` x `grid` tiles of side image_size * scale / grid -> (R, 4)
    XYXY float32."""
    boxes = [[0.0, 0.0, image_size, image_size]]
    for s in scales:
        side = image_size * s / grid
        steps = int(round(image_size / side)) if s == 1.0 else grid
        step = (image_size - side) / max(steps - 1, 1)
        for i in range(steps):
            for j in range(steps):
                x1, y1 = j * step, i * step
                boxes.append([x1, y1, x1 + side, y1 + side])
    return np.asarray(boxes, np.float32)


class PretrainState:
    """The pretraining state (model, optimizer, iteration); its
    `state_dict` is what `DetectionCheckpointer` saves."""

    def __init__(self, model: PretrainFastRCNN, optimizer: Optimizer, iteration: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.iteration = iteration

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "iteration": self.iteration}

    def load_state_dict(self, state: Dict) -> None:
        check_state_keys(state, self.state_dict().keys())
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])


def make_pretrain_step(state: PretrainState) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> step(images224, boxes, tokens) -> the three losses and
    `total_loss`, kept on the device; one update, iteration + 1."""

    def step(images: torch.Tensor, boxes: torch.Tensor, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        with torch.enable_grad():
            losses = state.model.pretrain_losses_with_text(images, boxes, tokens)
            total = torch.stack(list(losses.values())).sum()
            total.backward()
        state.optimizer.step()
        state.iteration += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def pretrain_loop(
    state: PretrainState,
    batches: Iterable[Tuple[np.ndarray, List[str]]],
    tokenize: Callable[[List[str]], np.ndarray],
    max_iter: int,
    pixel_mean: Sequence[float] = CLIP_PIXEL_MEAN,
    pixel_std: Sequence[float] = CLIP_PIXEL_STD,
    image_size: int = 224,
    grid: int = 3,
    log_period: int = 20,
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor], float], None]] = None,
) -> Dict[str, float]:
    """Up to `max_iter` steps over `batches` ((B, S, S, 3) uint8, captions);
    returns the metrics of the last logging step (every `log_period`-th and
    the last) on the host, and raises FloatingPointError when the total
    there is not finite. `on_step(iteration, metrics, loader_seconds)`, when
    given, runs after each step is enqueued: the host's seconds for the
    batch, its normalisation, its tokens and their copy to the device."""
    step_fn = make_pretrain_step(state)
    device = next(state.model.parameters()).device
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    boxes1 = torch.from_numpy(grid_region_boxes(image_size, grid)).to(device)
    metrics_host: Dict[str, float] = {}
    batches = iter(batches)
    t0 = time.time()
    for it in range(max_iter):
        t_load = time.perf_counter()
        item = next(batches, None)
        if item is None:
            break
        images_u8, captions = item
        images = torch.from_numpy((images_u8.astype(np.float32) / 255.0 - mean) / std).to(device)
        tokens = torch.from_numpy(np.asarray(tokenize(captions), np.int32)).to(device)
        boxes = boxes1.expand(images.shape[0], -1, -1)
        loader_s = time.perf_counter() - t_load
        metrics = step_fn(images, boxes, tokens)
        if on_step is not None:
            on_step(it, metrics, loader_s)
        if (it + 1) % log_period == 0 or it == max_iter - 1:
            metrics_host = {k: float(v) for k, v in metrics.items()}
            if not np.isfinite(metrics_host["total_loss"]):
                raise FloatingPointError(f"non-finite pretrain loss at iter {it}: {metrics_host}")
            logger.info("iter %d/%d %.2fs %s", it + 1, max_iter, time.time() - t0, metrics_host)
    return metrics_host
