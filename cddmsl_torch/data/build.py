"""Data loaders: dataset dicts -> fixed-shape `DetBatch` stream (the port's
copy of the single-process path of cddmsl_tpu/data/build.py).

The host side is numpy and runs in the JAX package's order: the sampler's
permutations, the mapper's draws from one `np.random.RandomState`, grouping
by orientation into the landscape and portrait pad buckets, and collation
into zero-padded arrays with the ground truth padded to TPU.MAX_GT_BOXES, so
a batch equals JAX's bit for bit. Batches are CPU tensors; a background
thread builds them ahead of the consumer and, with `pin_memory`, pins them,
so that `to_device` copies them to the card without blocking.

Loaders are closable: `close()` (or leaving a `with` block) stops the
prefetch thread, which would otherwise run on for an infinite train stream.
"""

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.rcnn import DetBatch
from .catalog import DatasetCatalog
from .dataset_mapper import DatasetMapper


def get_detection_dataset_dicts(names: Sequence[str], filter_empty: bool = True) -> List[dict]:
    if isinstance(names, str):
        names = [names]
    dicts: List[dict] = []
    for name in names:
        dicts.extend(DatasetCatalog.get(name))
    if filter_empty and dicts and "annotations" in dicts[0]:
        dicts = [d for d in dicts if len(d.get("annotations", []))]
    if not dicts:
        raise ValueError(f"No valid images found in {names}")
    return dicts


class TrainingSampler:
    """Infinite stream of shuffled indices, one permutation per epoch."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            if self.shuffle:
                yield from g.permutation(self.size).tolist()
            else:
                yield from range(self.size)


class InferenceSampler:
    def __init__(self, size: int):
        self.size = size

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.size))


def pad_and_collate(samples: List[dict], pad_hw: Tuple[int, int], max_gt: int = 100, with_trgt: bool = True) -> DetBatch:
    """Samples -> a DetBatch of CPU tensors: images zero-padded to `pad_hw`
    at the top left, the true and original sizes, the first `max_gt` boxes
    and classes of each image with a validity mask."""
    b = len(samples)
    H, W = pad_hw
    images = np.zeros((b, H, W, 3), np.float32)
    images_t = np.zeros((b, H, W, 3), np.float32) if with_trgt else None
    sizes = np.zeros((b, 2), np.int32)
    orig = np.zeros((b, 2), np.int32)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        img = s["image"]
        h, w = img.shape[:2]
        if h > H or w > W:
            raise ValueError(f"image ({h},{w}) exceeds pad bucket ({H},{W})")
        images[i, :h, :w] = img
        if with_trgt:
            images_t[i, :h, :w] = s.get("image_trgt", img)
        sizes[i] = (h, w)
        orig[i] = s["orig_hw"]
        n = min(len(s["boxes"]), max_gt)
        if n:
            gt_boxes[i, :n] = s["boxes"][:n]
            gt_classes[i, :n] = s["classes"][:n]
            gt_valid[i, :n] = True
    t = torch.from_numpy
    return DetBatch(
        image=t(images), image_sizes=t(sizes), orig_sizes=t(orig), gt_boxes=t(gt_boxes),
        gt_classes=t(gt_classes), gt_valid=t(gt_valid), image_trgt=t(images_t) if with_trgt else None,
    )


def to_device(batch: DetBatch, device) -> DetBatch:
    """The batch on `device`; from pinned memory the copies do not block."""
    return DetBatch(*(None if f is None else f.to(device, non_blocking=True) for f in batch))


def _pinned(batch: DetBatch) -> DetBatch:
    return DetBatch(*(None if f is None else f.pin_memory() for f in batch))


def _bucket_for(sample: dict, pad_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The pad bucket of a sample: landscape (short, long) or portrait
    (long, short) after its orientation."""
    h, w = sample["image"].shape[:2]
    H, W = min(pad_hw), max(pad_hw)
    return (H, W) if w >= h else (W, H)


class _Prefetcher:
    """Runs `gen_fn()` on a background thread, `depth` items ahead; an
    iterator that stops with the stream and raises the producer's error."""

    def __init__(self, gen_fn: Callable[[], Iterator], depth: int = 4):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = object()
        self._closed = threading.Event()
        self._done = False
        self.thread = threading.Thread(target=self._run, args=(gen_fn,), daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """Waits for room in the queue; False once the loader is closed."""
        while not self._closed.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _run(self, gen_fn):
        try:
            for item in gen_fn():
                if not self._put(item):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)
        self._put(self._stop)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._closed.is_set():
            raise StopIteration
        item = self.q.get()
        if item is self._stop:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item

    def close(self, timeout: float = 30.0) -> None:
        """Stops the producer after its current item and waits for it."""
        self._closed.set()
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("the loader's prefetch thread did not stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_detection_train_loader(cfg, seed: int = 0, pin_memory: bool = False) -> _Prefetcher:
    """Infinite stream of training DetBatches (with the translated twins)
    in cfg.SOLVER.IMS_PER_BATCH, grouped by orientation into the
    TPU.PAD_SIZE_TRAIN buckets."""
    dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN, cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    mapper = DatasetMapper(cfg, is_train=True)
    sampler = TrainingSampler(len(dicts), seed=seed)
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    pad_hw = tuple(cfg.TPU.PAD_SIZE_TRAIN)
    max_gt = cfg.TPU.MAX_GT_BOXES
    aspect_grouping = cfg.DATALOADER.ASPECT_RATIO_GROUPING

    def gen():
        rng = np.random.RandomState(seed + 1)
        buckets = {}
        for idx in sampler:
            sample = mapper(dicts[idx], rng)
            key = _bucket_for(sample, pad_hw) if aspect_grouping else (max(pad_hw), max(pad_hw))
            buckets.setdefault(key, []).append(sample)
            if len(buckets[key]) == batch_size:
                group, buckets[key] = buckets[key], []
                batch = pad_and_collate(group, key, max_gt, with_trgt=True)
                yield _pinned(batch) if pin_memory else batch

    return _Prefetcher(gen, depth=cfg.DATALOADER.NUM_WORKERS)


def build_detection_test_loader(
    cfg, dataset_name: str, batch_size: Optional[int] = None, pin_memory: bool = False
) -> Tuple[_Prefetcher, int]:
    """(finite stream of (DetBatch, metadata dicts), number of images). A
    batch holds images of one orientation; the last batch of each is padded
    by repeating its last image, and the length of its metadata list says
    how many rows are real. The batch size defaults to
    MODEL.CLIP.IMS_PER_BATCH_TEST."""
    dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    mapper = DatasetMapper(cfg, is_train=False)
    batch_size = batch_size or cfg.MODEL.CLIP.IMS_PER_BATCH_TEST
    pad_hw = tuple(cfg.TPU.PAD_SIZE_TEST)
    max_gt = cfg.TPU.MAX_GT_BOXES

    def collate(group):
        batch = pad_and_collate(group, _bucket_for(group[0], pad_hw), max_gt, with_trgt=False)
        return _pinned(batch) if pin_memory else batch

    def gen():
        rng = np.random.RandomState(0)
        groups, metas = {}, {}
        for i in InferenceSampler(len(dicts)):
            d = dicts[i]
            sample = mapper(d, rng)
            key = _bucket_for(sample, pad_hw)
            groups.setdefault(key, []).append(sample)
            metas.setdefault(key, []).append(d)
            if len(groups[key]) == batch_size:
                yield collate(groups[key]), metas[key]
                groups[key], metas[key] = [], []
        for key, group in groups.items():
            if group:
                yield collate(group + [group[-1]] * (batch_size - len(group))), metas[key]

    return _Prefetcher(gen, depth=4), len(dicts)
