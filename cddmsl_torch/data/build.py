"""Data loaders: dataset dicts -> fixed-shape `DetBatch` stream (the port's
copy of the single-process path of cddmsl_tpu/data/build.py).

The host side is numpy and runs in the JAX package's order: the sampler's
permutations, the mapper's draws from one `np.random.RandomState`, grouping
by orientation into the landscape and portrait pad buckets, and collation
into zero-padded arrays with the ground truth padded to TPU.MAX_GT_BOXES, so
a batch equals JAX's bit for bit. Batches are CPU tensors; a background
thread builds them ahead of the consumer and, with `pin_memory`, pins them,
so that `to_device` copies them to the card without blocking.

The mean-teacher loader (`build_semisup_train_loader_two_crops`) splits the
training set into a labeled and an unlabeled part (`divide_label_unlabel`)
and yields ((label_strong, label_weak), (unlabel_strong, unlabel_weak)):
two sampler streams, one mapper state serving both, labeled first.

With MODEL.LOAD_PROPOSALS each set's dicts take the proposals of its
DATASETS.PROPOSAL_FILES_* file (`proposals.py`), the mapper moves them with
the image, and the batch carries the top DATASETS.PRECOMPUTED_PROPOSAL_TOPK_*
of each image (`DetBatch.proposal_*`).

Loaders are closable: `close()` (or leaving a `with` block) stops the
prefetch thread, which would otherwise run on for an infinite train stream.

Under a process group (JAX's `_process_block`) every rank walks the same
sampler stream and maps every sample of the same global batches, as one
process does, so all ranks agree on each step's pad bucket and the mapper's
random stream runs as on one process; then each collates only its rows of
the batch (`_process_block`: its `local_rows` block, of each microbatch with
SOLVER.ACCUM_STEPS). The blocks in rank order are the single process's
batch, row for row. The test loader splits each batch so, and every rank
receives the whole batch's metadata.
"""

import json
import os
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.rcnn import DetBatch
from ..parallel import comm
from .catalog import DatasetCatalog
from .dataset_mapper import DatasetMapper, DatasetMapperTwoCropSeparate
from .proposals import load_proposals_into_dataset


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


def pad_and_collate(samples: List[dict], pad_hw: Tuple[int, int], max_gt: int = 100, with_trgt: bool = True,
                    max_proposals: int = 0) -> DetBatch:
    """Samples -> a DetBatch of CPU tensors: images zero-padded to `pad_hw`
    at the top left, the true and original sizes, the first `max_gt` boxes
    and classes of each image with a validity mask; with `max_proposals`
    the first that many precomputed proposals of each image (scores -inf
    and not valid past them)."""
    b = len(samples)
    H, W = pad_hw
    images = np.zeros((b, H, W, 3), np.float32)
    images_t = np.zeros((b, H, W, 3), np.float32) if with_trgt else None
    sizes = np.zeros((b, 2), np.int32)
    orig = np.zeros((b, 2), np.int32)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    prop_boxes = np.zeros((b, max_proposals, 4), np.float32)
    prop_scores = np.full((b, max_proposals), -np.inf, np.float32)
    prop_valid = np.zeros((b, max_proposals), bool)
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
        p = min(len(s.get("proposal_boxes", ())), max_proposals)
        if p:
            prop_boxes[i, :p] = s["proposal_boxes"][:p]
            prop_scores[i, :p] = s["proposal_objectness"][:p]
            prop_valid[i, :p] = True
    t = torch.from_numpy
    proposals = (t(prop_boxes), t(prop_scores), t(prop_valid)) if max_proposals else (None, None, None)
    return DetBatch(
        image=t(images), image_sizes=t(sizes), orig_sizes=t(orig), gt_boxes=t(gt_boxes),
        gt_classes=t(gt_classes), gt_valid=t(gt_valid), image_trgt=t(images_t) if with_trgt else None,
        proposal_boxes=proposals[0], proposal_scores=proposals[1], proposal_valid=proposals[2],
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


def _process_block(samples: List, rank: int, world: int, parts: int = 1) -> List:
    """This rank's rows of a global batch: its `local_rows` block of each of
    `parts` equal microbatches, in order. All of them on one process."""
    if world == 1:
        return samples
    m = len(samples) // parts
    if m * parts != len(samples):
        raise ValueError(f"a batch of {len(samples)} does not split into {parts} microbatches")
    lo, hi = comm.local_rows(m, rank, world)
    return [s for j in range(parts) for s in samples[j * m + lo : j * m + hi]]


def _shard(rank: Optional[int], world: Optional[int]) -> Tuple[int, int]:
    return (comm.get_rank() if rank is None else rank), (comm.get_world_size() if world is None else world)


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


def build_detection_train_loader(cfg, seed: int = 0, pin_memory: bool = False, rank: Optional[int] = None,
                                 world: Optional[int] = None) -> _Prefetcher:
    """Infinite stream of training DetBatches (with the translated twins)
    of cfg.SOLVER.IMS_PER_BATCH images in all, grouped by orientation into
    the TPU.PAD_SIZE_TRAIN buckets; this rank's rows of each (`rank` and
    `world` default to the process group's)."""
    rank, world = _shard(rank, world)
    dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN, cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    if cfg.MODEL.LOAD_PROPOSALS:
        for path in cfg.DATASETS.PROPOSAL_FILES_TRAIN:
            dicts = load_proposals_into_dataset(dicts, path)
    max_props = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if cfg.MODEL.LOAD_PROPOSALS else 0
    mapper = DatasetMapper(cfg, is_train=True)
    sampler = TrainingSampler(len(dicts), seed=seed)
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    parts = cfg.SOLVER.ACCUM_STEPS
    if batch_size % (parts * world):
        raise ValueError(f"SOLVER.IMS_PER_BATCH {batch_size} does not split into {parts} microbatch(es) over "
                         f"{world} rank(s)")
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
                batch = pad_and_collate(_process_block(group, rank, world, parts), key, max_gt, with_trgt=True,
                                        max_proposals=max_props)
                yield _pinned(batch) if pin_memory else batch

    return _Prefetcher(gen, depth=cfg.DATALOADER.NUM_WORKERS)


def build_detection_test_loader(
    cfg, dataset_name: str, batch_size: Optional[int] = None, pin_memory: bool = False, rank: Optional[int] = None,
    world: Optional[int] = None,
) -> Tuple[_Prefetcher, int]:
    """(finite stream of (DetBatch, metadata dicts), number of images). A
    batch holds images of one orientation; the last batch of each is padded
    by repeating its last image, and the length of its metadata list says
    how many rows are real. The batch size defaults to
    MODEL.CLIP.IMS_PER_BATCH_TEST. Under a process group the DetBatch holds
    this rank's `local_rows` of the batch and the metadata is the whole
    batch's."""
    rank, world = _shard(rank, world)
    dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    if cfg.MODEL.LOAD_PROPOSALS:
        # the file at the set's place in DATASETS.TEST (the first for another set)
        names, files = list(cfg.DATASETS.TEST), list(cfg.DATASETS.PROPOSAL_FILES_TEST)
        k = names.index(dataset_name) if dataset_name in names else 0
        if k < len(files):
            dicts = load_proposals_into_dataset(dicts, files[k])
    max_props = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST if cfg.MODEL.LOAD_PROPOSALS else 0
    mapper = DatasetMapper(cfg, is_train=False)
    batch_size = batch_size or cfg.MODEL.CLIP.IMS_PER_BATCH_TEST
    if batch_size % world:
        raise ValueError(f"an eval batch of {batch_size} does not divide over {world} ranks")
    pad_hw = tuple(cfg.TPU.PAD_SIZE_TEST)
    max_gt = cfg.TPU.MAX_GT_BOXES

    def collate(group):
        key = _bucket_for(group[0], pad_hw)
        batch = pad_and_collate(_process_block(group, rank, world), key, max_gt, with_trgt=False,
                                max_proposals=max_props)
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


def divide_label_unlabel(
    dicts: List[dict], sup_percent: float, seed: int, seed_path: Optional[str] = None
) -> Tuple[List[dict], List[dict]]:
    """(labeled, unlabeled): int(sup_percent% of len(dicts)) indices from the
    reference's JSON seed file at `seed_path` where it exists
    ({sup_percent: {seed: indices}}), else the first of a permutation seeded
    by `seed`; both parts keep the dataset's order."""
    n = len(dicts)
    num_label = int(sup_percent / 100.0 * n)
    if seed_path and os.path.exists(seed_path):
        with open(seed_path) as f:
            idx = json.load(f)[str(sup_percent)][str(seed)][:num_label]
    else:
        idx = np.random.RandomState(seed).permutation(n)[:num_label].tolist()
    labeled = {int(i) for i in idx}
    return [d for i, d in enumerate(dicts) if i in labeled], [d for i, d in enumerate(dicts) if i not in labeled]


def build_semisup_train_loader_two_crops(cfg, seed: int = 0, pin_memory: bool = False, rank: Optional[int] = None,
                                        world: Optional[int] = None) -> _Prefetcher:
    """Infinite stream of ((label_strong, label_weak), (unlabel_strong,
    unlabel_weak)) DetBatches of SOLVER.IMG_PER_BATCH_LABEL and
    IMG_PER_BATCH_UNLABEL images in all, this rank's rows of each. The parts
    are DATASETS.TRAIN_LABEL and TRAIN_UNLABEL with DATASETS.CROSS_DATASET,
    else DATASETS.TRAIN divided by DATALOADER.SUP_PERCENT. The samplers are
    seeded with `seed` and `seed + 7`; one mapper state (`seed + 1`) maps a
    whole labeled batch, then a whole unlabeled one, each grouped by
    orientation into the TPU.PAD_SIZE_TRAIN buckets."""
    rank, world = _shard(rank, world)
    for key in ("IMG_PER_BATCH_LABEL", "IMG_PER_BATCH_UNLABEL"):
        if cfg.SOLVER[key] % world:
            raise ValueError(f"SOLVER.{key} {cfg.SOLVER[key]} does not divide over {world} ranks")
    if cfg.DATASETS.CROSS_DATASET:
        label_dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN_LABEL, True)
        unlabel_dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN_UNLABEL, False)
    else:
        label_dicts, unlabel_dicts = divide_label_unlabel(
            get_detection_dataset_dicts(cfg.DATASETS.TRAIN, True), cfg.DATALOADER.SUP_PERCENT,
            cfg.DATALOADER.RANDOM_DATA_SEED, cfg.DATALOADER.RANDOM_DATA_SEED_PATH,
        )
    mapper = DatasetMapperTwoCropSeparate(cfg, True)
    pad_hw = tuple(cfg.TPU.PAD_SIZE_TRAIN)
    max_gt = cfg.TPU.MAX_GT_BOXES

    def collate(samples, key):
        batch = pad_and_collate(samples, key, max_gt)
        return _pinned(batch) if pin_memory else batch

    def gen():
        rng = np.random.RandomState(seed + 1)
        lab_it = iter(TrainingSampler(len(label_dicts), seed=seed))
        unl_it = iter(TrainingSampler(len(unlabel_dicts), seed=seed + 7))

        def take(dicts, it, n, buckets):
            """(strong, weak) pairs into the orientation buckets until one
            holds n: (its key, this rank's strong samples, its weak ones)."""
            while True:
                s, w = mapper(dicts[next(it)], rng)
                key = _bucket_for(s, pad_hw)
                pairs = buckets.setdefault(key, [])
                pairs.append((s, w))
                if len(pairs) == n:
                    del buckets[key]
                    pairs = _process_block(pairs, rank, world)
                    return key, [p[0] for p in pairs], [p[1] for p in pairs]

        lab_buckets, unl_buckets = {}, {}
        while True:
            key_l, ls, lw = take(label_dicts, lab_it, cfg.SOLVER.IMG_PER_BATCH_LABEL, lab_buckets)
            key_u, us, uw = take(unlabel_dicts, unl_it, cfg.SOLVER.IMG_PER_BATCH_UNLABEL, unl_buckets)
            yield (collate(ls, key_l), collate(lw, key_l)), (collate(us, key_u), collate(uw, key_u))

    return _Prefetcher(gen, depth=cfg.DATALOADER.NUM_WORKERS)
