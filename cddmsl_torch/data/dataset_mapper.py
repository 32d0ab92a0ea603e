"""Dataset dict -> per-image numpy sample (the port's copy of
cddmsl_tpu/data/dataset_mapper.py `DatasetMapper`, `DatasetMapperTwoCropSeparate`,
`SemSegDatasetMapper` and `PanopticDatasetMapper`).

The image and its translated twin `data_dt_file_name` are read and put
through the same sampled geometric transforms; the boxes follow, are clipped
to the image and empty ones dropped. With MODEL.LOAD_PROPOSALS the dict's
precomputed proposals follow them too (`proposals.transform_proposals`),
the top DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN (or _TEST) kept. With
MODEL.MASK_ON each instance's polygon rings (of 3 points or more) follow
as well, as "polygons", dropped with their boxes; with MODEL.KEYPOINT_ON
each instance's keypoints, (N, K, 3) "keypoints" (`transforms.
transform_keypoint_annotations`, the flip's mirror indices from the
keypoint_names / keypoint_flip_map metadata of the first DATASETS.TRAIN,
or DATASETS.TEST, set). Instances marked difficult are dropped
at train time (the detectron2 VOC convention).

The two-crop mapper of the mean-teacher loader gives (strong, weak) views of
one image under one geometric transform: the weak view is the plain sample,
the strong one its photometric augmentation (and its translated twin's).

`SemSegDatasetMapper` and `PanopticDatasetMapper` (the JAX package's) map
the semantic and the panoptic sets: their label maps follow the image
NEAREST (`Transform.apply_segmentation`).
"""

from typing import Dict, List

import numpy as np
from PIL import Image

from .datasets.coco_panoptic import panoptic_png_to_sem_seg, rgb2id
from .proposals import transform_proposals
from .transforms import (
    TransformList, apply_augmentations, build_augmentation, build_strong_augmentation_fn, create_keypoint_hflip_indices,
    transform_keypoint_annotations,
)


def read_image(path: str, fmt: str = "RGB") -> np.ndarray:
    img = np.asarray(Image.open(path).convert("RGB"))
    return img[:, :, ::-1] if fmt == "BGR" else img


def transform_boxes(annos: List[dict], tfms: TransformList, image_hw, with_masks: bool = False,
                    with_keypoints: bool = False, hflip_indices=None) -> Dict:
    """The annotations' boxes through `tfms`, clipped to `image_hw`, empty
    ones dropped with their classes; `with_masks` adds each instance's
    polygon rings through `tfms` ("polygons": per instance a list of (P, 2)
    arrays; an RLE segmentation gives no ring), `with_keypoints` its
    keypoints ("keypoints" (N, K, 3), K the most an instance has, zeros past
    an instance's own)."""
    boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
    classes = np.array([a["category_id"] for a in annos], np.int32).reshape(-1)
    polygons = None
    if with_masks:
        polygons = []
        for a in annos:
            segs = a.get("segmentation") or []
            rings = [np.asarray(seg, np.float32).reshape(-1, 2) for seg in (segs if isinstance(segs, list) else [])]
            polygons.append([tfms.apply_coords(pts) for pts in rings if len(pts) >= 3])
    keypoints = None
    if with_keypoints:
        kps = [np.asarray(a.get("keypoints", []), np.float32).reshape(-1, 3) for a in annos]
        keypoints = np.zeros((len(annos), max((len(k) for k in kps), default=0), 3), np.float32)
        for i, kp in enumerate(kps):
            if len(kp):
                keypoints[i, :len(kp)] = transform_keypoint_annotations(kp, tfms, image_hw, hflip_indices)
    if len(boxes):
        boxes = tfms.apply_box(boxes)
        h, w = image_hw
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, classes = boxes[keep], classes[keep]
        if polygons is not None:
            polygons = [p for p, k in zip(polygons, keep) if k]
        if keypoints is not None:
            keypoints = keypoints[keep]
    out = {"boxes": boxes, "classes": classes}
    if polygons is not None:
        out["polygons"] = polygons
    if keypoints is not None:
        out["keypoints"] = keypoints
    return out


class DatasetMapper:
    """cfg -> callable(dataset_dict, rng) -> sample dict of numpy arrays:
    image, [image_trgt], boxes (N, 4), classes (N,), hw, orig_hw, image_id."""

    def __init__(self, cfg, is_train: bool = True):
        self.is_train = is_train
        self.augmentations = build_augmentation(cfg, is_train)
        self.image_format = cfg.INPUT.FORMAT
        self.load_proposals = cfg.MODEL.LOAD_PROPOSALS
        self.use_instance_mask = cfg.MODEL.MASK_ON
        self.use_keypoint = cfg.MODEL.KEYPOINT_ON
        self.hflip_indices = None
        names = cfg.DATASETS.TRAIN if is_train else cfg.DATASETS.TEST
        if self.use_keypoint and names:
            from .catalog import MetadataCatalog

            meta = MetadataCatalog.get(names[0])
            if meta.get("keypoint_names"):
                self.hflip_indices = create_keypoint_hflip_indices(meta)
        d = cfg.DATASETS
        self.proposal_topk = d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if is_train else d.PRECOMPUTED_PROPOSAL_TOPK_TEST

    def __call__(self, dataset_dict: dict, rng: np.random.RandomState) -> dict:
        d = dataset_dict
        image = read_image(d["file_name"], self.image_format)
        orig_hw = image.shape[:2]
        image, tfms = apply_augmentations(self.augmentations, image, rng)
        hw = image.shape[:2]
        out = {
            "image": image,
            "hw": np.asarray(hw, np.int32),
            "orig_hw": np.asarray(orig_hw, np.int32),
            "image_id": d.get("image_id"),
        }
        if self.load_proposals:
            out.update(transform_proposals(d, hw, tfms, self.proposal_topk))
        if "data_dt_file_name" in d:
            image_t = read_image(d["data_dt_file_name"], self.image_format)
            if image_t.shape[:2] != orig_hw:  # twins are pixel-aligned; guard anyway
                image_t = np.asarray(Image.fromarray(image_t).resize((orig_hw[1], orig_hw[0])))
            out["image_trgt"] = tfms.apply_image(image_t)
        annos = [a for a in d.get("annotations", []) if not (self.is_train and a.get("difficult", 0))]
        out.update(transform_boxes(annos, tfms, hw, self.use_instance_mask, self.use_keypoint, self.hflip_indices))
        return out


class DatasetMapperTwoCropSeparate:
    """cfg -> callable(dataset_dict, rng) -> (strong, weak) samples: one
    geometric transform, then the strong augmentation of the image and of
    its twin, drawn from `rng` after the weak sample's draws."""

    def __init__(self, cfg, is_train: bool = True):
        self.base = DatasetMapper(cfg, is_train)
        self.strong_aug = build_strong_augmentation_fn()

    def __call__(self, dataset_dict: dict, rng: np.random.RandomState):
        weak = self.base(dataset_dict, rng)
        strong = dict(weak)
        strong["image"] = self.strong_aug(weak["image"], rng)
        if "image_trgt" in weak:
            strong["image_trgt"] = self.strong_aug(weak["image_trgt"], rng)
        return strong, weak


def check_labels(sem: np.ndarray, num_classes: int, ignore_label: int, path: str) -> np.ndarray:
    """`sem` unchanged where every label is a class of the head or the
    ignore label; else ValueError naming `path` (a label past the head's
    classes would index past its logits, where JAX's loss reads garbage)."""
    bad = (sem != ignore_label) & ((sem < 0) | (sem >= num_classes))
    if bad.any():
        raise ValueError(f"{path}: labels {sorted(set(np.unique(sem[bad]).tolist()))[:8]} are not classes of "
                         f"MODEL.SEM_SEG_HEAD.NUM_CLASSES = {num_classes} (ignore {ignore_label})")
    return sem


class SemSegDatasetMapper:
    """A sem-seg record -> the image and its labelTrainIds map through the
    same sampled geometric transforms (the map NEAREST), as "sem_seg" (H,
    W) int32; no instances. A label that is neither a class of the head
    nor the ignore value raises (`check_labels`)."""

    def __init__(self, cfg, is_train: bool = True):
        self.augmentations = build_augmentation(cfg, is_train)
        self.image_format = cfg.INPUT.FORMAT
        self.num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.ignore_label = cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE

    def __call__(self, dataset_dict: dict, rng: np.random.RandomState) -> dict:
        d = dataset_dict
        image = read_image(d["file_name"], self.image_format)
        orig_hw = image.shape[:2]
        image, tfms = apply_augmentations(self.augmentations, image, rng)
        sem = np.asarray(Image.open(d["sem_seg_file_name"]), np.int32)
        sem = tfms.apply_segmentation(check_labels(sem, self.num_classes, self.ignore_label, d["sem_seg_file_name"]))
        return {
            "image": image,
            "hw": np.asarray(image.shape[:2], np.int32),
            "orig_hw": np.asarray(orig_hw, np.int32),
            "image_id": d.get("image_id"),
            "boxes": np.zeros((0, 4), np.float32),
            "classes": np.zeros((0,), np.int32),
            "sem_seg": sem.astype(np.int32),
        }


class PanopticDatasetMapper:
    """A panoptic record -> the image through the sampled geometric
    transforms, the thing segments' boxes (from segments_info, moved,
    clipped, empty ones dropped) and thing-space classes, and "sem_seg", the
    stuff-space class map of the panoptic PNG (MODEL.SEM_SEG_HEAD.IGNORE_VALUE
    where no segment is), NEAREST. With MODEL.MASK_ON, "bitmasks": each kept
    thing's pixels of the NEAREST-transformed segment-id map, float32. The
    stuff space is every category of the set (JAX's loader): a set of more
    categories than the head's classes raises (`check_labels`)."""

    def __init__(self, cfg, is_train: bool = True):
        self.augmentations = build_augmentation(cfg, is_train)
        self.image_format = cfg.INPUT.FORMAT
        self.num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.ignore_label = cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE
        self.use_instance_mask = cfg.MODEL.MASK_ON

    def __call__(self, dataset_dict: dict, rng: np.random.RandomState) -> dict:
        d = dataset_dict
        image = read_image(d["file_name"], self.image_format)
        orig_hw = image.shape[:2]
        image, tfms = apply_augmentations(self.augmentations, image, rng)
        hw = image.shape[:2]
        pan = np.asarray(Image.open(d["pan_seg_file_name"]).convert("RGB"))
        sem = check_labels(panoptic_png_to_sem_seg(pan, d["segments_info"], self.ignore_label), self.num_classes,
                           self.ignore_label, d["pan_seg_file_name"])
        sem = tfms.apply_segmentation(sem)
        ids = tfms.apply_segmentation(rgb2id(pan).astype(np.int32)) if self.use_instance_mask else None
        things = [seg for seg in d["segments_info"] if seg["isthing"] and seg.get("bbox") is not None]
        boxes = np.asarray([[x, y, x + w, y + h] for x, y, w, h in (seg["bbox"] for seg in things)],
                           np.float32).reshape(-1, 4)
        classes = np.asarray([seg["category_id"] for seg in things], np.int32).reshape(-1)
        seg_ids = np.asarray([seg["id"] for seg in things], np.int32).reshape(-1)
        if len(boxes):
            boxes = tfms.apply_box(boxes)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, hw[1])
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, hw[0])
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes, seg_ids = boxes[keep], classes[keep], seg_ids[keep]
        out = {
            "image": image,
            "hw": np.asarray(hw, np.int32),
            "orig_hw": np.asarray(orig_hw, np.int32),
            "image_id": d.get("image_id"),
            "boxes": boxes,
            "classes": classes,
            "sem_seg": sem.astype(np.int32),
        }
        if ids is not None:
            out["bitmasks"] = [(ids == sid).astype(np.float32) for sid in seg_ids]
        return out
