"""Dataset dict -> per-image numpy sample (the port's copy of
cddmsl_tpu/data/dataset_mapper.py `DatasetMapper`, boxes only, and
`DatasetMapperTwoCropSeparate`).

The image and its translated twin `data_dt_file_name` are read and put
through the same sampled geometric transforms; the boxes follow, are clipped
to the image and empty ones dropped. With MODEL.LOAD_PROPOSALS the dict's
precomputed proposals follow them too (`proposals.transform_proposals`),
the top DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN (or _TEST) kept. Instances marked difficult are dropped
at train time (the detectron2 VOC convention).

The two-crop mapper of the mean-teacher loader gives (strong, weak) views of
one image under one geometric transform: the weak view is the plain sample,
the strong one its photometric augmentation (and its translated twin's).
"""

from typing import Dict, List

import numpy as np
from PIL import Image

from .proposals import transform_proposals
from .transforms import TransformList, apply_augmentations, build_augmentation, build_strong_augmentation_fn


def read_image(path: str, fmt: str = "RGB") -> np.ndarray:
    img = np.asarray(Image.open(path).convert("RGB"))
    return img[:, :, ::-1] if fmt == "BGR" else img


def transform_boxes(annos: List[dict], tfms: TransformList, image_hw) -> Dict[str, np.ndarray]:
    """The annotations' boxes through `tfms`, clipped to `image_hw`, empty
    ones dropped with their classes."""
    boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
    classes = np.array([a["category_id"] for a in annos], np.int32).reshape(-1)
    if len(boxes):
        boxes = tfms.apply_box(boxes)
        h, w = image_hw
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, classes = boxes[keep], classes[keep]
    return {"boxes": boxes, "classes": classes}


class DatasetMapper:
    """cfg -> callable(dataset_dict, rng) -> sample dict of numpy arrays:
    image, [image_trgt], boxes (N, 4), classes (N,), hw, orig_hw, image_id."""

    def __init__(self, cfg, is_train: bool = True):
        self.is_train = is_train
        self.augmentations = build_augmentation(cfg, is_train)
        self.image_format = cfg.INPUT.FORMAT
        self.load_proposals = cfg.MODEL.LOAD_PROPOSALS
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
        out.update(transform_boxes(annos, tfms, hw))
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
