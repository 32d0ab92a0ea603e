"""Dataset dict -> per-image numpy sample (the port's copy of
cddmsl_tpu/data/dataset_mapper.py `DatasetMapper`, boxes only).

The image and its translated twin `data_dt_file_name` are read and put
through the same sampled geometric transforms; the boxes follow, are clipped
to the image and empty ones dropped. Instances marked difficult are dropped
at train time (the detectron2 VOC convention).
"""

from typing import Dict, List

import numpy as np
from PIL import Image

from .transforms import TransformList, apply_augmentations, build_augmentation


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
        if "data_dt_file_name" in d:
            image_t = read_image(d["data_dt_file_name"], self.image_format)
            if image_t.shape[:2] != orig_hw:  # twins are pixel-aligned; guard anyway
                image_t = np.asarray(Image.fromarray(image_t).resize((orig_hw[1], orig_hw[0])))
            out["image_trgt"] = tfms.apply_image(image_t)
        annos = [a for a in d.get("annotations", []) if not (self.is_train and a.get("difficult", 0))]
        out.update(transform_boxes(annos, tfms, hw))
        return out
