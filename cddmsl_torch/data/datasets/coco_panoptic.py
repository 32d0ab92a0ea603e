"""COCO panoptic sets (the port's copy of cddmsl_tpu/data/datasets/
coco_panoptic.py): the panoptic json pairs each image with a PNG whose RGB
encodes segment ids (id = R + 256 G + 256^2 B) and per-segment category and
iscrowd records.

Each record holds `pan_seg_file_name` and its `segments_info`, each
segment with its thing-space `category_id` (its stuff-space id where it is
not a thing), its `stuff_category_id` (every category lives in the stuff
space, which the semantic target uses), `isthing`, `iscrowd`, `bbox` and
`area`.
"""

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def rgb2id(color: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int32 segment ids (panopticapi's rule)."""
    color = color.astype(np.int32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def load_coco_panoptic_json(json_file: str, image_root: str, panoptic_root: str,
                            dataset_name: Optional[str] = None) -> List[dict]:
    """The records of one panoptic json; with `dataset_name` its metadata
    (thing and stuff classes, the two contiguous id maps, evaluator
    "coco_panoptic_seg") where the set has none yet."""
    with open(json_file) as f:
        pan = json.load(f)
    cats = sorted(pan["categories"], key=lambda c: c["id"])
    thing_ids = [c["id"] for c in cats if c.get("isthing", 0)]
    stuff_ids = [c["id"] for c in cats]  # the stuff map covers every category
    thing_map = {cid: i for i, cid in enumerate(thing_ids)}
    stuff_map = {cid: i for i, cid in enumerate(stuff_ids)}
    if dataset_name is not None:
        from ..catalog import MetadataCatalog

        meta = MetadataCatalog.get(dataset_name)
        if meta.get("thing_classes") is None:
            meta.set(thing_classes=[c["name"] for c in cats if c.get("isthing", 0)],
                     stuff_classes=[c["name"] for c in cats], thing_dataset_id_to_contiguous_id=thing_map,
                     stuff_dataset_id_to_contiguous_id=stuff_map, evaluator_type="coco_panoptic_seg")
    images = {img["id"]: img for img in pan["images"]}
    dicts = []
    for ann in pan["annotations"]:
        img = images[ann["image_id"]]
        segments = []
        for seg in ann["segments_info"]:
            cid = seg["category_id"]
            segments.append({
                "id": seg["id"],
                "category_id": thing_map.get(cid, stuff_map[cid]),
                "stuff_category_id": stuff_map[cid],
                "isthing": cid in thing_map,
                "iscrowd": seg.get("iscrowd", 0),
                "bbox": seg.get("bbox"),
                "area": seg.get("area"),
            })
        dicts.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": ann["image_id"],
            "height": img["height"],
            "width": img["width"],
            "pan_seg_file_name": os.path.join(panoptic_root, ann["file_name"]),
            "segments_info": segments,
        })
    logger.info("Loaded %d panoptic images from %s", len(dicts), json_file)
    return dicts


def panoptic_png_to_sem_seg(pan_png: np.ndarray, segments_info: List[Dict], ignore_label: int = 255) -> np.ndarray:
    """(H, W, 3) panoptic PNG and its segments -> (H, W) int32 stuff-space
    class map (things at their stuff-space id; pixels of no segment at
    `ignore_label`)."""
    ids = rgb2id(pan_png)
    out = np.full(ids.shape, ignore_label, np.int32)
    for seg in segments_info:
        out[ids == seg["id"]] = seg.get("stuff_category_id", seg["category_id"])
    return out


def register_coco_panoptic(name: str, json_file: str, image_root: str, panoptic_root: str) -> None:
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(name, lambda: load_coco_panoptic_json(json_file, image_root, panoptic_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, panoptic_root=panoptic_root,
                                  evaluator_type="coco_panoptic_seg")
