"""LVIS-json detection sets (the port's copy of
cddmsl_tpu/data/datasets/lvis.py `load_lvis_json` and
`register_lvis_instances`, over plain json).

What differs from COCO: there are no crowd annotations; each record keeps
its image's `neg_category_ids` and `not_exhaustive_category_ids` (as
contiguous ids), which the LVIS evaluator uses to ignore detections; an
image without a `file_name` takes the last two parts of its `coco_url`
(val2017/xxx.jpg); the metadata keeps each class's `image_count`
(`class_image_counts`), which sorts the classes into rare, common and
frequent. Segmentations are kept as the file has them and not read.
"""

import json
import os
from collections import defaultdict
from typing import List, Optional


def load_lvis_json(json_file: str, image_root: str, dataset_name: Optional[str] = None) -> List[dict]:
    with open(json_file) as f:
        lvis = json.load(f)

    cats = sorted(lvis["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        from ..catalog import MetadataCatalog

        meta = MetadataCatalog.get(dataset_name)
        if meta.get("thing_classes") is None:
            meta.set(thing_classes=[c["name"] for c in cats], thing_dataset_id_to_contiguous_id=id_map,
                     class_image_counts=[c.get("image_count", 0) for c in cats], evaluator_type="lvis")

    anns_by_image = defaultdict(list)
    for ann in lvis.get("annotations", []):
        anns_by_image[ann["image_id"]].append(ann)

    dicts = []
    for img in lvis["images"]:
        file_name = img["file_name"] if "file_name" in img else "/".join(img["coco_url"].split("/")[-2:])
        annos = []
        for ann in anns_by_image.get(img["id"], []):
            x, y, w, h = ann["bbox"]
            rec = {"category_id": id_map[ann["category_id"]], "bbox": [x, y, x + w, y + h], "bbox_mode": "XYXY_ABS",
                   "iscrowd": 0}
            if ann.get("segmentation") is not None:
                rec["segmentation"] = ann["segmentation"]
            annos.append(rec)
        dicts.append({
            "file_name": os.path.join(image_root, file_name),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
            "neg_category_ids": [id_map[c] for c in img.get("neg_category_ids", []) if c in id_map],
            "not_exhaustive_category_ids": [id_map[c] for c in img.get("not_exhaustive_category_ids", [])
                                            if c in id_map],
            "annotations": annos,
        })
    return dicts


def register_lvis_instances(name: str, json_file: str, image_root: str) -> None:
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="lvis")
