"""COCO-json instance sets (the port's copy of
cddmsl_tpu/data/datasets/coco.py `load_coco_json` and
`register_coco_instances`).

Contiguous class ids follow the categories sorted by id; the metadata gets
their names when the set is first loaded. Crowd annotations are dropped and
boxes go from XYWH to XYXY. An annotation's segmentation (polygon rings or
an RLE dict) is kept as it is: the mapper rasterises the polygons, the
evaluator reads both. An annotation's keypoints (COCO's flat [x0, y0, v0,
...]) are kept as they are: like JAX's loader, this one does not add
detectron2's +0.5 pixel-centre shift, and neither does the mapper (ROADMAP
C).
"""

import json
import os
from collections import defaultdict
from typing import List, Optional


def load_coco_json(json_file: str, image_root: str, dataset_name: Optional[str] = None,
                   filter_crowd: bool = True) -> List[dict]:
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        from ..catalog import MetadataCatalog

        meta = MetadataCatalog.get(dataset_name)
        if meta.get("thing_classes") is None:
            meta.set(thing_classes=[c["name"] for c in cats], thing_dataset_id_to_contiguous_id=id_map)

    anns_by_image = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_image[ann["image_id"]].append(ann)

    dicts = []
    for img in coco["images"]:
        annos = []
        for ann in anns_by_image.get(img["id"], []):
            if filter_crowd and ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann["bbox"]
            rec = {"category_id": id_map[ann["category_id"]], "bbox": [x, y, x + w, y + h],
                   "bbox_mode": "XYXY_ABS", "iscrowd": ann.get("iscrowd", 0)}
            if ann.get("segmentation") is not None:
                rec["segmentation"] = ann["segmentation"]
            if ann.get("keypoints") is not None:
                rec["keypoints"] = ann["keypoints"]
            annos.append(rec)
        dicts.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
            "annotations": annos,
        })
    return dicts


def register_coco_instances(name: str, json_file: str, image_root: str) -> None:
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="coco")
