"""Cityscapes instance boxes and the adverse-weather pairing (the port's copy
of the detection loaders of cddmsl_tpu/data/datasets/cityscapes.py).

Boxes are the extents of the gtFine polygons of the 8 detection classes; a
label ending in "group" counts as its class, any other label is dropped.
The DG variant pairs each clear image with its synthetic-fog twin under
leftImg8bit_foggy through `data_dt_file_name`, or with itself when the twin
is missing. Both are evaluated with the VOC evaluator.
`load_cityscapes_semantic` pairs each image with its gtFine labelTrainIds
PNG for the semantic segmentor (evaluator "sem_seg").

The loader keeps the files whose names end in "leftImg8bit.png", as the JAX
package's does. A leftImg8bit_foggy directory holds "..._leftImg8bit_foggy_
beta_<b>.png" files, so a set registered on one finds no image.
"""

import json
import os
from typing import List, Sequence

CITYSCAPES_THING_CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")


def _poly_bbox(polygon):
    xs = [p[0] for p in polygon]
    ys = [p[1] for p in polygon]
    return [min(xs), min(ys), max(xs), max(ys)]


def load_cityscapes_instances(
    image_dir: str, gt_dir: str, class_names: Sequence[str] = CITYSCAPES_THING_CLASSES
) -> List[dict]:
    """image_dir: .../leftImg8bit/<split>; gt_dir: .../gtFine/<split>."""
    dicts = []
    for city in sorted(os.listdir(image_dir)):
        city_img_dir = os.path.join(image_dir, city)
        if not os.path.isdir(city_img_dir):
            continue
        for basename in sorted(os.listdir(city_img_dir)):
            if not basename.endswith("leftImg8bit.png"):
                continue
            prefix = basename[: -len("leftImg8bit.png")]
            with open(os.path.join(gt_dir, city, prefix + "gtFine_polygons.json")) as f:
                ann = json.load(f)
            annos = []
            for obj in ann["objects"]:
                label = obj["label"]
                if label.endswith("group"):
                    label = label[: -len("group")]
                if label not in class_names:
                    continue
                annos.append({"category_id": class_names.index(label), "bbox": _poly_bbox(obj["polygon"]),
                              "bbox_mode": "XYXY_ABS"})
            dicts.append({
                "file_name": os.path.join(city_img_dir, basename),
                "image_id": prefix.rstrip("_"),
                "height": ann["imgHeight"],
                "width": ann["imgWidth"],
                "annotations": annos,
            })
    return dicts


def load_cityscapes_DG_instances(
    image_dir: str, gt_dir: str, foggy_image_dir: str, beta: float = 0.02,
    class_names: Sequence[str] = CITYSCAPES_THING_CLASSES,
) -> List[dict]:
    """Each clear image paired with leftImg8bit_foggy/<...>_foggy_beta_<b>.png
    through `data_dt_file_name`."""
    dicts = load_cityscapes_instances(image_dir, gt_dir, class_names)
    for r in dicts:
        rel = os.path.relpath(r["file_name"], image_dir)
        dt_file = os.path.join(foggy_image_dir, rel.replace("leftImg8bit.png", f"leftImg8bit_foggy_beta_{beta}.png"))
        r["data_dt_file_name"] = dt_file if os.path.exists(dt_file) else r["file_name"]
    return dicts


def register_cityscapes(name, image_dir, gt_dir, class_names=CITYSCAPES_THING_CLASSES):
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(name, lambda: load_cityscapes_instances(image_dir, gt_dir, class_names))
    MetadataCatalog.get(name).set(thing_classes=list(class_names), image_dir=image_dir, gt_dir=gt_dir,
                                  evaluator_type="pascal_voc")


def register_cityscapes_DG(name, image_dir, gt_dir, foggy_image_dir, beta=0.02, class_names=CITYSCAPES_THING_CLASSES):
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(
        name, lambda: load_cityscapes_DG_instances(image_dir, gt_dir, foggy_image_dir, beta, class_names)
    )
    MetadataCatalog.get(name).set(thing_classes=list(class_names), image_dir=image_dir, gt_dir=gt_dir,
                                  foggy_image_dir=foggy_image_dir, evaluator_type="pascal_voc")


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    """Sem-seg records: each image with its *_gtFine_labelTrainIds.png (the
    19 trainIds, 255 ignored); raises without images or without the first
    label file."""
    dicts = []
    for city in sorted(os.listdir(image_dir)):
        city_img_dir = os.path.join(image_dir, city)
        if not os.path.isdir(city_img_dir):
            continue
        for basename in sorted(os.listdir(city_img_dir)):
            if not basename.endswith("leftImg8bit.png"):
                continue
            prefix = basename[: -len("leftImg8bit.png")]
            dicts.append({"file_name": os.path.join(city_img_dir, basename),
                          "sem_seg_file_name": os.path.join(gt_dir, city, prefix + "gtFine_labelTrainIds.png"),
                          "image_id": prefix.rstrip("_")})
    assert dicts, f"no cityscapes images under {image_dir}"
    if not os.path.isfile(dicts[0]["sem_seg_file_name"]):
        raise FileNotFoundError(f"{dicts[0]['sem_seg_file_name']}: generate labelTrainIds.png with "
                                "cityscapesscripts createTrainIdLabelImgs.py")
    return dicts


def register_cityscapes_semantic(name: str, image_dir: str, gt_dir: str) -> None:
    from ..catalog import DatasetCatalog, MetadataCatalog
    from .cityscapes_panoptic import CITYSCAPES_CATEGORIES

    DatasetCatalog.register(name, lambda: load_cityscapes_semantic(image_dir, gt_dir))
    MetadataCatalog.get(name).set(stuff_classes=[k["name"] for k in CITYSCAPES_CATEGORIES], image_dir=image_dir,
                                  gt_dir=gt_dir, ignore_label=255, evaluator_type="sem_seg")
