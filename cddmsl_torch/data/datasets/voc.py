"""PASCAL-VOC XML dataset loading, plus the domain-generalization pairing
(the port's copy of cddmsl_tpu/data/datasets/voc.py).

Mirrors the reference loaders (detectron2/data/datasets/pascal_voc.py):
  * `load_voc_instances` — standard VOC XML -> list[dict]
  * `load_voc_DG_instances` (pascal_voc.py:98-172) — pairs every image with
    its CycleGAN-translated counterpart at
    ../<dt_domain>/VOC<year>/JPEGImages/<id>.jpg via `data_dt_file_name`
"""

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence

CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# 6-class artistic subsets (Watercolor/Comic only annotate these;
# reference train_net.py:102-103 restricts eval to them)
ARTISTIC_6_CLASSES = ("bicycle", "bird", "car", "cat", "dog", "person")


def _parse_voc_xml(anno_file: str, class_names: Sequence[str]) -> List[dict]:
    tree = ET.parse(anno_file)
    instances = []
    for obj in tree.findall("object"):
        cls = obj.find("name").text
        if cls not in class_names:
            continue
        difficult = int(obj.find("difficult").text) if obj.find("difficult") is not None else 0
        bbox = obj.find("bndbox")
        # VOC is 1-indexed; convert to 0-indexed float coords (reference
        # pascal_voc.py subtracts 1.0 from x1/y1)
        box = [
            float(bbox.find("xmin").text) - 1.0,
            float(bbox.find("ymin").text) - 1.0,
            float(bbox.find("xmax").text),
            float(bbox.find("ymax").text),
        ]
        instances.append(
            {
                "category_id": class_names.index(cls),
                "bbox": box,
                "bbox_mode": "XYXY_ABS",
                "difficult": difficult,
            }
        )
    return instances


def load_voc_instances(
    dirname: str, split: str, class_names: Sequence[str] = CLASS_NAMES
) -> List[dict]:
    """dirname: e.g. datasets/VOC2007; split: train/val/trainval/test."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]
    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        tree = ET.parse(anno_file)
        r = {
            "file_name": jpeg_file,
            "image_id": fileid,
            "height": int(tree.find("size/height").text),
            "width": int(tree.find("size/width").text),
            "annotations": _parse_voc_xml(anno_file, class_names),
        }
        dicts.append(r)
    return dicts


def load_voc_DG_instances(
    dirname: str,
    split: str,
    dt_domain: str,
    class_names: Sequence[str] = CLASS_NAMES,
) -> List[dict]:
    """Paired-domain VOC: every record carries `data_dt_file_name`, the
    translated twin at ../<dt_domain>/VOC<year>/JPEGImages/<id>.jpg
    (reference pascal_voc.py:98-172). Records whose twin is missing keep the
    source path (robustness; the reference would crash at read time)."""
    dicts = load_voc_instances(dirname, split, class_names)
    year_dir = os.path.basename(os.path.normpath(dirname))  # VOC2007 / VOC2012
    parent = os.path.dirname(os.path.normpath(dirname))
    for r in dicts:
        fileid = r["image_id"]
        dt_file = os.path.join(parent, dt_domain, year_dir, "JPEGImages", fileid + ".jpg")
        r["data_dt_file_name"] = dt_file if os.path.exists(dt_file) else r["file_name"]
    return dicts


def register_pascal_voc(name, dirname, split, year, class_names=CLASS_NAMES):
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split, class_names))
    MetadataCatalog.get(name).set(
        thing_classes=list(class_names),
        dirname=dirname,
        year=year,
        split=split,
        evaluator_type="pascal_voc",
    )


def register_pascal_DG(name, dirname, split, year, dt_domain, class_names=CLASS_NAMES):
    """reference pascal_voc.py:182 register_pascal_DG."""
    from ..catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(
        name, lambda: load_voc_DG_instances(dirname, split, dt_domain, class_names)
    )
    MetadataCatalog.get(name).set(
        thing_classes=list(class_names),
        dirname=dirname,
        year=year,
        split=split,
        dt_domain=dt_domain,
        evaluator_type="pascal_voc",
    )
