"""Cityscapes panoptic sets (the port's copy of cddmsl_tpu/data/datasets/
cityscapes_panoptic.py): each leftImg8bit image with its COCO-format
panoptic PNG and segments_info from cityscapesscripts' createPanopticImgs
json, the dataset's category ids mapped to the train ids of the 19 classes
in both the thing and the stuff space.
"""

import json
import logging
import os
from typing import List

logger = logging.getLogger(__name__)

# the 19 evaluated classes: name, id, trainId, isthing, color
CITYSCAPES_CATEGORIES = [
    {"name": "road", "id": 7, "trainId": 0, "isthing": 0, "color": (128, 64, 128)},
    {"name": "sidewalk", "id": 8, "trainId": 1, "isthing": 0, "color": (244, 35, 232)},
    {"name": "building", "id": 11, "trainId": 2, "isthing": 0, "color": (70, 70, 70)},
    {"name": "wall", "id": 12, "trainId": 3, "isthing": 0, "color": (102, 102, 156)},
    {"name": "fence", "id": 13, "trainId": 4, "isthing": 0, "color": (190, 153, 153)},
    {"name": "pole", "id": 17, "trainId": 5, "isthing": 0, "color": (153, 153, 153)},
    {"name": "traffic light", "id": 19, "trainId": 6, "isthing": 0, "color": (250, 170, 30)},
    {"name": "traffic sign", "id": 20, "trainId": 7, "isthing": 0, "color": (220, 220, 0)},
    {"name": "vegetation", "id": 21, "trainId": 8, "isthing": 0, "color": (107, 142, 35)},
    {"name": "terrain", "id": 22, "trainId": 9, "isthing": 0, "color": (152, 251, 152)},
    {"name": "sky", "id": 23, "trainId": 10, "isthing": 0, "color": (70, 130, 180)},
    {"name": "person", "id": 24, "trainId": 11, "isthing": 1, "color": (220, 20, 60)},
    {"name": "rider", "id": 25, "trainId": 12, "isthing": 1, "color": (255, 0, 0)},
    {"name": "car", "id": 26, "trainId": 13, "isthing": 1, "color": (0, 0, 142)},
    {"name": "truck", "id": 27, "trainId": 14, "isthing": 1, "color": (0, 0, 70)},
    {"name": "bus", "id": 28, "trainId": 15, "isthing": 1, "color": (0, 60, 100)},
    {"name": "train", "id": 31, "trainId": 16, "isthing": 1, "color": (0, 80, 100)},
    {"name": "motorcycle", "id": 32, "trainId": 17, "isthing": 1, "color": (0, 0, 230)},
    {"name": "bicycle", "id": 33, "trainId": 18, "isthing": 1, "color": (119, 11, 32)},
]


def cityscapes_panoptic_meta() -> dict:
    """The thing and stuff id maps (both to trainIds), names and colors."""
    thing_map, stuff_map = {}, {}
    for k in CITYSCAPES_CATEGORIES:
        (thing_map if k["isthing"] else stuff_map)[k["id"]] = k["trainId"]
    names = [k["name"] for k in CITYSCAPES_CATEGORIES]
    colors = [k["color"] for k in CITYSCAPES_CATEGORIES]
    return {"thing_classes": names, "thing_colors": colors, "stuff_classes": names, "stuff_colors": colors,
            "thing_dataset_id_to_contiguous_id": thing_map, "stuff_dataset_id_to_contiguous_id": stuff_map}


def load_cityscapes_panoptic(image_dir: str, gt_dir: str, gt_json: str, meta: dict) -> List[dict]:
    """`gt_dir` the cityscapes_panoptic_<split> PNG folder, `gt_json` its
    json; raises when the json or an annotation's image is missing."""
    if not os.path.exists(gt_json):
        raise FileNotFoundError(f"{gt_json} not found: run cityscapesscripts createPanopticImgs.py")
    with open(gt_json) as f:
        info = json.load(f)
    image_by_base = {}
    for city in sorted(os.listdir(image_dir)):
        city_dir = os.path.join(image_dir, city)
        if not os.path.isdir(city_dir):
            continue
        for basename in os.listdir(city_dir):
            suffix = "_leftImg8bit.png"
            if basename.endswith(suffix):
                image_by_base[basename[: -len(suffix)]] = os.path.join(city_dir, basename)
    thing_map = meta["thing_dataset_id_to_contiguous_id"]
    stuff_map = meta["stuff_dataset_id_to_contiguous_id"]
    ret = []
    for ann in info["annotations"]:
        image_file = image_by_base.get(ann["image_id"])
        if image_file is None:
            raise FileNotFoundError(f"no image for annotation {ann['image_id']}")
        segments = []
        for seg in ann["segments_info"]:
            cid = seg["category_id"]
            segments.append({**seg, "category_id": thing_map.get(cid, stuff_map.get(cid, cid)),
                             "isthing": cid in thing_map})
        sem_label_file = image_file.replace("leftImg8bit", "gtFine").split(".")[0] + "_labelTrainIds.png"
        ret.append({
            "file_name": image_file,
            "image_id": "_".join(os.path.splitext(os.path.basename(image_file))[0].split("_")[:3]),
            "sem_seg_file_name": sem_label_file,
            "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
            "segments_info": segments,
        })
    logger.info("Loaded %d cityscapes panoptic images from %s", len(ret), gt_json)
    return ret


def register_all_cityscapes_panoptic(root: str) -> None:
    """cityscapes_fine_panoptic_{train,val} under root/cityscapes."""
    from ..catalog import DatasetCatalog, MetadataCatalog

    meta = cityscapes_panoptic_meta()
    for split in ("train", "val"):
        key = f"cityscapes_fine_panoptic_{split}"
        image_dir = os.path.join(root, "cityscapes", "leftImg8bit", split)
        gt_dir = os.path.join(root, "cityscapes", "gtFine", f"cityscapes_panoptic_{split}")
        gt_json = os.path.join(root, "cityscapes", "gtFine", f"cityscapes_panoptic_{split}.json")
        DatasetCatalog.register(key, lambda x=image_dir, y=gt_dir, z=gt_json: load_cityscapes_panoptic(x, y, z, meta))
        MetadataCatalog.get(key).set(panoptic_root=gt_dir, image_root=image_dir, panoptic_json=gt_json,
                                     gt_dir=gt_dir.replace("cityscapes_panoptic_", ""),
                                     evaluator_type="cityscapes_panoptic_seg", ignore_label=255, label_divisor=1000,
                                     **meta)
