"""Deterministic on-disk fixtures: the same seed writes byte-identical
images and annotations.

- `make_synthetic_voc` and `register_synthetic_quick` (the port's copies of
  those in cddmsl_tpu/data/datasets/synthetic.py): VOC with a bright
  rectangle exactly where each ground-truth box is;
- `make_synthetic_coco` (the JAX package's writer without its keypoints,
  and without the polygons in the json): a COCO-json set with one bright
  diamond per box, registered as `{prefix}_train` / `{prefix}_val` by
  `register_synthetic_coco`; `make_synthetic_proposals` writes its
  precomputed-proposal pickle; `make_synthetic_bdd` moves it to the
  bdd_100k_val paths;
- `make_synthetic_cityscapes`: one split of the Cityscapes layout (PNGs,
  gtFine polygon JSONs, the leftImg8bit_foggy twins) on smooth images.
"""

import json
import os
from typing import Tuple

import numpy as np

from ..catalog import DatasetCatalog
from .cityscapes import CITYSCAPES_THING_CLASSES
from .voc import register_pascal_DG, register_pascal_voc

_FIXTURE_HW = (100, 140)


def make_synthetic_voc(root: str, n: int = 6, seed: int = 0, classes: Tuple[str, ...] = ("dog", "cat")) -> str:
    """Writes a VOC2007-layout dataset of `n` images and its dt_clipart twin
    (the inverted images) under `root`; returns the VOC2007 directory."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    voc = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    dt = os.path.join(root, "dt_clipart", "VOC2007", "JPEGImages")
    os.makedirs(dt, exist_ok=True)
    h, w = _FIXTURE_HW
    ids = []
    for i in range(n):
        fid = f"{i:06d}"
        ids.append(fid)
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)  # dark noise background
        objs = []
        for _ in range(rng.randint(1, 3)):
            bw = int(30 + rng.rand() * 40)
            bh = int(25 + rng.rand() * 35)
            x1 = int(rng.rand() * (w - bw - 2)) + 1
            y1 = int(rng.rand() * (h - bh - 2)) + 1
            cls = classes[int(rng.randint(len(classes)))]
            img[y1 : y1 + bh, x1 : x1 + bw] = 255 if cls == classes[0] else 160
            objs.append((cls, x1, y1, x1 + bw, y1 + bh))
        Image.fromarray(img).save(os.path.join(voc, "JPEGImages", fid + ".jpg"))
        Image.fromarray(255 - img).save(os.path.join(dt, fid + ".jpg"))
        parts = [f"<annotation><size><width>{w}</width><height>{h}</height></size>"]
        for cls, x1, y1, x2, y2 in objs:
            parts.append(
                f"<object><name>{cls}</name><difficult>0</difficult>"
                f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            )
        parts.append("</annotation>")
        with open(os.path.join(voc, "Annotations", fid + ".xml"), "w") as f:
            f.write("\n".join(parts))
    for split in ("trainval", "test"):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids))
    return voc


def register_synthetic_quick(root: str, prefix: str = "synthetic_voc") -> None:
    """Writes the fixture under `root` and registers `{prefix}_trainval` (the
    DG pair), `{prefix}_trainval_plain` and `{prefix}_test`."""
    voc = make_synthetic_voc(root)
    for name, register in (
        (f"{prefix}_trainval", lambda: register_pascal_DG(f"{prefix}_trainval", voc, "trainval", 2007, "dt_clipart")),
        (f"{prefix}_trainval_plain", lambda: register_pascal_voc(f"{prefix}_trainval_plain", voc, "trainval", 2007)),
        (f"{prefix}_test", lambda: register_pascal_voc(f"{prefix}_test", voc, "test", 2007)),
    ):
        if name not in DatasetCatalog:
            register()



def make_synthetic_coco(root: str, n: int = 6, seed: int = 0, classes: Tuple[str, ...] = ("dog", "cat"),
                        hw: Tuple[int, int] = _FIXTURE_HW) -> Tuple[str, str]:
    """Writes a COCO-json set of `n` JPEGs under `root`/coco_synth, one bright
    diamond per box, box sizes scaled from the 100x140 fixture to `hw`;
    returns (json path, image root). At the default size the images are
    the JAX package's, byte for byte."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_root = os.path.join(root, "coco_synth", "images")
    os.makedirs(img_root, exist_ok=True)
    h, w = hw
    sy, sx = h / _FIXTURE_HW[0], w / _FIXTURE_HW[1]
    images, annotations = [], []
    for i in range(n):
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        images.append({"id": i + 1, "file_name": f"{i:06d}.jpg", "height": h, "width": w})
        for _ in range(rng.randint(1, 3)):
            bw = int((34 + rng.rand() * 36) * sx)
            bh = int((30 + rng.rand() * 30) * sy)
            x1 = int(rng.rand() * (w - bw - 2)) + 1
            y1 = int(rng.rand() * (h - bh - 2)) + 1
            cid = int(rng.randint(len(classes)))
            cx, cy = x1 + bw / 2.0, y1 + bh / 2.0
            yy, xx = np.mgrid[0:h, 0:w]
            inside = (np.abs(xx + 0.5 - cx) / (bw / 2.0) + np.abs(yy + 0.5 - cy) / (bh / 2.0)) <= 1.0
            img[inside] = 255 if cid == 0 else 160
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1, "category_id": cid + 1,
                                "bbox": [x1, y1, bw, bh], "area": bw * bh / 2.0, "iscrowd": 0})
        Image.fromarray(img).save(os.path.join(img_root, f"{i:06d}.jpg"))
    categories = [{"id": c + 1, "name": name} for c, name in enumerate(classes)]
    json_path = os.path.join(root, "coco_synth", "instances.json")
    with open(json_path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return json_path, img_root


def register_synthetic_coco(root: str, prefix: str = "synthetic_coco") -> None:
    """Writes the COCO fixture under `root` and registers `{prefix}_train`
    and `{prefix}_val` (the same images, as in the JAX package)."""
    from .coco import register_coco_instances

    json_path, img_root = make_synthetic_coco(root)
    for name in (f"{prefix}_train", f"{prefix}_val"):
        if name not in DatasetCatalog:
            register_coco_instances(name, json_path, img_root)


def make_synthetic_proposals(root: str, seed: int = 1) -> str:
    """Writes the precomputed-proposal pickle of the COCO fixture under
    `root` (detectron2's schema: ids, boxes, objectness_logits): per image
    each ground-truth box (logit 8-9), three jittered copies (2-3) and eight
    random background boxes (-2 to -1), clipped to the image; the JAX
    package's file for the same fixture. Returns its path."""
    import pickle

    json_path = os.path.join(root, "coco_synth", "instances.json")
    with open(json_path) as f:
        coco = json.load(f)
    rng = np.random.RandomState(seed)
    h, w = _FIXTURE_HW
    by_img = {}
    for a in coco["annotations"]:
        x1, y1, bw, bh = a["bbox"]
        by_img.setdefault(a["image_id"], []).append([x1, y1, x1 + bw, y1 + bh])
    ids, boxes, logits = [], [], []
    for im in coco["images"]:
        gt = np.asarray(by_img.get(im["id"], []), np.float64).reshape(-1, 4)
        props, scores = [], []
        for g in gt:
            props.append(g)
            scores.append(8.0 + rng.rand())
            for _ in range(3):
                props.append(g + rng.randn(4) * 3.0)
                scores.append(2.0 + rng.rand())
        for _ in range(8):
            x1 = rng.uniform(0, w - 20)
            y1 = rng.uniform(0, h - 20)
            props.append([x1, y1, x1 + rng.uniform(10, 40), y1 + rng.uniform(10, 30)])
            scores.append(-2.0 + rng.rand())
        ids.append(im["id"])
        boxes.append(np.clip(np.asarray(props, np.float32), 0, [w, h, w, h]))
        logits.append(np.asarray(scores, np.float32))
    out = os.path.join(root, "coco_synth", "proposals.pkl")
    with open(out, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes, "objectness_logits": logits}, f)
    return out


def make_synthetic_bdd(root: str, n: int = 6, seed: int = 0, classes: Tuple[str, ...] = ("dog", "cat"),
                       hw: Tuple[int, int] = _FIXTURE_HW) -> Tuple[str, str]:
    """`make_synthetic_coco` at the paths bdd_100k_val reads under `root`;
    returns (json path, image root)."""
    json_path, img_root = make_synthetic_coco(os.path.join(root, "bdd100k"), n, seed, classes, hw)
    dst_json = os.path.join(root, "bdd100k", "labels", "bdd100k_labels_images_det_coco_val.json")
    dst_images = os.path.join(root, "bdd100k", "images", "100k", "val")
    os.renames(json_path, dst_json)
    os.renames(img_root, dst_images)
    return dst_json, dst_images


# labels the Cityscapes fixture draws beside the 8 classes: a group label,
# which counts as its class, and one outside the classes, which is dropped
_CITY_EXTRA_LABELS = ("persongroup", "sky")


def make_synthetic_cityscapes(root: str, n: int = 4, seed: int = 0, hw: Tuple[int, int] = (1024, 2048),
                              split: str = "train", foggy: bool = True) -> str:
    """Writes one split of the Cityscapes layout under `root`/cityscapes and
    returns that directory: `n` smooth PNGs with filled boxes
    (leftImg8bit/<split>/<city>/<city>_<seq>_000019_leftImg8bit.png), their
    gtFine polygon JSONs and, with `foggy`, the fog twins
    (leftImg8bit_foggy/<split>/<city>/..._leftImg8bit_foggy_beta_0.02.png)
    of all images but the last. Image 0 holds a "persongroup" and a "sky"
    object; every image holds at least one object of the 8 classes."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    city_root = os.path.join(root, "cityscapes")
    cities = ("frankfurt", "lindau") if split == "val" else ("aachen", "bremen")
    h, w = hw
    base = 40 + 80 * np.linspace(0, 1, h)[:, None] + 40 * np.linspace(0, 1, w)[None, :]
    labels = CITYSCAPES_THING_CLASSES + _CITY_EXTRA_LABELS
    for i in range(n):
        city = cities[i % 2]
        prefix = f"{city}_{i:06d}_000019_"
        img = (base[..., None] + rng.rand(3) * 40).astype(np.uint8)
        objects = []
        for j in range(2 + rng.randint(3)):
            if i == 0 and j < 2:
                label = _CITY_EXTRA_LABELS[j]
            else:
                label = labels[rng.randint(len(CITYSCAPES_THING_CLASSES) if j == 0 else len(labels))]
            bw, bh = int((0.1 + rng.rand() * 0.25) * w), int((0.15 + rng.rand() * 0.3) * h)
            x1, y1 = int(rng.rand() * (w - bw - 2)) + 1, int(rng.rand() * (h - bh - 2)) + 1
            img[y1 : y1 + bh, x1 : x1 + bw] = 90 + 15 * labels.index(label)
            polygon = [[x1, y1 + bh // 2], [x1 + bw // 2, y1], [x1 + bw, y1 + bh // 3], [x1 + bw, y1 + bh],
                       [x1, y1 + bh]]
            objects.append({"label": label, "polygon": polygon})
        for sub, name, pixels in (
            ("leftImg8bit", prefix + "leftImg8bit.png", img),
            ("leftImg8bit_foggy", prefix + "leftImg8bit_foggy_beta_0.02.png",
             (img * 0.55 + 0.45 * 205).astype(np.uint8) if foggy and i < n - 1 else None),
        ):
            if pixels is not None:
                os.makedirs(os.path.join(city_root, sub, split, city), exist_ok=True)
                Image.fromarray(pixels).save(os.path.join(city_root, sub, split, city, name), compress_level=1)
        gt = os.path.join(city_root, "gtFine", split, city)
        os.makedirs(gt, exist_ok=True)
        with open(os.path.join(gt, prefix + "gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, f)
    return city_root
