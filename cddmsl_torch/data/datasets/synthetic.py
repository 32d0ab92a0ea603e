"""The deterministic on-disk VOC fixture (the port's copy of
`make_synthetic_voc` and `register_synthetic_quick` in
cddmsl_tpu/data/datasets/synthetic.py): the same seed writes byte-identical
images and annotations, with a bright rectangle exactly where each
ground-truth box is.
"""

import os
from typing import Tuple

import numpy as np

from ..catalog import DatasetCatalog
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

